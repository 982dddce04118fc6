"""Sequential-faithful decode oracle (host-side numpy, not batched).

Port of ``openpifpaf_tpu/ops/sequential_oracle.py``.  Reference parity:
``src/openpifpaf/csrc/src/decoder/cifcaf.cpp:~140`` — the seed loop with
occupancy suppression and the priority-queue ``_grow()`` (``:~220``).  The
production decoder (``ops/growth.py``) replaces this sequential scheduling
with data-parallel frontier relaxation; this module keeps the reference's
*scheduling* semantics — seeds consumed in score order, an occupancy grid
claimed pose by pose, one joint placed at a time per pose — with the
per-connection math of ``growth``'s weighted best connection.  It is the
slow oracle that bounds the parallel decoder's scheduling deviation
(``drift.py``, ``drift_report.py``, ``trained_drift.py``).

The inputs are one image's ``Seeds`` and ``CafCandidates``, on any
device: each tensor the oracle reads is read back to the host once
(``common.read_back``, counted in ``common.HOST_SYNCS``), never per scalar.
The arithmetic is the JAX module's, on the same numpy dtypes, so the two
give the same poses bit for bit.  Two things make it faster without
changing a result: a pose computes each directed edge's best connection
once, when its source joint is placed (the connection depends on nothing
that changes later), and a connection scans only the valid candidates of
its edge, in their order (an invalid candidate scores 0 and can decide
nothing that a 0 decides).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from .caf_scored import CafCandidates
from .common import read_back
from .growth import GrowthConfig, directed_edges
from .seeds import Seeds

_CAND_FIELDS = ('score', 'x_src', 'y_src', 'x_tgt', 'y_tgt', 's_tgt')


class Occupancy:
    """Per-field byte grid at reduced resolution.

    Reference: ``csrc/src/decoder/utils/occupancy.cpp:~15`` —
    ``set(f, x, y, sigma)`` claims a sigma-scaled square, ``get`` queries.
    """

    def __init__(self, n_fields: int, hw, *, reduction: float = 2.0,
                 min_scale: float = 4.0):
        self.reduction = reduction
        self.min_scale = min_scale
        h = int(np.ceil(hw[0] / reduction)) + 1
        w = int(np.ceil(hw[1] / reduction)) + 1
        self.grid = np.zeros((n_fields, h, w), bool)

    def set(self, f: int, x: float, y: float, sigma: float) -> None:
        r = max(self.min_scale, sigma) / self.reduction
        xg, yg = x / self.reduction, y / self.reduction
        _, h, w = self.grid.shape
        x0 = int(np.clip(round(xg - r), 0, w - 1))
        x1 = int(np.clip(round(xg + r), 0, w - 1))
        y0 = int(np.clip(round(yg - r), 0, h - 1))
        y1 = int(np.clip(round(yg + r), 0, h - 1))
        self.grid[f, y0:y1 + 1, x0:x1 + 1] = True

    def get(self, f: int, x: float, y: float) -> bool:
        _, h, w = self.grid.shape
        xg = int(np.clip(round(x / self.reduction), 0, w - 1))
        yg = int(np.clip(round(y / self.reduction), 0, h - 1))
        return bool(self.grid[f, yg, xg])


class HostCandidates:
    """One image's ``CafCandidates`` on the host: per directed edge the
    valid candidates' arrays, in slot order, taken at first use."""

    def __init__(self, cand: CafCandidates):
        arrays = {name: read_back(getattr(cand, name))
                  for name in _CAND_FIELDS + ('valid',)}
        self._valid = arrays.pop('valid')
        self._arrays = arrays
        self._edges = {}

    def edge(self, e: int, d: int):
        """(score, x_src, y_src, x_tgt, y_tgt, s_tgt) of edge ``e`` walked
        in direction ``d``, valid candidates only."""
        key = (e, d)
        if key not in self._edges:
            keep = np.flatnonzero(self._valid[e, d])
            self._edges[key] = tuple(self._arrays[name][e, d][keep]
                                     for name in _CAND_FIELDS)
        return self._edges[key]


def _best_connection(q: int, x: float, y: float, sigma: float,
                     cand: HostCandidates, edges, config: GrowthConfig,
                     blend: bool):
    """Scalar twin of ``growth._connection_values``'s weighted best."""
    score, cxs, cys, cxt, cyt, cst = cand.edge(int(edges.edge[q]),
                                               int(edges.direction[q]))
    if not len(score):
        return 0.0, (0.0, 0.0, 0.0)

    d2 = (cxs - x) ** 2 + (cys - y) ** 2
    sig2 = sigma * sigma
    w = np.exp(-0.5 * d2 / (config.gauss_denom * sig2))
    in_range = d2 <= (config.filter_factor ** 2) * sig2
    cs = np.where(in_range, w * score, 0.0)

    i1 = int(np.argmax(cs))
    v1 = float(cs[i1])
    t1 = (float(cxt[i1]), float(cyt[i1]), float(cst[i1]))
    if not blend:
        return v1, t1

    cs2 = cs.copy()
    cs2[i1] = 0.0
    i2 = int(np.argmax(cs2))
    v2 = float(cs2[i2])
    dt2 = (cxt[i2] - t1[0]) ** 2 + (cyt[i2] - t1[1]) ** 2
    if v2 > config.blend_min and dt2 <= t1[2] ** 2:
        wsum = max(v1 + v2, 1e-8)
        tx = (v1 * t1[0] + v2 * float(cxt[i2])) / wsum
        ty = (v1 * t1[1] + v2 * float(cyt[i2])) / wsum
        ts = (v1 * t1[2] + v2 * float(cst[i2])) / wsum
        return 0.5 * (v1 + v2), (tx, ty, ts)
    return v1, t1


def _frontier_option(q: int, pose: np.ndarray, cand: HostCandidates, edges,
                     config: GrowthConfig, keypoint_threshold: float,
                     reverse_match: bool):
    """The placement that directed edge ``q`` offers from its placed
    source joint: (value, (target joint, target, new v)), or None."""
    s_kp, t_kp = int(edges.src_kp[q]), int(edges.tgt_kp[q])
    x, y, vs, ss = pose[s_kp]
    sigma = max(ss, config.min_xy_scale)
    value, tgt = _best_connection(q, x, y, sigma, cand, edges, config,
                                  config.connection_blend)
    if value <= 0.0:
        return None
    if reverse_match:
        sig_t = max(tgt[2], config.min_xy_scale)
        rv, back = _best_connection(q ^ 1, tgt[0], tgt[1], sig_t, cand,
                                    edges, config, blend=False)
        back2 = (back[0] - x) ** 2 + (back[1] - y) ** 2
        if not (rv > 0.0
                and back2 <= (config.filter_factor ** 2) * sigma ** 2):
            return None
    new_v = np.sqrt(value * vs)
    if new_v <= keypoint_threshold \
            or new_v <= config.keypoint_threshold_rel * vs:
        return None
    return value, (t_kp, tgt, new_v)


def _grow_pose(pose: np.ndarray, placed: np.ndarray, cand: HostCandidates,
               edges, config: GrowthConfig, keypoint_threshold: float,
               reverse_match: bool) -> None:
    """Grow one pose to completion, best frontier connection first (the
    first directed edge of the highest value)."""
    q_n = len(edges.src_kp)
    options = {}    # q -> its placement, computed once per source joint
    while True:
        best = (0.0, None)
        for q in range(q_n):
            if not placed[edges.src_kp[q]] or placed[edges.tgt_kp[q]]:
                continue
            if q not in options:
                options[q] = _frontier_option(q, pose, cand, edges, config,
                                              keypoint_threshold,
                                              reverse_match)
            option = options[q]
            if option is not None and option[0] > best[0]:
                best = option
        if best[1] is None:
            return
        t_kp, (tx, ty, ts), new_v = best[1]
        pose[t_kp] = (tx, ty, new_v, ts)
        placed[t_kp] = True


def decode_sequential(seeds: Seeds, cand: CafCandidates,
                      skeleton: np.ndarray, *, n_keypoints: int, image_hw,
                      config: GrowthConfig = GrowthConfig(),
                      force_cand: CafCandidates = None) -> List[np.ndarray]:
    """Reference-scheduled decode of one image: returns the grown poses
    (K, 4) in seed consumption order (before NMS and instance scoring).

    ``seeds`` (S,) and ``cand`` (E, 2, C): one image's slice of a
    ``FrontEnd``.  ``force_cand``: the relaxed-threshold candidate set
    consumed only by the force-complete second pass (as ``growth.grow``'s
    ``force_cand``).
    """
    edges = directed_edges(np.asarray(skeleton))
    occupancy = Occupancy(n_keypoints, image_hw)
    poses: List[np.ndarray] = []

    # one read-back per tensor: the loops below index per scalar
    seeds = Seeds(*[read_back(a) for a in seeds])
    host_cand = HostCandidates(cand)
    host_fc = (HostCandidates(force_cand)
               if config.force_complete and force_cand is not None
               else host_cand)

    order = np.argsort(-seeds.v, kind='stable')
    for si in order:
        if len(poses) >= config.max_poses:
            break
        if not bool(seeds.valid[si]):
            continue
        f = int(seeds.f[si])
        x, y, v, s = (float(seeds.x[si]), float(seeds.y[si]),
                      float(seeds.v[si]), float(seeds.s[si]))
        if occupancy.get(f, x, y):
            continue
        pose = np.zeros((n_keypoints, 4), np.float32)
        placed = np.zeros(n_keypoints, bool)
        pose[f] = (x, y, v, s)
        placed[f] = True
        _grow_pose(pose, placed, host_cand, edges, config,
                   config.keypoint_threshold, config.reverse_match)
        if config.force_complete:
            relaxed = dataclasses.replace(config, keypoint_threshold_rel=0.0)
            _grow_pose(pose, placed, host_fc, edges, relaxed,
                       config.force_complete_threshold, reverse_match=False)
        for k in range(n_keypoints):
            if placed[k]:
                occupancy.set(k, pose[k, 0], pose[k, 1], pose[k, 3])
        poses.append(pose)
    return poses
