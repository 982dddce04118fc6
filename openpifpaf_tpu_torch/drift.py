"""Randomized crowd-scene drift harness: parallel decode vs the oracle.

Port of the JAX repository's ``tests/drift_harness.py`` with its painters
(``tests/test_decoder.py``'s ``paint_cif`` and ``paint_caf``).  The
reference decoder is order-dependent — seeds are consumed in score order
against an occupancy grid (``src/openpifpaf/csrc/src/decoder/cifcaf.cpp:
~140``) — while the production decoder grows all poses at once and
substitutes seed claims and NMS for occupancy.  This harness measures that
*scheduling* drift where it matters: dense, overlapping, scale-varied
crowds with partial occlusion.

Both paths take the same front end (``ops.pipeline.decode_front_end``:
CifHr, K1 on the card, then seeds and CAF candidates) and the same NMS
and scoring (``ops.pipeline.finalize_poses``), so every deviation is growth
scheduling and seed claims against occupancy, nothing else.  The scenes
are data: they are drawn with numpy from the same generator calls, in the
same order, as the JAX harness draws them, so a seed gives the same fields
in both packages.  Only the decode is torch.  The harness decodes a batch
of scenes at once on its device; each scene's result does not depend on
the batch.  The oracle (``ops.sequential_oracle``) takes one image's slice
of the front end and reads each of its tensors back once.

Used by ``drift_report.py`` (the density report), ``trained_drift.py``
(``scene_agreement``) and ``chip_smoke.py``'s drift phase.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import headmeta
from .device import resolve_device
from .ops import common, pipeline, sequential_oracle
from .ops.common import read_back
from .plugins.coco import constants

SIGMAS = np.asarray(constants.COCO_PERSON_SIGMAS, np.float32)
SCORE_WEIGHTS = np.asarray(constants.COCO_PERSON_SCORE_WEIGHTS, np.float32)
IMAGE_HW = (961, 961)   # 61x61 field grid at stride 16
GRID_HW = (61, 61)


# ---------------------------------------------------------------------------
# painters
# ---------------------------------------------------------------------------

def inv_sigmoid(p):
    p = np.clip(p, 1e-6, 1 - 1e-6)
    return np.log(p / (1 - p))


def inv_softplus(s):
    return np.log(np.expm1(np.maximum(s, 1e-6)))


def paint_cif(field, kp_xyv_px, scales_px, stride):
    """Paint raw CIF (K, 5, H, W): 4x4 neighborhood per visible keypoint."""
    k, _, h, w = field.shape
    for f in range(k):
        x, y, v = kp_xyv_px[f]
        if v <= 0:
            continue
        cx, cy = x / stride, y / stride
        i0, j0 = int(np.floor(cx)) - 1, int(np.floor(cy)) - 1
        for j in range(j0, j0 + 4):
            for i in range(i0, i0 + 4):
                if not (0 <= i < w and 0 <= j < h):
                    continue
                d = max(abs(cx - i), abs(cy - j))
                conf = 1.0 if d < 1.5 else 0.4
                field[f, 0, j, i] = inv_sigmoid(conf)
                field[f, 1, j, i] = cx - i
                field[f, 2, j, i] = cy - j
                field[f, 3, j, i] = inv_softplus(0.5)
                field[f, 4, j, i] = inv_softplus(scales_px[f] / stride)
    return field


def paint_caf(field, kp_xyv_px, scales_px, skeleton, stride):
    """Paint raw CAF (E, 9, H, W): cells along each edge segment."""
    _, _, h, w = field.shape
    for e, (a1, a2) in enumerate(skeleton):
        x1, y1, v1 = kp_xyv_px[a1 - 1]
        x2, y2, v2 = kp_xyv_px[a2 - 1]
        if v1 <= 0 or v2 <= 0:
            continue
        c1 = np.array([x1, y1]) / stride
        c2 = np.array([x2, y2]) / stride
        n_steps = max(2, int(np.ceil(np.linalg.norm(c2 - c1))) + 1)
        for t in np.linspace(0.0, 1.0, n_steps):
            p = c1 + t * (c2 - c1)
            i, j = int(round(p[0])), int(round(p[1]))
            if not (0 <= i < w and 0 <= j < h):
                continue
            field[e, 0, j, i] = inv_sigmoid(1.0)
            field[e, 1, j, i] = c1[0] - i
            field[e, 2, j, i] = c1[1] - j
            field[e, 3, j, i] = c2[0] - i
            field[e, 4, j, i] = c2[1] - j
            field[e, 5, j, i] = inv_softplus(0.5)
            field[e, 6, j, i] = inv_softplus(0.5)
            field[e, 7, j, i] = inv_softplus(scales_px[a1 - 1] / stride)
            field[e, 8, j, i] = inv_softplus(scales_px[a2 - 1] / stride)
    return field


# ---------------------------------------------------------------------------
# keypoint families and decode configuration
# ---------------------------------------------------------------------------

def _hflip_perm(keypoints, hflip):
    return np.asarray([keypoints.index(hflip.get(name, name))
                       for name in keypoints], np.int32)


@dataclasses.dataclass
class SceneSpec:
    """Keypoint-family parameters of the harness (COCO-17 or WholeBody)."""

    name: str
    keypoints: Sequence[str]
    sigmas: np.ndarray
    score_weights: np.ndarray
    skeleton: Sequence            # 1-based joint index pairs
    upright_pose: np.ndarray      # (K, 3)
    hflip_perm: Optional[np.ndarray] = None
    image_hw: tuple = IMAGE_HW
    grid_hw: tuple = GRID_HW
    # person pixel-scale range: wholebody needs larger figures so the
    # face/hand keypoint clusters resolve to distinct feature cells
    scale_range: tuple = (8.0, 22.0)

    @property
    def n_keypoints(self):
        return len(self.keypoints)


COCO_SPEC = SceneSpec(
    name='coco',
    keypoints=constants.COCO_KEYPOINTS,
    sigmas=SIGMAS,
    score_weights=SCORE_WEIGHTS,
    skeleton=constants.COCO_PERSON_SKELETON,
    upright_pose=constants.COCO_UPRIGHT_POSE,
    hflip_perm=_hflip_perm(constants.COCO_KEYPOINTS, constants.HFLIP),
)


def wholebody_spec() -> SceneSpec:
    """133 keypoints / 129 edges — the deep-limb-chain budget stress."""
    from .plugins.wholebody import constants as wb

    return SceneSpec(
        name='wholebody',
        keypoints=list(wb.KEYPOINTS),
        sigmas=np.asarray(wb.SIGMAS, np.float32),
        score_weights=np.ones(len(wb.KEYPOINTS), np.float32),
        skeleton=wb.SKELETON,
        upright_pose=np.asarray(wb.UPRIGHT_POSE, np.float32),
        hflip_perm=_hflip_perm(list(wb.KEYPOINTS), wb.HFLIP),
        scale_range=(28.0, 64.0),
    )


def metas_for(spec: SceneSpec):
    cif_meta = headmeta.Cif(
        'cif', spec.name, keypoints=list(spec.keypoints),
        sigmas=list(np.asarray(spec.sigmas, np.float32)),
        score_weights=list(np.asarray(spec.score_weights, np.float32)))
    caf_meta = headmeta.Caf(
        'caf', spec.name, keypoints=list(spec.keypoints),
        sigmas=list(np.asarray(spec.sigmas, np.float32)),
        skeleton=spec.skeleton)
    return cif_meta, caf_meta


def build_fields(poses_and_scales, h=GRID_HW[0], w=GRID_HW[1], stride=16,
                 spec: SceneSpec = COCO_SPEC):
    """Paint raw CIF/CAF fields for any keypoint family."""
    cif = np.zeros((spec.n_keypoints, 5, h, w), np.float32)
    caf = np.zeros((len(spec.skeleton), 9, h, w), np.float32)
    cif[:, 0] = -10.0
    caf[:, 0] = -10.0
    for kp, scales in poses_and_scales:
        paint_cif(cif, kp, scales, stride)
        paint_caf(caf, kp, scales, spec.skeleton, stride)
    return cif, caf


def harness_config(max_poses: int = 128, *, image_hw=IMAGE_HW,
                   max_seeds: int = 1024, max_candidates: int = 512,
                   **growth_updates) -> pipeline.CifCafConfig:
    """Production defaults with budgets raised so static-budget overflow
    (which hits both paths alike) does not mask scheduling drift at
    60-pose density.  With force_complete the second pass gets its own
    relaxed candidate set with a doubled budget, as the production decoder
    (``decoder/cifcaf.py``: score_th 0.001, 2x max_candidates).

    ``max_poses`` binds asymmetrically under field noise: duplicate seeds
    occupy parallel pose slots before the seed-claim suppression removes
    them, while the sequential oracle skips occupied seeds and spends its
    budget on fresh ones, so noisy dense scenes need a larger budget
    (``drift_report --noise``: 256) for the comparison to measure
    scheduling rather than slot exhaustion (``n_dropped_poses`` counts
    that overflow in production)."""
    config = pipeline.CifCafConfig(stride=16, image_hw=image_hw)
    growth_config = dataclasses.replace(config.growth, max_poses=max_poses,
                                        **growth_updates)
    caf_fc = None
    if growth_config.force_complete:
        caf_fc = dataclasses.replace(
            config.caf, score_th=growth_config.force_complete_threshold,
            max_candidates=2 * max_candidates)
    return dataclasses.replace(
        config,
        seeds=dataclasses.replace(config.seeds, max_seeds=max_seeds),
        caf=dataclasses.replace(config.caf, max_candidates=max_candidates),
        caf_fc=caf_fc,
        growth=growth_config,
    )


# ---------------------------------------------------------------------------
# scene generation
# ---------------------------------------------------------------------------

def random_scene(rng: np.random.Generator, n_poses: int,
                 spec: SceneSpec = COCO_SPEC):
    """n_poses clustered, scale-varied, partially occluded upright poses.

    Returns a list of (kp (K,3) px, scales (K,) px) painting inputs.
    Clustering forces overlap (the occupancy-order regime); random hflip
    and per-joint jitter vary the geometry.
    """
    h, w = spec.image_hw
    n_kp = spec.n_keypoints
    pose_y_top = float(spec.upright_pose[:, 1].max())
    pose_y_half = (pose_y_top - float(spec.upright_pose[:, 1].min())) / 2.0
    n_clusters = max(1, int(np.ceil(n_poses / 6)))
    clusters = rng.uniform(150, min(h, w) - 150, size=(n_clusters, 2))
    poses = []
    for _ in range(n_poses):
        scale = float(rng.uniform(*spec.scale_range))
        cx, cy = clusters[int(rng.integers(n_clusters))]
        cx += float(rng.normal(0, 70.0))
        cy += float(rng.normal(0, 70.0))

        unit = np.asarray(spec.upright_pose, np.float32).copy()
        if spec.hflip_perm is not None and rng.uniform() < 0.5:
            unit = unit[spec.hflip_perm]
            unit[:, 0] = -unit[:, 0]
        kp = np.zeros((n_kp, 3), np.float32)
        kp[:, 0] = unit[:, 0] * scale + cx
        kp[:, 1] = (pose_y_top - unit[:, 1]) * scale + cy \
            - pose_y_half * scale
        kp[:, :2] += rng.normal(0, 0.06 * scale, size=(n_kp, 2))
        kp[:, 0] = np.clip(kp[:, 0], 8.0, w - 9.0)
        kp[:, 1] = np.clip(kp[:, 1], 8.0, h - 9.0)
        kp[:, 2] = 2.0

        # partial occlusion: drop a random subset of joints
        if rng.uniform() < 0.4:
            n_drop = int(rng.integers(3, max(4, (n_kp * 10) // 17)))
            drop = rng.choice(n_kp, size=n_drop, replace=False)
            kp[drop, 2] = 0.0

        scales = np.maximum(4.0, np.asarray(spec.sigmas, np.float32)
                            * scale * 4)
        poses.append((kp, scales))
    return poses


# ---------------------------------------------------------------------------
# field-level realism noise: trained fields are noisy, with near-threshold
# seeds and spurious activations, the regime where occupancy-order
# scheduling bites
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FieldNoise:
    """Perturbations applied to the raw painted fields.  Both decode paths
    take the same noisy front end, so the drift stays pure scheduling."""

    conf_logit_sigma: float = 0.7      # per-cell confidence jitter (logits)
    peak_conf_range: tuple = (0.25, 1.0)   # per-joint peak confidence
    offset_sigma: float = 0.15         # regression noise, feature-cell units
    scale_lognorm_sigma: float = 0.25  # joint-scale multiplicative noise
    spurious_blobs: int = 40           # fake CIF activations per scene
    spurious_conf: tuple = (0.15, 0.6)     # their confidence range
    spurious_caf: int = 40             # fake CAF cells per scene


# the WholeBody noise of ``drift_report --spec wholebody --noise``: the
# default magnitudes sever the deep face/hand chains entirely (both
# decoders agree on zero poses); milder noise keeps the scenes decodable
WHOLEBODY_NOISE = FieldNoise(conf_logit_sigma=0.35,
                             peak_conf_range=(0.6, 1.0), offset_sigma=0.08,
                             spurious_blobs=60, spurious_caf=60)


def apply_field_noise(cif: np.ndarray, caf: np.ndarray,
                      rng: np.random.Generator, noise: FieldNoise):
    """In-place perturbation of raw (pre-activation) painted fields."""
    h, w = cif.shape[-2:]
    painted_cif = cif[:, 0] > -5.0
    painted_caf = caf[:, 0] > -5.0

    # per-joint peak confidence attenuation -> near-threshold seeds
    lo, hi = noise.peak_conf_range
    atten = inv_sigmoid(rng.uniform(lo, hi, size=cif.shape[0]))
    atten = np.minimum(0.0, atten - inv_sigmoid(0.999))
    cif[:, 0] += np.where(painted_cif, atten[:, None, None], 0.0)

    # confidence jitter (painted cells only; the background stays far
    # below threshold by construction)
    cif[:, 0] += np.where(
        painted_cif, rng.normal(0.0, noise.conf_logit_sigma, painted_cif.shape),
        0.0)
    caf[:, 0] += np.where(
        painted_caf, rng.normal(0.0, noise.conf_logit_sigma, painted_caf.shape),
        0.0)

    # offset regression noise (feature-cell units)
    for ch in (1, 2):
        cif[:, ch] += np.where(
            painted_cif, rng.normal(0.0, noise.offset_sigma, painted_cif.shape),
            0.0)
    for ch in (1, 2, 3, 4):
        caf[:, ch] += np.where(
            painted_caf, rng.normal(0.0, noise.offset_sigma, painted_caf.shape),
            0.0)

    # joint-scale multiplicative noise (decode softplus, scale, re-encode)
    sc = np.log1p(np.exp(np.minimum(cif[:, 4], 30.0)))
    sc = sc * np.exp(rng.normal(0.0, noise.scale_lognorm_sigma, sc.shape))
    cif[:, 4] = np.where(painted_cif, inv_softplus(sc), cif[:, 4])

    # spurious CIF blobs: plausible-looking fake activations
    for _ in range(noise.spurious_blobs):
        f = int(rng.integers(cif.shape[0]))
        i, j = int(rng.integers(w)), int(rng.integers(h))
        conf = float(rng.uniform(*noise.spurious_conf))
        cif[f, 0, j, i] = inv_sigmoid(conf)
        cif[f, 1, j, i] = float(rng.uniform(-0.5, 0.5))
        cif[f, 2, j, i] = float(rng.uniform(-0.5, 0.5))
        cif[f, 3, j, i] = inv_softplus(0.5)
        cif[f, 4, j, i] = inv_softplus(float(rng.uniform(0.3, 1.5)))

    # spurious CAF cells: fake association evidence
    for _ in range(noise.spurious_caf):
        e = int(rng.integers(caf.shape[0]))
        i, j = int(rng.integers(w)), int(rng.integers(h))
        conf = float(rng.uniform(*noise.spurious_conf))
        caf[e, 0, j, i] = inv_sigmoid(conf)
        for ch in (1, 2, 3, 4):
            caf[e, ch, j, i] = float(rng.uniform(-3.0, 3.0))
        caf[e, 5, j, i] = caf[e, 6, j, i] = inv_softplus(0.5)
        caf[e, 7, j, i] = caf[e, 8, j, i] = inv_softplus(
            float(rng.uniform(0.3, 1.5)))
    return cif, caf


# ---------------------------------------------------------------------------
# decode paths
# ---------------------------------------------------------------------------

def image_slice(named_tuple, i: int):
    """Image ``i`` of a batched ``Seeds`` or ``CafCandidates`` (views)."""
    if named_tuple is None:
        return None
    return type(named_tuple)(*[t[i] for t in named_tuple])


def oracle_poses(fe: pipeline.FrontEnd, i: int, *, skeleton, n_keypoints,
                 config: pipeline.CifCafConfig) -> List[np.ndarray]:
    """The sequential oracle's poses of image ``i`` of a front end."""
    cands_fc = fe.cands_fc
    return sequential_oracle.decode_sequential(
        image_slice(fe.sds, i), image_slice(fe.cands, i), skeleton,
        n_keypoints=n_keypoints, image_hw=config.image_hw,
        config=config.growth, force_cand=image_slice(cands_fc, i))


def pack_oracle_poses(per_image: Sequence[List[np.ndarray]], *,
                      max_poses: int, n_keypoints: int):
    """The oracle's pose lists as (B, P, K, 4) poses, (B, P, K) placed and
    (B, P) valid arrays for ``finalize_poses``."""
    b = len(per_image)
    poses = np.zeros((b, max_poses, n_keypoints, 4), np.float32)
    placed = np.zeros((b, max_poses, n_keypoints), bool)
    valid = np.zeros((b, max_poses), bool)
    for i, pose_list in enumerate(per_image):
        for p, pose in enumerate(pose_list[:max_poses]):
            poses[i, p] = pose
            placed[i, p] = pose[:, 2] > 0
            valid[i, p] = True
    return poses, placed, valid


def extract_batch(xyv, scores, valid) -> list:
    """Per image the score-descending list of (xyv (K, 3), score), from
    host arrays (B, P, K, 3), (B, P), (B, P)."""
    return [_extract(xyv[i], scores[i], valid[i]) for i in range(len(valid))]


class Harness:
    """Front end on the device (K1 there), production back end, oracle,
    finalize.  ``device``: ``None`` is the card (raising without CUDA);
    the tests pass ``'cpu'``.

    ``seconds`` and ``oracle_syncs`` accumulate over every decode: the
    decode of both paths with the read-backs, the oracle alone, the
    scenes decoded, and the host syncs of the oracle's read-backs."""

    def __init__(self, config: pipeline.CifCafConfig = None,
                 spec: SceneSpec = COCO_SPEC, *, device=None):
        self.device = resolve_device(device)
        self.spec = spec
        self.config = config or harness_config(image_hw=spec.image_hw)
        self.cif_meta, self.caf_meta = metas_for(spec)
        self.skeleton = np.asarray(self.caf_meta.skeleton, np.int32) - 1
        self.n_keypoints = spec.n_keypoints
        self.score_weights = np.asarray(spec.score_weights, np.float32)
        self.seconds = {'decode': 0.0, 'oracle': 0.0}
        self.scenes = 0
        self.oracle_syncs = 0

    @torch.no_grad()
    def decode_fields(self, fields):
        """[(cif (K,5,H,W), caf (E,9,H,W)), ...] raw fields of a batch of
        scenes -> per scene (parallel poses, oracle poses), each a
        score-descending list of (xyv (K,3), score): the JAX harness's
        ``decode_both``, over a batch."""
        start = time.perf_counter()
        cif = torch.as_tensor(np.stack([c for c, _ in fields]),
                              device=self.device)
        caf = torch.as_tensor(np.stack([c for _, c in fields]),
                              device=self.device)
        cfg = self.config
        fe = pipeline.decode_front_end(cif, caf, cif_meta=self.cif_meta,
                                       caf_meta=self.caf_meta, config=cfg)
        out = pipeline.decode_back_end(fe, cif_meta=self.cif_meta,
                                       caf_meta=self.caf_meta, config=cfg)
        parallel = extract_batch(*(read_back(t) for t in
                                   (out.xyv, out.scores, out.valid)))

        oracle_start, syncs = time.perf_counter(), common.HOST_SYNCS
        per_image = [oracle_poses(fe, i, skeleton=self.skeleton,
                                  n_keypoints=self.n_keypoints, config=cfg)
                     for i in range(len(fields))]
        self.oracle_syncs += common.HOST_SYNCS - syncs
        self.seconds['oracle'] += time.perf_counter() - oracle_start
        poses, placed, valid = (
            torch.as_tensor(a, device=self.device)
            for a in pack_oracle_poses(per_image, max_poses=cfg.growth.max_poses,
                                       n_keypoints=self.n_keypoints))
        o_poses, _, o_scores, o_valid = pipeline.finalize_poses(
            poses, placed, valid, fe.scale_px,
            score_weights=self.score_weights, config=cfg)
        oracle = extract_batch(read_back(o_poses[..., :3]),
                               read_back(o_scores), read_back(o_valid))
        self.seconds['decode'] += time.perf_counter() - start
        self.scenes += len(fields)
        return list(zip(parallel, oracle))

    def scene_fields(self, scene, noise: FieldNoise = None,
                     noise_rng: np.random.Generator = None):
        """The raw (cif, caf) fields of ``scene``, with ``noise`` drawn
        from ``noise_rng`` (default ``default_rng(0)``)."""
        cif, caf = build_fields(scene, h=self.spec.grid_hw[0],
                                w=self.spec.grid_hw[1], spec=self.spec)
        if noise is not None:
            apply_field_noise(cif, caf, noise_rng or np.random.default_rng(0),
                              noise)
        return cif, caf


def _extract(poses, scores, valid):
    out = [(poses[i, :, :3], float(scores[i]))
           for i in range(len(valid)) if valid[i]]
    out.sort(key=lambda t: -t[1])
    return out


# ---------------------------------------------------------------------------
# agreement metrics
# ---------------------------------------------------------------------------

def oks(ref_xyv, other_xyv, sigmas: np.ndarray = SIGMAS):
    """OKS of ``other`` against ``ref`` (visible-in-ref joints)."""
    vis = ref_xyv[:, 2] > 0
    if vis.sum() == 0:
        return 0.0
    x, y = ref_xyv[vis, 0], ref_xyv[vis, 1]
    area = max(float((x.max() - x.min()) * (y.max() - y.min())), 1.0)
    d2 = ((ref_xyv[:, :2] - other_xyv[:, :2]) ** 2).sum(-1)
    e = d2 / (2.0 * area * (2.0 * sigmas) ** 2)
    return float(np.exp(-e)[vis].mean())


def scene_agreement(parallel, oracle, *, oks_match: float = 0.5,
                    sigmas: np.ndarray = SIGMAS):
    """Greedy OKS matching (oracle score order); per-scene metrics dict."""
    used = set()
    matched = []
    for o_xyv, o_score in oracle:
        best, best_oks = None, oks_match
        for pi, (p_xyv, _) in enumerate(parallel):
            if pi in used:
                continue
            v = oks(o_xyv, p_xyv, sigmas)
            if v > best_oks:
                best, best_oks = pi, v
        if best is not None:
            used.add(best)
            matched.append((o_xyv, o_score, *parallel[best], best_oks))

    n_o, n_p, n_m = len(oracle), len(parallel), len(matched)
    f1 = 2.0 * n_m / (n_o + n_p) if (n_o + n_p) else 1.0
    if matched:
        mean_oks = float(np.mean([m[4] for m in matched]))
        score_delta = float(np.mean([abs(m[1] - m[3]) for m in matched]))
        joint_agree = float(np.mean([
            ((m[0][:, 2] > 0) == (m[2][:, 2] > 0)).mean() for m in matched]))
    else:
        mean_oks = score_delta = joint_agree = float('nan')
    return {
        'n_oracle': n_o, 'n_parallel': n_p, 'n_matched': n_m, 'f1': f1,
        'mean_oks': mean_oks, 'score_delta': score_delta,
        'joint_agreement': joint_agree,
    }


def run_scenes(harness: Harness, seeds_and_densities,
               noise: FieldNoise = None, *, batch_size: int = 1):
    """[(seed, n_poses), ...] -> list of per-scene metrics dicts.  The
    scenes are decoded ``batch_size`` at a time."""
    results = []
    sigmas = np.asarray(harness.spec.sigmas, np.float32)
    jobs = list(seeds_and_densities)
    for first in range(0, len(jobs), batch_size):
        batch = jobs[first:first + batch_size]
        fields = []
        for seed, n_poses in batch:
            rng = np.random.default_rng(seed)
            scene = random_scene(rng, n_poses, spec=harness.spec)
            fields.append(harness.scene_fields(scene, noise, noise_rng=rng))
        for (seed, n_poses), (parallel, oracle) in zip(
                batch, harness.decode_fields(fields)):
            m = scene_agreement(parallel, oracle, sigmas=sigmas)
            m['seed'] = seed
            m['n_poses'] = n_poses
            results.append(m)
    return results


def aggregate(results):
    """Micro-averaged detection agreement + means of per-scene metrics."""
    n_o = sum(r['n_oracle'] for r in results)
    n_p = sum(r['n_parallel'] for r in results)
    n_m = sum(r['n_matched'] for r in results)
    vals = {k: [r[k] for r in results if np.isfinite(r[k])]
            for k in ('mean_oks', 'score_delta', 'joint_agreement')}
    return {
        'n_scenes': len(results),
        'n_oracle': n_o, 'n_parallel': n_p, 'n_matched': n_m,
        'detection_f1': 2.0 * n_m / (n_o + n_p) if (n_o + n_p) else 1.0,
        'mean_oks': float(np.mean(vals['mean_oks'])),
        'mean_score_delta': float(np.mean(vals['score_delta'])),
        'mean_joint_agreement': float(np.mean(vals['joint_agreement'])),
    }
