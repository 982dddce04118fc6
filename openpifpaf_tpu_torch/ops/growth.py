"""Pose growth: data-parallel frontier relaxation with wave recycling.

Port of ``openpifpaf_tpu/ops/growth.py``.  Reference parity:
``src/openpifpaf/csrc/src/decoder/cifcaf.cpp`` ``_grow()`` (``:~220``):
repeatedly pop the best frontier connection (placed joint -> missing
neighbour), find the best CAF association near the placed joint
(Gaussian-weighted, top-two blend, reverse-match confirmation), place the
joint if above threshold.  All poses grow at once; each round every pose
places its single best frontier joint (one priority-queue pop per pose).

The JAX ``while_loop``s (``growth.py:482, 630``) run as batched Python
loops (``common.while_loop``) that stop at the same convergence test or
cap, and under ``torch.export`` as its traced form (the waves' loop with
``grow``'s nested in its body).  Ties keep JAX's order: ``argmax`` returns the first maximum and every
``argsort`` is stable.  Scatters write index sets without duplicates, or
spill into a pad column that is never read, as the JAX version does.

Every option of the JAX ``GrowthConfig`` is here: ``force_complete`` (the
relaxed second pass of each wave, ``growth.py:460-497``, on its own
candidate set), ``placements_per_round`` (the top-m frontier joints per
round, ``growth.py:387-451``) and ``seed_dedup`` (``compact_seeds``,
``growth.py:500-533``); ``init_poses`` is the legacy single-wave
initialiser, which always dedups.  The second pass is a second host loop,
so it adds host syncs (``common.HOST_SYNCS``) to every wave.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import nms as nms_mod
from .caf_scored import CafCandidates
from .common import while_loop
from .seeds import Seeds


@dataclasses.dataclass(frozen=True)
class GrowthConfig:
    keypoint_threshold: float = 0.15
    keypoint_threshold_rel: float = 0.5   # relative to the source joint v
    filter_factor: float = 2.0            # candidate filter radius = f * sigma
    gauss_denom: float = 0.25             # w = exp(-0.5 d2 / (gd * sigma^2))
    blend_min: float = 0.01               # second candidate min score to blend
    min_xy_scale: float = 2.0             # floor for sigma, px
    reverse_match: bool = True
    connection_blend: bool = True         # --connection-method=blend|max
    max_poses: int = 96
    seed_dedup_radius: float = 4.0        # px floor for seed suppression
    seed_dedup_scale: float = 0.5         # radius = max(floor, f * seed scale)
    force_complete: bool = False          # relaxed second pass
    force_complete_threshold: float = 0.001
    # joints placed per pose per round: 1 is the reference's priority-queue
    # pop; m > 1 places the top-m frontier joints at once, whose new
    # out-edges the same round does not see (a scheduling relaxation)
    placements_per_round: int = 1
    max_waves: int = 8
    # radius dedup of seeds against stronger seeds of the same field before
    # the waves (off: the oracle's semantics; ``init_poses`` always dedups)
    seed_dedup: bool = False


class DirectedEdges(NamedTuple):
    """Static directed-edge tables derived from a skeleton. Q = 2E."""

    src_kp: np.ndarray   # (Q,) keypoint index of the placed (source) end
    tgt_kp: np.ndarray   # (Q,) keypoint index of the missing (target) end
    edge: np.ndarray     # (Q,) edge index e
    direction: np.ndarray  # (Q,) 0 = walk 1->2, 1 = walk 2->1


def directed_edges(skeleton: np.ndarray) -> DirectedEdges:
    """skeleton: (E, 2) 0-based.  Directed index q = 2*e + d (the reverse
    of q is q ^ 1)."""
    skeleton = np.asarray(skeleton, dtype=np.int64)
    e = skeleton.shape[0]
    src = np.empty(2 * e, np.int64)
    tgt = np.empty(2 * e, np.int64)
    src[0::2], tgt[0::2] = skeleton[:, 0], skeleton[:, 1]
    src[1::2], tgt[1::2] = skeleton[:, 1], skeleton[:, 0]
    return DirectedEdges(src, tgt, np.repeat(np.arange(e), 2),
                         np.tile(np.array([0, 1]), e))


def _seed_keep(seeds: Seeds, config: GrowthConfig) -> torch.Tensor:
    """(B, S) valid seeds without a stronger valid seed of the same field
    within the dedup radius ``max(seed_dedup_radius, seed_dedup_scale *
    s)`` of either seed.  Seeds are sorted descending by value, so seed j
    is stronger than seed i when j < i."""
    s = seeds.v.shape[1]
    r = torch.clamp(config.seed_dedup_scale * seeds.s,
                    min=config.seed_dedup_radius)
    dx = seeds.x[:, None, :] - seeds.x[:, :, None]
    dy = seeds.y[:, None, :] - seeds.y[:, :, None]
    d2 = dx * dx + dy * dy
    same_field = seeds.f[:, None, :] == seeds.f[:, :, None]
    rank = torch.arange(s, device=seeds.v.device)
    stronger = rank[None, :] < rank[:, None]
    rr = torch.maximum(r[:, None, :], r[:, :, None])
    suppressed = (same_field & stronger & (d2 < rr * rr)
                  & seeds.valid[:, None, :]).any(dim=2)
    return seeds.valid & ~suppressed


def _kept_first(keep: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, S) order that puts the kept seeds first, descending by value
    (a stable sort, as ``jnp.argsort``)."""
    return torch.argsort(torch.where(keep, -v, float('inf')), dim=1,
                         stable=True)


def init_poses(seeds: Seeds, *, n_keypoints: int, config: GrowthConfig):
    """Seed dedup + pose initialization: the legacy single-wave path.

    A seed is dropped when a stronger seed of the same field lies within
    its dedup radius; the kept seeds fill the ``max_poses`` slots in
    descending value.  Returns (poses (B,P,K,4) [x,y,v,scale], placed
    (B,P,K), pose_valid (B,P), seed_v (B,P), n_dropped (B,) — kept seeds
    beyond the budget — and seed_f (B,P), each slot's seed field, K where
    the slot is empty).  Needs at least ``max_poses`` seed slots, as the
    JAX version does.
    """
    b = seeds.v.shape[0]
    p, k = config.max_poses, n_keypoints
    dev = seeds.v.device
    keep = _seed_keep(seeds, config)
    order = _kept_first(keep, seeds.v)[:, :p]
    sel_valid = torch.gather(keep, 1, order)
    f = torch.gather(seeds.f, 1, order)
    values = torch.stack([torch.where(sel_valid, torch.gather(a, 1, order),
                                      0.0)
                          for a in (seeds.x, seeds.y, seeds.v, seeds.s)],
                         dim=-1)                                  # (B, P, 4)
    bi = torch.arange(b, device=dev)[:, None]
    rows = torch.arange(p, device=dev)[None, :]
    poses = torch.zeros(b, p, k, 4, device=dev)
    poses[bi, rows, f] = values
    placed = torch.zeros(b, p, k, dtype=torch.bool, device=dev)
    placed[bi, rows, f] = sel_valid
    n_dropped = torch.clamp(keep.sum(dim=1) - sel_valid.sum(dim=1),
                            min=0).int()
    return (poses, placed, sel_valid, values[..., 2], n_dropped,
            torch.where(sel_valid, f, k))


def compact_seeds(seeds: Seeds, config: GrowthConfig):
    """The seed list the waves consume, in rank order: ``(x, y, v, s, f,
    valid)``, each (B, S).  With ``config.seed_dedup`` the seeds that
    ``init_poses`` would drop are invalid and the kept ones move to the
    front, still descending by value."""
    if not config.seed_dedup:
        return (seeds.x, seeds.y, torch.where(seeds.valid, seeds.v, 0.0),
                seeds.s, seeds.f, seeds.valid)
    keep = _seed_keep(seeds, config)
    order = _kept_first(keep, seeds.v)
    x, y, v, s, f, kept = (torch.gather(a, 1, order) for a in (
        seeds.x, seeds.y, seeds.v, seeds.s, seeds.f, keep))
    return x, y, torch.where(kept, v, 0.0), s, f, kept


def _edge_table(ends: np.ndarray, n_keypoints: int) -> np.ndarray:
    """(K, D) directed-edge ids whose ``ends`` entry is k, ascending q per
    row, padded with Q (D = max degree)."""
    q_n = ends.shape[0]
    rows = [[q for q in range(q_n) if ends[q] == k]
            for k in range(n_keypoints)]
    d = max(1, max(len(r) for r in rows))
    table = np.full((n_keypoints, d), q_n, np.int64)
    for k, r in enumerate(rows):
        table[k, :len(r)] = r
    return table


def out_edges_table(edges: DirectedEdges, n_keypoints: int) -> np.ndarray:
    return _edge_table(edges.src_kp, n_keypoints)


def in_edges_table(edges: DirectedEdges, n_keypoints: int) -> np.ndarray:
    return _edge_table(edges.tgt_kp, n_keypoints)


class EdgeTables(NamedTuple):
    """The static edge tables as device tensors, and their sizes as Python
    ints: inside a traced loop the state's sizes are symbolic, and an outer
    loop's symbol cannot be captured by an inner loop, so the loops read
    K and Q from here."""

    src: torch.Tensor        # (Q,)
    tgt: torch.Tensor        # (Q,)
    out_edges: torch.Tensor  # (K, D), pad = Q
    in_edges: torch.Tensor   # (K, Din), pad = Q
    n_keypoints: int         # K
    n_edges: int             # Q, directed


def edge_tables(edges: DirectedEdges, n_keypoints: int,
                device) -> EdgeTables:
    def t(a):
        return torch.as_tensor(a, dtype=torch.int64, device=device)
    return EdgeTables(t(edges.src_kp), t(edges.tgt_kp),
                      t(out_edges_table(edges, n_keypoints)),
                      t(in_edges_table(edges, n_keypoints)), n_keypoints,
                      len(edges.src_kp))


def dirviews(cand: CafCandidates, edges: DirectedEdges):
    """Directed candidate tensors (score, x_src, y_src, x_tgt, y_tgt,
    s_tgt, valid), each (B, Q, C)."""
    e_idx = torch.as_tensor(edges.edge, device=cand.score.device)
    d_idx = torch.as_tensor(edges.direction, device=cand.score.device)
    return tuple(a[:, e_idx, d_idx] for a in (
        cand.score, cand.x_src, cand.y_src, cand.x_tgt, cand.y_tgt,
        cand.s_tgt, cand.valid))


def _take(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``a[..., i]`` per leading index: gather one entry of the last axis."""
    return torch.gather(a, -1, i[..., None])[..., 0]


def _weighted_best(qx, qy, sigma, cxs, cys, cxt, cyt, cst, cvalid, cscore,
                   config: GrowthConfig, blend: bool):
    """Gaussian-filtered best (and optional top-2 blend) association.

    qx, qy, sigma: (...,) query source position/scale; c*: (..., C)
    candidate geometry/scores.  Returns value, tx, ty, ts (all (...,)).
    """
    dx = cxs - qx[..., None]
    dy = cys - qy[..., None]
    d2 = dx * dx + dy * dy
    sig2 = (sigma * sigma)[..., None]
    # in range, the exponent is >= -0.5 ff^2 / gd; the floor below that
    # changes only values the mask zeroes, and spares the CPU's exp its
    # slow path for large negative arguments
    floor = -0.5 * config.filter_factor ** 2 / config.gauss_denom - 1.0
    w = torch.exp(torch.clamp(-0.5 * d2 / (config.gauss_denom * sig2),
                              min=floor))
    in_range = d2 <= (config.filter_factor ** 2) * sig2
    cs = torch.where(in_range & cvalid, w * cscore, 0.0)

    i1 = torch.argmax(cs, dim=-1)               # first maximum, as JAX
    v1, t1x, t1y, t1s = (_take(a, i1) for a in (cs, cxt, cyt, cst))
    if not blend:
        return v1, t1x, t1y, t1s

    c_range = torch.arange(cs.shape[-1], device=cs.device)
    cs2 = torch.where(c_range == i1[..., None], 0.0, cs)
    i2 = torch.argmax(cs2, dim=-1)
    v2, t2x, t2y, t2s = (_take(a, i2) for a in (cs2, cxt, cyt, cst))

    ddx = t2x - t1x
    ddy = t2y - t1y
    dt2 = ddx * ddx + ddy * ddy
    blendable = (v2 > config.blend_min) & (dt2 <= t1s * t1s)
    wsum = torch.clamp(v1 + v2, min=1e-8)
    bx = (v1 * t1x + v2 * t2x) / wsum
    by = (v1 * t1y + v2 * t2y) / wsum
    bs = (v1 * t1s + v2 * t2s) / wsum
    tx = torch.where(blendable, bx, t1x)
    ty = torch.where(blendable, by, t1y)
    ts = torch.where(blendable, bs, t1s)
    value = torch.where(blendable, 0.5 * (v1 + v2), v1)
    return value, tx, ty, ts


def _connection_values_at(poses, placed, pose_valid, dv, et: EdgeTables,
                          config: GrowthConfig, reverse_match: bool, q_sel,
                          q_valid):
    """Best association per (pose, directed edge ``q_sel``).

    q_sel, q_valid: (B, P, D) — the out-edges of the joint each pose placed
    last round (padded entries masked).  Returns value, target x/y/scale
    and new joint score, each (B, P, D).  Mirrors
    ``grow_connection_blend`` + reverse match (``cifcaf.cpp:~220..~330``).
    """
    q_n = et.n_edges
    c_score, c_xs, c_ys, c_xt, c_yt, c_st, c_valid = dv
    q_safe = torch.clamp(q_sel, max=q_n - 1)   # clamp the pad sentinel
    bi = torch.arange(q_sel.shape[0], device=q_sel.device)[:, None, None]

    def sel(a, q):
        return a[bi, q]                         # (B, P, D, C)

    src = et.src[q_safe]
    tgt = et.tgt[q_safe]
    xs = torch.gather(poses[..., 0], 2, src)
    ys = torch.gather(poses[..., 1], 2, src)
    vs = torch.gather(poses[..., 2], 2, src)
    ss = torch.clamp(torch.gather(poses[..., 3], 2, src),
                     min=config.min_xy_scale)
    active = (torch.gather(placed, 2, src) & ~torch.gather(placed, 2, tgt)
              & pose_valid[..., None] & q_valid)

    value, tx, ty, ts = _weighted_best(
        xs, ys, ss, sel(c_xs, q_safe), sel(c_ys, q_safe), sel(c_xt, q_safe),
        sel(c_yt, q_safe), sel(c_st, q_safe), sel(c_valid, q_safe),
        sel(c_score, q_safe), config, config.connection_blend)

    if reverse_match:
        # walk back from the found target along the reversed edge (q ^ 1)
        # and require landing near the source joint
        rev = torch.clamp(q_safe ^ 1, max=q_n - 1)
        sig_t = torch.clamp(ts, min=config.min_xy_scale)
        rv, rx, ry, _ = _weighted_best(
            tx, ty, sig_t, sel(c_xs, rev), sel(c_ys, rev), sel(c_xt, rev),
            sel(c_yt, rev), sel(c_st, rev), sel(c_valid, rev),
            sel(c_score, rev), config, blend=False)
        bx = rx - xs
        by = ry - ys
        back2 = bx * bx + by * by
        ok = (rv > 0.0) & (back2 <= (config.filter_factor ** 2) * ss * ss)
        value = torch.where(ok, value, 0.0)

    value = torch.where(active, value, 0.0)
    new_v = torch.sqrt(value * vs)
    return value, tx, ty, ts, new_v


def _connection_values(poses, placed, pose_valid, dv, et: EdgeTables,
                       config: GrowthConfig, reverse_match: bool):
    """Best association per (pose, directed edge), every edge at once:
    ``_connection_values_at`` with all Q edges selected for every pose.
    Returns value, target x/y/scale and new joint score, each (B, P, Q)."""
    q_n = et.n_edges
    q_all = torch.arange(q_n, device=poses.device).expand(
        *pose_valid.shape, q_n)
    return _connection_values_at(poses, placed, pose_valid, dv, et, config,
                                 reverse_match, q_all,
                                 torch.ones_like(q_all, dtype=torch.bool))


def _first_true(mask: torch.Tensor, m: int) -> torch.Tensor:
    """(..., m) indices of the first m True entries of ``mask`` along its
    last axis, ascending, then False ones: ``argsort(~mask, stable)[:m]``."""
    return torch.argsort((~mask).to(torch.uint8), dim=-1,
                         stable=True)[..., :m]


def _top_m(values: torch.Tensor, m: int) -> torch.Tensor:
    """(..., m) indices of the m largest ``values`` along the last axis,
    ties to the lower index first (``jax.lax.top_k``'s order)."""
    return torch.argsort(values, dim=-1, descending=True,
                         stable=True)[..., :m]


def grow(poses: torch.Tensor, placed: torch.Tensor, pose_valid: torch.Tensor,
         dv, et: EdgeTables, config: GrowthConfig, *,
         fresh_onehot: torch.Tensor = None, active: torch.Tensor = None,
         force_dv=None):
    """Frontier relaxation until no pose places a joint, or K-1 rounds.

    poses (B, P, K, 4) [x, y, v, scale]; placed (B, P, K); pose_valid
    (B, P); dv: ``dirviews`` of the candidates; fresh_onehot (B, P, K)
    marks the joints whose out-edge connections the first round computes
    (the newly seeded ones: already-grown poses are at their fixed point;
    default ``placed``, the single-wave start after ``init_poses``).

    A (pose, edge) connection depends only on its source joint, which never
    moves once placed, so it is computed once, in the round after the
    source lands, and cached in (B, P, Q+1) tables (column Q is the pad
    spill).  ``active`` (B,) limits the loops to images still iterating in
    an enclosing loop.

    With ``config.force_complete`` a second pass follows on the grown
    poses: the same rounds with ``force_complete_threshold``, no relative
    gate and no reverse match, on ``force_dv`` (the ``dirviews`` of the
    separately thresholded candidate set; ``dv`` when None).  It starts
    from every connection computed at once (``_connection_values``), as
    the JAX pass does (``growth.py:460-497``), not from the fresh joints.
    """
    b, p = placed.shape[:2]
    k, q_n = et.n_keypoints, et.n_edges
    rows_k = torch.arange(k, device=poses.device)
    m = max(1, config.placements_per_round)

    def make_body(th: float, rel: float, reverse: bool, pass_dv):
        """One relaxation round at threshold ``th``, relative gate ``rel``,
        with or without the reverse match, on candidates ``pass_dv``."""
        def body(state, _):
            poses, placed, rounds_done, _, value, tx, ty, ts, new_v, last = \
                state

            # connections that became computable: the joints placed last
            # round (the first m True of ``last``, as JAX's stable argsort
            # of ~last)
            j_new = _first_true(last, m)                           # (B,P,m)
            new_ok = torch.gather(last, 2, j_new)
            q_sel = et.out_edges[j_new]                         # (B,P,m,D)
            q_ok = ((q_sel < q_n) & new_ok[..., None]).flatten(2)
            q_sel = q_sel.flatten(2)                             # (B,P,mD)
            fresh = _connection_values_at(poses, placed, pose_valid,
                                          pass_dv, et, config, reverse,
                                          q_sel, q_ok)
            q_scatter = torch.where(q_ok, q_sel, q_n)               # pad spill
            value, tx, ty, ts, new_v = (
                t.scatter(2, q_scatter, f) for t, f in
                zip((value, tx, ty, ts, new_v), fresh))

            vs = poses[:, :, et.src, 2]
            act = (placed[:, :, et.src] & ~placed[:, :, et.tgt]
                   & pose_valid[..., None])
            nv = new_v[..., :q_n]
            ok = (nv > th) & (nv > rel * vs) & act
            conn = torch.where(ok, value[..., :q_n], 0.0)            # (B,P,Q)
            conn_kd = F.pad(conn, (0, 1))[:, :, et.in_edges]     # (B,P,K,Din)
            # in-edge rows ascend in q: the first maximum keeps the lowest q
            d_star = torch.argmax(conn_kd, dim=-1)                   # (B,P,K)
            best_v = _take(conn_kd, d_star)
            best_q = et.in_edges[rows_k, d_star]

            # the top-m frontier joints per pose (m = 1: the best one, one
            # priority-queue pop per pose); ties keep the lower joint first,
            # as ``jax.lax.top_k``
            j_star = _top_m(best_v, m)                               # (B,P,m)
            slot_ok = ((torch.gather(best_v, 2, j_star) > 0.0)
                       & pose_valid[..., None])
            j_safe = torch.where(slot_ok, j_star, k)                # pad spill
            bq = torch.gather(best_q, 2, j_star)
            new_data = torch.stack([torch.gather(t, 2, bq)
                                    for t in (tx, ty, new_v, ts)], dim=-1)
            poses = F.pad(poses, (0, 0, 0, 1)).scatter(
                2, j_safe[..., None].expand(-1, -1, -1, 4), new_data)[:, :, :k]
            onehot = F.pad(torch.zeros_like(placed), (0, 1)).scatter(
                2, j_safe, True)[..., :k]
            return (poses, placed | onehot, rounds_done + 1,
                    slot_ok.any(dim=2).any(dim=1), value, tx, ty, ts, new_v,
                    onehot)

        return body

    def cond(state):
        return (state[2] < k - 1) & state[3]

    def run(poses, placed, body, tables, new_onehot):
        state = (poses, placed, torch.zeros(b, dtype=torch.int64,
                                            device=poses.device),
                 torch.ones(b, dtype=torch.bool, device=poses.device),
                 *tables, new_onehot)
        state = while_loop(cond, body, state, active=active)
        return state[0], state[1]

    table = torch.zeros(b, p, q_n + 1, device=poses.device)
    poses, placed = run(
        poses, placed,
        make_body(config.keypoint_threshold, config.keypoint_threshold_rel,
                  config.reverse_match, dv),
        (table,) * 5, placed if fresh_onehot is None else fresh_onehot)
    if config.force_complete:
        fc_dv = dv if force_dv is None else force_dv
        full = _connection_values(poses, placed, pose_valid, fc_dv, et,
                                  config, reverse_match=False)
        poses, placed = run(
            poses, placed,
            make_body(config.force_complete_threshold, 0.0, False, fc_dv),
            tuple(F.pad(t, (0, 1)) for t in full),
            torch.zeros(b, p, k, dtype=torch.bool, device=poses.device))
    return poses, placed


def grow_waves(seeds: Seeds, cand: CafCandidates, edges: DirectedEdges, *,
               n_keypoints: int, image_hw, config: GrowthConfig,
               nms_config: nms_mod.NMSConfig,
               force_cand: CafCandidates = None):
    """Wave-recycled growth: the reference's seed-budget semantics.

    Grow a wave, run the exact seed-claim fixpoint, then refill the freed
    pose slots with the next *unclaimed* seeds in rank order and grow only
    those — claimed seeds never consume ``max_poses`` budget, as in the
    sequential reference (``cifcaf.cpp:~140``).  Stops as soon as a wave
    seeds nothing, or after ``max_waves``.

    ``force_cand``: the force-complete pass's own candidate set (``cand``
    when None), used only with ``config.force_complete``.

    Returns ``(poses, placed, alive, n_dropped, seed_f, seed_rank)``, each
    with a leading batch axis; ``alive`` includes the seed-claim
    suppression, ``n_dropped`` (B,) counts eligible seeds left unconsumed.
    """
    sx, sy, sv, ss, sf, s_valid = compact_seeds(seeds, config)
    # the traced loop (``common.while_loop`` under ``torch.export``) takes
    # no two closed-over tensors that share storage, as the seeds' x, y and
    # s (views of one gathered tensor) do
    sx, sy, ss = (t.clone() for t in (sx, sy, ss))
    b, s = sx.shape
    p = config.max_poses
    k = n_keypoints
    dev = sx.device
    et = edge_tables(edges, k, dev)
    dv = dirviews(cand, edges)
    force_dv = None if force_cand is None else dirviews(force_cand, edges)
    rows_p = torch.arange(p, device=dev)

    def eligibility(poses, placed, alive, consumed):
        claimed = nms_mod.points_claimed(
            poses, placed, alive, sf, sx, sy, image_hw=image_hw,
            config=nms_config)
        return s_valid & ~consumed & ~claimed

    def body(state, running):
        poses, placed, slot_rank, slot_f, slot_valid, alive, consumed, \
            wave, _ = state

        eligible = eligibility(poses, placed, alive, consumed)
        n_free = p - alive.sum(dim=1)
        chosen = eligible & (torch.cumsum(eligible.int(), dim=1)
                             <= n_free[:, None])
        n_new = chosen.sum(dim=1)

        free_slots = torch.argsort(alive.to(torch.uint8), dim=1,
                                   stable=True)                  # free first
        sel = torch.argsort((~chosen).to(torch.uint8), dim=1,
                            stable=True)[:, :p]                  # chosen first
        assign = rows_p[None, :] < n_new[:, None]
        f_sel = torch.clamp(torch.gather(sf, 1, sel), 0, k - 1)

        # every write below is a scatter into a tensor made here: a body of
        # the traced loop may not write into its state or a closure
        seed_rows = torch.zeros_like(poses).scatter(
            2, f_sel[..., None, None].expand(-1, -1, 1, 4), torch.stack(
                [torch.gather(a, 1, sel) for a in (sx, sy, sv, ss)],
                dim=-1)[:, :, None])
        placed_rows = torch.zeros_like(placed).scatter(2, f_sel[..., None],
                                                       True)

        def refill(t, new_rows):
            # ``t.at[free_slots].set(where(assign, new_rows,
            # t[free_slots]))``: free_slots is a permutation
            trailing = (...,) + (None,) * (t.dim() - 2)
            idx = free_slots[trailing].expand_as(t)
            old = torch.gather(t, 1, idx)
            return t.scatter(1, idx, torch.where(assign[trailing], new_rows,
                                                 old))

        poses = refill(poses, seed_rows)
        placed = refill(placed, placed_rows)
        slot_rank = refill(slot_rank, sel)
        slot_f = refill(slot_f, f_sel)
        slot_valid = refill(slot_valid, torch.ones_like(assign))
        consumed = consumed | chosen

        fresh = torch.zeros_like(placed).flatten(1).scatter(
            1, free_slots * k + f_sel, assign).view_as(placed)
        poses, placed = grow(poses, placed, slot_valid, dv, et, config,
                             fresh_onehot=fresh, active=running,
                             force_dv=force_dv)
        alive = nms_mod.seed_claim_suppression(
            poses, placed, slot_valid, slot_f, image_hw=image_hw,
            config=nms_config, rank=slot_rank, active=running)
        return (poses, placed, slot_rank, slot_f, slot_valid, alive,
                consumed, wave + 1, n_new > 0)

    def cond(state):
        return state[8] & (state[7] < config.max_waves)

    long = dict(dtype=torch.int64, device=dev)
    flag = dict(dtype=torch.bool, device=dev)
    init = (torch.zeros(b, p, k, 4, device=dev), torch.zeros(b, p, k, **flag),
            torch.full((b, p), s, **long), torch.full((b, p), k, **long),
            torch.zeros(b, p, **flag), torch.zeros(b, p, **flag),
            torch.zeros(b, s, **flag), torch.zeros(b, **long),
            torch.ones(b, **flag))
    poses, placed, slot_rank, slot_f, _, alive, consumed, _, _ = \
        while_loop(cond, body, init)

    n_dropped = eligibility(poses, placed, alive, consumed).sum(dim=1).int()
    return poses, placed, alive, n_dropped, slot_f, slot_rank
