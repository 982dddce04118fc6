"""Decode primitives of the port against ``openpifpaf_tpu``, op by op.

Inputs come from a numpy seed; the JAX functions are single-image and run
per image (or are ``vmap``-ed), the port's carry the batch axis.  Ties and
rounding are where the frameworks differ by default, so they get cases of
their own: ``lax.top_k``/``jnp.argsort``/``jnp.argmax`` put lower indices
first (the port uses stable sorts and the first maximum), and both
``jnp.round`` and ``torch.round`` round half to even.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from openpifpaf_tpu import headmeta as jax_headmeta
from openpifpaf_tpu.models import heads as jax_heads
from openpifpaf_tpu.ops import caf_scored as jax_caf
from openpifpaf_tpu.ops import common as jax_common
from openpifpaf_tpu.ops import nms as jax_nms
from openpifpaf_tpu.ops import seeds as jax_seeds
from openpifpaf_tpu_torch import headmeta
from openpifpaf_tpu_torch.models import heads
from openpifpaf_tpu_torch.ops import caf_scored, common, nms, seeds
from openpifpaf_tpu_torch.plugins.coco import constants


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_masked_top_k_ties_and_padding():
    rng = np.random.default_rng(0)
    values = rng.integers(0, 4, (3, 40)).astype(np.float32)   # many ties
    mask = rng.uniform(size=(3, 40)) > 0.3
    for k in (7, 40, 50):                                      # 50 > n pads
        wv, wi, wok = (np.asarray(a) for a in
                       jax_common.masked_top_k(values, mask, k))
        gv, gi, gok = (a.numpy() for a in
                       common.masked_top_k(t(values), t(mask), k))
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gok, wok)
        np.testing.assert_array_equal(gi[gok], wi[wok])
        np.testing.assert_array_equal(gi, wi)


def test_stable_argsort_and_argmax_tie_order():
    """The growth loop's ``jnp.argsort(..., stable=True)`` on bool masks and
    ``jnp.argmax`` on tied scores, against the port's forms."""
    rng = np.random.default_rng(1)
    flags = rng.uniform(size=(4, 96)) > 0.5
    want = np.asarray(jnp.argsort(jnp.asarray(flags), axis=1, stable=True))
    got = torch.argsort(t(flags).to(torch.uint8), dim=1, stable=True)
    np.testing.assert_array_equal(got.numpy(), want)
    scores = rng.integers(0, 3, (4, 5, 64)).astype(np.float32)
    np.testing.assert_array_equal(
        torch.argmax(t(scores), dim=-1).numpy(),
        np.asarray(jnp.argmax(scores, axis=-1)))
    # first True as the growth round's ``argsort(~last)[:, :1]``
    last = rng.uniform(size=(4, 96, 17)) > 0.8
    want = np.asarray(jnp.argsort(~jnp.asarray(last), axis=2,
                                  stable=True))[..., 0]
    got = torch.argmax(t(last).to(torch.uint8), dim=2)
    np.testing.assert_array_equal(got.numpy(), want)


def test_round_half_to_even():
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5, 4.5, 1.25],
                 np.float32)
    np.testing.assert_array_equal(torch.round(t(x)).numpy(),
                                  np.asarray(jnp.round(x)))
    assert torch.round(t(x)).numpy().tolist()[:6] == \
        [-2.0, -2.0, -0.0, 0.0, 2.0, 2.0]


def test_gather_field_out_of_range():
    rng = np.random.default_rng(2)
    grids = rng.normal(size=(2, 3, 7, 9)).astype(np.float32)
    f = rng.integers(0, 3, (2, 50))
    x = rng.uniform(-10.0, 30.0, (2, 50)).astype(np.float32)  # spacing 2
    y = rng.uniform(-10.0, 25.0, (2, 50)).astype(np.float32)
    x[:, :4] = [-1e6, 1e6, 16.0, 0.0]                         # clamped reads
    want = np.stack([np.asarray(jax_common.gather_field(
        grids[i], f[i], x[i], y[i], 2.0)) for i in range(2)])
    got = common.gather_field(t(grids), t(f), t(x), t(y), 2.0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    fields = np.array([2, 0, 1])
    want = np.stack([np.asarray(jax_common.gather_field_grouped(
        grids[i], fields, x[i].reshape(3, -1)[:, :16],
        y[i].reshape(3, -1)[:, :16], 2.0)) for i in range(2)]) \
        if False else None
    xg = x[:, :48].reshape(2, 3, 16)
    yg = y[:, :48].reshape(2, 3, 16)
    want = np.stack([np.asarray(jax_common.gather_field_grouped(
        grids[i], fields, xg[i], yg[i], 2.0)) for i in range(2)])
    got = common.gather_field_grouped(t(grids), t(fields), t(xg), t(yg),
                                      2.0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def coco(hm):
    cif = hm.Cif('cif', 'p', keypoints=constants.COCO_KEYPOINTS,
                 sigmas=constants.COCO_PERSON_SIGMAS)
    caf = hm.Caf('caf', 'p', keypoints=constants.COCO_KEYPOINTS,
                 sigmas=constants.COCO_PERSON_SIGMAS,
                 skeleton=constants.COCO_PERSON_SKELETON)
    return cif, caf


def test_split_fields_and_softplus():
    """sigmoid and softplus (+1e-4 on spreads).  ``F.softplus`` returns x
    above 20, ``jax.nn.softplus`` adds log1p(exp(-x)) < 2e-9 there —
    below f32 resolution at that magnitude, so rtol 1e-6 holds."""
    rng = np.random.default_rng(3)
    x = rng.normal(0.0, 8.0, (2, 19, 9, 5, 6)).astype(np.float32)
    x[0, 0, 5:, 0, :3] = [25.0, 40.0, 21.0]
    want = jax_heads.split_fields(jnp.asarray(x), coco(jax_headmeta)[1])
    got = heads.split_fields(t(x), coco(headmeta)[1])
    for name, w, g in zip(want._fields, want, got):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


def random_cif(rng, b=2, f=17, h=9, w=11):
    conf = rng.uniform(0.0, 1.0, (b, f, h, w)).astype(np.float32)
    jj, ii = np.mgrid[0:h, 0:w].astype(np.float32)
    x = ((ii + rng.normal(0, 0.5, (b, f, h, w))) * 16).astype(np.float32)
    y = ((jj + rng.normal(0, 0.5, (b, f, h, w))) * 16).astype(np.float32)
    s = np.abs(rng.normal(20, 8, (b, f, h, w))).astype(np.float32)
    hr = rng.uniform(0.0, 1.0, (b, f, 65, 81)).astype(np.float32)
    return conf, x, y, s, hr


def test_seeds_select():
    rng = np.random.default_rng(4)
    conf, x, y, s, hr = random_cif(rng)
    for config in (dict(), dict(max_seeds=40)):
        want = [jax_seeds.select(conf[i], x[i], y[i], s[i], hr[i],
                                 hr_spacing=2,
                                 config=jax_seeds.SeedsConfig(**config))
                for i in range(2)]
        got = seeds.select(t(conf), t(x), t(y), t(s), t(hr), hr_spacing=2,
                           config=seeds.SeedsConfig(**config))
        for name in seeds.Seeds._fields:
            w = np.stack([np.asarray(getattr(s_, name)) for s_ in want])
            g = getattr(got, name).numpy()
            if name in ('f', 'valid'):
                np.testing.assert_array_equal(g, w, err_msg=name)
            else:
                np.testing.assert_allclose(g, w, atol=1e-5, rtol=0,
                                           err_msg=name)


def test_caf_scored_score():
    rng = np.random.default_rng(5)
    raw = rng.normal(0.0, 2.0, (2, 19, 9, 9, 11)).astype(np.float32)
    hr = rng.uniform(0.0, 1.0, (2, 17, 65, 81)).astype(np.float32)
    skeleton = np.asarray(constants.COCO_PERSON_SKELETON) - 1
    scales = rng.uniform(0.5, 1.0, 19).astype(np.float32)
    for config, cs in ((dict(), None), (dict(max_candidates=8), scales)):
        want = [jax_caf.score(
            jax_heads.split_fields(jnp.asarray(raw[i]), coco(jax_headmeta)[1]),
            hr[i], skeleton, stride=16, hr_spacing=2,
            config=jax_caf.CafScoredConfig(**config), confidence_scales=cs)
            for i in range(2)]
        got = caf_scored.score(
            heads.split_fields(t(raw), coco(headmeta)[1]), t(hr), skeleton,
            stride=16, hr_spacing=2,
            config=caf_scored.CafScoredConfig(**config),
            confidence_scales=cs)
        for name in caf_scored.CafCandidates._fields:
            w = np.stack([np.asarray(getattr(c, name)) for c in want])
            g = getattr(got, name).numpy()
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=0,
                                       err_msg=name)
        assert got.n_dropped.dtype == torch.int32


def random_poses(rng, b=2, p=24, k=17, spread=30.0):
    poses = np.zeros((b, p, k, 4), np.float32)
    centres = rng.uniform(20, 120, (b, p // 3, 1, 2))
    xy = np.repeat(centres, 3, axis=1) + rng.normal(0, spread / 10,
                                                     (b, p, k, 2))
    poses[..., :2] = xy
    poses[..., 2] = rng.uniform(0.0, 1.0, (b, p, k))
    poses[..., 3] = rng.uniform(2.0, 12.0, (b, p, k))
    placed = rng.uniform(size=(b, p, k)) > 0.2
    valid = rng.uniform(size=(b, p)) > 0.1
    return poses, placed, valid


def test_keypoint_nms():
    rng = np.random.default_rng(6)
    poses, _, valid = random_poses(rng)
    js = rng.uniform(2.0, 16.0, poses.shape[:3]).astype(np.float32)
    w = np.asarray(constants.COCO_PERSON_SCORE_WEIGHTS, np.float32)
    want = [jax_nms.keypoint_nms(jnp.asarray(poses[i]), jnp.asarray(valid[i]),
                                 jnp.asarray(js[i]), jnp.asarray(w),
                                 jax_nms.NMSConfig()) for i in range(2)]
    got = nms.keypoint_nms(t(poses), t(valid), t(js), t(w), nms.NMSConfig())
    for j, name in enumerate(('poses', 'scores', 'valid')):
        wj = np.stack([np.asarray(r[j]) for r in want])
        np.testing.assert_allclose(got[j].numpy(), wj, atol=1e-6, rtol=0,
                                   err_msg=name)
    assert (got[0][..., 2] == 0).sum() > (poses[..., 2] < 0.15).sum()


def test_seed_claims_and_points_claimed():
    """Occupancy geometry with coordinates on .5 grid boundaries (the
    half-to-even cases) and explicit seed ranks."""
    rng = np.random.default_rng(7)
    poses, placed, valid = random_poses(rng, spread=10.0)
    poses[..., :2] = np.round(poses[..., :2]) + 1.0           # x/2 on .5
    seed_f = rng.integers(0, 17, (2, 24))
    rank = np.stack([rng.permutation(24) for _ in range(2)])
    config = nms.NMSConfig()
    jconfig = jax_nms.NMSConfig()
    want = np.stack([np.asarray(jax_nms.seed_claim_suppression(
        poses[i], placed[i], valid[i], seed_f[i], image_hw=(161, 161),
        config=jconfig, rank=rank[i])) for i in range(2)])
    got = nms.seed_claim_suppression(t(poses), t(placed), t(valid),
                                     t(seed_f), image_hw=(161, 161),
                                     config=config, rank=t(rank))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < valid.sum()

    f = rng.integers(0, 17, (2, 60))
    x = (rng.integers(0, 80, (2, 60)) + 0.5 * rng.integers(0, 2, (2, 60))
         ).astype(np.float32) * 2.0 + 1.0                    # x/2 on .5
    y = rng.uniform(0, 160, (2, 60)).astype(np.float32)
    want = np.stack([np.asarray(jax_nms.points_claimed(
        poses[i], placed[i], valid[i], f[i], x[i], y[i],
        image_hw=(161, 161), config=jconfig)) for i in range(2)])
    got = nms.points_claimed(t(poses), t(placed), t(valid), t(f), t(x), t(y),
                             image_hw=(161, 161), config=config)
    np.testing.assert_array_equal(got.numpy(), want)


def test_while_loop_holds_converged_images():
    """vmap-of-while_loop semantics: an image whose condition fails stops
    changing while the others go on; one host sync per iteration."""
    def cond(state):
        return state[0] < state[1]

    def body(state, running):
        return state[0] + 1, state[1]

    limits = torch.tensor([0, 3, 5])
    before = common.HOST_SYNCS
    count, _ = common.while_loop(cond, body,
                                 (torch.zeros(3, dtype=torch.int64), limits))
    assert count.tolist() == [0, 3, 5]
    assert common.HOST_SYNCS - before == 6
    want = jax.vmap(lambda lim: jax.lax.while_loop(
        lambda c: c < lim, lambda c: c + 1, 0))(jnp.asarray([0, 3, 5]))
    assert np.asarray(want).tolist() == [0, 3, 5]
