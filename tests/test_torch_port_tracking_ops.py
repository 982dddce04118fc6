"""The port's temporal association (``ops/tracking.py``) against the JAX
package's ``openpifpaf_tpu.ops.tracking``.

The same numpy inputs — seeded random TCAF fields and pose sets, and the
painted pair fields of ``tests/test_tracking.py::paint_tcaf`` — go through
both.  Candidates must agree exactly in their indices and validity and
within 1e-6 in their values; association scores within 1e-6; matches must
be identical, exactly tied scores included (the first index of equal
values wins in both, ``jnp.argmax`` and ``torch.argmax``).  The
association on the device reads nothing back to the host: it runs with the
tensor methods that would read a value (``item``, ``bool``, ``tolist``,
``numpy``, ``int``, ``float``, ``index``) made to raise, and ``associate``
adds exactly one to ``common.HOST_SYNCS``, its one readback.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpifpaf_tpu import headmeta as jax_headmeta
from openpifpaf_tpu.models.heads import split_fields as jax_split_fields
from openpifpaf_tpu.ops import tracking as jax_tracking
from openpifpaf_tpu_torch import headmeta
from openpifpaf_tpu_torch.models.heads import split_fields
from openpifpaf_tpu_torch.ops import common, tracking
from openpifpaf_tpu_torch.plugins.coco import constants

from test_decoder import synthetic_pose
from test_tracking import paint_tcaf

TOL = 1e-6


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the CPU decode is many small ops, and the
    cores are left to the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tcaf_metas():
    out = []
    for hm in (jax_headmeta, headmeta):
        meta = hm.Tcaf('tcaf', 'test',
                       keypoints_single_frame=constants.COCO_KEYPOINTS,
                       sigmas_single_frame=constants.COCO_PERSON_SIGMAS)
        meta.base_stride = 16
        out.append(meta)
    return out


def random_field(seed, h=9, w=11, tied=True):
    """Raw (17, 9, h, w) TCAF: confidence logits N(0, 2), with whole rows
    of exactly equal logits so that the top-C budget cuts through ties;
    offsets within a few cells, scales of 1-4 cells."""
    rng = np.random.default_rng(seed)
    field = np.zeros((17, 9, h, w), np.float32)
    field[:, 0] = rng.normal(0.0, 2.0, (17, h, w))
    if tied:
        field[:, 0, 2] = 1.5
        field[3, 0] = 0.75
    field[:, 1:5] = rng.uniform(-2.0, 2.0, (17, 4, h, w))
    field[:, 5:7] = rng.normal(0.0, 1.0, (17, 2, h, w))
    field[:, 7:9] = np.log(np.expm1(rng.uniform(1.0, 4.0, (17, 2, h, w))))
    return field


def candidates_both(field, config_kw):
    jax_meta, meta = tcaf_metas()
    want = jax_tracking.tcaf_candidates(
        jax_split_fields(jnp.asarray(field), jax_meta), stride=16,
        config=jax_tracking.TrackingConfig(**config_kw))
    got = tracking.tcaf_candidates(
        split_fields(torch.from_numpy(field), meta), stride=16,
        config=tracking.TrackingConfig(**config_kw))
    return ([np.asarray(a) for a in want], [a.numpy() for a in got])


@pytest.mark.parametrize('seed,max_candidates', [(0, 16), (1, 40), (2, 128)])
def test_tcaf_candidates(seed, max_candidates):
    want, got = candidates_both(random_field(seed),
                                dict(max_candidates=max_candidates))
    names = tracking.TcafCandidates._fields
    for name, w, g in zip(names, want, got):
        if name in ('valid', 'n_dropped'):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=name)
    assert int(got[-1]) > 0 or max_candidates == 128


def poses_near(cands, n, seed, frame):
    """(n, 17, 3) poses whose joints sit at candidates' endpoints of
    ``frame`` (1 or 2), moved by up to 3 px, some joints invisible."""
    rng = np.random.default_rng(seed)
    x, y = (cands[1], cands[2]) if frame == 1 else (cands[3], cands[4])
    valid = cands[6]
    xyv = np.zeros((n, 17, 3), np.float32)
    for p in range(n):
        for k in range(17):
            c = rng.integers(0, max(1, int(valid[k].sum())))
            xyv[p, k] = (x[k, c] + rng.uniform(-3, 3),
                         y[k, c] + rng.uniform(-3, 3), rng.uniform(0.2, 1.0))
    xyv[rng.uniform(size=(n, 17)) < 0.2, 2] = 0.0
    return xyv


def scores_both(field, prev, prev_valid, curr, curr_valid, config_kw):
    jax_meta, meta = tcaf_metas()
    jax_config = jax_tracking.TrackingConfig(**config_kw)
    config = tracking.TrackingConfig(**config_kw)
    jc = jax_tracking.tcaf_candidates(
        jax_split_fields(jnp.asarray(field), jax_meta), stride=16,
        config=jax_config)
    want = jax_tracking.association_scores(jc, prev, prev_valid, curr,
                                           curr_valid, jax_config)
    tc = tracking.tcaf_candidates(split_fields(torch.from_numpy(field), meta),
                                  stride=16, config=config)
    got = tracking.association_scores(
        tc, *(torch.from_numpy(a) for a in (prev, prev_valid, curr,
                                            curr_valid)), config)
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_association_scores(seed):
    config_kw = dict(max_candidates=24, min_radius_px=6.0)
    field = random_field(seed)
    _, cands = candidates_both(field, config_kw)
    prev = poses_near(cands, 5, seed, 1)
    curr = poses_near(cands, 6, seed + 10, 2)
    prev_valid = np.array([1, 1, 0, 1, 1], np.float32)
    curr_valid = np.array([1, 0, 1, 1, 1, 1], np.float32)
    want, got = scores_both(field, prev, prev_valid, curr, curr_valid,
                            config_kw)
    assert got.shape == (5, 6)
    assert (want > 0).sum() >= 10
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def score_matrices():
    rng = np.random.default_rng(3)
    yield 'random', rng.uniform(0.0, 1.0, (7, 5)).astype(np.float32), 0.05
    # quantized: many exact ties, claimed in the first index order
    yield 'ties', (rng.integers(0, 4, (6, 8)) / 4.0).astype(np.float32), 0.2
    yield 'all_equal', np.full((4, 4), 0.5, np.float32), 0.05
    yield 'below_threshold', np.full((3, 2), 0.01, np.float32), 0.05
    yield 'tall', (rng.integers(0, 3, (9, 3)) / 2.0).astype(np.float32), 0.4


@pytest.mark.parametrize('name,scores,min_score', list(score_matrices()),
                         ids=[m[0] for m in score_matrices()])
def test_greedy_match(name, scores, min_score):
    want = np.asarray(jax_tracking.greedy_match(jnp.asarray(scores),
                                                min_score))
    got = tracking.greedy_match(torch.from_numpy(scores), min_score)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def painted_pair(shift_px=24.0):
    kp1, scales = synthetic_pose()
    kp2 = kp1.copy()
    kp2[:, 0] += shift_px
    field = np.zeros((17, 9, 21, 21), np.float32)
    field[:, 0] = -10.0
    paint_tcaf(field, kp1, kp2, scales, 16)
    return kp1, kp2, field


@pytest.mark.parametrize('case', ['linked', 'swapped_slots', 'distant',
                                  'two_tied'])
def test_associate_painted(case):
    """The whole association (JAX ``make_associator``, the port's
    ``associate``) on painted pair fields: the shifted pose is linked,
    across slots, a distant one is not, and two identical previous poses
    tie exactly (the first one is claimed)."""
    kp1, kp2, field = painted_pair()
    prev = np.zeros((4, 17, 3), np.float32)
    curr = np.zeros((4, 17, 3), np.float32)
    prev_valid = np.zeros(4, np.float32)
    curr_valid = np.zeros(4, np.float32)
    prev[0], prev_valid[0] = kp1, 1.0
    curr[1 if case == 'swapped_slots' else 0], curr_valid[:2] = kp2, 1.0
    if case == 'distant':
        prev[0, :, 0] += 150.0
    if case == 'two_tied':
        prev[2], prev_valid[2] = kp1, 1.0
    jax_meta, meta = tcaf_metas()
    want_match, want_dropped = jax_tracking.make_associator(
        tcaf_meta=jax_meta, config=jax_tracking.TrackingConfig())(
        field, prev, prev_valid, curr, curr_valid)
    before = common.HOST_SYNCS
    match, dropped = tracking.associate(
        torch.from_numpy(field), prev, prev_valid, torch.from_numpy(curr),
        curr_valid, tcaf_meta=meta, config=tracking.TrackingConfig())
    assert common.HOST_SYNCS - before == 1
    np.testing.assert_array_equal(match, np.asarray(want_match))
    assert dropped == int(want_dropped)
    linked = {'linked': 0, 'swapped_slots': 1, 'two_tied': 0}
    if case in linked:
        assert match[linked[case]] == 0
    else:
        assert (match == -1).all()


READBACKS = ('item', '__bool__', 'tolist', 'numpy', '__int__', '__float__',
             '__index__')


@contextlib.contextmanager
def no_readback():
    """Make every tensor method that reads a value to the host raise."""
    saved = {name: getattr(torch.Tensor, name) for name in READBACKS}

    def refuse(name):
        def method(self, *args, **kwargs):
            raise AssertionError(f'host readback: Tensor.{name}')
        return method

    try:
        for name in READBACKS:
            setattr(torch.Tensor, name, refuse(name))
        yield
    finally:
        for name, method in saved.items():
            setattr(torch.Tensor, name, method)


def test_association_reads_nothing_back():
    kp1, kp2, field = painted_pair()
    _, meta = tcaf_metas()
    prev = np.stack([kp1, np.zeros_like(kp1)])
    curr = torch.from_numpy(np.stack([np.zeros_like(kp2), kp2]))
    valid = np.array([1.0, 0.0], np.float32)
    field_t = torch.from_numpy(field)
    with no_readback():
        out = tracking.associate_on_device(
            field_t, prev, valid, curr, torch.tensor([0.0, 1.0]),
            tcaf_meta=meta, config=tracking.TrackingConfig())
        match = tracking.greedy_match(torch.rand(6, 5), 0.05)
        with pytest.raises(AssertionError, match='host readback'):
            bool(match.any())
    assert out.tolist() == [-1, 0, 0]
    assert match.shape == (5,)
