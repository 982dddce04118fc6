"""The port's batched CifCaf decode against ``openpifpaf_tpu``'s.

Both decoders see the same fields: the trained-checkpoint fixture
``tests/fixtures/golden_toykp_fields.npz`` (4 images) and painted scenes
from ``tests/test_decoder.py::build_fields``.  Required: the same ``valid``
set, every ``DecodedPoses`` field within ``xyv`` atol 1e-3 and ``scores``
atol 1e-4 (the frameworks' f32 ``exp``/sums differ in the last ulp), and
identical overflow counters.  This holds with the decoder's defaults and
with ``--force-complete-pose`` (the second candidate set and the relaxed
second growth pass), each configuration built by the two packages'
``CifCaf.config_for``.  The port also reproduces
``golden_toykp_poses.json`` within ``tests/test_golden.py``'s tolerances.
The decode options (``placements_per_round``, ``seed_dedup``, dense
connections) are held in ``test_torch_port_decode_options*.py`` and
``test_torch_port_dense.py``.
"""

import json
import os

import numpy as np
import pytest
import torch

from openpifpaf_tpu import decoder as jax_decoder
from openpifpaf_tpu import headmeta as jax_headmeta
from openpifpaf_tpu import ops as jax_ops
from openpifpaf_tpu_torch import decoder, headmeta, ops
from openpifpaf_tpu_torch.ops import common
from openpifpaf_tpu_torch.plugins.coco import constants

import test_decoder
from test_decoder import build_fields, synthetic_pose

FIXTURES = os.path.join(os.path.dirname(__file__), 'fixtures')


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's CPU decode is many small ops: one intra-op thread costs
    a sixth of the CPU time of the default and leaves the cores to the
    other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def metas(hm):
    cif = hm.Cif('cif', 'toykp', keypoints=constants.COCO_KEYPOINTS,
                 sigmas=constants.COCO_PERSON_SIGMAS,
                 score_weights=constants.COCO_PERSON_SCORE_WEIGHTS)
    caf = hm.Caf('caf', 'toykp', keypoints=constants.COCO_KEYPOINTS,
                 sigmas=constants.COCO_PERSON_SIGMAS,
                 skeleton=constants.COCO_PERSON_SKELETON)
    cif.head_index, caf.head_index = 0, 1
    cif.base_stride = caf.base_stride = 16
    return cif, caf


def decoder_configs(image_hw, force_complete):
    """The JAX and the port's ``CifCaf.config_for(image_hw)`` with
    ``force_complete`` set on both decoder classes."""
    configs = []
    for cls, hm, kw in ((jax_decoder.CifCaf, jax_headmeta, {}),
                        (decoder.CifCaf, headmeta, {'device': 'cpu'})):
        old = cls.force_complete
        try:
            cls.force_complete = force_complete
            configs.append(cls(*metas(hm), **kw).config_for(image_hw))
        finally:
            cls.force_complete = old
    return configs


def decode_both(cif, caf, image_hw, force_complete=False):
    jax_config, config = decoder_configs(image_hw, force_complete)
    jc, ja = metas(jax_headmeta)
    want = jax_ops.make_batch_decoder(
        cif_meta=jc, caf_meta=ja, config=jax_config)(cif, caf)
    tc, ta = metas(headmeta)
    got = ops.make_batch_decoder(
        cif_meta=tc, caf_meta=ta, config=config, device='cpu')(cif, caf)
    return ([np.asarray(x) for x in want], [x.numpy() for x in got])


def assert_same_decode(want, got):
    names = ops.DecodedPoses._fields
    w, g = dict(zip(names, want)), dict(zip(names, got))
    for name in names:
        assert w[name].shape == g[name].shape, name
    np.testing.assert_array_equal(g['valid'], w['valid'])
    np.testing.assert_allclose(g['xyv'], w['xyv'], atol=1e-3, rtol=0)
    np.testing.assert_allclose(g['joint_scales'], w['joint_scales'],
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(g['scores'], w['scores'], atol=1e-4, rtol=0)
    for name in ('n_dropped_caf', 'n_dropped_cif', 'n_dropped_poses'):
        np.testing.assert_array_equal(g[name], w[name], err_msg=name)


@pytest.fixture(scope='module')
def golden():
    fields = np.load(os.path.join(FIXTURES, 'golden_toykp_fields.npz'))
    with open(os.path.join(FIXTURES, 'golden_toykp_poses.json')) as f:
        poses = json.load(f)
    return fields['cif'], fields['caf'], poses


def check_golden(golden, force_complete):
    cif, caf, _ = golden
    want, got = decode_both(cif, caf, (161, 161), force_complete)
    assert_same_decode(want, got)
    assert got[3].sum() == 6
    if force_complete:
        # the relaxed second pass completes every pose
        assert (got[0][got[3]][..., 2] > 0).all()


def test_golden_fields_match_jax_decode(golden):
    check_golden(golden, force_complete=False)


def test_golden_fields_match_jax_decode_force_complete(golden):
    check_golden(golden, force_complete=True)


def painted_scenes():
    """Single person, two people, a crowded 3x3 grid, an empty image and
    a person whose wrists are below the seed and keypoint thresholds."""
    kp, scales = synthetic_pose()
    single = build_fields([(kp, scales)])
    kp1, s1 = synthetic_pose(offset_px=(-70.0, 0.0))
    kp2, _ = synthetic_pose(offset_px=(75.0, 10.0))
    two = build_fields([(kp1, s1), (kp2, s1)])
    crowd = build_fields([
        synthetic_pose(offset_px=(dx, dy), scale=8.0)
        for dy in (0.0, 110.0, 220.0) for dx in (-110.0, 0.0, 110.0)])
    empty = (np.full_like(single[0], -10.0), np.full_like(single[1], -10.0))
    weak = test_decoder.TestForceComplete.weakened_fields()[:2]
    scenes = [single, two, crowd, empty, weak]
    return (np.stack([s[0] for s in scenes]),
            np.stack([s[1] for s in scenes]))


def check_painted(force_complete):
    """All scenes in one batch (one JAX compile per configuration)."""
    cif, caf = painted_scenes()
    want, got = decode_both(cif, caf, (21 * 16, 21 * 16), force_complete)
    assert_same_decode(want, got)
    assert got[3].sum(axis=1).tolist() == [1, 2, 9, 0, 1]
    weak_pose = got[0][4][got[3][4]][0]
    # without the flag the two weak wrists stay empty; with it the second
    # pass places them
    assert (weak_pose[:, 2] > 0).sum() == (17 if force_complete else 15)


def test_painted_scenes_match_jax_decode():
    check_painted(force_complete=False)


def test_painted_scenes_match_jax_decode_force_complete():
    check_painted(force_complete=True)


def test_force_complete_counts_its_host_syncs():
    """The second pass is a second host loop in every wave: its syncs are
    counted in ``common.HOST_SYNCS``, not hidden."""
    cif, caf = (f[4:] for f in painted_scenes())     # the weak wrists
    counts = []
    for force_complete in (False, True):
        _, config = decoder_configs((21 * 16, 21 * 16), force_complete)
        tc, ta = metas(headmeta)
        decode = ops.make_batch_decoder(cif_meta=tc, caf_meta=ta,
                                        config=config, device='cpu')
        before = common.HOST_SYNCS
        decode(cif, caf)
        counts.append(common.HOST_SYNCS - before)
    assert counts[1] > counts[0] > 0


def test_force_complete_config_matches_jax():
    """``config_for`` under ``--force-complete-pose``: a second candidate
    set at ``force_complete_caf_th`` with twice the budget, the first
    pass's set unchanged, NMS keypoint threshold 0."""
    for force_complete in (False, True):
        want, got = decoder_configs((161, 161), force_complete)
        assert got.caf == ops.caf_scored.CafScoredConfig(**vars(want.caf))
        assert (got.caf_fc is None) == (want.caf_fc is None) \
            == (not force_complete)
        if force_complete:
            assert got.caf_fc.score_th == want.caf_fc.score_th == 0.001
            assert got.caf_fc.max_candidates == want.caf_fc.max_candidates \
                == 512
        assert got.growth.force_complete == want.growth.force_complete \
            == force_complete
        assert got.growth.force_complete_threshold \
            == want.growth.force_complete_threshold
        assert got.nms.keypoint_threshold == want.nms.keypoint_threshold \
            == (0.0 if force_complete else 0.15)


def test_golden_poses_reproduced(golden):
    """``tests/test_golden.py`` through the port's CifCaf decoder."""
    cif, caf, meta = golden
    dec = decoder.factory(list(metas(headmeta)), device='cpu')
    anns = dec.batch_fields([torch.from_numpy(cif), torch.from_numpy(caf)])
    for i, want_poses in enumerate(meta['poses']):
        assert len(anns[i]) == len(want_poses), f'image {i}: pose count'
        got = sorted(anns[i], key=lambda a: -a.score)
        for ann, want in zip(got, want_poses):
            want_xyv = np.asarray(want['xyv'], np.float32)
            assert abs(float(ann.score) - want['score']) < 0.01
            vis = want_xyv[:, 2] > 0
            np.testing.assert_array_equal(ann.data[:, 2] > 0, vis)
            np.testing.assert_allclose(ann.data[vis, :2], want_xyv[vis, :2],
                                       atol=1.0)
            np.testing.assert_allclose(ann.data[vis, 2], want_xyv[vis, 2],
                                       atol=0.02)
    # the single-image call decodes the same poses
    one = dec([cif[1], caf[1]])
    assert [a.score for a in one] == [a.score for a in anns[1]]
