"""The port's decode options against ``openpifpaf_tpu``'s decode on the
golden toykp fields, and the legacy single-wave decode.

The options of ``test_torch_port_decode_options`` (``placements_per_round``
2 and 3 with and without ``--force-complete-pose``, ``seed_dedup`` on) on
``tests/fixtures/golden_toykp_fields.npz`` (a trained checkpoint's fields,
4 images at 161 px), held within ``xyv`` atol 1e-3 and ``scores`` atol
1e-4 with identical ``valid`` sets and overflow counters, each m > 1 case
beyond those tolerances from JAX's decode at m = 1.  Then the
single-wave decode of ``tools/stage_timing.py`` (``init_poses``, ``grow``
from every seed, ``finalize_poses`` with the seed fields) on the painted
scenes, with and without force-complete.
"""

import jax
import numpy as np
import pytest
import torch

from openpifpaf_tpu import headmeta as jax_headmeta
from openpifpaf_tpu.ops import growth as jax_growth
from openpifpaf_tpu.ops import pipeline as jax_pipeline
from openpifpaf_tpu_torch import headmeta
from openpifpaf_tpu_torch.ops import growth, pipeline

from test_torch_port_decode import assert_same_decode, metas, painted_scenes
from test_torch_port_decode import golden, one_torch_thread  # noqa: F401
from test_torch_port_decode_options import (OPTIONS, PAINTED_HW,
                                            beyond_tolerance, decode_both,
                                            jax_at_m1, option_configs)

GOLDEN_HW = (161, 161)


@pytest.mark.parametrize('m,force_complete,seed_dedup', OPTIONS)
def test_golden_fields_options_match_jax(golden, m, force_complete,
                                         seed_dedup):
    cif, caf, _ = golden
    want, got = decode_both(cif, caf, option_configs(
        GOLDEN_HW, m, force_complete, seed_dedup))
    assert_same_decode(want, got)
    assert got[3].sum() == 6
    if m > 1:
        # the golden fields separate m from m = 1 too
        assert beyond_tolerance(want, jax_at_m1(
            'golden', cif, caf, GOLDEN_HW, force_complete))


def legacy_decode_jax(cif, caf, config):
    """The single-wave decode of ``tools/stage_timing.py``: ``init_poses``,
    ``grow`` from every seed, ``finalize_poses`` with the seed fields."""
    jc, ja = metas(jax_headmeta)
    edges = jax_growth.directed_edges(np.asarray(ja.skeleton) - 1)

    @jax.jit
    def one(c, a):
        fe = jax_pipeline.decode_front_end(c, a, cif_meta=jc, caf_meta=ja,
                                           config=config)
        poses, placed, pose_valid, _, _, seed_f = jax_growth.init_poses(
            fe.sds, n_keypoints=17, config=config.growth)
        poses, placed = jax_growth.grow(poses, placed, pose_valid, fe.cands,
                                        edges, config.growth,
                                        force_cand=fe.cands_fc)
        return jax_pipeline.finalize_poses(
            poses, placed, pose_valid, fe.scale_px,
            score_weights=jc.score_weights, config=config, seed_f=seed_f)
    outs = [one(cif[i], caf[i]) for i in range(cif.shape[0])]
    return [np.stack([np.asarray(o[j]) for o in outs]) for j in range(4)]


def legacy_decode_port(cif, caf, config):
    tc, ta = metas(headmeta)
    fe = pipeline.decode_front_end(torch.from_numpy(cif),
                                   torch.from_numpy(caf), cif_meta=tc,
                                   caf_meta=ta, config=config)
    edges = growth.directed_edges(np.asarray(ta.skeleton) - 1)
    poses, placed, pose_valid, _, _, seed_f = growth.init_poses(
        fe.sds, n_keypoints=17, config=config.growth)
    et = growth.edge_tables(edges, 17, poses.device)
    force_dv = (None if fe.cands_fc is None
                else growth.dirviews(fe.cands_fc, edges))
    poses, placed = growth.grow(poses, placed, pose_valid,
                                growth.dirviews(fe.cands, edges), et,
                                config.growth, force_dv=force_dv)
    out = pipeline.finalize_poses(poses, placed, pose_valid, fe.scale_px,
                                  score_weights=tc.score_weights,
                                  config=config, seed_f=seed_f)
    return [t.numpy() for t in out]


@pytest.mark.parametrize('force_complete', [False, True])
def test_legacy_single_wave_decode_matches_jax(force_complete):
    """The single-wave decode from ``init_poses`` on the painted scenes:
    poses, joint scales, scores and the valid set as the JAX one's."""
    cif, caf = painted_scenes()
    jax_config, config = option_configs(PAINTED_HW, 1, force_complete,
                                        False)
    want = legacy_decode_jax(cif, caf, jax_config)
    got = legacy_decode_port(cif, caf, config)
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_allclose(got[0][..., :3], want[0][..., :3], atol=1e-3,
                               rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got[2], want[2], atol=1e-4, rtol=0)
    assert got[3].sum(axis=1).tolist() == [1, 2, 9, 0, 1]
