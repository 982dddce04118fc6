"""The port's ``growth.compact_seeds`` (with and without ``seed_dedup``)
and ``growth.init_poses`` (the legacy single-wave initialiser) against
``openpifpaf_tpu``'s, exactly, on the seeds of JAX's front end for the
painted COCO scenes of ``test_torch_port_decode``.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from openpifpaf_tpu import headmeta as jax_headmeta
from openpifpaf_tpu.ops import growth as jax_growth
from openpifpaf_tpu.ops import pipeline as jax_pipeline
from openpifpaf_tpu_torch.ops import growth, seeds

from test_torch_port_decode import metas, painted_scenes
from test_torch_port_decode import one_torch_thread  # noqa: F401  (fixture)
from test_torch_port_decode_options import PAINTED_HW, option_configs


@functools.lru_cache(maxsize=None)
def painted_fronts():
    """The JAX front end of each painted scene (seeds and candidates; the
    growth options do not reach it), compiled once for the file."""
    cif, caf = painted_scenes()
    jax_config, _ = option_configs(PAINTED_HW, 1, False, False)
    jc, ja = metas(jax_headmeta)
    front = jax.jit(lambda c, a: jax_pipeline.decode_front_end(
        c, a, cif_meta=jc, caf_meta=ja, config=jax_config))
    return [front(cif[i], caf[i]) for i in range(cif.shape[0])]


def batched_seeds(sds_list):
    """The port's ``Seeds`` (B, S) from per-image JAX seeds."""
    return seeds.Seeds(*[torch.as_tensor(np.stack(
        [np.asarray(getattr(s, name)) for s in sds_list]))
        for name in seeds.Seeds._fields])._replace(
            f=torch.as_tensor(np.stack([np.asarray(s.f) for s in sds_list]),
                              dtype=torch.int64))


@pytest.mark.parametrize('seed_dedup', [False, True])
def test_compact_seeds_matches_jax(seed_dedup):
    """``compact_seeds`` on the JAX front end's seeds of the painted scenes,
    exactly: with dedup off the seeds pass through, with it on the kept
    seeds move to the front in rank order."""
    jax_config, _ = option_configs(PAINTED_HW, 1, False, seed_dedup)
    fronts = painted_fronts()
    got = growth.compact_seeds(batched_seeds([fe.sds for fe in fronts]),
                               jax_config.growth)
    for i, fe in enumerate(fronts):
        want = jax_growth.compact_seeds(fe.sds, jax_config.growth)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))
    n_valid = sum(int(np.asarray(fe.sds.valid).sum()) for fe in fronts)
    # the painted cells give duplicate seeds within the radius: dedup drops
    # some, and without it every valid seed passes
    assert (int(got[5].sum()) < n_valid) == seed_dedup


def test_init_poses_matches_jax():
    """``init_poses`` on the same seeds (the JAX front end's) exactly."""
    jax_config, _ = option_configs(PAINTED_HW, 1, False, False)
    fronts = painted_fronts()
    got = growth.init_poses(batched_seeds([fe.sds for fe in fronts]),
                            n_keypoints=17, config=jax_config.growth)
    for i, fe in enumerate(fronts):
        want = jax_growth.init_poses(fe.sds, n_keypoints=17,
                                     config=jax_config.growth)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))
    assert int(got[2].sum()) > 0
