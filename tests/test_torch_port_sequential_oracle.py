"""The port's sequential decode oracle (``ops/sequential_oracle.py``)
against the JAX package's.

- ``Occupancy``: the same claimed grid and the same answers after the same
  seeded sequence of claims and queries, squares clipped at the borders.
- ``decode_sequential`` on the same ``Seeds`` and ``CafCandidates`` (the
  JAX harness's front end of ``tests/drift_harness.py`` scenes, handed to
  the port as CPU tensors): the same number of poses, each equal to JAX's
  with max |Δ| 0, with force-complete off and on (its relaxed candidate
  set), for a clean and a noisy COCO crowd and a small WholeBody scene
  (133 keypoints, 258 directed edges; a 31 x 31 field grid).  The port
  reads each tensor back once (``common.HOST_SYNCS``).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from openpifpaf_tpu.ops import growth as jax_growth
from openpifpaf_tpu.ops import sequential_oracle as jax_oracle
from openpifpaf_tpu_torch.ops import caf_scored, common, growth, seeds
from openpifpaf_tpu_torch.ops import sequential_oracle

import drift_harness as dh

SCENES = {
    'coco': (dh.COCO_SPEC, None, (1005, 29)),
    'coco-noise': (dh.COCO_SPEC, dh.FieldNoise(), (4003, 19)),
    'wholebody': (dataclasses.replace(dh.wholebody_spec(),
                                      image_hw=(481, 481), grid_hw=(31, 31)),
                  None, (5001, 2)),
}


def test_occupancy_matches_jax():
    rng = np.random.default_rng(0)
    hw = (97, 130)
    ours = sequential_oracle.Occupancy(5, hw)
    theirs = jax_oracle.Occupancy(5, hw)
    for _ in range(200):
        f = int(rng.integers(5))
        x, y = rng.uniform(-10.0, 140.0), rng.uniform(-10.0, 110.0)
        if rng.uniform() < 0.5:
            sigma = float(rng.uniform(0.5, 12.0))
            ours.set(f, x, y, sigma)
            theirs.set(f, x, y, sigma)
        else:
            assert ours.get(f, x, y) == theirs.get(f, x, y)
    assert ours.grid.shape == theirs.grid.shape
    np.testing.assert_array_equal(ours.grid, theirs.grid)
    assert ours.grid.any() and not ours.grid.all()


@functools.lru_cache(maxsize=None)
def jax_harness(spec_name):
    """The JAX harness of a keypoint family, with the force-complete
    candidate set (its front end compiled once)."""
    spec = next(spec for spec, _, _ in SCENES.values()
                if spec.name == spec_name)
    budgets = (dict(max_poses=256, max_seeds=4096)
               if spec.name == 'wholebody' else {})
    return dh.Harness(dh.harness_config(image_hw=spec.image_hw,
                                        force_complete=True, **budgets),
                      spec=spec)


@functools.lru_cache(maxsize=None)
def front_end(scene_name):
    """The JAX harness's front end of one scene, with the force-complete
    candidate set, as numpy arrays, and the harness."""
    spec, noise, (seed, n_poses) = SCENES[scene_name]
    harness = jax_harness(spec.name)
    rng = np.random.default_rng(seed)
    scene = dh.random_scene(rng, n_poses, spec=spec)
    cif, caf = dh.build_fields(scene, h=spec.grid_hw[0], w=spec.grid_hw[1],
                               spec=spec)
    if noise is not None:
        dh.apply_field_noise(cif, caf, rng, noise)
    fe = harness._front(cif, caf)  # pylint: disable=protected-access
    as_numpy = lambda t: type(t)(*[np.asarray(a) for a in t])  # noqa: E731
    return (harness, as_numpy(fe.sds), as_numpy(fe.cands),
            as_numpy(fe.cands_fc))


def port_growth_config(jax_config):
    return growth.GrowthConfig(**{f.name: getattr(jax_config, f.name)
                                  for f in dataclasses.fields(
                                      growth.GrowthConfig)})


@pytest.mark.parametrize('force_complete', [False, True])
@pytest.mark.parametrize('scene_name', list(SCENES))
def test_decode_sequential_matches_jax(scene_name, force_complete):
    harness, sds, cands, cands_fc = front_end(scene_name)
    jax_config = dataclasses.replace(harness.config.growth,
                                     force_complete=force_complete)
    want = jax_oracle.decode_sequential(
        sds, cands, harness.skeleton, n_keypoints=harness.n_keypoints,
        image_hw=harness.config.image_hw, config=jax_config,
        force_cand=cands_fc)

    def tensors(cls, arrays):
        return cls(*[torch.from_numpy(np.array(a)) for a in arrays])

    syncs = common.HOST_SYNCS
    got = sequential_oracle.decode_sequential(
        tensors(seeds.Seeds, sds), tensors(caf_scored.CafCandidates, cands),
        harness.skeleton, n_keypoints=harness.n_keypoints,
        image_hw=harness.config.image_hw,
        config=port_growth_config(jax_config),
        force_cand=tensors(caf_scored.CafCandidates, cands_fc))
    # six seed arrays and seven candidate arrays per set taken, each read
    # once
    assert common.HOST_SYNCS - syncs == 6 + 7 + 7 * force_complete

    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    if force_complete:
        # the relaxed pass completes what the first pass left
        plain = jax_oracle.decode_sequential(
            sds, cands, harness.skeleton, n_keypoints=harness.n_keypoints,
            image_hw=harness.config.image_hw,
            config=dataclasses.replace(jax_config, force_complete=False))
        assert sum((p[:, 2] > 0).sum() for p in got) >= \
            sum((p[:, 2] > 0).sum() for p in plain)


def test_directed_edges_match_jax():
    """The oracle walks the port's directed edge tables: JAX's."""
    skeleton = np.asarray(dh.wholebody_spec().skeleton) - 1
    for got, want in zip(growth.directed_edges(skeleton),
                         jax_growth.directed_edges(skeleton)):
        np.testing.assert_array_equal(got, want)
