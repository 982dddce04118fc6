"""The port's drift harness (``drift.py``) against the JAX repository's
``tests/drift_harness.py``, on the CPU (its CLIs:
``test_torch_port_drift_tools.py``).

- The keypoint families (COCO and WholeBody), the scenes and their noise:
  for three seeds the painted fields equal JAX's with max |Δ| 0.
- ``scene_agreement`` and ``aggregate`` on the same pose lists: equal.
- ``Harness`` against JAX's over four scenes (three clean, one noisy; a
  31 x 31 field grid): per scene the same oracle, parallel and matched pose
  counts, mean OKS, mean |score delta| and joint agreement within 1e-3 of
  JAX's; the oracle reads 13 tensors back per scene.
- A scene's result does not depend on the batch: three scenes decoded
  together equal the same scenes decoded one by one.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from openpifpaf_tpu_torch import drift

import drift_harness as dh

TOL = 1e-3
SMALL = dict(image_hw=(481, 481), grid_hw=(31, 31))
HARNESS_JOBS = [(1000, 5), (1003, 19), (1006, 34)]
NOISY_JOB = (4003, 19)


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """The CPU decode is many small ops: one intra-op thread for the whole
    module (its module fixtures decode too), the count restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------- scenes
def test_specs_match_jax():
    for got, want in ((drift.COCO_SPEC, dh.COCO_SPEC),
                      (drift.wholebody_spec(), dh.wholebody_spec())):
        for field in dataclasses.fields(dh.SceneSpec):
            g, w = getattr(got, field.name), getattr(want, field.name)
            if isinstance(w, np.ndarray):
                assert g.dtype == w.dtype, field.name
                np.testing.assert_array_equal(g, w)
            else:
                assert list(g) == list(w) if isinstance(w, list) else \
                    g == w, field.name
    for got, want in zip(drift.metas_for(drift.wholebody_spec()),
                         dh.metas_for(dh.wholebody_spec())):
        assert got.keypoints == want.keypoints
        assert got.sigmas == want.sigmas
        assert getattr(got, 'skeleton', None) == getattr(want, 'skeleton',
                                                          None)
    assert drift.WHOLEBODY_NOISE == drift.FieldNoise(
        conf_logit_sigma=0.35, peak_conf_range=(0.6, 1.0), offset_sigma=0.08,
        spurious_blobs=60, spurious_caf=60)


@pytest.mark.parametrize('case', [('coco', 1003, 19, False),
                                  ('coco', 4005, 34, True),
                                  ('wholebody', 6001, 4, True)])
def test_scenes_match_jax(case):
    name, seed, n_poses, noisy = case
    spec, jax_spec = ((drift.COCO_SPEC, dh.COCO_SPEC) if name == 'coco'
                      else (drift.wholebody_spec(), dh.wholebody_spec()))
    noise = (drift.WHOLEBODY_NOISE if name == 'wholebody'
             else drift.FieldNoise())
    jax_noise = (dh.FieldNoise(**dataclasses.asdict(noise)))
    rng, jax_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    scene = drift.random_scene(rng, n_poses, spec=spec)
    jax_scene = dh.random_scene(jax_rng, n_poses, spec=jax_spec)
    assert len(scene) == len(jax_scene) == n_poses
    for (kp, scales), (jax_kp, jax_scales) in zip(scene, jax_scene):
        np.testing.assert_array_equal(kp, jax_kp)
        np.testing.assert_array_equal(scales, jax_scales)
    fields = drift.build_fields(scene, spec=spec)
    jax_fields = dh.build_fields(jax_scene, spec=jax_spec)
    if noisy:
        drift.apply_field_noise(*fields, rng, noise)
        dh.apply_field_noise(*jax_fields, jax_rng, jax_noise)
    for got, want in zip(fields, jax_fields):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert float(np.abs(got - want).max()) == 0.0
    # the generators are left in the same state
    assert rng.uniform() == jax_rng.uniform()


def test_scene_agreement_and_aggregate_match_jax():
    """Pose lists of a scene, perturbed, some dropped, some joints hidden:
    the same per-scene metrics and the same aggregate."""
    rng = np.random.default_rng(3)
    scene = dh.random_scene(rng, 12)
    results, jax_results = [], []
    for case in range(4):
        oracle = [(np.concatenate([kp[:, :2], rng.uniform(0.2, 1.0, (17, 1))
                                   * (kp[:, 2:] > 0)], 1),
                   float(rng.uniform())) for kp, _ in scene]
        parallel = [(xyv + np.concatenate([rng.normal(0, 2.0 * case,
                                                      (17, 2)),
                                           np.zeros((17, 1))], 1),
                     score + float(rng.normal(0, 0.01)))
                    for xyv, score in oracle[case:]]
        for xyv, _ in parallel[::3]:
            xyv[rng.integers(17), 2] = 0.0
        if case == 3:
            parallel = []
        got = drift.scene_agreement(parallel, oracle)
        want = dh.scene_agreement(parallel, oracle)
        assert got.keys() == want.keys()
        for key, value in want.items():
            assert got[key] == value or (math.isnan(got[key])
                                         and math.isnan(value)), key
        results.append(got)
        jax_results.append(want)
    assert drift.aggregate(results) == dh.aggregate(jax_results)
    assert results[3]['n_matched'] == 0 and results[0]['f1'] == 1.0


# -------------------------------------------------------------- harness
@pytest.fixture(scope='module')
def port_harness():
    return drift.Harness(drift.harness_config(image_hw=SMALL['image_hw']),
                         spec=dataclasses.replace(drift.COCO_SPEC, **SMALL),
                         device='cpu')


@pytest.fixture(scope='module')
def port_results(port_harness):
    return (drift.run_scenes(port_harness, HARNESS_JOBS),
            drift.run_scenes(port_harness, [NOISY_JOB],
                             noise=drift.FieldNoise()))


def test_harness_matches_jax(port_results, port_harness):
    jax_harness = dh.Harness(dh.harness_config(image_hw=SMALL['image_hw']),
                             spec=dataclasses.replace(dh.COCO_SPEC, **SMALL))
    want = (dh.run_scenes(jax_harness, HARNESS_JOBS)
            + dh.run_scenes(jax_harness, [NOISY_JOB], noise=dh.FieldNoise()))
    got = port_results[0] + port_results[1]
    for g, w in zip(got, want):
        for key in ('seed', 'n_poses', 'n_oracle', 'n_parallel',
                    'n_matched'):
            assert g[key] == w[key], (key, g, w)
        for key in ('mean_oks', 'score_delta', 'joint_agreement'):
            assert abs(g[key] - w[key]) <= TOL, (key, g, w)
    assert sum(g['n_oracle'] for g in got) >= 40
    assert port_harness.scenes == len(got)
    # each scene's oracle reads 13 tensors back once: 6 seeds, 7 candidates
    assert port_harness.oracle_syncs == 13 * len(got)


def test_batch_does_not_change_a_scene(port_results, port_harness):
    batched = drift.run_scenes(port_harness, HARNESS_JOBS,
                               batch_size=len(HARNESS_JOBS))
    assert batched == port_results[0]
