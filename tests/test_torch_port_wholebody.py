"""The 133-keypoint WholeBody topology and the toy crowd in the port,
against ``openpifpaf_tpu`` and the sequential oracle.

- ``plugins/wholebody/constants.py`` equals the JAX package's copy.
- ToyWb and ToyCrowd: ground truth and rendered images bit for bit (the
  JAX render wraps the same uint8 array in a PIL image), head metas, and
  training samples and targets as the JAX pipeline's on the same draws
  (images within 1 grey level, masks bit for bit, float targets within
  1e-6); ToyWb refuses the hflip eval variant.
- The port's CPU decode on ``tests/drift_harness.py`` scenes, on the JAX
  front end's fields: at WholeBody (``wholebody_spec()``, the budgets of
  ``test_drift_wholebody.py``: 256 poses, 4096 seeds) every pose within
  ``xyv`` 1e-3 and score 1e-4 of the JAX decode's, and against
  ``sequential_oracle.decode_sequential`` on the clean scenes detection F1
  1.0, mean OKS >= 0.999, mean score delta <= 1e-4
  (``test_drift_wholebody.py``'s bar for JAX); at COCO on three crowd
  scenes the same hold to JAX and ``test_drift.py``'s gates to the oracle.
"""

import dataclasses

import numpy as np
import PIL.Image
import pytest
import torch

from openpifpaf_tpu import encoder as jax_encoder
from openpifpaf_tpu import transforms as jax_transforms
from openpifpaf_tpu.plugins.toykp import crowd as jax_crowd
from openpifpaf_tpu.plugins.toykp import toywb as jax_toywb
from openpifpaf_tpu.plugins.wholebody import constants as jax_wb
from openpifpaf_tpu_torch import headmeta, ops
from openpifpaf_tpu_torch.ops import caf_scored, cif_hr, growth, nms, seeds
from openpifpaf_tpu_torch.plugins.coco import constants
from openpifpaf_tpu_torch.plugins.toykp import crowd, toywb
from openpifpaf_tpu_torch.plugins.wholebody import constants as wb

import drift_harness as dh
from test_torch_port_encoder import assert_targets_equal
from test_torch_port_encoder import numpy_painters  # noqa: F401  (fixture)

SIZE = 97


def test_wholebody_constants_match_jax():
    assert wb.KEYPOINTS == jax_wb.KEYPOINTS and len(wb.KEYPOINTS) == 133
    assert wb.SIGMAS == jax_wb.SIGMAS
    assert wb.SKELETON == jax_wb.SKELETON and len(wb.SKELETON) == 129
    assert wb.HFLIP == jax_wb.HFLIP
    np.testing.assert_array_equal(wb.UPRIGHT_POSE, jax_wb.UPRIGHT_POSE)


def test_toywb_pose_and_head_metas_match_jax():
    np.testing.assert_array_equal(toywb.TOYWB_POSE, jax_toywb.TOYWB_POSE)
    np.testing.assert_array_equal(toywb.toywb_pose(), jax_toywb.toywb_pose())
    assert toywb.TOYWB_SIGMAS == jax_toywb.TOYWB_SIGMAS
    for got, want in zip(toywb.ToyWb().head_metas,
                         jax_toywb.ToyWb().head_metas):
        assert type(got).__name__ == type(want).__name__
        assert (got.name, got.dataset, got.n_fields) == \
            (want.name, want.dataset, want.n_fields)
        assert got.keypoints == want.keypoints
        assert got.sigmas == want.sigmas
        assert getattr(got, 'skeleton', None) == getattr(want, 'skeleton',
                                                          None)
    assert [m.n_fields for m in toywb.ToyWb().head_metas] == [133, 129]


DATASETS = {'toywb': (toywb.ToyWbDataset, jax_toywb.ToyWbDataset),
            'toycrowd': (crowd.ToyCrowdDataset, jax_crowd.ToyCrowdDataset)}


@pytest.mark.parametrize('name', list(DATASETS))
def test_ground_truth_and_render_match_jax(name):
    port_cls, jax_cls = DATASETS[name]
    port = port_cls(4, SIZE, None, seed=3)
    ours = jax_cls(4, SIZE, None, seed=3)
    n_people = []
    for i in range(4):
        gt, want_gt = port.ground_truth(i), ours.ground_truth(i)
        assert len(gt) == len(want_gt)
        for kp, want in zip(gt, want_gt):
            np.testing.assert_array_equal(kp, want)
        image = port.render(i, gt)
        want_image = ours.render(i, want_gt)
        assert isinstance(want_image, PIL.Image.Image)
        np.testing.assert_array_equal(image, np.asarray(want_image))
        assert image.dtype == np.uint8 and image.shape == (SIZE, SIZE, 3)
        n_people.append(len(gt))
    if name == 'toycrowd':
        # crowds, with occluded joints marked invisible
        assert max(n_people) >= 3
        assert any((kp[:, 2] == 0).any() for i in range(4)
                   for kp in port.ground_truth(i))


def jax_sample(name, index, rng, augmentation, head_metas):
    """The JAX training sample (its data module's transforms, drawn from
    ``rng``, with the numpy encoders)."""
    _, jax_cls = DATASETS[name]
    if name == 'toywb':
        normalize = jax_toywb.ToyWb()._normalize()  # pylint: disable=protected-access
        flips = []
    else:
        normalize = jax_crowd.ToyCrowd()._normalize()  # pylint: disable=protected-access
        flips = [jax_transforms.RandomApply(jax_transforms.HFlip(
            constants.COCO_KEYPOINTS, constants.HFLIP), 0.5, rng=rng)]
    steps = [normalize]
    if augmentation:
        steps += flips + [jax_transforms.RescaleRelative((0.8, 1.25), rng=rng),
                          jax_transforms.Crop(SIZE, rng=rng),
                          jax_transforms.CenterPad(SIZE)]
    else:
        steps += [jax_transforms.RescaleAbsolute(SIZE),
                  jax_transforms.CenterPad(SIZE)]
    steps += [jax_transforms.TRAIN_TRANSFORM, jax_encoder.Encoders(
        [jax_encoder.CifEncoder(head_metas[0], use_native=False),
         jax_encoder.CafEncoder(head_metas[1], use_native=False)])]
    return jax_cls(3, SIZE, jax_transforms.Compose(steps), seed=0)[index]


@pytest.mark.parametrize('augmentation', [True, False])
@pytest.mark.parametrize('name', list(DATASETS))
def test_samples_match_jax(name, augmentation, monkeypatch):
    module = {'toywb': toywb.ToyWb, 'toycrowd': crowd.ToyCrowd}[name]
    jax_module = {'toywb': jax_toywb.ToyWb,
                  'toycrowd': jax_crowd.ToyCrowd}[name]
    monkeypatch.setattr(module, 'image_size', SIZE)
    monkeypatch.setattr(module, 'augmentation', augmentation)
    dm = module()
    jax_metas = jax_module().head_metas
    for m in dm.head_metas + jax_metas:
        m.base_stride = 16
    rng, jax_rng = np.random.default_rng(5), np.random.default_rng(5)
    ds = dm.dataset_cls(3, SIZE, dm.preprocess(rng), seed=0, rng=rng)
    for i in range(3):
        image, targets, _ = ds[i]
        want_image, want_targets, _ = jax_sample(name, i, jax_rng,
                                                 augmentation, jax_metas)
        diff = np.abs(image.permute(1, 2, 0).numpy() - want_image).max()
        assert diff <= 1.0 / (255 * 0.224) + 1e-6
        for want, got in zip(want_targets, targets):
            assert_targets_equal(want, got)
    assert targets[0]['conf'].shape[0] == (133 if name == 'toywb' else 17)


def test_toywb_refuses_hflip_eval():
    dm = toywb.ToyWb()
    with pytest.raises(ValueError, match='hflip'):
        dm.eval_loader(hflip=True)
    assert dm.eval_loader(long_edge=65) is not None
    assert dm.metrics()[0] is not None


# ----------------------------------------------------------------- decode
@pytest.fixture(autouse=True)
def two_torch_threads():
    """The WholeBody CPU decode splats 133 fields and grows 256 poses over
    132 rounds per wave: two intra-op threads halve its time and leave the
    other cores to the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


PORT_CONFIGS = dict(cifhr=cif_hr.CifHrConfig, seeds=seeds.SeedsConfig,
                    caf=caf_scored.CafScoredConfig,
                    caf_fc=caf_scored.CafScoredConfig,
                    growth=growth.GrowthConfig, nms=nms.NMSConfig)


def port_config(jax_config):
    """The port's ``CifCafConfig`` with every value of the JAX one."""
    kw = {}
    for field in dataclasses.fields(ops.CifCafConfig):
        value = getattr(jax_config, field.name)
        cls = PORT_CONFIGS.get(field.name)
        if cls is not None and value is not None:
            value = cls(**{f.name: getattr(value, f.name)
                           for f in dataclasses.fields(cls)})
        kw[field.name] = value
    return ops.CifCafConfig(**kw)


def port_decoder(harness):
    spec = harness.spec
    cif_meta = headmeta.Cif('cif', spec.name, keypoints=list(spec.keypoints),
                            sigmas=list(np.asarray(spec.sigmas, np.float32)),
                            score_weights=list(np.asarray(spec.score_weights,
                                                          np.float32)))
    caf_meta = headmeta.Caf('caf', spec.name, keypoints=list(spec.keypoints),
                            sigmas=list(np.asarray(spec.sigmas, np.float32)),
                            skeleton=spec.skeleton)
    return ops.make_batch_decoder(cif_meta=cif_meta, caf_meta=caf_meta,
                                  config=port_config(harness.config),
                                  device='cpu')


def assert_same_poses(got, want):
    """Score-ordered pose lists: the same count, each pose of ``got``
    matched one to one with a pose of ``want``, xyv within 1e-3 and score
    within 1e-4."""
    assert len(got) == len(want)
    free = list(range(len(want)))
    for xyv, score in got:
        d = [float(np.abs(xyv - want[j][0]).max()) for j in free]
        best = int(np.argmin(d))
        assert d[best] <= 1e-3
        assert abs(score - want[free.pop(best)][1]) <= 1e-4


def run_port_scenes(harness, jobs):
    """Per scene the port's decode held to the JAX decode, and the port's
    agreement with the oracle (``drift_harness`` metrics)."""
    decode = port_decoder(harness)
    spec = harness.spec
    results = []
    for seed, n_poses in jobs:
        scene = dh.random_scene(np.random.default_rng(seed), n_poses,
                                spec=spec)
        parallel, oracle = harness.decode_both(scene)
        cif, caf = dh.build_fields(scene, h=spec.grid_hw[0],
                                   w=spec.grid_hw[1], spec=spec)
        out = decode(cif[None], caf[None])
        got = dh._extract(out.xyv[0].numpy(),  # pylint: disable=protected-access
                          out.scores[0].numpy(), out.valid[0].numpy())
        assert_same_poses(got, parallel)
        assert int(out.n_dropped_poses.sum()) == 0
        m = dh.scene_agreement(got, oracle,
                               sigmas=np.asarray(spec.sigmas, np.float32))
        m['seed'], m['n_poses'] = seed, n_poses
        results.append(m)
    return dh.aggregate(results)


def test_wholebody_clean_scenes_match_jax_and_oracle():
    harness = dh.Harness(dh.harness_config(max_poses=256, max_seeds=4096),
                         spec=dh.wholebody_spec())
    assert harness.n_keypoints == 133 and len(harness.skeleton) == 129
    agg = run_port_scenes(harness, [(5000, 3), (5001, 6), (5002, 9)])
    assert agg['n_oracle'] > 0
    assert agg['detection_f1'] == 1.0, agg
    assert agg['mean_oks'] >= 0.999, agg
    assert agg['mean_score_delta'] <= 1e-4, agg


def test_coco_crowd_scenes_match_jax_and_oracle():
    agg = run_port_scenes(dh.Harness(), [(1001, 9), (1005, 29), (3000, 60)])
    assert agg['n_oracle'] >= 40
    assert agg['detection_f1'] >= 0.98, agg
    assert agg['mean_oks'] >= 0.99, agg
    assert agg['mean_score_delta'] <= 0.01, agg
    assert agg['mean_joint_agreement'] >= 0.98, agg
