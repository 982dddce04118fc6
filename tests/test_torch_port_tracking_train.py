"""The port's tracking training path against the JAX package: toykpst
frame pairs, the TCAF encoder, the tracking collate, the composite loss's
fold of frame pairs and two train steps.

- Four toykpst training samples, with and without augmentation, against
  the JAX pipeline on the same draws (the spatial augmentations on one
  seeded generator, ``ImageToTracking`` seeded 7 as ``ToyKpSt`` seeds
  it): both frames within 1 grey level, the same sequence id and
  offsets, and the CIF, CAF and TCAF targets bit for bit (the TCAF
  targets link the two frames' instances by their track ids).
- The tracking collate: interleaved (2B, 3, H, W) frames, (B, 2, ...)
  single-frame targets and (B, ...) TCAF targets, as JAX's in NCHW.
- The nine loss components of the three heads within 1e-5 relative of the
  JAX ``MultiHeadLoss``, the pair fold included, and a head without
  vectors or scales (the ``nv > 0`` guard) giving 0 for those components.
- Two SGD steps of the port's ``Trainer`` on a narrow tracking model
  against two of the JAX ``Trainer._train_step``, f32, with the tolerances
  of ``test_torch_port_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpifpaf_tpu import encoder as jax_encoder
from openpifpaf_tpu import losses as jax_losses
from openpifpaf_tpu import transforms as jax_transforms
from openpifpaf_tpu.datasets import collate as jax_collate
from openpifpaf_tpu.models import checkpoint as jax_checkpoint
from openpifpaf_tpu.models import tracking_base as jax_tracking
from openpifpaf_tpu.plugins.posetrack.toykpst import ToyKpSt as JaxToyKpSt
from openpifpaf_tpu.plugins.toykp.datamodule import \
    ToyKpDataset as JaxToyKpDataset
from openpifpaf_tpu.training import OptimizeFactory as JaxOptimizeFactory
from openpifpaf_tpu.training import Trainer as JaxTrainer
from openpifpaf_tpu_torch import datasets, headmeta, losses, models
from openpifpaf_tpu_torch.plugins.coco import constants
from openpifpaf_tpu_torch.plugins.posetrack import ToyKpSt
from openpifpaf_tpu_torch.plugins.toykp import ToyKpDataset
from openpifpaf_tpu_torch.training import OptimizeFactory, Trainer

from test_torch_port_encoder import assert_targets_equal
from test_torch_port_encoder import numpy_painters  # noqa: F401  (fixture)
from test_torch_port_tracking_model import (flax_narrow_tracking,
                                            port_narrow_tracking)
from test_torch_port_train import F32_EPS, configured

SIZE = 81
GREY_LEVEL = 1.0 / (255 * 0.224)   # one grey level after normalization


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the CPU decode is many small ops, and the
    cores are left to the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_toykpst_dataset(n, rng, augmentation, pair_seed=7):
    """The JAX ToyKpSt training pipeline with its random transforms on
    ``rng`` and the numpy encoders (``ToyKpSt._preprocess`` draws from
    unseeded generators and may take the C++ painters)."""
    dm = JaxToyKpSt()
    for m in dm.head_metas:
        m.base_stride = 16
    steps = [dm._normalize()]  # pylint: disable=protected-access
    if augmentation:
        flip = jax_transforms.HFlip(constants.COCO_KEYPOINTS, constants.HFLIP)
        steps += [jax_transforms.RandomApply(flip, 0.5, rng=rng),
                  jax_transforms.RescaleRelative((0.8, 1.25), rng=rng),
                  jax_transforms.Crop(SIZE, rng=rng),
                  jax_transforms.CenterPad(SIZE)]
    else:
        steps += [jax_transforms.RescaleAbsolute(SIZE),
                  jax_transforms.CenterPad(SIZE)]
    cif, caf, tcaf = dm.head_metas
    steps += [jax_transforms.TRAIN_TRANSFORM,
              jax_transforms.ImageToTracking(max_shift_px=dm.max_shift,
                                             seed=pair_seed),
              jax_encoder.TrackingEncoders([
                  jax_encoder.CifEncoder(cif, use_native=False),
                  jax_encoder.CafEncoder(caf, use_native=False),
                  jax_encoder.TcafEncoder(tcaf)])]
    return JaxToyKpDataset(n, SIZE, jax_transforms.Compose(steps), seed=0)


def port_toykpst_dataset(n, rng, augmentation, monkeypatch):
    monkeypatch.setattr(ToyKpSt, 'image_size', SIZE)
    monkeypatch.setattr(ToyKpSt, 'augmentation', augmentation)
    dm = ToyKpSt()
    for m in dm.head_metas:
        m.base_stride = 16
    return ToyKpDataset(n, SIZE, dm.preprocess(rng, 7), seed=0, rng=rng)


@pytest.fixture(name='samples', params=[True, False],
                ids=['augmented', 'plain'])
def fixture_samples(request, monkeypatch):
    rng, jax_rng = np.random.default_rng(5), np.random.default_rng(5)
    ds = port_toykpst_dataset(4, rng, request.param, monkeypatch)
    jax_ds = jax_toykpst_dataset(4, jax_rng, request.param)
    return [ds[i] for i in range(4)], [jax_ds[i] for i in range(4)]


def test_toykpst_samples(samples):
    ours, theirs = samples
    shifts = set()
    for (images, targets, meta), (want_images, want_targets, want_meta) in \
            zip(ours, theirs):
        assert len(images) == 2
        for image, want in zip(images, want_images):
            assert image.shape == (3, SIZE, SIZE)
            diff = np.abs(image.permute(1, 2, 0).numpy() - want).max()
            assert diff <= GREY_LEVEL + 1e-6
        assert meta['sequence_id'] == want_meta['sequence_id']
        np.testing.assert_array_equal(meta['offset'], want_meta['offset'])
        for want, got in zip(want_targets, targets):
            assert_targets_equal(want, got, atol=0.0)
        # the TCAF offsets carry each sample's own random pan
        tcaf = targets[2]
        assert tcaf['conf'].shape == (17, 6, 6)
        shifts.add(float(tcaf['vec'][:, 1, 0][tcaf['vec_mask'][:, 1]].sum()
                         - tcaf['vec'][:, 0, 0][tcaf['vec_mask'][:, 0]]
                         .sum()))
        assert tcaf['conf'].sum() > 0
    assert len(shifts) > 1


def test_tracking_collate(samples):
    ours, theirs = samples
    images, targets, metas = datasets.collate_tracking_images_targets_meta(
        ours)
    want_images, want_targets, _ = \
        jax_collate.collate_tracking_images_targets_meta(theirs)
    assert images.shape == (8, 3, SIZE, SIZE)
    assert images.dtype == torch.float32
    assert np.abs(images.permute(0, 2, 3, 1).numpy()
                  - want_images).max() <= GREY_LEVEL + 1e-6
    torch.testing.assert_close(images[1], ours[0][0][1])
    for want, got in zip(want_targets, targets):
        assert_targets_equal(want, got, atol=0.0)
    assert targets[0]['conf'].shape == (4, 2, 17, 6, 6)
    assert targets[2]['conf'].shape == (4, 17, 6, 6)
    assert len(metas) == 4

    eval_images, anns, eval_metas = \
        datasets.collate_tracking_images_anns_meta(
            [(s[0], s[1], s[2]) for s in ours[:2]])
    assert eval_images.shape == (4, 3, SIZE, SIZE)
    assert len(anns) == len(eval_metas) == 2


def random_fields(targets, seed=0):
    """Raw head outputs over ``targets``: (2B, ...) for the single-frame
    heads, (B, ...) for TCAF, from N(0, 3)."""
    rng = np.random.default_rng(seed)
    out = []
    for t, nc in zip(targets, (5, 9, 9)):
        shape = tuple(t['conf'].shape)
        b, f = (2 * shape[0], shape[2]) if len(shape) == 5 else shape[:2]
        out.append(rng.normal(0.0, 3.0, (b, f, nc, *shape[-2:]))
                   .astype(np.float32))
    return out


def test_loss_components(samples):
    ours, theirs = samples
    _, targets, _ = datasets.collate_tracking_images_targets_meta(ours)
    _, jax_targets, _ = jax_collate.collate_tracking_images_targets_meta(
        theirs)
    fields = random_fields(targets)
    dm = ToyKpSt()
    jax_dm = JaxToyKpSt()
    total, comps = losses.Factory().factory(dm.head_metas)(
        [torch.from_numpy(f) for f in fields], targets)
    want_total, want_comps = jax_losses.Factory().factory(
        jax_dm.head_metas)([jnp.asarray(f) for f in fields],
                           [{k: jnp.asarray(v) for k, v in t.items()}
                            for t in jax_targets])
    assert len(comps) == len(want_comps) == 9
    np.testing.assert_allclose([float(c) for c in comps],
                               [float(c) for c in want_comps], rtol=1e-5)
    np.testing.assert_allclose(float(total), float(want_total), rtol=1e-5)


def test_loss_without_vectors_or_scales():
    """A head with no vector and no scale components (a confidence-only
    meta): its regression and scale losses are 0, as in JAX."""

    class ConfOnly(headmeta.Cif):
        n_vectors = 0
        n_scales = 0

    meta = ConfOnly('conf', 'test', keypoints=constants.COCO_KEYPOINTS)
    rng = np.random.default_rng(0)
    field = torch.from_numpy(rng.normal(size=(2, 17, 1, 4, 4))
                             .astype(np.float32))
    target = {'conf': torch.from_numpy(
                  (rng.uniform(size=(2, 17, 4, 4)) > 0.8)
                  .astype(np.float32)),
              'conf_mask': torch.ones((2, 17, 4, 4), dtype=torch.bool)}
    conf, reg, scale = losses.CompositeLoss(meta)(field, target)
    assert float(conf) > 0
    assert float(reg) == 0.0 and float(scale) == 0.0


SGD = dict(lr=0.05, momentum=0.9, clip_grad_norm=0.5, weight_decay=1e-3)


def test_two_train_steps(samples, tmp_path):
    ours, _ = samples
    images, targets, _ = datasets.collate_tracking_images_targets_meta(
        ours[:2])
    module, variables, metas = flax_narrow_tracking()
    jax_model = jax_tracking.TrackingModel(
        module, metas, base_stride=16, basenet_name='tshufflenetv2k16',
        variables=jax.tree.map(jnp.copy, variables))
    jax_model.fused_train = False
    jax_trainer = JaxTrainer(jax_model,
                             jax_losses.Factory().factory(metas),
                             configured(JaxOptimizeFactory(), SGD),
                             '/dev/null', ema_decay=0.9)
    state = jax_trainer.init_state(2)
    jax_trainer._build_steps()  # pylint: disable=protected-access
    jax_trainer.n_devices = 1
    x, t = jax_trainer._place(  # pylint: disable=protected-access
        images.permute(0, 2, 3, 1).numpy(),
        [{k: v.numpy() for k, v in d.items()} for d in targets])
    want_totals = []
    for _ in range(2):
        state, total, _ = jax_trainer._train_step(state, x, t)  # pylint: disable=protected-access
        want_totals.append(float(total))
    want = jax_checkpoint.flatten_tree({'params': state.params,
                                        'batch_stats': state.batch_stats})

    model = port_narrow_tracking(jax_checkpoint.flatten_tree(variables))
    model.fused_train = False   # canonical against canonical, as JAX's
    before = {k: v.clone() for k, v in model.module.state_dict().items()}
    trainer = Trainer(model, losses.Factory().factory(model.head_metas),
                      configured(OptimizeFactory(), SGD),
                      str(tmp_path / 'model'))
    trainer.ema_decay = 0.9
    trainer.setup(2)
    totals = [float(trainer.train_step(images, targets)[0])
              for _ in range(2)]
    np.testing.assert_allclose(totals, want_totals, rtol=1e-5)

    want = models.from_jax_variables(want)
    state_dict = model.module.state_dict()
    for key, value in want.items():
        if key.endswith('num_batches_tracked'):
            continue
        if key.endswith(('running_mean', 'running_var')):
            scale = max(1.0, float(value.abs().max()))
            assert float((state_dict[key] - value).abs().max()) <= \
                1e-5 * scale, key
            continue
        delta, want_delta = state_dict[key] - before[key], value - before[key]
        scale = float(want_delta.abs().max())
        assert scale > 0, key
        ulps = 2 * F32_EPS * float(before[key].abs().max())
        assert float((delta - want_delta).abs().max()) <= \
            1e-4 * scale + ulps, key
