"""Multi-dataset training and cifar10 in the port against the JAX package.

- cifar10's synthetic stand-in equals JAX's ``_synthetic_cifar`` bit for
  bit, and the ``--cifar10-root`` reader of the python batches reads the
  same arrays.
- ``--dataset toykp,cifar10``: both packages' ``MultiDataModule`` merge the
  heads (cif, caf, cifdet) and round-robin the loaders; the val batches
  (no augmentation, no shuffle) are equal in order, images, targets (the
  f32 ones within 1e-6) and ``None`` padding, and the train loader
  alternates the two padding patterns.
- One f32 SGD step (nesterov, norm clip, weight decay) of the narrow
  three-head model on a toykp batch, then one on a cifar10 batch, against
  the JAX ``_train_step`` on the same batches: all 9 loss components
  within 1e-5 relative, the cifdet components exactly 0 on the toykp
  batch and the cif and caf components on the cifar10 batch (and the
  cifdet scale component, which CifDet has none of, on both), the
  parameter change within 1e-4 of its largest value per parameter (plus
  2 ulps), the BatchNorm statistics within 1e-5 relative.  The heads
  without targets still move, by weight decay and momentum, as in JAX.
- ``--debug-checks``' finite-loss check in the train step.
- The cifar10 eval: a JAX-written checkpoint of a narrow model with
  cifar10's CifDet head scored by both packages' ``Evaluator`` on the 16
  validation images: the 12 bbox stats within 1e-6.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpifpaf_tpu import datasets as jax_datasets
from openpifpaf_tpu import eval as jax_eval
from openpifpaf_tpu import headmeta as jax_headmeta
from openpifpaf_tpu import losses as jax_losses
from openpifpaf_tpu import models as jax_models
from openpifpaf_tpu import predictor as jax_predictor
from openpifpaf_tpu.decoder.cifdet import CifDet as JaxCifDet
from openpifpaf_tpu.models import checkpoint as jax_checkpoint
from openpifpaf_tpu.models import heads as jax_heads
from openpifpaf_tpu.models import shell as jax_shell
from openpifpaf_tpu.models import shufflenetv2k as jax_sn
from openpifpaf_tpu.plugins.cifar10 import datamodule as jax_cifar10
from openpifpaf_tpu.plugins.toykp import datamodule as jax_toykp
from openpifpaf_tpu.training import OptimizeFactory as JaxOptimizeFactory
from openpifpaf_tpu.training import Trainer as JaxTrainer
from openpifpaf_tpu_torch import (datasets, debug_checks, decoder,
                                  headmeta, losses, models, plugins)
from openpifpaf_tpu_torch import eval as port_eval
from openpifpaf_tpu_torch.plugins import cifar10, toykp
from openpifpaf_tpu_torch.predictor import Predictor
from openpifpaf_tpu_torch.training import OptimizeFactory, Trainer

from test_torch_port_cifdet import (det_meta, flax_three_heads,
                                    port_three_heads, three_head_metas)
from test_torch_port_decode import one_torch_thread  # noqa: F401  (fixture)
from test_torch_port_encoder import assert_targets_equal
from test_torch_port_losses import toykp_batch
from test_torch_port_models import (NARROW, flax_narrow, port_narrow,
                                    random_variables)
from test_torch_port_train import F32_EPS, OPTIMIZERS, configured

plugins.register()


@pytest.fixture
def small_modules(monkeypatch):
    """toykp at 81 px (4 train, 2 val images, no augmentation) and cifar10
    (4 train, 4 val synthetic images), batch 2, in both packages; set on
    the classes themselves (a value another test left on a class shadows
    the base class's)."""
    for cls in (jax_toykp.ToyKp, toykp.ToyKp):
        monkeypatch.setattr(cls, 'with_dense', False)
        monkeypatch.setattr(cls, 'image_size', 81)
        monkeypatch.setattr(cls, 'n_images', 4)
        monkeypatch.setattr(cls, 'n_val_images', 2)
        monkeypatch.setattr(cls, 'augmentation', False)
    for cls in (jax_cifar10.Cifar10, cifar10.Cifar10):
        monkeypatch.setattr(cls, 'root', '/nonexistent-cifar10-root')
        monkeypatch.setattr(cls, 'n_synthetic', 4)
        monkeypatch.setattr(cls, 'n_synthetic_val', 4)
    for cls in (jax_toykp.ToyKp, toykp.ToyKp, jax_cifar10.Cifar10,
                cifar10.Cifar10):
        monkeypatch.setattr(cls, 'batch_size', 2)
        monkeypatch.setattr(cls, 'loader_workers', 0)
    return (jax_datasets.factory('toykp,cifar10'),
            datasets.factory('toykp,cifar10'))


@pytest.mark.parametrize('n, seed', [(64, 0), (16, 1), (5, 7)])
def test_synthetic_cifar_bit_identical(n, seed):
    want_images, want_labels = jax_cifar10._synthetic_cifar(n, seed)  # pylint: disable=protected-access
    images, labels = cifar10.synthetic_cifar(n, seed)
    assert images.dtype == np.uint8 and images.shape == (n, 32, 32, 3)
    np.testing.assert_array_equal(images, want_images)
    np.testing.assert_array_equal(labels, want_labels)


def test_cifar10_root_reader(tmp_path):
    """A directory with python-version batches is read as the JAX package
    reads it (the data then come from it, not from the stand-in)."""
    batch_dir = tmp_path / 'cifar-10-batches-py'
    batch_dir.mkdir()
    rng = np.random.default_rng(0)
    for name in [f'data_batch_{i}' for i in range(1, 6)] + ['test_batch']:
        batch = {b'data': rng.integers(0, 256, (3, 3072), dtype=np.uint8),
                 b'labels': rng.integers(0, 10, 3).tolist()}
        with open(batch_dir / name, 'wb') as f:
            pickle.dump(batch, f)
    for train in (True, False):
        want = jax_cifar10._load_cifar_batches(str(tmp_path), train)  # pylint: disable=protected-access
        got = cifar10.load_cifar_batches(str(tmp_path), train)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
    dm = cifar10.Cifar10()
    dm.root = str(tmp_path)
    images, _ = dm.data(train=True)
    assert images.shape == (15, 32, 32, 3)


def assert_same_train_batch(want, got):
    images_j, targets_j, metas_j = want
    images_p, targets_p, metas_p = got
    np.testing.assert_allclose(images_p.permute(0, 2, 3, 1).numpy(),
                               images_j, atol=1e-6, rtol=0)
    assert [t is None for t in targets_p] == [t is None for t in targets_j]
    for tj, tp in zip(targets_j, targets_p):
        if tj is not None:
            assert_targets_equal(tj, {k: v.numpy() for k, v in tp.items()})
    assert [m['dataset_index'] for m in metas_p] == \
        [m['dataset_index'] for m in metas_j]


def test_multidataset_batches_match_jax(small_modules):
    jax_dm, dm = small_modules
    assert isinstance(dm, datasets.MultiDataModule)
    assert [(type(m).__name__, m.name) for m in dm.head_metas] == \
        [(type(m).__name__, m.name) for m in jax_dm.head_metas] == \
        [('Cif', 'cif'), ('Caf', 'caf'), ('CifDet', 'cifdet')]
    for m in dm.head_metas + jax_dm.head_metas:
        m.base_stride = 16
    want = list(jax_dm.val_loader())
    got = list(dm.val_loader())
    assert len(got) == len(want) == len(dm.val_loader()) == 3
    for w, g in zip(want, got):
        assert_same_train_batch(w, g)
    assert [tuple(t is None for t in b[1]) for b in got] == [
        (False, False, True), (True, True, False), (True, True, False)]
    assert tuple(got[1][0].shape) == (2, 3, 33, 33)
    assert tuple(got[1][1][2]['vec'].shape) == (2, 10, 2, 2, 5, 5)

    patterns = [tuple(t is None for t in b[1]) for b in dm.train_loader()]
    assert patterns == [(False, False, True), (True, True, False)] * 2
    dm.seed = 3
    assert all(m.seed == 3 for m in dm.datamodules)


# ----------------------------------------------------------- train step
def jax_trainer_for(settings, variables):
    metas = three_head_metas(jax_headmeta)
    module, _ = flax_three_heads()
    model = jax_models.Model(module, metas, base_stride=16,
                             basenet_name='shufflenetv2k16',
                             variables=jax.tree.map(jnp.copy, variables))
    model.fused_train = False
    trainer = JaxTrainer(model, jax_losses.Factory().factory(metas),
                         configured(JaxOptimizeFactory(), settings),
                         '/dev/null', ema_decay=0.9)
    state = trainer.init_state(2)
    trainer._build_steps()  # pylint: disable=protected-access
    trainer.n_devices = 1
    return trainer, state


def test_three_head_train_steps_match_jax(small_modules):
    settings = OPTIMIZERS['sgd_nesterov_clip_norm']
    _, dm = small_modules
    for m in dm.head_metas:
        m.base_stride = 16
    batches = [b[:2] for b in dm.val_loader()][:2]   # toykp, then cifar10
    _, variables = flax_three_heads()

    jax_trainer, state = jax_trainer_for(settings, variables)
    want_comps = []
    for images, targets in batches:
        x, t = jax_trainer._place(  # pylint: disable=protected-access
            images.permute(0, 2, 3, 1).numpy(),
            [None if d is None else {k: v.numpy() for k, v in d.items()}
             for d in targets])
        state, _, comps = jax_trainer._train_step(state, x, t)  # pylint: disable=protected-access
        want_comps.append(np.asarray(comps))
    want = models.from_jax_variables(jax_checkpoint.flatten_tree(
        {'params': state.params, 'batch_stats': state.batch_stats}))

    model = port_three_heads(jax_checkpoint.flatten_tree(variables),
                             three_head_metas(headmeta))
    model.fused_train = False   # canonical against canonical, as JAX's
    before = {k: v.clone() for k, v in model.module.state_dict().items()}
    trainer = Trainer(model, losses.Factory().factory(model.head_metas),
                      configured(OptimizeFactory(), settings), '/dev/null')
    trainer.ema_decay = 0.9
    trainer.setup(2)
    for (images, targets), want_c in zip(batches, want_comps):
        total, comps = trainer.train_step(images, targets)
        assert comps.shape == (9,) and np.isfinite(float(total))
        np.testing.assert_allclose(comps.numpy(), want_c, rtol=1e-5,
                                   atol=1e-7)
    # toykp's batch: no cifdet target; cifar10's: no cif and caf targets
    assert want_comps[0][6:].tolist() == [0.0] * 3
    assert want_comps[1][:6].tolist() == [0.0] * 6
    # CifDet has no scale component: its third loss is 0 on every batch
    assert (want_comps[0][:6] > 0).all() and (want_comps[1][6:8] > 0).all()

    state_dict = model.module.state_dict()
    for key, value in want.items():
        if key.endswith('num_batches_tracked'):
            continue
        if key.endswith(('running_mean', 'running_var')):
            scale = max(1.0, float(value.abs().max()))
            assert float((state_dict[key] - value).abs().max()) \
                <= 1e-5 * scale, key
            continue
        delta, want_delta = state_dict[key] - before[key], value - before[key]
        ulps = 2 * F32_EPS * float(before[key].abs().max())
        assert float((delta - want_delta).abs().max()) <= \
            1e-4 * float(want_delta.abs().max()) + ulps, key


# ---------------------------------------------------------------- eval
def det_only_metas(hm):
    meta = det_meta(hm)
    meta.head_index = 0
    return [meta]


@pytest.fixture
def cifar10_checkpoint(tmp_path):
    """A JAX-written checkpoint of the narrow ShuffleNetV2K with cifar10's
    CifDet head (10 x 7, PixelShuffle 2), its confidence bias shifted by +2
    and its box size by +4 cells."""
    module = jax_shell.Shell(
        basenet=jax_sn.ShuffleNetV2K(*NARROW, dtype=jnp.float32),
        head_nets=[jax_heads.CompositeField4(
            meta=m, in_features=64, dtype=jnp.float32)
            for m in det_only_metas(jax_headmeta)])
    flat = jax_checkpoint.flatten_tree(random_variables(module, 2))
    bias = flat['params/head_nets_0/conv/bias'].reshape(10, 7, 2, 2)
    bias[:, 0] += 2.0
    bias[:, 3:5] += 4.0
    path = str(tmp_path / 'cifar10.npz')
    jax_checkpoint.save(path, variables=jax_checkpoint.unflatten_tree(flat),
                        head_metas=det_only_metas(jax_headmeta),
                        basenet_name='shufflenetv2k16', base_stride=16)
    return module, path


def test_cifar10_eval_matches_jax(cifar10_checkpoint, monkeypatch):
    """The seed and instance thresholds are lowered to 0.1 in both
    packages: a random head's splats are each a sixteenth of its
    confidence, so at 0.3 and 0.15 no cell of these fields would be a
    detection."""
    module, path = cifar10_checkpoint
    for cls in (JaxCifDet, decoder.CifDet):
        monkeypatch.setattr(cls, 'seed_threshold', 0.1)
        monkeypatch.setattr(cls, 'instance_threshold', 0.1)
    for cls in (jax_cifar10.Cifar10, cifar10.Cifar10):
        monkeypatch.setattr(cls, 'root', '/nonexistent-cifar10-root')
        monkeypatch.setattr(cls, 'batch_size', 8)
        monkeypatch.setattr(cls, 'loader_workers', 0)
    header, variables = jax_checkpoint.load(path)
    jax_model = jax_models.Model(module, header['head_metas'],
                                 base_stride=16, variables=variables)
    want = jax_eval.Evaluator(jax_cifar10.Cifar10(), jax_predictor.Predictor(
        model=jax_model)).run()

    port_header, flat = models.checkpoint.load(path)
    meta, = port_header['head_metas']
    shell = models.Shell(models.ShuffleNetV2K(*NARROW),
                         [models.CompositeField4(meta, 64)])
    shell.load_state_dict(models.from_jax_variables(flat), strict=True)
    model = models.Model(shell, [meta], base_stride=16,
                         device=torch.device('cpu'), bf16=False)
    evaluator = port_eval.Evaluator(cifar10.Cifar10(),
                                    Predictor(model=model, device='cpu'))
    got = evaluator.run()
    assert got['text_labels'] == want['text_labels']
    assert len(got['stats']) == 12 and got['n_images'] == 16
    np.testing.assert_allclose(got['stats'], want['stats'], atol=1e-6,
                               rtol=0)
    predictions = evaluator.metrics[0].predictions
    assert len(predictions) >= 16
    assert {p['category'] for p in predictions} <= set(cifar10.CATEGORIES)


def test_finite_loss_check(monkeypatch):
    """``--debug-checks``: a NaN pixel makes the training loss non-finite,
    and the train step raises before the optimizer moves."""
    _, variables, _ = flax_narrow()
    model = port_narrow(jax_checkpoint.flatten_tree(variables))
    images, targets = toykp_batch(65)
    images[0, 0, 5, 5] = float('nan')
    trainer = Trainer(model, losses.Factory().factory(model.head_metas),
                      OptimizeFactory(), '/dev/null')
    trainer.setup(1)
    before = [p.clone() for p in model.module.parameters()]
    monkeypatch.setattr(debug_checks, '_ENABLED', True)
    with pytest.raises(debug_checks.DebugCheckError, match='training loss'):
        trainer.train_step(images, targets)
    assert all(torch.equal(a, b)
               for a, b in zip(before, model.module.parameters()))
