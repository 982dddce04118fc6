"""Head transfer and the head options of the port against the JAX package.

- ``models.factory(checkpoint=..., head_metas=...)`` on a JAX-written
  single-frame npz (a narrow ShuffleNetV2K registered under a test name in
  both packages): to tracking heads (the backbone, CIF and CAF transfer,
  TCAF is fresh) and to heads of other keypoints (same names, other
  shapes: fresh); the same transferred and fresh modules as JAX's
  ``Factory.transfer`` names in its log line, the transferred tensors
  exact, the epoch 0 (as ``tests/test_nets.py:129`` holds JAX's).
- A checkpoint with a head name of two datasets: the same warning as JAX.
- ``--head-dropout``: the identity in eval mode; in train mode the kept
  entries scaled by 1/(1-p), about p of them zero.
- ``--cross-talk``: the train forward of a narrow ``Shell`` equal to the
  JAX ``Shell``'s (batch statistics, f32, within 1e-4 of scale); no effect
  on a tracking shell, as JAX builds it without one.
- ``--head-upsample-stride 2``: the factory's forward equal to JAX's.
- The three flags' defaults equal JAX's; the train CLI on ``toykpst``
  from a single-frame checkpoint with ``--head-dropout`` and
  ``--cross-talk`` takes one step on the canonical graph and writes
  tracking heads.
"""

import argparse
import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpifpaf_tpu import headmeta as jax_headmeta
from openpifpaf_tpu import models as jax_models
from openpifpaf_tpu.models import base as jax_base
from openpifpaf_tpu.models import checkpoint as jax_checkpoint
from openpifpaf_tpu.models import heads as jax_heads
from openpifpaf_tpu.models import shell as jax_shell
from openpifpaf_tpu.models import shufflenetv2k as jax_sn
from openpifpaf_tpu.models import tracking_base as jax_tracking
from openpifpaf_tpu.plugins.posetrack.cocokpst import \
    tracking_head_metas as jax_tracking_head_metas
from openpifpaf_tpu_torch import headmeta, models, training
from openpifpaf_tpu_torch import train as port_train
from openpifpaf_tpu_torch.models import base, checkpoint, fused_shufflenet
from openpifpaf_tpu_torch.models import shufflenetv2k
from openpifpaf_tpu_torch.plugins.crowdpose import constants as crowdpose
from openpifpaf_tpu_torch.plugins.posetrack import ToyKpSt

from test_torch_port_models import NARROW, coco_metas, flax_narrow
from test_torch_port_predict import NARROW_NAME, narrow_spec
from test_torch_port_tracking_model import head_metas as toykpst_metas

HW = (65, 81)
TOL = 1e-4
CROSS_TALK = 0.2
FACTORY_LOG = {'jax': 'openpifpaf_tpu.models.factory',
               'port': 'openpifpaf_tpu_torch.models.factory'}


@pytest.fixture(name='narrow_registered')
def fixture_narrow_registered(monkeypatch):
    """The narrow backbone under ``NARROW_NAME`` in both registries."""
    monkeypatch.setitem(jax_base.BASE_FACTORIES, NARROW_NAME,
                        narrow_spec(jax_base, jax_sn))
    monkeypatch.setitem(base.BASE_FACTORIES, NARROW_NAME,
                        narrow_spec(base, shufflenetv2k))


@pytest.fixture(name='jitted_init')
def fixture_jitted_init(monkeypatch):
    """JAX's ``Model.init`` and ``TrackingModel.init`` through ``jax.jit``:
    the same variables as the eager init that ``Factory.transfer`` calls,
    in a third of its CPU time."""
    def jitted(batch):
        def init(self, rng, input_hw=(81, 81)):
            dummy = jnp.zeros((batch, *input_hw, 3), jnp.float32)
            self.variables = jax.jit(functools.partial(
                self.module.init, train=False))(rng, dummy)
            return self.variables
        return init

    monkeypatch.setattr(jax_shell.Model, 'init', jitted(1))
    monkeypatch.setattr(jax_tracking.TrackingModel, 'init', jitted(2))


@pytest.fixture(scope='module', name='single_frame')
def fixture_single_frame(tmp_path_factory):
    """A JAX-written npz of the narrow backbone with CIF and CAF heads."""
    _, variables, metas = flax_narrow(seed=4)
    path = str(tmp_path_factory.mktemp('transfer') / 'single.npz')
    jax_checkpoint.save(path, variables=variables, head_metas=metas,
                        basenet_name=NARROW_NAME, base_stride=16, epoch=7)
    return path


def crowdpose_metas(hm):
    """Heads of the same names, 14 keypoints: other shapes."""
    kw = dict(keypoints=crowdpose.KEYPOINTS, sigmas=crowdpose.SIGMAS,
              pose=crowdpose.UPRIGHT_POSE)
    return [hm.Cif('cif', 'crowdpose', draw_skeleton=crowdpose.SKELETON,
                   **kw),
            hm.Caf('caf', 'crowdpose', skeleton=crowdpose.SKELETON, **kw)]


def factory_messages(caplog, package):
    return [(r.levelname, r.getMessage()) for r in caplog.records
            if r.name == FACTORY_LOG[package]]


def transfer_message(transferred, fresh):
    return ('WARNING', f'transfer learning: {transferred} from checkpoint; '
            f'FRESH (random) weights: {fresh}')


def test_transfer_to_tracking_matches_jax(single_frame, narrow_registered,
                                          jitted_init, caplog):
    caplog.set_level(logging.INFO)
    want = jax_models.Factory(checkpoint=single_frame, bf16=False).factory(
        head_metas=toykpst_metas(jax_tracking_head_metas),
        rng=jax.random.key(1))
    model = models.factory(checkpoint=single_frame,
                           head_metas=toykpst_metas(), device='cpu',
                           bf16=False, seed=1)
    assert factory_messages(caplog, 'port') == \
        factory_messages(caplog, 'jax')
    assert factory_messages(caplog, 'port')[-1] == transfer_message(
        ['basenet', 'head_nets_0 (cif)', 'head_nets_1 (caf)'],
        ['head_nets_2 (tcaf)'])
    assert model.epoch == want.epoch == 0
    assert isinstance(model, models.TrackingModel)
    assert type(want).__name__ == 'TrackingModel'
    assert [(type(m).__name__, m.dataset, m.name)
            for m in model.head_metas] == \
        [(type(m).__name__, m.dataset, m.name) for m in want.head_metas]

    _, flat = checkpoint.load(single_frame)
    old = models.from_jax_variables(flat)
    state = model.module.state_dict()
    fresh_shapes = models.from_jax_variables(
        jax_checkpoint.flatten_tree(jax.tree.map(np.asarray,
                                                 want.variables)))
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in fresh_shapes.items()}
    for key, value in state.items():
        if not key.startswith('head_nets.2.'):
            torch.testing.assert_close(value, old[key], rtol=0, atol=0)


def test_heads_of_other_shapes_are_fresh(single_frame, narrow_registered,
                                         caplog):
    """Heads of the same names but 14 keypoints: the backbone transfers,
    the heads keep their fresh weights (JAX's rule: every shape must
    agree)."""
    caplog.set_level(logging.INFO)
    model = models.factory(checkpoint=single_frame,
                           head_metas=crowdpose_metas(headmeta),
                           device='cpu', bf16=False, seed=1)
    assert factory_messages(caplog, 'port')[-1] == transfer_message(
        ['basenet'], ['head_nets_0 (cif)', 'head_nets_1 (caf)'])
    _, flat = checkpoint.load(single_frame)
    old = models.from_jax_variables(flat)
    fresh, _ = models.build_shell(NARROW_NAME, crowdpose_metas(headmeta))
    models.init_weights(fresh, torch.Generator().manual_seed(1))
    for key, value in model.module.state_dict().items():
        want = old[key] if key.startswith('basenet.') else \
            fresh.state_dict()[key]
        torch.testing.assert_close(value, want, rtol=0, atol=0)


def test_ambiguous_head_name_warns(tmp_path, narrow_registered, jitted_init,
                                   caplog):
    """A checkpoint with CIF heads of two datasets grafted onto a third:
    the first is taken, with JAX's warning."""
    metas = coco_metas() + [coco_metas()[0]]
    metas[2].dataset = 'other'
    model = models.factory(NARROW_NAME, metas, device='cpu', bf16=False)
    path = str(tmp_path / 'two_datasets.npz')
    checkpoint.save(path, variables=models.to_jax_variables(
        model.module.state_dict()), head_metas=model.head_metas,
        basenet_name=NARROW_NAME, base_stride=16)
    caplog.set_level(logging.INFO)
    jax_models.Factory(checkpoint=path, bf16=False).factory(
        head_metas=toykpst_metas(jax_tracking_head_metas),
        rng=jax.random.key(0))
    got = models.factory(checkpoint=path, head_metas=toykpst_metas(),
                         device='cpu', bf16=False)
    warning = ('WARNING', "head 'cif' matches several checkpoint heads; "
               'transferring the first (head_nets_0)')
    assert factory_messages(caplog, 'port') == \
        factory_messages(caplog, 'jax')
    assert factory_messages(caplog, 'port')[1] == warning
    torch.testing.assert_close(got.module.head_nets[0].conv.weight,
                               model.module.head_nets[0].conv.weight,
                               rtol=0, atol=0)


def test_head_dropout():
    meta = coco_metas()[0]
    torch.manual_seed(0)
    head = models.CompositeField4(meta, 64, dropout_rate=0.25)
    plain = models.CompositeField4(meta, 64)
    plain.load_state_dict(head.state_dict())
    x = torch.randn(2, 64, 24, 24)
    head.eval()
    torch.testing.assert_close(head(x), plain(x), rtol=0, atol=0)
    seen = []
    head.conv.register_forward_hook(lambda m, args, out: seen.append(args[0]))
    head.train()
    head(x)
    dropped = seen[0]
    kept = dropped != 0
    torch.testing.assert_close(dropped[kept], x[kept] / 0.75)
    assert abs(1.0 - float(kept.float().mean()) - 0.25) < 0.01


def port_shell(flat, cross_talk, metas):
    shell = models.Shell(models.ShuffleNetV2K(*NARROW),
                         [models.CompositeField4(m, 64) for m in metas],
                         cross_talk=cross_talk)
    shell.load_state_dict(models.from_jax_variables(flat), strict=True)
    return shell


def test_cross_talk_train_forward_matches_jax():
    _, variables, metas = flax_narrow(seed=2)
    shell = jax_shell.Shell(
        basenet=jax_sn.ShuffleNetV2K(*NARROW),
        head_nets=[jax_heads.CompositeField4(meta=m, in_features=64)
                   for m in metas], cross_talk=CROSS_TALK)
    x = np.random.default_rng(0).normal(size=(3, *HW, 3)).astype(np.float32)
    want, _ = jax.jit(lambda v, xx: shell.apply(
        v, xx, train=True, mutable=['batch_stats']))(variables, x)
    flat = jax_checkpoint.flatten_tree(variables)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2))
    outs = {}
    for cross_talk in (0.0, CROSS_TALK):
        port = port_shell(flat, cross_talk, coco_metas())
        port.eval()     # eval mode: no cross-talk
        eval_out = [o.detach() for o in port(xt)]
        port.train()
        outs[cross_talk] = [o.detach() for o in port(xt)], eval_out
    for g, w in zip(outs[CROSS_TALK][0], want):
        w = np.asarray(w)
        assert float(np.abs(g.numpy() - w).max()) <= \
            TOL * max(1.0, float(np.abs(w).max()))
    assert not torch.allclose(outs[0.0][0][0], outs[CROSS_TALK][0][0])
    torch.testing.assert_close(outs[0.0][1][0], outs[CROSS_TALK][1][0],
                               rtol=0, atol=0)


def test_cross_talk_leaves_a_tracking_shell(narrow_registered):
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(4, 3, *HW)).astype(np.float32))
    outs = []
    for cross_talk in (0.0, 0.3):
        torch.manual_seed(0)
        shell, _ = models.build_shell(NARROW_NAME, toykpst_metas(),
                                      cross_talk=cross_talk)
        assert isinstance(shell, models.TrackingShell)
        models.init_weights(shell, torch.Generator().manual_seed(0))
        shell.train()
        outs.append([o.detach() for o in shell(x)])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_head_upsample_stride_matches_jax(narrow_registered):
    """``factory(upsample_stride=2)`` raises the heads' PixelShuffle factor
    (``max`` with the meta's, ``factory.py:146-147``): its forward on the
    weights of the JAX heads built with stride 2."""
    module, variables, _ = flax_narrow(upsample_stride=2, seed=5)
    model = models.factory(NARROW_NAME, coco_metas(), device='cpu',
                           bf16=False, upsample_stride=2)
    assert [m.upsample_stride for m in model.head_metas] == [2, 2]
    assert [m.stride for m in model.head_metas] == [8, 8]
    model.module.load_state_dict(models.from_jax_variables(
        jax_checkpoint.flatten_tree(variables)), strict=True)
    model.refold()
    x = np.random.default_rng(2).normal(size=(2, *HW, 3)).astype(np.float32)
    want = jax.jit(lambda v, xx: module.apply(v, xx, train=False))(
        variables, x)
    got = model(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert float(np.abs(g.numpy() - w).max()) <= \
            TOL * max(1.0, float(np.abs(w).max()))


def test_network_flag_defaults():
    jax_parser, parser = argparse.ArgumentParser(), argparse.ArgumentParser()
    jax_models.Factory.cli(jax_parser)
    models.network_cli(parser.add_argument_group('network configuration'))
    want, got = vars(jax_parser.parse_args([])), vars(parser.parse_args([]))
    assert got == {k: want[k] for k in ('head_dropout', 'head_upsample_stride',
                                        'cross_talk')}
    assert models.network_options(parser.parse_args(
        ['--head-dropout=0.1', '--cross-talk=0.2',
         '--head-upsample-stride=2'])) == \
        dict(head_dropout=0.1, cross_talk=0.2, upsample_stride=2)


def test_train_cli_transfers_to_toykpst(single_frame, narrow_registered,
                                        tmp_path, monkeypatch, caplog):
    """One toykpst step from the single-frame checkpoint with dropout and
    cross-talk: the trainer's forward is the canonical graph (the fused
    plans are refused), and the checkpoint holds the tracking heads."""
    def refused(*args, **kwargs):
        raise AssertionError('the fused plan ran in training')

    monkeypatch.setattr(fused_shufflenet, 'fold', refused)
    for cls in (ToyKpSt, training.Trainer, training.OptimizeFactory):
        for name, value in list(vars(cls).items()):
            if not name.startswith('__') and not callable(value) \
                    and not isinstance(value, (classmethod, staticmethod)):
                monkeypatch.setattr(cls, name, value)
    caplog.set_level(logging.INFO)
    out = str(tmp_path / 'tracking')
    assert port_train.main([
        '--device=cpu', '--dataset=toykpst', f'--checkpoint={single_frame}',
        '--toykpst-image-size=65', '--toykpst-n-images=2', '--batch-size=2',
        '--epochs=1', '--no-bf16', '--head-dropout=0.1', '--cross-talk=0.2',
        '--loader-workers=0', '-o', out]) == 0
    assert factory_messages(caplog, 'port')[1:] == [
        ('WARNING', "transfer learning: ['basenet', 'head_nets_0 (cif)', "
         "'head_nets_1 (caf)'] from checkpoint; FRESH (random) weights: "
         "['head_nets_2 (tcaf)']")]
    header, flat = checkpoint.load(out + '.npz')
    assert [(type(m).__name__, m.name) for m in header['head_metas']] == \
        [('Cif', 'cif'), ('Caf', 'caf'), ('Tcaf', 'tcaf')]
    assert header['basenet'] == NARROW_NAME and header['epoch'] == 1
    assert all(np.isfinite(v).all() for v in flat.values())
