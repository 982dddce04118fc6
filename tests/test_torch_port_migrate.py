"""The port's upstream-checkpoint converter and migrate CLI against the JAX
package's.

- Upstream torch state dicts written by JAX's ``to_torch_state_dict`` from
  narrow ShuffleNetV2K (with CIF and CAF heads), ResNet and Swin
  variables, read by the port's ``convert_state_dict``: the port's forward
  within 1e-5 of the output scale of JAX's on the same variables.
- The port's ``to_torch_state_dict``: JAX's keys and arrays, and back to
  the same flat variables; an unknown trunk raises JAX's ``ValueError``.
- ``python -m openpifpaf_tpu_torch.migrate --from-torch`` (in this
  process, the narrow backbone registered under a test name) on a
  ``torch.save``d state dict: an npz whose header names its source, which
  JAX's ``Factory(checkpoint=...)`` loads to the forward of the original
  variables; ``load_torch_checkpoint`` on a state dict, a whole module and
  ``{'model': ...}``.
- ``migrate_npz`` on a ``format_version`` 0 file: the same file as JAX's
  (``strip_module_prefixes``); a current file is left alone.
"""

import json

import jax
import numpy as np
import pytest
import torch

from openpifpaf_tpu import migrate as jax_migrate
from openpifpaf_tpu import models as jax_models
from openpifpaf_tpu.models import base as jax_base
from openpifpaf_tpu.models import checkpoint as jax_checkpoint
from openpifpaf_tpu.models import converter as jax_converter
from openpifpaf_tpu.models import resnet as jax_resnet
from openpifpaf_tpu.models import shufflenetv2k as jax_sn
from openpifpaf_tpu.models import swin as jax_swin
from openpifpaf_tpu_torch import migrate, models
from openpifpaf_tpu_torch.models import base, checkpoint, converter
from openpifpaf_tpu_torch.models import model_migration, resnet
from openpifpaf_tpu_torch.models import shufflenetv2k, swin

from test_torch_port_backbones_cnn import (backbone_variables, jax_forward,
                                           port_backbone, port_forward)
from test_torch_port_models import flax_narrow, port_narrow
from test_torch_port_predict import NARROW_NAME, narrow_spec

TOL = 1e-5      # of the output scale
SWIN = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8))
ODD = 49


def close(got, want):
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= TOL * scale


def tree(flat):
    return jax_checkpoint.unflatten_tree(dict(flat))


def narrow_flat(seed=0):
    _, variables, _ = flax_narrow(seed=seed)
    return jax_checkpoint.flatten_tree(variables)


def shell_forward(module, variables, x):
    return [np.asarray(o) for o in jax.jit(
        lambda v, xx: module.apply(v, xx, train=False))(variables, x)]


def test_shufflenet_state_dict_from_jax():
    module, variables, _ = flax_narrow(seed=1)
    state_dict = jax_converter.to_torch_state_dict(
        variables, basenet_name='shufflenetv2k16')
    assert 'head_nets.1.conv.weight' in state_dict
    model = port_narrow(converter.convert_state_dict(
        state_dict, basenet_name='shufflenetv2k16'))
    x = np.random.default_rng(0).normal(size=(2, 65, 81, 3)).astype(
        np.float32)
    want = shell_forward(module, variables, x)
    got = model.apply(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    for g, w in zip(got, want):
        close(g.numpy(), w)


@pytest.mark.parametrize('name', ['resnet50', 'swin_t'])
def test_backbone_state_dict_from_jax(name):
    jax_net, net = {
        'resnet50': (jax_resnet.ResNet((1, 1, 1, 1)),
                     resnet.ResNet((1, 1, 1, 1))),
        'swin_t': (jax_swin.Swin(**SWIN), swin.Swin(**SWIN))}[name]
    flat = backbone_variables(jax_net, seed=2)
    state_dict = jax_converter.to_torch_state_dict(tree(flat),
                                                   basenet_name=name)
    net = port_backbone(net, converter.convert_state_dict(
        state_dict, basenet_name=name))
    x = np.random.default_rng(3).normal(size=(2, ODD, ODD, 3)).astype(
        np.float32)
    close(port_forward(net, x), jax_forward(jax_net, flat, x))


@pytest.mark.parametrize('name', ['shufflenetv2k16', 'resnet50', 'swin_t'])
def test_to_torch_state_dict_matches_jax(name):
    flat = narrow_flat() if name == 'shufflenetv2k16' else backbone_variables(
        {'resnet50': jax_resnet.ResNet((1, 1, 1, 1)),
         'swin_t': jax_swin.Swin(**SWIN)}[name])
    want = jax_converter.to_torch_state_dict(tree(flat), basenet_name=name)
    got = converter.to_torch_state_dict(flat, basenet_name=name)
    assert list(got) == list(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    back = converter.convert_state_dict(got, basenet_name=name)
    assert set(back) == set(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


def test_unknown_basenet_raises_as_jax():
    for fn in ('convert_state_dict', 'to_torch_state_dict'):
        with pytest.raises(ValueError) as want:
            getattr(jax_converter, fn)({}, basenet_name='mobilenetv2')
        with pytest.raises(ValueError) as got:
            getattr(converter, fn)({}, basenet_name='mobilenetv2')
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match='no torch mapping'):
        converter.to_torch_state_dict(
            {'params/basenet/nowhere/kernel': np.zeros((1, 1))},
            basenet_name='resnet50')


def test_migrate_from_torch(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(jax_base.BASE_FACTORIES, NARROW_NAME,
                        narrow_spec(jax_base, jax_sn))
    monkeypatch.setitem(base.BASE_FACTORIES, NARROW_NAME,
                        narrow_spec(base, shufflenetv2k))
    module, variables, _ = flax_narrow(seed=1)
    state_dict = converter.to_torch_state_dict(
        jax_checkpoint.flatten_tree(variables), basenet_name=NARROW_NAME)
    source = str(tmp_path / 'upstream.pt')
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in state_dict.items()}, source)
    out = str(tmp_path / 'converted.npz')
    assert migrate.main(['--from-torch', source, '--basenet', NARROW_NAME,
                         '--dataset', 'cocokp', '--output', out, '-q']) == 0
    assert capsys.readouterr().out.strip() == out

    header, _ = checkpoint.load(out)
    assert header['extra'] == {'converted_from': source}
    assert header['basenet'] == NARROW_NAME and header['base_stride'] == 16
    assert [(m.dataset, m.name) for m in header['head_metas']] == \
        [('cocokp', 'cif'), ('cocokp', 'caf')]
    loaded = jax_models.Factory(checkpoint=out, bf16=False).factory()
    x = np.random.default_rng(4).normal(size=(1, 33, 33, 3)).astype(
        np.float32)
    want = shell_forward(module, variables, x)
    for g, w in zip(shell_forward(loaded.module, loaded.variables, x), want):
        np.testing.assert_allclose(g, w, atol=1e-6)
    port = models.factory(checkpoint=out, device='cpu', bf16=False)
    for g, w in zip(port.apply(torch.from_numpy(x.transpose(0, 3, 1, 2))),
                    want):
        close(g.numpy(), w)


def test_load_torch_checkpoint_forms(tmp_path):
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 1), torch.nn.BatchNorm2d(4))
    forms = {'state_dict': net.state_dict(), 'module': net,
             'model_dict': {'model': net, 'epoch': 3},
             'model_state': {'model': net.state_dict()}}
    for name, data in forms.items():
        path = str(tmp_path / f'{name}.pt')
        torch.save(data, path)
        got = converter.load_torch_checkpoint(path)
        want = jax_converter.load_torch_checkpoint(path)
        assert list(got) == list(want) == list(net.state_dict())
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])


def write_npz(path, flat, header):
    flat = dict(flat)
    flat['__meta__'] = np.frombuffer(json.dumps(header).encode('utf-8'),
                                     dtype=np.uint8).copy()
    np.savez(path, **flat)


def read_npz(path):
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    return flat, json.loads(bytes(flat.pop('__meta__')).decode('utf-8'))


def test_migrate_format_version_0(tmp_path):
    flat = {'params/module./head_nets_0/conv/bias': np.arange(3.0),
            'params/basenet/conv1/kernel': np.ones((1, 1, 3, 2))}
    header = {'format_version': 0, 'basenet': 'shufflenetv2k16',
              'base_stride': 16, 'epoch': 2, 'head_metas': []}
    old = str(tmp_path / 'old.npz')
    write_npz(old, flat, header)
    outs = {p: str(tmp_path / f'{p}.npz') for p in ('jax', 'port')}
    assert jax_migrate.migrate_npz(old, outs['jax']) == outs['jax']
    assert migrate.migrate_npz(old, outs['port']) == outs['port']
    want, got = read_npz(outs['jax']), read_npz(outs['port'])
    assert got[1] == want[1]
    assert got[1]['format_version'] == model_migration.CURRENT_FORMAT_VERSION
    assert sorted(got[0]) == sorted(want[0]) == [
        'params/basenet/conv1/kernel', 'params/head_nets_0/conv/bias']
    for key in want[0]:
        np.testing.assert_array_equal(got[0][key], want[0][key])
    # a current file is left alone; the CLI migrates in place
    assert migrate.migrate_npz(outs['port']) == outs['port']
    assert migrate.main([old, '-q']) == 0
    assert read_npz(old)[1] == want[1]
