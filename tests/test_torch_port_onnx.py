"""The port's native ONNX export against the JAX package's, on the CPU.

For each case of ``tests/test_onnx_export.py`` (upsample 1 and 2, ResNet,
the nine bases of ``:98-101``, a CifDet head; at narrow configurations of
each family, 33 px) the same flax variables, drawn from a numpy seed with
BatchNorm away from the identity, go into the JAX ``Model`` and, through
``from_jax_variables``, into the port's (their names and shapes are the
port's through ``to_jax_variables``, which the bridge tests hold to
flax's).  Then:

- the port's artifact, parsed, equals JAX's: the same nodes in the same
  order with the same attributes, inputs and outputs, and the same
  initializers bit for bit.  BoTNet's two relative-position tables resized
  to the map are the one exception: each package bakes them with its own
  resize (``jax.image.resize`` against the port module's
  ``linear_resize_matrix``), so they are held within 1e-6;
- the port's interpreter (``onnx_native.execute_model``, torch) equals
  JAX's interpreter within 1e-5 of the output scale;
- the port's interpreter equals the port's forward (``Model.__call__``)
  within 1e-3.

Also the unsupported basenet and norm, the CLI with ``--verify`` against
the JAX exporter on the same checkpoint, and the initializers' dtypes and
layout.
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from openpifpaf_tpu import headmeta as jax_headmeta
from openpifpaf_tpu import models as jax_models
from openpifpaf_tpu import onnx_native as jax_onnx
from openpifpaf_tpu.models import botnet as jax_botnet
from openpifpaf_tpu.models import effnetv2 as jax_effnetv2
from openpifpaf_tpu.models import heads as jax_heads
from openpifpaf_tpu.models import hrformer as jax_hrformer
from openpifpaf_tpu.models import mobilenet as jax_mobilenet
from openpifpaf_tpu.models import resnet as jax_resnet
from openpifpaf_tpu.models import shell as jax_shell
from openpifpaf_tpu.models import shufflenetv2k as jax_sn
from openpifpaf_tpu.models import squeezenet as jax_squeezenet
from openpifpaf_tpu.models import swin as jax_swin
from openpifpaf_tpu.models import xcit as jax_xcit
from openpifpaf_tpu_torch import headmeta, models, onnx_native
from openpifpaf_tpu_torch.models import botnet, checkpoint, effnetv2
from openpifpaf_tpu_torch.models import hrformer, mobilenet, resnet
from openpifpaf_tpu_torch.models import squeezenet, swin, xcit

from test_torch_port_backbones_cnn import MBV2_CONFIG, MBV3_CONFIG, RAW_FILL, X1
from test_torch_port_models import NARROW, coco_metas

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (33, 33)
INTERPRETER_TOL = 1e-5    # of the output scale
FORWARD_TOL = 1e-3
RESIZED = ('_resized',)   # BoTNet's baked tables (see the docstring)
# the backbone tests' narrow EffNetV2 without its fused block of expansion 1
# whose width differs from its input's: both emitters take such a block's
# configured width for its output's
EFFNET_CONFIG = (('fused', 1, 24, 2, 1), ('fused', 4, 32, 1, 2),
                 ('mbconv', 4, 48, 2, 2), ('mbconv', 6, 64, 1, 2))

# name -> (JAX backbone, port backbone, out_features), each at a narrow
# configuration of the family (``test_torch_port_backbones_*.py``'s)
BASES = {
    'shufflenetv2k': (lambda: jax_sn.ShuffleNetV2K(*NARROW),
                      lambda: models.ShuffleNetV2K(*NARROW), 64),
    'resnet': (lambda: jax_resnet.ResNet((1, 1, 1, 1)),
               lambda: resnet.ResNet((1, 1, 1, 1)), 2048),
    'mobilenetv2': (
        lambda: jax_mobilenet.MobileNetV2(config=MBV2_CONFIG,
                                          out_channels=128),
        lambda: mobilenet.MobileNetV2(config=MBV2_CONFIG, out_channels=128),
        128),
    'squeezenet': (jax_squeezenet.SqueezeNet, squeezenet.SqueezeNet, 512),
    'mobilenetv3large': (
        lambda: jax_mobilenet.MobileNetV3(config=MBV3_CONFIG, out_channels=96),
        lambda: mobilenet.MobileNetV3(config=MBV3_CONFIG, out_channels=96),
        96),
    'effnetv2s': (
        lambda: jax_effnetv2.EffNetV2(config=EFFNET_CONFIG, out_channels=96),
        lambda: effnetv2.EffNetV2(config=EFFNET_CONFIG, out_channels=96), 96),
    'botnet': (lambda: jax_botnet.BotNet((1, 1, 1, 1)),
               lambda: botnet.BotNet((1, 1, 1, 1)), 2048),
    'swin_t': (
        lambda: jax_swin.Swin(embed_dim=32, depths=(2, 2, 2, 2),
                              num_heads=(1, 2, 4, 8)),
        lambda: swin.Swin(embed_dim=32, depths=(2, 2, 2, 2),
                          num_heads=(1, 2, 4, 8)), 256),
    'xcit_small_12': (
        lambda: jax_xcit.XCiT(embed_dim=64, depth=2, num_heads=8),
        lambda: xcit.XCiT(embed_dim=64, depth=2, num_heads=8), 64),
    'hrformer_s': (
        lambda: jax_hrformer.HRFormer(base_channels=8, num_modules=(1, 1, 1),
                                      blocks_per_module=1),
        lambda: hrformer.HRFormer(base_channels=8, num_modules=(1, 1, 1),
                                  blocks_per_module=1), 160),
    'shufflenetv2x1': (lambda: jax_sn.ShuffleNetV2K(*X1, kernel_size=3),
                       lambda: models.ShuffleNetV2K(*X1, 3), 1024),
}


@pytest.fixture(autouse=True)
def restore_torch_threads():
    """Some tests here run on one torch thread: give the count back, so
    that the files this worker runs next keep theirs."""
    threads = torch.get_num_threads()
    yield
    torch.set_num_threads(threads)


def cifdet_metas(hm):
    return [hm.CifDet('cifdet', 'testexport',
                      categories=['person', 'car', 'dog'])]


def shell_variables(shell, seed=0):
    """Flat flax variables for a port Shell from a numpy seed, under the
    names and in the layouts of ``to_jax_variables`` (flax's: the bridge
    tests hold them to flax's own for every backbone, and JAX's emitters
    index them): kernels of variance 1/fan_in, norm scales in [0.8, 1.2],
    biases and means N(0, 0.05), variances in [0.5, 1.5], the raw
    parameters by ``RAW_FILL``."""
    rng = np.random.default_rng(seed)

    def fill(key, shape):
        name = key.rsplit('/', 1)[1]
        if name in RAW_FILL:
            value = RAW_FILL[name](rng, shape)
        elif name == 'kernel':
            value = rng.normal(0.0, 1.0 / np.sqrt(np.prod(shape[:-1])), shape)
        elif name == 'var':
            value = rng.uniform(0.5, 1.5, shape)
        elif name == 'scale':
            value = rng.uniform(0.8, 1.2, shape)
        else:                                   # bias, mean
            value = rng.normal(0.0, 0.05, shape)
        return value.astype(np.float32)

    return {key: fill(key, value.shape) for key, value in
            models.to_jax_variables(shell.state_dict()).items()}


def nested(flat):
    """``params/basenet/conv1/kernel`` keys -> flax's nested variables."""
    tree = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split('/')
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def model_pair(base, metas_of=coco_metas, upsample=1):
    """(JAX model, port model) of one backbone and the heads ``metas_of``
    gives, with the same variables, carried into the port by
    ``from_jax_variables``."""
    jax_base, port_base, features = BASES[base]
    jax_metas = metas_of(jax_headmeta)
    metas = metas_of(headmeta)
    for m in jax_metas + metas:
        m.upsample_stride = upsample
    shell = models.Shell(port_base(),
                         [models.CompositeField4(m, features) for m in metas])
    flat = shell_variables(shell)
    shell.load_state_dict(models.from_jax_variables(flat), strict=True)
    port = models.Model(shell, metas, base_stride=16,
                        device=torch.device('cpu'), bf16=False)
    module = jax_shell.Shell(
        basenet=jax_base(),
        head_nets=[jax_heads.CompositeField4(meta=m, in_features=features)
                   for m in jax_metas])
    jax_model = SimpleNamespace(module=module, variables=nested(flat),
                                head_metas=jax_metas)
    return jax_model, port


def assert_same_graph(got, want):
    """Parsed artifacts: the same nodes, attributes, inputs, outputs and
    initializers (bit for bit but for ``RESIZED``)."""
    for key in ('ir_version', 'opset', 'inputs', 'outputs'):
        assert got[key] == want[key], key
    assert len(got['nodes']) == len(want['nodes'])
    for i, (g, w) in enumerate(zip(got['nodes'], want['nodes'])):
        assert g == w, (i, g['op_type'], w['op_type'])
    assert list(got['initializers']) == list(want['initializers'])
    for name, w in want['initializers'].items():
        g = got['initializers'][name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name.endswith(RESIZED):
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
        else:
            assert np.array_equal(g, w), name


def hold(jax_model, port, input_hw=HW):
    """Artifacts equal; interpreters equal; the port's interpreter equal
    to the port's forward.  Returns the parsed port artifact."""
    torch.set_num_threads(1)
    want = jax_onnx.parse_model(
        jax_onnx.build_model_graph(jax_model, input_hw=input_hw))
    got = onnx_native.parse_model(
        onnx_native.build_model_graph(port, input_hw=input_hw))
    assert got['opset'] == onnx_native.OPSET_VERSION == 13
    assert got['ir_version'] == onnx_native.IR_VERSION == 8
    assert got['inputs'][0] == {'name': 'input', 'shape': [1, 3, *input_hw]}
    assert_same_graph(got, want)

    x = np.random.default_rng(0).normal(size=(1, 3, *input_hw)) \
        .astype(np.float32)
    jax_out = jax_onnx.execute_model(want, {'input': x})
    port_out = onnx_native.execute_model(got, {'input': x})
    forward = port(torch.from_numpy(x))
    assert len(forward) == len(got['outputs']) == len(port.head_metas)
    for info, f in zip(got['outputs'], forward):
        g = port_out[info['name']].numpy()
        j = jax_out[info['name']]
        assert g.shape == j.shape == tuple(f.shape) == tuple(info['shape'])
        scale = max(1.0, float(np.abs(j).max()))
        assert np.abs(g - j).max() <= INTERPRETER_TOL * scale, \
            np.abs(g - j).max() / scale
        assert np.abs(g - f.numpy()).max() <= FORWARD_TOL, \
            np.abs(g - f.numpy()).max()
    return got


@pytest.mark.parametrize('upsample', [1, 2])
def test_roundtrip_matches_jax(upsample):
    hold(*model_pair('shufflenetv2k', upsample=upsample))


def test_resnet_roundtrip_matches_jax():
    hold(*model_pair('resnet'))


@pytest.mark.parametrize('base', ['mobilenetv2', 'squeezenet',
                                  'mobilenetv3large', 'effnetv2s',
                                  'botnet', 'swin_t', 'xcit_small_12',
                                  'hrformer_s', 'shufflenetv2x1'])
def test_mobilenet_squeezenet_roundtrip(base):
    hold(*model_pair(base))


def test_cifdet_head_roundtrip():
    parsed = hold(*model_pair('shufflenetv2k', cifdet_metas))
    (out_info,) = parsed['outputs']
    assert out_info['shape'] == [1, 3, 7, 3, 3]


def test_unsupported_basenet_and_norm_raise():
    fake = SimpleNamespace(module=SimpleNamespace(basenet=object()))
    with pytest.raises(NotImplementedError, match='ShuffleNetV2'):
        onnx_native.build_model_graph(fake, input_hw=HW)
    net = resnet.ResNet((1, 1, 1, 1), norm='groupnorm')
    grouped = SimpleNamespace(module=models.Shell(net, []), head_metas=[])
    with pytest.raises(NotImplementedError, match='batchnorm/none'):
        onnx_native.build_model_graph(grouped, input_hw=HW)
    odd = effnetv2.EffNetV2(config=(('fused', 1, 24, 1, 1),
                                    ('fused', 1, 40, 1, 1)), out_channels=8)
    with pytest.raises(NotImplementedError, match='expansion 1'):
        onnx_native.build_model_graph(SimpleNamespace(
            module=models.Shell(odd, []), head_metas=[]), input_hw=HW)


@pytest.fixture(scope='module', autouse=True)
def port_cli(tmp_path_factory):
    """The port's CLI with ``--verify`` on a checkpoint of full-width
    sn2k16 (seeded), started before the module's first test so that it
    runs beside the others; ``test_export_cli`` reads it."""
    tmp = tmp_path_factory.mktemp('onnx_cli')
    model = models.factory('shufflenetv2k16', coco_metas(), device='cpu',
                           seed=3)
    ckpt = str(tmp / 'model.npz')
    checkpoint.save(ckpt, variables=models.to_jax_variables(
        model.module.state_dict()), head_metas=model.head_metas,
        basenet_name='shufflenetv2k16', base_stride=16)
    proc = subprocess.Popen(
        [sys.executable, '-m', 'openpifpaf_tpu_torch.export_onnx',
         '--device', 'cpu', f'--checkpoint={ckpt}', '--verify',
         '--outfile', str(tmp / 'port.onnx'), '--input-height', '33',
         '--input-width', '33'],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS='1'), text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    yield SimpleNamespace(ckpt=ckpt, onnx=tmp / 'port.onnx', proc=proc)
    proc.kill()
    proc.communicate()


def test_export_cli(port_cli):
    """The port's CLI with ``--verify`` writes the artifact that the JAX
    exporter writes for the same checkpoint."""
    out = port_cli.proc.communicate(timeout=300)[0]
    assert port_cli.proc.returncode == 0, out[-3000:]
    assert 'verify: max abs deviation' in out
    got = onnx_native.parse_model(port_cli.onnx.read_bytes())
    jax_model = jax_models.Factory(checkpoint=port_cli.ckpt).factory()
    want = jax_onnx.parse_model(
        jax_onnx.build_model_graph(jax_model, input_hw=(33, 33)))
    assert got['inputs'][0]['shape'] == [1, 3, 33, 33]
    assert len(got['outputs']) == 2
    assert len(got['nodes']) > 100
    assert_same_graph(got, want)


def test_initializer_dtypes_and_layout():
    """Conv weights are OIHW float32; depthwise grouped correctly (the JAX
    test's numbers for full-width sn2k16)."""
    model = models.factory('shufflenetv2k16', coco_metas(), device='cpu')
    parsed = onnx_native.parse_model(
        onnx_native.build_model_graph(model, input_hw=HW))
    w = parsed['initializers']['basenet.conv1.weight']
    assert w.dtype == np.float32
    assert w.shape == (24, 3, 3, 3)       # (O, I, kH, kW) for sn2k16
    dw = parsed['initializers']['basenet.stage2_0.branch1_dwconv.weight']
    assert dw.shape[1] == 1               # depthwise: I/groups == 1
    conv_nodes = {n['inputs'][1]: n for n in parsed['nodes']
                  if n['op_type'] == 'Conv'}
    assert conv_nodes['basenet.stage2_0.branch1_dwconv.weight'][
        'attrs']['group']['i'] == 24
