"""The port's export: K2 as a registered operator, the ``.pt2`` program,
the CoreML refusal and ``count_ops``, on the CPU against the JAX package
(the program with the decode: ``test_torch_port_export_decoder.py``).

- ``openpifpaf_tpu_torch::pair_chain``: its CPU implementation equals
  ``pair_chain_plain`` bit for bit, ``torch.library.opcheck`` passes, a
  backward through it raises, a parameter not in ``pack``'s layout is
  refused, and its FLOP formula counts the chain's products and taps;
- ``export_program``: the exported forward, saved and loaded, equals eager
  ``Model.__call__`` (max |d| <= 1e-6 in f32, expected 0) at batch 1 and,
  with ``--dynamic-batch``, at 1 and 3; and the JAX ``export_stablehlo``
  artifact of the same weights, reloaded, within 1e-4 (the f32 bound of
  the port's forward against JAX, ``test_torch_port_models.py``).  The
  narrow model in process, full-width sn2k16 and a tracking model (batch
  raised to even) through the CLI; a narrow tracking program with
  ``--dynamic-batch`` against eager at 1, 2 and 3 frame pairs;
- the CoreML CLI refuses;
- ``count_ops``: GMACs equal to the MACs of the forward's convolutions and
  linear layers counted from their shapes, JAX's number printed beside.
"""

import functools
import os
import re
import subprocess
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from openpifpaf_tpu import count_ops as jax_count_ops
from openpifpaf_tpu import export_stablehlo
from openpifpaf_tpu.models import checkpoint as jax_checkpoint
from openpifpaf_tpu_torch import count_ops, export_coreml, export_onnx
from openpifpaf_tpu_torch import export_program, models
from openpifpaf_tpu_torch.models import checkpoint
from openpifpaf_tpu_torch.ops import pair_chain as pc
from openpifpaf_tpu_torch.plugins.coco.cocokp import CocoKp
from openpifpaf_tpu_torch.plugins.posetrack import ToyKpSt

from test_torch_port_models import NARROW, flax_narrow, port_narrow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (33, 33)
JAX_F32_TOL = 1e-4
EAGER_TOL = 1e-6


@pytest.fixture(autouse=True)
def restore_torch_threads():
    """Some tests here run on one torch thread: give the count back, so
    that the files this worker runs next keep theirs."""
    threads = torch.get_num_threads()
    yield
    torch.set_num_threads(threads)


def seeded_blocks(channels, n_blocks=3, seed=0):
    """The folded stride-1 blocks of a seeded stage of pair width
    ``channels // 2``, BatchNorm statistics away from the identity."""
    net = models.ShuffleNetV2K((n_blocks + 1,), (24, channels, channels))
    generator = torch.Generator().manual_seed(seed)
    models.init_weights(net, generator)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                shape = tuple(m.running_mean.shape)
                m.running_mean.copy_(torch.from_numpy(
                    rng.normal(0.0, 0.3, shape).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(
                    rng.uniform(0.5, 2.0, shape).astype(np.float32)))
    return [pc.block_params(getattr(net, f'stage2_{i}'))
            for i in range(1, n_blocks + 1)]


def chain_inputs(channels, dtype, batch=2, seed=1):
    """(a, b, packed chain) on the CPU; post-relu pairs are nonnegative."""
    rng = np.random.default_rng(seed)
    a, b = (torch.from_numpy(np.abs(rng.normal(
        size=(batch, 9, 7, channels // 2))).astype(np.float32)).to(dtype)
        for _ in range(2))
    return a, b, pc.pack(seeded_blocks(channels), dtype)


def op_args(a, b, chain):
    return (a, b, chain.w1, chain.w2, chain.vec, chain.dwk, chain.channels)


# widths 44 and 48: q = 11 (odd, the shifted layout) and q = 12
@pytest.mark.parametrize('channels', [44, 48])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_op_cpu_equals_plain(channels, dtype):
    a, b, chain = chain_inputs(channels, dtype)
    want = pc.pair_chain_plain(a, b, chain.blocks, dtype)
    launches = (pc.KERNEL_LAUNCHES, pc.CUDA_LAUNCHES)
    for got in (torch.ops.openpifpaf_tpu_torch.pair_chain(*op_args(a, b, chain)),
                pc.apply_chain(a, b, chain)):
        for g, w in zip(got, want):
            assert g.dtype == dtype and torch.equal(g, w)
    assert (pc.KERNEL_LAUNCHES, pc.CUDA_LAUNCHES) == launches
    # the packed layout read back is the blocks as rounded to the storage
    for got, blk in zip(pc.unpack(chain.w1, chain.w2, chain.vec, chain.dwk,
                                  chain.channels), chain.blocks):
        for g, w, field in zip(got, blk, blk._fields):
            rounded = w.to(dtype).float() if field in ('w1a', 'w1b', 'w2') \
                else w
            assert torch.equal(g, rounded), field


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_opcheck(dtype):
    a, b, chain = chain_inputs(44, dtype)
    torch.library.opcheck(torch.ops.openpifpaf_tpu_torch.pair_chain.default,
                          op_args(a, b, chain))


def test_no_backward_and_wrapper_refuses_cpu():
    a, b, chain = chain_inputs(44, torch.float32)
    a.requires_grad_(True)
    out_a, _ = pc.apply_chain(a, b, chain)
    with pytest.raises(RuntimeError, match='no autograd formula'):
        out_a.sum().backward()
    with pytest.raises(ValueError, match='CUDA tensor'):
        pc.pair_chain(a.detach(), b, chain)


MALFORMED = {
    'vec narrower than the chain': lambda p: p.update(vec=p['vec'][..., :8]),
    'vec in bfloat16': lambda p: p.update(vec=p['vec'].bfloat16()),
    'vec not contiguous': lambda p: p.update(
        vec=p['vec'].transpose(1, 2).contiguous().transpose(1, 2)),
    'dwk missing a tap': lambda p: p.update(dwk=p['dwk'][:, :24]),
    'w2 of another width': lambda p: p.update(w2=p['w2'][:, :, :-1]),
    'w1 in another type': lambda p: p.update(w1=p['w1'].bfloat16()),
    'one block fewer in vec': lambda p: p.update(vec=p['vec'][1:]),
}


@pytest.mark.parametrize('fault', sorted(MALFORMED))
def test_op_refuses_malformed_parameters(fault):
    """The kernel reads ``w1``, ``w2``, ``vec`` and ``dwk`` by pointer, so
    the op (on either device) refuses any layout other than ``pack``'s."""
    a, b, chain = chain_inputs(44, torch.float32)
    params = dict(w1=chain.w1, w2=chain.w2, vec=chain.vec, dwk=chain.dwk)
    MALFORMED[fault](params)
    with pytest.raises(ValueError, match='is not packed for a chain'):
        torch.ops.openpifpaf_tpu_torch.pair_chain(
            a, b, params['w1'], params['w2'], params['vec'], params['dwk'],
            chain.channels)


def test_flop_formula():
    """The op counts 2 (2 C^2 + 25 C) per pixel and block; the served
    forward (through the op) counts as the canonical graph does."""
    a, b, chain = chain_inputs(44, torch.float32, batch=3)
    with FlopCounterMode(display=False) as counter:
        pc.apply_chain(a, b, chain)
    c = 22
    assert counter.get_total_flops() == 2 * 3 * (3 * 9 * 7) * (
        2 * c * c + 25 * c)
    _, variables, _ = flax_narrow()
    model = port_narrow(jax_checkpoint.flatten_tree(variables))
    served = count_ops.count(model, HW, forward=model)
    assert served == count_ops.count(model, HW)


@functools.lru_cache(maxsize=None)
def narrow_pair():
    """The narrow flax Shell (as a JAX ``Model``) and the port's Model with
    its variables."""
    module, variables, metas = flax_narrow()
    jax_model = SimpleNamespace(module=module, variables=variables,
                                head_metas=metas)
    return jax_model, port_narrow(jax_checkpoint.flatten_tree(variables))


def images(batch, seed=0, hw=HW):
    return np.random.default_rng(seed).normal(
        size=(batch, 3, *hw)).astype(np.float32)


def hold_to_eager(program, model, batches):
    """The loaded program against eager ``Model.__call__``."""
    outs = {}
    for batch in batches:
        x = torch.from_numpy(images(batch, seed=batch))
        with torch.no_grad():
            got, want = program.module()(x), model(x)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
            assert float((g - w).abs().max()) <= EAGER_TOL
        outs[batch] = got
    return outs


def chain_calls(program):
    return sum(node.target is torch.ops.openpifpaf_tpu_torch.pair_chain.default
               for node in program.graph.nodes)


@pytest.mark.parametrize('dynamic', [False, True])
def test_program_equals_eager_and_jax(tmp_path, dynamic):
    torch.set_num_threads(1)
    jax_model, model = narrow_pair()
    path = str(tmp_path / 'narrow.pt2')
    torch.export.save(export_program.export_forward(
        model, HW, dynamic_batch=dynamic), path)
    program = export_program.load_exported(path)
    assert chain_calls(program) == len(model.inference_plan().chains) == 1
    batches = (1, 3) if dynamic else (1,)
    outs = hold_to_eager(program, model, batches)

    # the JAX artifact of the same weights, serialized and reloaded
    exported = export_stablehlo.export_forward(
        jax_model, HW, batch_size=1, dynamic_batch=dynamic)
    jax_path = tmp_path / 'narrow.stablehlo'
    jax_path.write_bytes(exported.serialize())
    reloaded = export_stablehlo.load_exported(str(jax_path))
    for batch in batches:
        want = reloaded.call(images(batch, seed=batch).transpose(0, 2, 3, 1))
        for g, w in zip(outs[batch], want):
            assert g.shape == w.shape
            assert np.abs(g.numpy() - np.asarray(w)).max() <= JAX_F32_TOL


def narrow_tracking():
    """A narrow tracking model (CIF, CAF, TCAF) seeded by torch, its
    BatchNorm statistics away from the identity."""
    metas = ToyKpSt().head_metas
    for m in metas:
        m.base_stride = 16
    shell = models.TrackingShell(
        models.ShuffleNetV2K(*NARROW),
        [models.CompositeField4(m, c) for m, c in zip(metas, (64, 64, 128))],
        (False, False, True))
    models.init_weights(shell, torch.Generator().manual_seed(5))
    generator = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for m in shell.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.3, generator=generator)
                m.running_var.uniform_(0.5, 2.0, generator=generator)
    return models.TrackingModel(shell, metas, base_stride=16,
                                device=torch.device('cpu'), bf16=False)


def test_tracking_program_from_one_pair(tmp_path):
    """A tracking program exported with ``--dynamic-batch`` takes 1, 2
    and 3 frame pairs (a stream calls it with one), each equal to eager
    ``Model.__call__``: CIF and CAF per frame, TCAF per pair."""
    torch.set_num_threads(1)
    model = narrow_tracking()
    path = str(tmp_path / 'tracking.pt2')
    torch.export.save(export_program.export_forward(
        model, HW, dynamic_batch=True), path)
    program = export_program.load_exported(path)
    assert chain_calls(program) == len(model.inference_plan().chains) == 1
    outs = hold_to_eager(program, model, (2, 4, 6))
    for frames, fields in outs.items():
        assert [f.shape[0] for f in fields] == [frames, frames, frames // 2]


@pytest.mark.parametrize('device', [['--device', 'cpu'], []])
def test_coreml_refused(caplog, device):
    """Without coremltools the CLI exits 1 before it builds a model, on
    any device."""
    assert export_coreml.main(device + ['--basenet', 'shufflenetv2k16']) == 1
    assert 'CoreML export unavailable' in caplog.text
    assert 'coremltools' in caplog.text and 'export_program' in caplog.text


@pytest.mark.parametrize('cli', [export_program, export_onnx, count_ops])
def test_clis_default_to_the_card(cli):
    if torch.cuda.is_available():
        pytest.skip('checks the behaviour without CUDA')
    with pytest.raises(RuntimeError, match='CUDA'):
        cli.main(['--basenet', 'shufflenetv2k16'])


def save(model, path, basenet_name):
    checkpoint.save(path, variables=models.to_jax_variables(
        model.module.state_dict()), head_metas=model.head_metas,
        basenet_name=basenet_name, base_stride=16)


@pytest.fixture(scope='module')
def cli_runs(tmp_path_factory):
    """The program CLI on full-width sn2k16 (``--dynamic-batch``) and on a
    tracking model (``--batch-size 1``), and the count_ops CLI, run side by
    side; returns the models, paths and outputs."""
    tmp = tmp_path_factory.mktemp('export_cli')
    single = models.factory('shufflenetv2k16', CocoKp().head_metas,
                            device='cpu', bf16=False, seed=3)
    tracking = models.factory('tshufflenetv2k16', ToyKpSt().head_metas,
                              device='cpu', bf16=False, seed=4)
    save(single, str(tmp / 'single.npz'), 'shufflenetv2k16')
    save(tracking, str(tmp / 'tracking.npz'), 'tshufflenetv2k16')
    size = ['--input-height', str(HW[0]), '--input-width', str(HW[1])]
    module = [sys.executable, '-m']
    runs = {
        'single': module + [
            'openpifpaf_tpu_torch.export_program', '--device', 'cpu',
            '--no-bf16', f'--checkpoint={tmp / "single.npz"}',
            '--dynamic-batch', '--outfile', str(tmp / 'single.pt2'), *size],
        'tracking': module + [
            'openpifpaf_tpu_torch.export_program', '--device', 'cpu',
            '--no-bf16', f'--checkpoint={tmp / "tracking.npz"}',
            '--batch-size', '1', '--outfile', str(tmp / 'tracking.pt2'),
            *size],
        'count_ops': module + ['openpifpaf_tpu_torch.count_ops', '--device',
                               'cpu', '--long-edge', '129']}
    env = dict(os.environ, OMP_NUM_THREADS='1')
    procs = {k: subprocess.Popen(cmd, cwd=REPO, env=env, text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT)
             for k, cmd in runs.items()}
    outputs = {}
    for name, proc in procs.items():
        outputs[name] = proc.communicate(timeout=300)[0]
        assert proc.returncode == 0, (name, outputs[name][-3000:])
    return SimpleNamespace(tmp=tmp, single=single, tracking=tracking,
                           outputs=outputs)


def test_program_cli_dynamic_batch(cli_runs):
    torch.set_num_threads(1)
    assert 'single.pt2:' in cli_runs.outputs['single']
    program = export_program.load_exported(str(cli_runs.tmp / 'single.pt2'))
    assert chain_calls(program) == 3
    hold_to_eager(program, cli_runs.single, (1, 3))


def test_program_cli_tracking_even_batch(cli_runs):
    torch.set_num_threads(1)
    assert 'raising --batch-size 1 -> 2' in cli_runs.outputs['tracking']
    program = export_program.load_exported(
        str(cli_runs.tmp / 'tracking.pt2'))
    (name,) = program.graph_signature.user_inputs
    (node,) = [n for n in program.graph.nodes if n.name == name]
    assert tuple(node.meta['val'].shape) == (2, 3, *HW)
    outs = hold_to_eager(program, cli_runs.tracking, (2,))
    # CIF and CAF per frame, TCAF per pair
    assert [o.shape[0] for o in outs[2]] == [2, 2, 1]


def conv_linear_macs(model, hw):
    """Multiply-adds of every Conv2d and Linear in the canonical forward,
    from the modules' shapes."""
    macs = []

    def hook(module, _, out):
        if isinstance(module, torch.nn.Conv2d):
            kh, kw = module.kernel_size
            macs.append(out.numel() * module.in_channels // module.groups
                        * kh * kw)
        else:
            macs.append(out.numel() * module.in_features)

    handles = [m.register_forward_hook(hook) for m in model.module.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        model.apply(torch.zeros((1, 3, *hw)))
    finally:
        for h in handles:
            h.remove()
    return sum(macs)


def test_count_ops(cli_runs):
    """The CLI's default model (full-width sn2k16, cocokp's heads, seed 0)
    at 129 px, and the narrow model exactly, beside JAX's count (XLA's
    cost analysis, elementwise operations included)."""
    printed = dict(re.findall(r'^(GMACs|GFLOPs|params): ([0-9.]+)M?$',
                              cli_runs.outputs['count_ops'], re.M))
    model = models.factory('shufflenetv2k16', CocoKp().head_metas,
                           device='cpu')
    macs = conv_linear_macs(model, (129, 129))
    assert printed['GMACs'] == f'{macs / 1e9:.2f}'
    assert printed['GFLOPs'] == f'{2 * macs / 1e9:.2f}'
    n_params = sum(p.numel() for p in model.module.parameters())
    assert printed['params'] == f'{n_params / 1e6:.2f}'

    jax_model, narrow = narrow_pair()
    stats = count_ops.count(narrow, HW)
    assert stats['gmacs'] * 1e9 == conv_linear_macs(narrow, HW)
    jax_model.num_params = lambda: sum(
        np.size(v) for v in jax.tree.leaves(jax_model.variables['params']))
    jax_stats = jax_count_ops.count(jax_model, HW)
    print(f'narrow sn2k16 at {HW}: port GMACs {stats["gmacs"]:.6f} '
          f'(FlopCounterMode), JAX GMACs {jax_stats["gmacs"]:.6f} (XLA cost '
          f'analysis); params {stats["million_params"]:.6f}M / '
          f'{jax_stats["million_params"]:.6f}M')
    assert jax_stats['million_params'] == stats['million_params']
    assert jax_stats['gmacs'] >= stats['gmacs']
