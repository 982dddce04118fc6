"""The port's ``export_program --include-decoder`` on the CPU: the served
forward and the CifCaf decode as one ``torch.export`` program.

- The program (``ServedDecode`` traced), saved and loaded, equals the
  port's eager forward plus ``decode_cifcaf`` bit for bit (``torch.equal``
  on all seven ``DecodedPoses`` tensors) at static batch 1 and 2, with
  ``--dynamic-batch`` at batch 1, 2 and 3, and with ``force_complete`` and
  ``placements_per_round = 2``.  The narrow ShuffleNetV2K of
  ``test_torch_port_models.py`` with its head biases shifted so that every
  cell detects (``test_torch_port_predictor.detecting_variables``), f32, at
  65 px: seeds, CAF scoring, the waves' growth and NMS all run.  The
  programs are traced, saved, loaded and run side by side, one process
  per case (``torch_port_export_cases.py``), each with K1 once and the
  narrow model's one K2 chain in its graph.
- ``common.while_loop`` traced (``torch._higher_order_ops.while_loop``)
  against the host loop on a toy nested fixpoint with a per-image freeze:
  bit for bit, and each image as if alone.
- The program against JAX's ``export_stablehlo.export_forward(...,
  include_decoder=True)`` at the same weights, reloaded and called: every
  field within the port's decode tolerances against JAX (xyv 1e-3, joint
  scales 1e-3, scores 1e-4, counters and ``valid`` equal), at least one
  pose placed.
- The CLI: ``--device cpu --basenet shufflenetv2k16 --include-decoder``
  (full width, seeded, bf16) writes a program that loads and equals the
  eager decode.
- A CifDet and a tracking model raise JAX's ``ValueError``.
- The eager decode's ``common.HOST_SYNCS``, one per iteration of a
  fixpoint loop, stays what it was before the loop could be traced.

The program reads ``fields[cif_meta.head_index]`` and
``fields[caf_meta.head_index]``, as JAX's program does: for a model with a
dense CAF head it decodes the sparse head's 19 connections, what the
decoder does at its default ``--dense-connections 0``; dense connections
are not exported.
"""

import os
import re
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from openpifpaf_tpu import export_stablehlo
from openpifpaf_tpu.models import checkpoint as jax_checkpoint
from openpifpaf_tpu_torch import decoder, export_program, models
from openpifpaf_tpu_torch.ops import common, pipeline
from openpifpaf_tpu_torch.plugins.coco.cocodet import CocoDet
from openpifpaf_tpu_torch.plugins.coco.cocokp import CocoKp
from openpifpaf_tpu_torch.plugins.posetrack import ToyKpSt

from test_torch_port_models import flax_narrow
from test_torch_port_predictor import detecting_variables
from torch_port_export_cases import (CASES, HW, OPERATORS, decode_options,
                                     images, narrow_model, operator_calls)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
XYV_TOL = 1e-3
SCORE_TOL = 1e-4
NON_CIFCAF = '--include-decoder supports CifCaf models only'
# the eager decode of ``images(2)`` by ``narrow_model``: host syncs of the
# fixpoint loops, one per iteration, measured on the Python loop before it
# could be traced and after
EAGER_HOST_SYNCS = 30


@pytest.fixture(autouse=True)
def restore_torch_threads():
    """The tests here run on one torch thread: give the count back, so
    that the files this worker runs next keep theirs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def weights():
    """The narrow flax module, its detecting variables and metas (with
    their head indices, which JAX's program reads)."""
    module, variables, metas = flax_narrow()
    for i, meta in enumerate(metas):
        meta.head_index = i
    return module, detecting_variables(variables, metas), metas


@pytest.fixture(scope='module')
def exports(tmp_path_factory):
    """Every case of ``torch_port_export_cases`` and the CLI, each traced
    in a process of its own, all at once; meanwhile JAX's program of the
    same weights, exported with a symbolic batch and called at batch 1
    and 2."""
    tmp = tmp_path_factory.mktemp('export_decoder')
    module, variables, metas = weights()
    flat = jax_checkpoint.flatten_tree(variables)
    np.savez(tmp / 'weights.npz', **flat)
    env = dict(os.environ, OMP_NUM_THREADS='1', PYTHONPATH=REPO)
    runs = {case: [os.path.join(TESTS, 'torch_port_export_cases.py'), case,
                   str(tmp / 'weights.npz'), str(tmp)] for case in CASES}
    runs['cli'] = ['-m', 'openpifpaf_tpu_torch.export_program', '--device',
                   'cpu', '--basenet', 'shufflenetv2k16', '--include-decoder',
                   '--input-height', str(HW[0]), '--input-width', str(HW[1]),
                   '--outfile', str(tmp / 'cli.pt2')]
    start = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, *args], cwd=REPO, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for name, args in runs.items()}
    try:
        jax_model = SimpleNamespace(module=module, variables=variables,
                                    head_metas=metas)
        exported = export_stablehlo.export_forward(
            jax_model, HW, include_decoder=True, dynamic_batch=True)
        jax_path = tmp / 'narrow.stablehlo'
        jax_path.write_bytes(exported.serialize())
        reloaded = export_stablehlo.load_exported(str(jax_path))
        jax_outs = {b: [np.asarray(o) for o in reloaded.call(
            images(b).transpose(0, 2, 3, 1))] for b in (1, 2)}
        outputs = {name: proc.communicate(timeout=600)[0]
                   for name, proc in procs.items()}
    finally:
        for proc in procs.values():
            proc.kill()
    for name, proc in procs.items():
        assert proc.returncode == 0, (name, outputs[name][-3000:])
    print(f'export processes done in {time.perf_counter() - start:.1f} s:',
          *(line for out in outputs.values() for line in out.splitlines()
            if 'traced in' in line), sep='\n  ')
    return SimpleNamespace(tmp=tmp, model=narrow_model(flat),
                           jax_outs=jax_outs, outputs=outputs)


def eager_decode(model, x):
    """The port's eager forward, then ``decode_cifcaf`` at the decoder's
    configuration for ``HW`` (the served path: ``CifCaf.batch_decoded``
    builds the same)."""
    dec = decoder.factory(model.head_metas, device='cpu')
    with torch.no_grad():
        fields = model(x)
        return pipeline.decode_cifcaf(
            fields[0], fields[1], cif_meta=dec.cif_meta,
            caf_meta=dec.caf_meta, config=dec.config_for(HW))


def hold_to_eager(exports, name, batches, case=None):
    """The runs of the saved and loaded program ``name``
    (``torch_port_export_cases``) against the eager decode, bit for bit;
    returns the program's outputs per batch."""
    results = np.load(exports.tmp / f'{name}.npz')
    assert {op: int(results[f'calls {op}']) for op in OPERATORS} == {
        OPERATORS[0]: 1, OPERATORS[1]: 1}
    outs = {}
    for batch in batches:
        got = [torch.from_numpy(results[f'{field} {batch}'])
               for field in pipeline.DecodedPoses._fields]
        with decode_options(case):
            want = eager_decode(exports.model, torch.from_numpy(images(batch)))
        for g, w, field in zip(got, want, pipeline.DecodedPoses._fields):
            assert g.dtype == w.dtype and g.shape == w.shape, field
            assert torch.equal(g, w), (batch, field)
        assert int(got[3].sum()) > 0, batch
        outs[batch] = got
    return outs


@pytest.mark.parametrize('batch', [1, 2])
def test_static_program_equals_eager(exports, batch):
    hold_to_eager(exports, f'static_{batch}', (batch,))


def test_dynamic_program_equals_eager_and_jax(exports):
    outs = hold_to_eager(exports, 'dynamic_None', (1, 2, 3))
    for batch, want in exports.jax_outs.items():
        got = [o.numpy() for o in outs[batch]]
        fields = dict(zip(pipeline.DecodedPoses._fields, zip(got, want)))
        for name, (g, w) in fields.items():
            assert g.shape == w.shape, name
        valid = fields['valid'][1]
        assert valid.any(), batch
        for name in ('valid', 'n_dropped_caf', 'n_dropped_cif',
                     'n_dropped_poses'):
            np.testing.assert_array_equal(*fields[name], err_msg=name)
        for name, tol in (('xyv', XYV_TOL), ('joint_scales', XYV_TOL),
                          ('scores', SCORE_TOL)):
            g, w = fields[name]
            np.testing.assert_allclose(g[valid], w[valid], atol=tol, rtol=0,
                                       err_msg=name)


@pytest.mark.parametrize('case', ['force_complete', 'placements'])
def test_program_options_equal_eager(exports, case):
    hold_to_eager(exports, f'{case}_2', (2,), case)


def test_cli_program_loads_and_equals_eager(exports):
    """The CLI's default model (full-width sn2k16, cocokp's heads, seed 0,
    bf16) with the decode: seven tensors, equal to the eager decode, K1
    once and K2's three chains in the graph."""
    assert 'cli.pt2:' in exports.outputs['cli']
    program = export_program.load_exported(str(exports.tmp / 'cli.pt2'))
    assert operator_calls(program) == {OPERATORS[0]: 1, OPERATORS[1]: 3}
    model = models.factory('shufflenetv2k16', CocoKp().head_metas,
                           device='cpu', seed=0)
    x = torch.from_numpy(images(1))
    with torch.no_grad():
        got = program.module()(x)
        want = decoder.factory(model.head_metas,
                               device='cpu').batch_decoded(model(x))
    assert len(got) == 7
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize('kind', ['cifdet', 'tracking'])
def test_non_cifcaf_models_refused(kind):
    if kind == 'cifdet':
        model = models.factory('shufflenetv2k16', CocoDet().head_metas,
                               device='cpu')
    else:
        model = models.factory('tshufflenetv2k16', ToyKpSt().head_metas,
                               device='cpu')
    with pytest.raises(ValueError, match=re.escape(NON_CIFCAF)):
        export_program.export_forward(model, HW, include_decoder=True)


class ToyFixpoint(torch.nn.Module):
    """Two nested fixpoints over (B, N) rows with a per-image freeze: the
    outer loop raises each image's floor by one until its row sums to its
    limit (at most 6 rounds); the inner loop, restricted to the images
    the outer one still runs, adds 0.5 to a row's smallest entry until it
    reaches the floor."""

    def forward(self, x, limit):
        def inner(x, floor, active):
            def cond(state):
                return state[0].min(dim=1).values < state[1]

            def body(state, _):
                v, level = state
                i = torch.argmin(v, dim=1, keepdim=True)
                return v.scatter(1, i, torch.gather(v, 1, i) + 0.5), level

            return common.while_loop(cond, body, (x, floor), active=active)[0]

        def cond(state):
            return (state[0].sum(dim=1) < limit) & (state[1] < 6)

        def body(state, running):
            x, rounds, floor = state
            floor = floor + 1.0
            return inner(x, floor, running), rounds + 1, floor

        zeros = torch.zeros(x.shape[0], dtype=torch.int64)
        return common.while_loop(cond, body, (x, zeros, x.min(dim=1).values))


def test_traced_while_loop_equals_host_loop():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(0, 2, (4, 5)).astype(np.float32))
    limit = torch.tensor([12.0, 25.0, 0.0, 40.0])
    toy = ToyFixpoint()
    before = common.HOST_SYNCS
    want = toy(x, limit)
    syncs = common.HOST_SYNCS - before
    program = torch.export.export(toy, (x, limit))
    hops = [n for n in program.graph.nodes
            if n.target is torch.ops.higher_order.while_loop]
    body = getattr(program.graph_module, hops[0].args[1].target)
    assert len(hops) == 1 and sum(
        n.target is torch.ops.higher_order.while_loop
        for n in body.graph.nodes) == 1
    before = common.HOST_SYNCS
    got = program.module()(x, limit)
    # the traced loop runs no host loop of the port's
    assert common.HOST_SYNCS == before and syncs > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    # each image as if alone: the others' iterations leave it as it is
    for i in range(4):
        alone = toy(x[i:i + 1], limit[i:i + 1])
        assert all(torch.equal(a[0], w[i]) for a, w in zip(alone, want))
    assert got[1].tolist() == [3, 4, 0, 6]


def test_eager_decode_host_syncs():
    """The eager decode still reads one flag per fixpoint iteration: the
    count of ``images(2)`` is the same as before the loop could be traced
    (``EAGER_HOST_SYNCS``)."""
    _, variables, _ = weights()
    model = narrow_model(jax_checkpoint.flatten_tree(variables))
    before = common.HOST_SYNCS
    decoded = eager_decode(model, torch.from_numpy(images(2)))
    assert common.HOST_SYNCS - before == EAGER_HOST_SYNCS
    assert int(decoded.valid.sum()) > 0
