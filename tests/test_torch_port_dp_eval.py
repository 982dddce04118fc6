"""The port's ``eval --dp-eval`` against the JAX package's.

A JAX-written checkpoint of a narrow ShuffleNetV2K (registered under a
test name in both packages) with toykp's heads, their biases shifted so
that every cell is a detection, evaluated on 8 toykp images at 81 px (the
rendered size, where both loaders give the same pixels) in batches of 3,
so that two batches are padded to the group:

- JAX's ``Predictor.data_parallel`` eval on the 8 virtual devices
  (``tests/test_parallel.py:215``'s pattern);
- the port's one-process eval;
- the port's eval CLI with ``--dp-eval`` in a gloo group of 2 ranks
  (``parallel.run_group``, the bodies in ``torch_port_dist.py``).

The stats agree within 1e-6 and the predictions within the decode
tolerances (xyv 1e-3, scores 1e-4); only rank 0 writes files.
"""

import json
import os

import jax
import numpy as np
import torch

from openpifpaf_tpu import eval as jax_eval
from openpifpaf_tpu import models as jax_models
from openpifpaf_tpu import predictor as jax_predictor
from openpifpaf_tpu.models import base as jax_base
from openpifpaf_tpu.models import checkpoint as jax_checkpoint
from openpifpaf_tpu.models import heads as jax_heads
from openpifpaf_tpu.models import shell as jax_shell
from openpifpaf_tpu.models import shufflenetv2k as jax_sn
from openpifpaf_tpu.plugins.toykp import datamodule as jax_toykp
from openpifpaf_tpu_torch import eval as port_eval, parallel
from openpifpaf_tpu_torch.models import base, shufflenetv2k
from openpifpaf_tpu_torch.plugins import toykp
from openpifpaf_tpu_torch.predictor import Predictor

import torch_port_dist as dist_bodies
from test_torch_port_models import random_variables

TOYKP = (('image_size', 81), ('n_val_images', 8), ('batch_size', 3),
         ('with_dense', False))


def narrow_checkpoint(path):
    metas = jax_toykp.ToyKp().head_metas
    for m in metas:
        m.base_stride = 16
    module = jax_shell.Shell(
        basenet=jax_sn.ShuffleNetV2K(*dist_bodies.NARROW),
        head_nets=[jax_heads.CompositeField4(meta=m, in_features=64)
                   for m in metas])
    variables = jax.tree.map(np.array, random_variables(module))
    for i, meta in enumerate(metas):
        bias = variables['params'][f'head_nets_{i}']['conv']['bias']
        bias = bias.reshape(meta.n_fields, meta.n_components)
        bias[:, 0] = 2.0
        bias[:, meta.n_components - meta.n_scales:] = 3.0
    jax_checkpoint.save(path, variables=variables, head_metas=metas,
                        basenet_name=dist_bodies.NARROW_NAME, base_stride=16)


def predictions(metric):
    return sorted(metric.predictions,
                  key=lambda p: (p['image_id'], -p['score']))


def test_dp_eval_two_ranks(tmp_path, monkeypatch):
    monkeypatch.setitem(jax_base.BASE_FACTORIES, dist_bodies.NARROW_NAME,
                        jax_base.BaseNetworkSpec(
                            dist_bodies.NARROW_NAME,
                            jax_sn._make(*dist_bodies.NARROW),  # pylint: disable=protected-access
                            stride=16, out_features=64))
    monkeypatch.setitem(base.BASE_FACTORIES, dist_bodies.NARROW_NAME,
                        base.BaseNetworkSpec(
                            dist_bodies.NARROW_NAME,
                            shufflenetv2k._make(*dist_bodies.NARROW),  # pylint: disable=protected-access
                            stride=16, out_features=64))
    for cls in (jax_toykp.ToyKp, toykp.ToyKp):
        for name, value in TOYKP:
            monkeypatch.setattr(cls, name, value)
    checkpoint = str(tmp_path / 'model.npz')
    narrow_checkpoint(checkpoint)

    monkeypatch.setattr(jax_predictor.Predictor, 'data_parallel', True)
    predictor = jax_predictor.Predictor(model=jax_models.Factory(
        checkpoint=checkpoint, bf16=False).factory())
    assert predictor._mesh.shape['data'] == 8  # pylint: disable=protected-access
    evaluator = jax_eval.Evaluator(jax_toykp.ToyKp(), predictor)
    want = evaluator.run()
    want_preds = predictions(evaluator.metrics[0])

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        evaluator = port_eval.Evaluator(toykp.ToyKp(), Predictor(
            checkpoint=checkpoint, device='cpu', bf16=False))
        single = evaluator.run()
    finally:
        torch.set_num_threads(threads)
    single_preds = predictions(evaluator.metrics[0])

    out = str(tmp_path / 'dp')
    assert parallel.run_group(dist_bodies.eval_cli, 2, ([
        '--dataset=toykp', '--toykp-image-size=81', '--batch-size=3',
        f'--checkpoint={checkpoint}', '--device=cpu', '--no-bf16', '-q',
        '--dp-eval', '--write-predictions', '-o', out],),
        timeout=240) == [0, 0]
    assert sorted(os.listdir(tmp_path)) == [
        'dp.pred.json', 'dp.stats.json', 'dp.zip', 'model.npz']
    with open(out + '.stats.json') as f:
        got = json.load(f)
    with open(out + '.pred.json') as f:
        got_preds = sorted(json.load(f),
                           key=lambda p: (p['image_id'], -p['score']))

    assert got['n_images'] == single['n_images'] == want['n_images'] == 8
    assert got['text_labels'] == want['text_labels']
    for stats in (want, single):
        np.testing.assert_allclose(got['stats'], stats['stats'], atol=1e-6,
                                   rtol=0)
    assert len(got_preds) == len(single_preds) == len(want_preds) > 8
    for preds in (want_preds, single_preds):
        for g, w in zip(got_preds, preds):
            assert g['image_id'] == w['image_id']
            np.testing.assert_allclose(g['keypoints'], w['keypoints'],
                                       atol=1e-3, rtol=0)
            assert abs(g['score'] - w['score']) <= 1e-4
