"""The port's tracking eval against the JAX package: the CLEAR-MOT
``PoseTrack`` metric and the toykpst eval CLI end to end.

- ``metric.PoseTrack`` of both packages accumulates the same tracked
  predictions and ground truth (matches, a miss, a false positive, an id
  switch within a sequence and an id reuse across sequences, a crowd
  annotation): the stats must be equal, and so must the PoseTrack-format
  prediction files.
- ``python -m openpifpaf_tpu_torch.eval --dataset toykpst`` and the JAX
  eval CLI score one JAX-written ``tshufflenetv2k16`` checkpoint (seeded
  weights, head biases shifted so that poses are found) on toykpst's 8
  eval pairs at 65 px: the port's eval has no tracking branch, the pairs
  go through ``Predictor.dataset_loader`` interleaved and
  ``TrackingPose.batch_fields`` takes them.  The COCO and PoseTrack stats
  must be within 1e-3 of JAX's (the decodes agree within 1e-3 in xyv).
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from openpifpaf_tpu import annotation as jax_annotation
from openpifpaf_tpu import metric as jax_metric
from openpifpaf_tpu import models as jax_models
from openpifpaf_tpu.plugins.posetrack.toykpst import ToyKpSt as JaxToyKpSt
from openpifpaf_tpu_torch import annotation, metric
from openpifpaf_tpu_torch.plugins.coco import constants

from test_torch_port_video import shifted_biases

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EDGE = 65


def tracked(module, xyv, id_, score=None, crowd=False):
    ann = module.Annotation(constants.COCO_KEYPOINTS,
                            constants.COCO_PERSON_SKELETON,
                            sigmas=constants.COCO_PERSON_SIGMAS)
    ann.data[:] = xyv
    ann.id_ = id_
    ann.fixed_score = score
    ann.iscrowd = crowd
    return ann


def frames(seed=0):
    """(meta, ground truth, predictions) per frame: two sequences."""
    rng = np.random.default_rng(seed)
    people = [np.concatenate([rng.uniform(0, 200, (17, 2)),
                              np.full((17, 1), 2.0)], 1).astype(np.float32)
              for _ in range(3)]
    jitter = [p + np.concatenate([rng.normal(0, 1.5, (17, 2)),
                                  np.zeros((17, 1))], 1).astype(np.float32)
              for p in people]
    gt = [(p, i) for i, p in enumerate(people)]
    return [
        ('s0', gt[:2], [(jitter[0], 1, 0.9), (jitter[1], 2, 0.8)]),
        ('s0', gt[:2], [(jitter[0], 1, 0.9), (jitter[1], 3, 0.8)]),  # switch
        ('s0', gt, [(jitter[0], 1, 0.9), (jitter[2] + 80, 4, 0.3)]),  # miss, fp
        ('s1', gt[:1], [(jitter[0], 7, 0.9)]),   # gt id 0 again: new sequence
        ('s1', gt[:1] + [(people[1], -1, None, True)],   # a crowd
         [(jitter[0], 7, 0.9)]),
    ]


def accumulate(module, metric_module):
    m = metric_module.PoseTrack(
        keypoint_oks_sigmas=constants.COCO_PERSON_SIGMAS)
    for i, (sequence, gts, preds) in enumerate(frames()):
        ground_truth = [tracked(module, p, *rest) for p, *rest in gts]
        m.accumulate([tracked(module, *p) for p in preds],
                     {'sequence_id': sequence, 'file_name': f'{i}.png'},
                     ground_truth=ground_truth)
    return m


def test_posetrack_metric_against_jax(tmp_path):
    want = accumulate(jax_annotation, jax_metric)
    got = accumulate(annotation, metric)
    assert got.stats() == want.stats()
    mota, _, misses, fps, switches, n_gt = got.stats()['stats']
    assert (misses, fps, switches, n_gt) == (2.0, 1.0, 1.0, 9.0)
    assert mota == pytest.approx(1.0 - 4.0 / 9.0)
    assert got.predictions_json() == want.predictions_json()
    got.write_predictions(str(tmp_path / 'port'))
    want.write_predictions(str(tmp_path / 'jax'))
    for seq in ('s0', 's1'):
        with open(tmp_path / f'port.{seq}.predictions.json') as f, \
                open(tmp_path / f'jax.{seq}.predictions.json') as g:
            assert json.load(f) == json.load(g)


@pytest.fixture(scope='module', name='checkpoint')
def fixture_checkpoint(tmp_path_factory):
    metas = JaxToyKpSt().head_metas
    model = jax_models.Factory(base_name='tshufflenetv2k16', bf16=False) \
        .from_scratch('tshufflenetv2k16', metas)
    model.init(jax.random.key(1), input_hw=(EDGE, EDGE))
    path = str(tmp_path_factory.mktemp('eval') / 'tracking.npz')
    jax_models.checkpoint.save(
        path, variables=shifted_biases(model.variables, metas),
        head_metas=model.head_metas, basenet_name='tshufflenetv2k16',
        base_stride=16)
    return path


def test_eval_cli_against_jax(checkpoint, tmp_path):
    args = ['--dataset=toykpst', f'--checkpoint={checkpoint}',
            f'--toykpst-image-size={EDGE}', '--batch-size=2', '--no-bf16']
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS='cpu',
               OMP_NUM_THREADS='1')
    outs = {p: str(tmp_path / p) for p in ('openpifpaf_tpu',
                                          'openpifpaf_tpu_torch')}
    procs = {p: subprocess.Popen(
        [sys.executable, '-m', f'{p}.eval', '-o', out] + args
        + (['--device=cpu'] if p == 'openpifpaf_tpu_torch' else []),
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for p, out in outs.items()}
    stats = {}
    for p, proc in procs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, f'{p}: {err[-3000:]}'
        with open(outs[p] + '.stats.json') as f:
            stats[p] = json.load(f)
    want, got = stats['openpifpaf_tpu'], stats['openpifpaf_tpu_torch']
    assert got['text_labels'] == want['text_labels']
    assert got['text_labels'][-6:] == ['MOTA', 'MOTP', 'misses',
                                       'false_positives', 'id_switches',
                                       'n_gt']
    assert got['n_images'] == want['n_images'] == 8
    np.testing.assert_allclose(got['stats'], want['stats'], atol=1e-3)
    assert got['stats'][-1] > 0                       # ground truth seen
    assert got['stats'][-3] > 0                       # poses predicted
