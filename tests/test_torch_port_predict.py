"""The port's predict entry points against the JAX package's, on a model
with pose and detection heads.

The narrow ShuffleNetV2K of ``test_torch_port_cifdet.py`` with toykp's CIF
and CAF heads and cifar10's CifDet head (PixelShuffle 2), f32, its
confidence and scale biases shifted so that every pose cell is a
detection, its CifDet head scaled and shifted so that the splats add up
(``detecting_variables``).  The images
are PNGs written by ``image_io.write_png`` whose long edge is the
predictor's (129 px), so neither package rescales (the PIL-free rescale
is within one grey level of PIL's, not equal to it).

- ``decoder.factory`` builds ``Multi(CifCaf, CifDet)`` for these heads, and
  on the fields of the JAX forward it gives JAX's annotations.  The JAX
  factory's ``DECODERS`` is a ``set``, so its ``Multi`` may run CifDet
  first: the two lists are compared by type (poses, then boxes), each in
  its decoder's order.  Poses: xyv within 1e-3, scores within 1e-4;
  boxes: categories equal, boxes within 1e-3 px, scores within 1e-4.
- ``Predictor.images`` and ``images_multiscale`` (the 129 px variant and
  its hflip, merged) in process, against the JAX ``Predictor``'s, at the
  same tolerances.
- ``python -m openpifpaf_tpu_torch.predict`` (``predict.main`` in process,
  ``--device cpu``) writes one ``.predictions.json`` per image equal to
  the JAX predict CLI's (a subprocess; both load one JAX-written
  checkpoint, the narrow backbone registered under a test name in both
  packages), poses and boxes as sets: the json rounds coordinates to 0.01
  px and scores to 0.001, so values are held within one rounding step
  plus the tolerances above.
- ``--debug-checks``: a NaN in a field raises in the decode's gathers, for
  CifCaf and CifDet; without the flag the same fields decode.
- ``--batch-size``: the port's sets the predictor's batch; JAX's is an
  unconfigured data-module flag and changes nothing (a difference kept).
"""

import argparse
import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from openpifpaf_tpu import decoder as jax_decoder
from openpifpaf_tpu import headmeta as jax_headmeta
from openpifpaf_tpu import models as jax_models
from openpifpaf_tpu import predictor as jax_predictor
from openpifpaf_tpu.models import checkpoint as jax_checkpoint
from openpifpaf_tpu_torch import (annotation, debug_checks, decoder,
                                  headmeta, image_io, logger)
from openpifpaf_tpu_torch import predict as port_predict
from openpifpaf_tpu_torch.models import base
from openpifpaf_tpu_torch.models import shufflenetv2k
from openpifpaf_tpu_torch.ops import common
from openpifpaf_tpu_torch.predictor import Predictor

from test_torch_port_cifdet import (flax_three_heads, port_three_heads,
                                    three_head_metas)
from test_torch_port_decode import one_torch_thread  # noqa: F401  (fixture)
from test_torch_port_models import NARROW

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LONG_EDGE = 129
NARROW_NAME = 'shufflenetv2k-narrow-test'


def detecting_variables():
    """The three-head flax variables, biases shifted: the pose heads'
    confidence to 2 and scales to 3 (every cell a detection); the CifDet
    head's kernel times 8 (offsets vary by ~0.9 cells, so local maxima are
    distinct, not near-ties of a flat field), its confidence by +2 and its
    box size by +30 cells (sigma 12 px at stride 8: neighbouring cells'
    splats add up)."""
    module, variables = flax_three_heads()
    flat = jax_checkpoint.flatten_tree(variables)
    for i, meta in enumerate(three_head_metas(jax_headmeta)):
        u = meta.upsample_stride
        bias = flat[f'params/head_nets_{i}/conv/bias'].reshape(
            meta.n_fields, meta.n_components, u, u)
        if isinstance(meta, jax_headmeta.CifDet):
            flat[f'params/head_nets_{i}/conv/kernel'] *= 8.0
            bias[:, 0] += 2.0
            bias[:, 3:5] += 30.0
        else:
            bias[:, 0] = 2.0
            bias[:, meta.n_components - meta.n_scales:] = 3.0
    return module, jax_checkpoint.unflatten_tree(flat)


@pytest.fixture(scope='module')
def three_head_models():
    module, variables = detecting_variables()
    jax_model = jax_models.Model(module, three_head_metas(jax_headmeta),
                                 base_stride=16, variables=variables)
    port_model = port_three_heads(jax_checkpoint.flatten_tree(variables),
                                  three_head_metas(headmeta))
    return jax_model, port_model


@pytest.fixture(scope='module')
def png_images(tmp_path_factory):
    """Two PNGs whose long edge is ``LONG_EDGE``: a portrait and a
    landscape, random pixels from a seed."""
    rng = np.random.default_rng(0)
    folder = tmp_path_factory.mktemp('images')
    paths = []
    for i, shape in enumerate([(LONG_EDGE, 96, 3), (86, LONG_EDGE, 3)]):
        path = str(folder / f'image{i}.png')
        image_io.write_png(path, rng.integers(0, 256, shape, dtype=np.uint8))
        paths.append(path)
    return paths


def split_types(anns):
    """(poses, boxes), each in the order its decoder gave them."""
    poses = [a for a in anns if getattr(a, 'data', None) is not None]
    boxes = [a for a in anns if getattr(a, 'data', None) is None]
    assert len(poses) + len(boxes) == len(anns)
    return poses, boxes


def assert_same_annotations(want, got):
    want_poses, want_boxes = split_types(want)
    got_poses, got_boxes = split_types(got)
    assert len(got_poses) == len(want_poses) > 0
    assert len(got_boxes) == len(want_boxes) > 0
    for w, g in zip(want_poses, got_poses):
        assert isinstance(g, annotation.Annotation)
        np.testing.assert_allclose(g.data, w.data, atol=1e-3, rtol=0)
        assert abs(g.score - w.score) <= 1e-4
    for w, g in zip(want_boxes, got_boxes):
        assert isinstance(g, annotation.AnnotationDet)
        assert g.category_id == w.category_id
        np.testing.assert_allclose(g.bbox, w.bbox, atol=1e-3, rtol=0)
        assert abs(g.score - w.score) <= 1e-4


@pytest.fixture(scope='module')
def predictors(three_head_models):
    jax_model, port_model = three_head_models
    want = jax_predictor.Predictor(model=jax_model)
    got = Predictor(model=port_model, device='cpu')
    for p in (want, got):
        p.long_edge = LONG_EDGE
        p.batch_size = 2
    return want, got


def test_multi_decoder_matches_jax(three_head_models, predictors):
    """The JAX side decodes with its predictor's decoder (its factory's
    ``Multi``), which the image tests below reuse compiled."""
    jax_model, port_model = three_head_models
    x = np.random.default_rng(1).normal(
        size=(2, LONG_EDGE, LONG_EDGE, 3)).astype(np.float32)
    fields = [np.asarray(f) for f in jax_model.apply(jax_model.variables, x)]
    dec = decoder.factory(port_model.head_metas, device='cpu')
    assert isinstance(dec, decoder.Multi)
    assert [type(d) for d in dec.decoders] == [decoder.CifCaf, decoder.CifDet]
    jax_dec = predictors[0].decoder
    assert type(jax_dec) is type(jax_decoder.factory(jax_model.head_metas))
    assert {type(d).__name__ for d in jax_dec.decoders} == \
        {'CifCaf', 'CifDet'}
    want = jax_dec.batch_fields(fields)
    got = dec.batch_fields([torch.from_numpy(np.array(f)) for f in fields])
    assert len(got) == len(want) == 2
    for w, g in zip(want, got):
        assert_same_annotations(w, g)
    # one image through __call__
    one = dec([f[1] for f in fields])
    assert [a.json_data() for a in one] == [a.json_data() for a in got[1]]


def test_predictor_images_matches_jax(predictors, png_images):
    want_predictor, got_predictor = predictors
    want = list(want_predictor.images(png_images))
    got = list(got_predictor.images(png_images))
    assert len(got) == len(want) == 2
    for (want_anns, _, want_meta), (got_anns, gt, got_meta) in zip(want, got):
        assert gt == [] and got_meta['file_name'] == want_meta['file_name']
        for key in ('offset', 'scale', 'width_height'):
            np.testing.assert_array_equal(got_meta[key], want_meta[key])
        assert_same_annotations(want_anns, got_anns)
    one, _, _ = got_predictor.image(png_images[1])
    assert [a.json_data() for a in one] == \
        [a.json_data() for a in got[1][0]]


def test_predictor_images_multiscale_matches_jax(predictors, png_images,
                                                 monkeypatch):
    """The 129 px variant and its hflip, OKS-merged (poses), boxes from the
    reference (unflipped) variant; the same with ``multi_scale`` set,
    through ``images``."""
    want_predictor, got_predictor = predictors
    want = list(want_predictor.images_multiscale(png_images,
                                                 long_edges=[LONG_EDGE]))
    got = list(got_predictor.images_multiscale(png_images,
                                               long_edges=[LONG_EDGE]))
    assert len(got) == len(want) == 2
    for (want_anns, _, _), (got_anns, _, _) in zip(want, got):
        assert_same_annotations(want_anns, got_anns)
    single = list(got_predictor.images(png_images))
    assert any(len(split_types(m[0])[0]) != len(split_types(s[0])[0])
               for m, s in zip(got, single))
    monkeypatch.setattr(got_predictor, 'multi_scale', True)
    monkeypatch.setattr(got_predictor, 'multi_scale_factors', (1.0,))
    by_images = list(got_predictor.images(png_images))
    for (a, _, _), (b, _, _) in zip(by_images, got):
        assert [x.json_data() for x in a] == [x.json_data() for x in b]


# ------------------------------------------------------------- the CLI
def narrow_spec(base_module, sn_module):
    return base_module.BaseNetworkSpec(NARROW_NAME, sn_module._make(*NARROW),  # pylint: disable=protected-access
                                       stride=16, out_features=64)


def keep_configuration(monkeypatch, *objects):
    """Let ``monkeypatch`` restore the class attributes and module globals
    a CLI's ``configure`` sets."""
    for obj in objects:
        for name, value in list(vars(obj).items()):
            if name.startswith('__') or callable(value) or isinstance(
                    value, (classmethod, staticmethod, property)):
                continue
            monkeypatch.setattr(obj, name, value)


JAX_PREDICT = """
import sys
from openpifpaf_tpu import predict
from openpifpaf_tpu.models import base, shufflenetv2k
base.register_basenet(base.BaseNetworkSpec(
    {name!r}, shufflenetv2k._make(*{narrow!r}), stride=16, out_features=64))
sys.exit(predict.main(sys.argv[1:]))
"""


def json_types(path):
    with open(path) as f:
        data = json.load(f)
    poses = [d for d in data if 'keypoints' in d]
    boxes = [d for d in data if 'keypoints' not in d]
    return poses, boxes


def test_predict_cli_matches_jax(png_images, tmp_path, monkeypatch):
    _, variables = detecting_variables()
    checkpoint = str(tmp_path / 'model.npz')
    jax_checkpoint.save(checkpoint, variables=variables,
                        head_metas=three_head_metas(jax_headmeta),
                        basenet_name=NARROW_NAME, base_stride=16)
    args = [*png_images, f'--checkpoint={checkpoint}', '--no-bf16',
            f'--long-edge={LONG_EDGE}']
    out_jax, out_port = tmp_path / 'jax', tmp_path / 'port'
    out_jax.mkdir()
    out_port.mkdir()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.path.join(
        REPO, 'tests'), JAX_PLATFORMS='cpu', OMP_NUM_THREADS='1')
    proc = subprocess.run(
        [sys.executable, '-c', JAX_PREDICT.format(name=NARROW_NAME,
                                                  narrow=NARROW),
         *args, '--predictor-batch-size=2', f'--json-output={out_jax}'],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]

    monkeypatch.setitem(base.BASE_FACTORIES, NARROW_NAME,
                        narrow_spec(base, shufflenetv2k))
    keep_configuration(
        monkeypatch, Predictor, decoder.Decoder, debug_checks,
        importlib.import_module('openpifpaf_tpu_torch.decoder.factory'),
        *decoder.DECODERS)
    assert port_predict.main([*args, '--device=cpu', '--batch-size=2',
                              '-q', f'--json-output={out_port}']) == 0
    for path in png_images:
        name = os.path.basename(path) + '.predictions.json'
        want_poses, want_boxes = json_types(out_jax / name)
        got_poses, got_boxes = json_types(out_port / name)
        assert len(got_poses) == len(want_poses) > 0
        assert len(got_boxes) == len(want_boxes) > 0
        for w, g in zip(want_poses, got_poses):
            np.testing.assert_allclose(g['keypoints'], w['keypoints'],
                                       atol=0.01 + 1e-3, rtol=0)
            np.testing.assert_allclose(g['bbox'], w['bbox'],
                                       atol=0.01 + 1e-3, rtol=0)
            assert abs(g['score'] - w['score']) <= 0.001 + 1e-4
        for w, g in zip(want_boxes, got_boxes):
            assert (g['category_id'], g['category']) == \
                (w['category_id'], w['category'])
            np.testing.assert_allclose(g['bbox'], w['bbox'],
                                       atol=0.01 + 1e-3, rtol=0)
            assert abs(g['score'] - w['score']) <= 0.001 + 1e-4
    assert port_predict.main(['--checkpoint', checkpoint,
                              '--device=cpu', '-q']) == 1


JAX_PREDICT_ARGS = """
import json, sys
from openpifpaf_tpu import predict
from openpifpaf_tpu.datasets import DataModule
from openpifpaf_tpu.predictor import Predictor
args = predict.cli(sys.argv[1:])
print(json.dumps(dict(batch_size=args.batch_size,
                      predictor_batch_size=args.predictor_batch_size,
                      predictor=Predictor.batch_size,
                      data_module=DataModule.batch_size)))
"""


def test_batch_size_flag_differs_from_jax(tmp_path, monkeypatch):
    """``predict --batch-size 3``: the port's flag sets the predictor's
    batch (dest ``predictor_batch_size``, as ``--predictor-batch-size``);
    JAX's is its data modules' flag (``datasets.cli``), which its predict
    CLI never configures, so it changes nothing there."""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS='cpu',
               OMP_NUM_THREADS='1')
    proc = subprocess.run(
        [sys.executable, '-c', JAX_PREDICT_ARGS, 'x.png', '--batch-size=3'],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    jax_args = json.loads(proc.stdout.splitlines()[-1])
    assert jax_args['batch_size'] == 3
    assert jax_args['predictor_batch_size'] == jax_args['predictor'] == 1
    assert jax_args['data_module'] != 3

    keep_configuration(
        monkeypatch, Predictor, decoder.Decoder, debug_checks,
        importlib.import_module('openpifpaf_tpu_torch.decoder.factory'),
        *decoder.DECODERS)
    args = port_predict.cli(['x.png', '--checkpoint=m.npz', '--batch-size=3'])
    assert args.predictor_batch_size == Predictor.batch_size == 3
    assert not hasattr(args, 'batch_size')
    assert port_predict.cli(['x.png', '--checkpoint=m.npz',
                             '--predictor-batch-size=2']) \
        .predictor_batch_size == Predictor.batch_size == 2


def test_predict_cli_refusals(capsys):
    """``-o`` (once refused) parses as JAX's; ``--checkpoint`` is
    required."""
    args = port_predict.cli(['x.png', '--checkpoint=m.npz', '-o', 'out.jpg'])
    assert args.image_output == 'out.jpg'
    assert port_predict.cli(['x.png', '--checkpoint=m.npz', '-o']) \
        .image_output is True
    with pytest.raises(SystemExit):
        port_predict.cli(['x.png'])
    assert '--checkpoint' in capsys.readouterr().err


# ------------------------------------------------------- debug checks
def test_debug_checks_raise_on_nan(three_head_models, monkeypatch):
    _, port_model = three_head_models
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(1, 3, 65, 65)).astype(np.float32))
    fields = [f.clone() for f in port_model(x)]
    fields[0][0, 3, 1, 2, 2] = float('nan')     # a CIF x offset
    fields[2][0, 4, 1, 3, 3] = float('nan')     # a CifDet y offset
    cifcaf = decoder.CifCaf(*port_model.head_metas[:2], device='cpu')
    cifdet = decoder.CifDet(port_model.head_metas[2], device='cpu')

    monkeypatch.setattr(debug_checks, '_ENABLED', False)
    cifcaf.batch_fields(fields)
    cifdet.batch_fields(fields)

    parser = argparse.ArgumentParser()
    logger.cli(parser)
    debug_checks.configure(parser.parse_args(['--debug-checks']))
    assert debug_checks.enabled()
    for dec in (cifcaf, cifdet):
        with pytest.raises(debug_checks.DebugCheckError, match='non-finite'):
            dec.batch_fields(fields)
    debug_checks.configure(parser.parse_args([]))
    assert not debug_checks.enabled()
    debug_checks.configure(parser.parse_args(['--debug']))
    assert debug_checks.enabled()
    with pytest.raises(debug_checks.DebugCheckError, match='out of bounds'):
        common.gather_field(torch.zeros(1, 2, 3, 3), torch.tensor([[2]]),
                            torch.zeros(1, 1), torch.zeros(1, 1))
