"""The port's painters and canvases (``openpifpaf_tpu_torch.show``) against
the JAX package's, pixel for pixel, under matplotlib's Agg backend.

- The same annotations, built in each package from one seeded numpy array
  (three poses with joints below and above the solid-line threshold and
  some not visible, an ``AnnotationDet`` and an ``AnnotationCrowd``), drawn
  by each package's ``AnnotationPainter`` through its ``image_canvas`` into
  a PNG, under each setting of the ``show`` flag group: the PNGs' pixels
  are equal.
- The reference's quirks, kept: ``--show-box``, ``--show-joint-scales``,
  ``--show-joint-confidences`` and ``--show-decoding-order`` set the
  painter's attributes and change no pixel; the default painters have no
  ``CrowdPainter``, so an ``AnnotationCrowd`` is logged and skipped;
  ``CrowdPainter`` draws only an annotation with a ``fixed_bbox``.
- ``canvas`` (with and without margins), ``white_screen`` and
  ``AnimationFrame`` give equal pixels; the flag group's defaults are
  JAX's; importing the package loads no matplotlib, and
  ``require_matplotlib`` raises where it cannot be imported.
- The CLIs, on a checkpoint of a narrow ShuffleNetV2K with seeded weights
  (confidence and scale biases raised so that poses are found) and PNGs
  of 97 x 129 px, ``--device cpu``: ``predict -o`` writes
  ``<image>.predictions.jpg``, byte-equal to what JAX's predict CLI writes
  for the same annotations (JAX's ``image_canvas`` on the PIL image and
  its ``AnnotationPainter``; the annotations are the port's own, those of
  its json output, taken before the json rounds them); ``video
  --video-output`` writes one ``NNNNNN.jpg`` per frame, byte-equal to
  JAX's rendering of the frame and its annotations.  Reference quirks:
  ``predict --debug-indices`` renders no decoder view (``Predictor``
  decodes through ``batch_fields``), the video CLI's single-image decode
  renders 6 per frame; ``video --show`` runs and has no effect.  ``train
  --debug-indices`` trains (the views are configured; as in JAX, training
  renders none).  Without matplotlib, ``-o``, ``--video-output`` and
  ``--debug-indices`` raise before any model is built and write nothing.
"""

import json
import logging
import os
import subprocess
import sys

import matplotlib
import numpy as np
import PIL.Image
import pytest
import torch

matplotlib.use('Agg')

from openpifpaf_tpu import annotation as jax_annotation  # noqa: E402
from openpifpaf_tpu import show as jax_show  # noqa: E402
from openpifpaf_tpu_torch import (annotation, debug_checks, decoder,  # noqa: E402
                                  headmeta, image_io, models, predict, show,
                                  train, video, visualizer)
from openpifpaf_tpu_torch.models import base, checkpoint, shufflenetv2k  # noqa: E402
from openpifpaf_tpu_torch.predictor import Predictor  # noqa: E402
from openpifpaf_tpu_torch.plugins.coco import constants  # noqa: E402

SIZE = (97, 129)   # image (H, W)

SETTINGS = {
    'default': [],
    'monocolor': ['--monocolor-connections'],
    'line-width': ['--line-width', '5'],
    'marker-size': ['--marker-size', '7'],
    'textbox-alpha': ['--textbox-alpha', '0.9'],
    'show-box': ['--show-box'],
    'show-joint-scales': ['--show-joint-scales'],
    'show-joint-confidences': ['--show-joint-confidences'],
    'show-decoding-order': ['--show-decoding-order'],
}
# the flags that the painters do not read (reference quirk)
UNREAD = ('show-box', 'show-joint-scales', 'show-joint-confidences',
          'show-decoding-order')


@pytest.fixture(autouse=True)
def restore_painters(monkeypatch):
    """``configure`` sets class attributes: restore them after each
    test."""
    for module in (jax_show, show):
        for cls in (module.KeypointPainter, module.AnimationFrame):
            for name, value in list(vars(cls).items()):
                if not name.startswith('_') and not callable(value):
                    monkeypatch.setattr(cls, name, value)


def configure(module, argv):
    import argparse

    parser = argparse.ArgumentParser()
    module.cli(parser)
    args = parser.parse_args(argv)
    module.configure(args)
    return vars(args)


def scene_arrays(seed=0):
    """Poses (3, 17, 3), their scores, a box and a crowd box, in px."""
    rng = np.random.default_rng(seed)
    h, w = SIZE
    xyv = np.zeros((3, 17, 3), np.float32)
    xyv[..., 0] = rng.uniform(5, w - 5, (3, 17))
    xyv[..., 1] = rng.uniform(5, h - 5, (3, 17))
    xyv[..., 2] = rng.choice([0.0, 0.3, 0.8, 1.0], (3, 17))
    scores = rng.uniform(0.2, 0.9, 3)
    box = rng.uniform(10, 50, 4).astype(np.float32)
    crowd = rng.uniform(10, 50, 4).astype(np.float32)
    return xyv, scores, box, crowd


def scene(ann_module, seed=0):
    xyv, scores, box, crowd = scene_arrays(seed)
    anns = []
    for pose, score in zip(xyv, scores):
        ann = ann_module.Annotation(constants.COCO_KEYPOINTS,
                                    constants.COCO_PERSON_SKELETON)
        ann.data[:] = pose
        ann.fixed_score = float(score)
        anns.append(ann)
    anns.append(ann_module.AnnotationDet(['person', 'car']).set(
        1, 0.75, box))
    anns.append(ann_module.AnnotationCrowd(['person']).set(1, crowd))
    return anns


def image(seed=1):
    return np.random.default_rng(seed).integers(0, 256, (*SIZE, 3),
                                                dtype=np.uint8)


def pixels(path):
    with PIL.Image.open(path) as im:
        return np.asarray(im)


def draw(module, ann_module, path, painter=None, anns=None):
    painter = painter or module.AnnotationPainter()
    with module.image_canvas(image(), str(path)) as ax:
        painter.annotations(ax, scene(ann_module) if anns is None else anns)
    return pixels(path)


@pytest.mark.parametrize('setting', sorted(SETTINGS))
def test_annotations_pixels_equal(setting, tmp_path, caplog):
    # before configure: the flags' defaults are the class attributes
    default = draw(show, annotation, tmp_path / 'default.png')
    argv = SETTINGS[setting]
    assert configure(jax_show, argv) == configure(show, argv)
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        want = draw(jax_show, jax_annotation, tmp_path / 'jax.png')
        got = draw(show, annotation, tmp_path / 'port.png')
    assert got.shape == (*SIZE, 4)
    np.testing.assert_array_equal(got, want)
    # the crowd annotation has no default painter: one warning per package
    assert [r.getMessage() for r in caplog.records].count(
        'no painter for AnnotationCrowd') == 2
    if setting in UNREAD:
        # quirk: the flag sets the painter's attribute and draws the same
        assert getattr(show.KeypointPainter,
                       setting.replace('-', '_')) is True
        np.testing.assert_array_equal(got, default)
    else:
        assert np.array_equal(got, default) == (setting == 'default')


def test_crowd_skipped_by_default(tmp_path):
    """Quirk: an ``AnnotationCrowd`` draws nothing with the default
    painters, and ``CrowdPainter`` draws only what has a ``fixed_bbox``
    (which ``AnnotationCrowd`` has not; a pose with one is filled)."""
    anns = scene(annotation)
    without = draw(show, annotation, tmp_path / 'a.png', anns=anns[:-1])
    with_crowd = draw(show, annotation, tmp_path / 'b.png', anns=anns)
    np.testing.assert_array_equal(with_crowd, without)

    outputs = []
    for module, ann_module in ((jax_show, jax_annotation),
                               (show, annotation)):
        anns = scene(ann_module)
        anns[0].fixed_bbox = np.array([20.0, 10.0, 40.0, 30.0], np.float32)
        painter = module.AnnotationPainter(painters={
            'AnnotationCrowd': module.CrowdPainter(),
            'Annotation': module.CrowdPainter(color='blue')})
        outputs.append(draw(module, ann_module,
                            tmp_path / f'{module.__name__}.png',
                            painter=painter, anns=[anns[-1], anns[0]]))
    np.testing.assert_array_equal(outputs[1], outputs[0])
    blank = draw(show, annotation, tmp_path / 'blank.png', anns=[])
    assert not np.array_equal(outputs[1], blank)
    painter = show.AnnotationPainter(
        painters={'AnnotationCrowd': show.CrowdPainter()})
    crowd_only = draw(show, annotation, tmp_path / 'crowd.png',
                      painter=painter, anns=[scene(annotation)[-1]])
    np.testing.assert_array_equal(crowd_only, blank)


def test_narrow_image_text_fails_in_both(tmp_path):
    """Reference fault, kept: on an image under ~90 px wide the canvas's
    dpi makes the painters' 8 pt text smaller than a pixel, and FreeType
    refuses it in both packages."""
    narrow = image()[:, :49]
    for module, ann_module in ((jax_show, jax_annotation),
                               (show, annotation)):
        with pytest.raises(RuntimeError, match='ppem'):
            with module.image_canvas(narrow, str(tmp_path / 'x.png')) as ax:
                module.AnnotationPainter().annotations(
                    ax, scene(ann_module)[:1])


@pytest.mark.parametrize('nomargin', [False, True])
def test_canvas_and_white_screen(nomargin, tmp_path):
    outputs = []
    for module in (jax_show, show):
        path = tmp_path / f'{module.__name__}.png'
        with module.canvas(str(path), dpi=50, nomargin=nomargin,
                           figsize=(3, 2)) as ax:
            module.white_screen(ax, alpha=0.5)
            ax.plot([0, 1, 2], [2, 0, 1], 'o-')
            ax.set_title('canvas')
        outputs.append(pixels(path))
    np.testing.assert_array_equal(outputs[1], outputs[0])


def test_animation_frame(tmp_path):
    outputs = []
    for module in (jax_show, show):
        frame = module.AnimationFrame(fig_width=2.0)
        frame.show = False
        frame.frame_init(image(2))
        frame.ax.plot([10, 60], [10, 50], 'r-')
        frame.update(image(3))          # clears the line
        frame.ax.annotate('x', (30, 30))
        path = tmp_path / f'{module.__name__}.png'
        frame.save_frame(str(path), dpi=40)
        frame.close()
        assert frame.fig is None
        outputs.append(pixels(path))
    np.testing.assert_array_equal(outputs[1], outputs[0])


def test_flag_defaults_match_jax():
    assert configure(show, []) == configure(jax_show, [])
    argv = ['--video-fps', '25', '--line-width', '3']
    assert configure(show, argv) == configure(jax_show, argv)
    assert show.AnimationFrame.video_fps == 25


def test_no_matplotlib_at_import_and_loud_without_it():
    """Importing the rendering modules loads no matplotlib; where it
    cannot be imported, ``require_matplotlib`` raises, naming it."""
    code = (
        'import sys\n'
        'import openpifpaf_tpu_torch.show as show, '
        'openpifpaf_tpu_torch.visualizer, openpifpaf_tpu_torch.logs\n'
        'assert not [m for m in sys.modules if m.startswith("matplotlib")]\n'
        'sys.modules["matplotlib"] = None\n'
        'try:\n'
        '    show.require_matplotlib()\n'
        'except ImportError as e:\n'
        '    assert "matplotlib" in str(e), e\n'
        'else:\n'
        '    raise AssertionError("no ImportError")\n')
    subprocess.run([sys.executable, '-c', code], check=True, timeout=60)


# ------------------------------------------------------------------ CLIs
NARROW_NAME = 'shufflenetv2k-narrow-show-test'
NARROW = ((1, 2, 1), (8, 16, 32, 64, 64))   # test_torch_port_models.NARROW


def keep_configuration(monkeypatch):
    """Let ``monkeypatch`` restore what the CLIs' ``configure`` sets."""
    objects = [Predictor, decoder.Decoder, debug_checks, visualizer.Base,
               sys.modules['openpifpaf_tpu_torch.decoder.factory'],
               *decoder.DECODERS]
    for obj in objects:
        for name, value in list(vars(obj).items()):
            if name.startswith('__') or callable(value) or isinstance(
                    value, (classmethod, staticmethod, property)):
                continue
            monkeypatch.setattr(obj, name, value)


@pytest.fixture(name='cli_inputs')
def fixture_cli_inputs(tmp_path, monkeypatch):
    """(checkpoint, two PNG paths, frames directory)."""
    keep_configuration(monkeypatch)
    spec = base.BaseNetworkSpec(
        NARROW_NAME, shufflenetv2k._make(*NARROW),  # pylint: disable=protected-access
        stride=16, out_features=64)
    monkeypatch.setitem(base.BASE_FACTORIES, NARROW_NAME, spec)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cif = headmeta.Cif(
        'cif', 'cocokp', keypoints=constants.COCO_KEYPOINTS,
        sigmas=constants.COCO_PERSON_SIGMAS,
        pose=constants.COCO_UPRIGHT_POSE,
        score_weights=constants.COCO_PERSON_SCORE_WEIGHTS)
    caf = headmeta.Caf(
        'caf', 'cocokp', keypoints=constants.COCO_KEYPOINTS,
        sigmas=constants.COCO_PERSON_SIGMAS,
        skeleton=constants.COCO_PERSON_SKELETON)
    model = models.factory(NARROW_NAME, [cif, caf], device='cpu',
                           bf16=False, seed=0)
    with torch.no_grad():
        for head, meta in zip(model.module.head_nets, model.head_metas):
            bias = head.conv.bias.view(meta.n_fields, meta.n_components)
            bias[:, 0] = 1.0
            bias[:, meta.n_components - meta.n_scales:] = 2.0
    path = str(tmp_path / 'model.npz')
    checkpoint.save(path, variables=models.to_jax_variables(
        model.module.state_dict()), head_metas=model.head_metas,
        basenet_name=NARROW_NAME, base_stride=16)
    frames = tmp_path / 'frames'
    frames.mkdir()
    rng = np.random.default_rng(0)
    pan = rng.integers(0, 256, (97, 137, 3), dtype=np.uint8)
    for i in range(2):
        image_io.write_png(str(frames / f'{i:03d}.png'),
                           np.ascontiguousarray(pan[:, 4 * i:4 * i + 129]))
    images = [str(frames / f'{i:03d}.png') for i in range(2)]
    yield path, images, str(frames)
    torch.set_num_threads(threads)


def record_painted(monkeypatch):
    """The annotations each port render is handed."""
    painted = []
    annotations = show.AnnotationPainter.annotations

    def spy(self, ax, anns, **kwargs):
        painted.append(list(anns))
        return annotations(self, ax, anns, **kwargs)
    monkeypatch.setattr(show.AnnotationPainter, 'annotations', spy)
    return painted


def jax_rendering(image_rgb, anns, path):
    """JAX's CLIs' rendering of ``anns`` (port annotations) over the
    image, into ``path``; its bytes."""
    jax_anns = []
    for ann in anns:
        jax_ann = jax_annotation.Annotation(ann.keypoints, ann.skeleton)
        jax_ann.data[:] = ann.data
        jax_ann.fixed_score = ann.fixed_score
        jax_anns.append(jax_ann)
    with jax_show.image_canvas(image_rgb, path) as ax:
        jax_show.AnnotationPainter().annotations(ax, jax_anns)
    with open(path, 'rb') as f:
        return f.read()


def read_bytes(path):
    with open(path, 'rb') as f:
        return f.read()


def test_predict_image_output_matches_jax(cli_inputs, tmp_path,
                                          monkeypatch):
    ckpt, images, _ = cli_inputs
    painted = record_painted(monkeypatch)
    out, views = tmp_path / 'out', tmp_path / 'views'
    out.mkdir()
    assert predict.main([*images, f'--checkpoint={ckpt}', '--device=cpu',
                         '--no-bf16', '--long-edge=129', '-q',
                         f'--json-output={out}', '-o', str(out),
                         '--debug-indices', 'cif:0', 'seeds',
                         '--save-all', str(views)]) == 0
    assert not views.exists()   # quirk: Predictor's path has no hook
    assert len(painted) == 2 and all(painted)
    for path, anns in zip(images, painted):
        name = os.path.join(out, os.path.basename(path))
        with open(name + '.predictions.json') as f:
            assert json.load(f) == [a.json_data() for a in anns]
        got = read_bytes(name + '.predictions.jpg')
        with PIL.Image.open(path) as im:   # as JAX's predict reads it
            want = jax_rendering(im, anns, str(tmp_path / 'jax.jpg'))
        assert got == want
        with PIL.Image.open(name + '.predictions.jpg') as im:
            assert im.size == (129, 97)


def test_video_output_matches_jax(cli_inputs, tmp_path, monkeypatch,
                                  caplog):
    ckpt, _, frames = cli_inputs
    painted = record_painted(monkeypatch)
    out, views = tmp_path / 'frames-out', tmp_path / 'views'
    with caplog.at_level(logging.WARNING):
        assert video.main([
            '--source', frames, f'--checkpoint={ckpt}', '--device=cpu',
            '--no-bf16', '--long-edge=129', '--video-output', str(out),
            '--show', '--debug-indices', 'cif:0', 'caf:0', 'cifhr:0',
            'seeds', '--save-all', str(views)]) == 0
    assert sum('--show has no effect' in r.getMessage()
               for r in caplog.records) == 1
    assert sorted(os.listdir(out)) == ['000000.jpg', '000001.jpg']
    assert len(os.listdir(views)) == 12   # 6 views per frame
    assert len(painted) == 2 and all(painted)
    for i, anns in enumerate(painted):
        frame = image_io.read_image(os.path.join(frames, f'{i:03d}.png'))
        want = jax_rendering(frame, anns, str(tmp_path / 'jax.jpg'))
        assert read_bytes(out / f'{i:06d}.jpg') == want


def test_train_debug_indices(cli_inputs, tmp_path):
    """One epoch of toykp on the narrow backbone with ``--debug-indices``
    and ``--save-all``: it trains, the indices are configured, and no view
    is rendered."""
    out, views = tmp_path / 'model', tmp_path / 'views'
    assert train.main([
        '--device=cpu', '--dataset=toykp', f'--basenet={NARROW_NAME}',
        '--toykp-image-size=33', '--toykp-n-images=4', '--batch-size=2',
        '--epochs=1', '--no-bf16', '-q', '-o', str(out),
        '--debug-indices', 'cif:0', 'caf:0', '--save-all', str(views)]) == 0
    assert os.path.exists(str(out) + '.npz')
    assert visualizer.Base.all_indices == [('cif', 0, 'all'),
                                           ('caf', 0, 'all')]
    assert visualizer.Base.save_dir == str(views)
    assert not views.exists()


def test_no_matplotlib_no_output(cli_inputs, tmp_path, monkeypatch):
    """Without matplotlib, ``-o``, ``--video-output`` and
    ``--debug-indices`` raise naming it, before any model is built."""
    ckpt, images, frames = cli_inputs
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    monkeypatch.setitem(sys.modules, 'matplotlib.pyplot', None)
    def refuse(*args, **kwargs):
        pytest.fail('a model was built')

    monkeypatch.setattr(Predictor, '__init__', refuse)
    monkeypatch.setattr(models, 'factory', refuse)
    out = tmp_path / 'out'
    out.mkdir()
    runs = [
        lambda: predict.main([*images, f'--checkpoint={ckpt}',
                              '--device=cpu', '-o', str(out),
                              f'--json-output={out}']),
        lambda: predict.main([*images, f'--checkpoint={ckpt}',
                              '--device=cpu', '--debug-indices', 'cif:0']),
        lambda: video.main(['--source', frames, f'--checkpoint={ckpt}',
                            '--device=cpu', '--video-output', str(out)]),
        lambda: video.main(['--source', frames, f'--checkpoint={ckpt}',
                            '--device=cpu', '--debug-indices', 'tcaf:0']),
        lambda: train.main(['--device=cpu', '--dataset=toykp',
                            f'--basenet={NARROW_NAME}', '-o',
                            str(out / 'model'), '--debug-indices', 'cif:0']),
    ]
    for run in runs:
        with pytest.raises(ImportError, match='matplotlib'):
            run()
    assert not os.listdir(out)
