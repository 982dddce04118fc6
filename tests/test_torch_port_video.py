"""The port's video CLI (``openpifpaf_tpu_torch.video``) and PNG reader
(``openpifpaf_tpu_torch.image_io``) against the JAX package.

- One JAX-written ``tshufflenetv2k16`` checkpoint (seeded weights, the
  toykpst CIF, CAF and TCAF heads, the confidence and scale biases shifted
  so that poses are found and tracked) streams the same five PNG frames
  through both CLIs, ``--device cpu --no-bf16`` for the port.  The frames
  are written at the long edge, so neither package rescales and both see
  the same pixels.  The json lines must have the same frames, the same
  track ids per frame and keypoints within 1e-3.
- The PNG reader against PIL on greyscale, grey with alpha, RGB and RGBA
  files written with each of the five row filters, and on PIL's own
  files; JPEG goes through PIL when it is importable and raises a
  ``ValueError`` naming the decoder when it is not.
- ``--video-output`` and ``--show`` raise ``NotImplementedError``, and the
  CLI without CUDA and without ``--device`` raises.
"""

import io
import json
import os
import subprocess
import sys

import jax
import numpy as np
import PIL.Image
import pytest
import torch

from openpifpaf_tpu import models as jax_models
from openpifpaf_tpu.plugins.posetrack.toykpst import ToyKpSt as JaxToyKpSt
from openpifpaf_tpu_torch import image_io, video

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EDGE = 65
N_FRAMES = 5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the CPU decode is many small ops, and the
    cores are left to the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def shifted_biases(variables, metas):
    """Confidence and scale biases up, as ``chip_smoke.py``'s
    ``shift_head_biases``, by less: some cells detect, not all."""
    params = jax.tree.map(np.array, variables['params'])
    for i, meta in enumerate(metas):
        bias = params[f'head_nets_{i}']['conv']['bias'].reshape(
            meta.n_fields, meta.n_components)
        bias[:, 0] = 0.5
        bias[:, meta.n_components - meta.n_scales:] = 2.0
        params[f'head_nets_{i}']['conv']['bias'] = bias.reshape(-1)
    return dict(variables, params=params)


@pytest.fixture(scope='module', name='stream')
def fixture_stream(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('video')
    metas = JaxToyKpSt().head_metas
    model = jax_models.Factory(base_name='tshufflenetv2k16', bf16=False) \
        .from_scratch('tshufflenetv2k16', metas)
    model.init(jax.random.key(0), input_hw=(EDGE, EDGE))
    checkpoint = str(tmp / 'tracking.npz')
    jax_models.checkpoint.save(
        checkpoint, variables=shifted_biases(model.variables, metas),
        head_metas=model.head_metas, basenet_name='tshufflenetv2k16',
        base_stride=16)

    frames = tmp / 'frames'
    frames.mkdir()
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (EDGE, 49, 3), dtype=np.uint8)
    for i in range(N_FRAMES):
        frame = np.roll(base, 3 * i, axis=1)   # a slow pan
        PIL.Image.fromarray(frame, 'RGB').save(str(frames / f'{i:03d}.png'))
    return checkpoint, str(frames), tmp


def cli(package, args):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS='cpu',
               OMP_NUM_THREADS='1')
    return subprocess.Popen(
        [sys.executable, '-m', f'{package}.video'] + args, cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def test_json_lines_equal_jax(stream):
    checkpoint, frames, tmp = stream
    common = ['--source', frames, '--checkpoint', checkpoint, '--long-edge',
              str(EDGE), '--no-bf16']
    outs = {p: str(tmp / f'{p}.jsonl')
            for p in ('openpifpaf_tpu', 'openpifpaf_tpu_torch')}
    procs = {
        'openpifpaf_tpu': cli('openpifpaf_tpu', common + [
            '--json-output', outs['openpifpaf_tpu']]),
        'openpifpaf_tpu_torch': cli('openpifpaf_tpu_torch', common + [
            '--device', 'cpu', '--json-output',
            outs['openpifpaf_tpu_torch']]),
    }
    for name, proc in procs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, f'{name}: {err[-3000:]}'
    want, got = ([json.loads(line) for line in open(outs[p])]
                 for p in ('openpifpaf_tpu', 'openpifpaf_tpu_torch'))
    assert [line['frame'] for line in got] == list(range(N_FRAMES))
    assert [line['frame'] for line in want] == list(range(N_FRAMES))
    n_poses = 0
    for w, g in zip(want, got):
        w_by_id = {p['id_']: p for p in w['predictions']}
        g_by_id = {p['id_']: p for p in g['predictions']}
        assert sorted(g_by_id) == sorted(w_by_id), w['frame']
        for i, pred in w_by_id.items():
            np.testing.assert_allclose(g_by_id[i]['keypoints'],
                                       pred['keypoints'], atol=1e-3, rtol=0)
            assert abs(g_by_id[i]['score'] - pred['score']) <= 1e-3
        n_poses += len(w_by_id)
    assert n_poses >= N_FRAMES
    # ids carry over between frames
    ids = [{p['id_'] for p in line['predictions']} for line in got]
    assert ids[0] & ids[-1]


def test_frame_reader(stream):
    _, frames, _ = stream
    got = list(video.FrameReader(frames, start_frame=1, skip_frames=2))
    assert [i for i, _, _ in got] == [0, 1]
    assert [os.path.basename(p) for _, p, _ in got] == ['001.png', '003.png']
    with PIL.Image.open(got[1][1]) as im:
        np.testing.assert_array_equal(got[1][2], np.asarray(im))
    with pytest.raises(ValueError, match='OpenCV'):
        list(video.FrameReader(os.path.join(frames, '000.png')))


@pytest.mark.parametrize('mode', ['L', 'LA', 'RGB', 'RGBA'])
@pytest.mark.parametrize('row_filter', image_io.FILTERS)
def test_png_reader_against_pil(mode, row_filter, tmp_path):
    channels = {'L': 1, 'LA': 2, 'RGB': 3, 'RGBA': 4}[mode]
    rng = np.random.default_rng(channels)
    image = rng.integers(0, 256, (13, 17, channels), dtype=np.uint8)
    image[4:9, 3:11] = 200          # flat runs: every filter's predictor
    data = image_io.png_bytes(image, row_filter)
    with PIL.Image.open(io.BytesIO(data)) as im:
        assert im.mode == mode
        pil = np.asarray(im).reshape(image.shape)
        pil_rgb = np.asarray(im.convert('RGB'))
    np.testing.assert_array_equal(image_io.read_png(data), pil)
    np.testing.assert_array_equal(image_io.read_png(data), image)
    path = str(tmp_path / 'x.png')
    with open(path, 'wb') as f:
        f.write(data)
    np.testing.assert_array_equal(image_io.read_image(path), pil_rgb)


@pytest.mark.parametrize('mode', ['L', 'RGB', 'RGBA'])
def test_png_reader_on_pil_files(mode, tmp_path):
    rng = np.random.default_rng(7)
    shape = (31, 23) if mode == 'L' else (31, 23, len(mode))
    image = rng.integers(0, 256, shape, dtype=np.uint8)
    image[10:20] = image[9]         # smooth rows make PIL pick the filters
    path = str(tmp_path / 'pil.png')
    PIL.Image.fromarray(image, mode).save(path)
    with PIL.Image.open(path) as im:
        want = np.asarray(im.convert('RGB'))
    np.testing.assert_array_equal(image_io.read_image(path), want)


def test_other_formats(tmp_path, monkeypatch):
    image = np.random.default_rng(0).integers(0, 256, (9, 11, 3), np.uint8)
    path = str(tmp_path / 'x.bmp')
    PIL.Image.fromarray(image).save(path)
    np.testing.assert_array_equal(image_io.read_image(path), image)

    def no_pil(name):
        raise ImportError(f'No module named {name!r}')

    monkeypatch.setattr(image_io.importlib, 'import_module', no_pil)
    with pytest.raises(ValueError, match='PIL decoder'):
        image_io.read_image(path)
    with pytest.raises(ValueError, match='16-bit|bit depth'):
        buf = io.BytesIO()
        PIL.Image.fromarray(image[:, :, 0].astype(np.uint16) * 256) \
            .save(buf, 'PNG')
        image_io.read_png(buf.getvalue())


def test_refused_flags_and_no_cuda(stream, monkeypatch):
    checkpoint, frames, _ = stream
    base = ['--source', frames, '--checkpoint', checkpoint]
    for flag in (['--video-output', '/dev/null'], ['--show']):
        with pytest.raises(NotImplementedError, match='visualizers'):
            video.cli(base + ['--device', 'cpu'] + flag)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        video.main(base + ['--max-frames', '1'])
