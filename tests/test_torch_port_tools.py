"""The port's last tools against the JAX package's.

- ``benchmark``: from stats files already written (so that no eval runs)
  both packages' tables, byte for byte.
- ``Configurable``: keyword overrides and the ``ValueError`` contract.
- ``TorchDatasetAdapter``: numpy items, bare and with COCO annotations,
  through both packages' normalization and eval transform; the port's
  uint8 tensor items and its refusal of other items.
- ``plugin``: a fake ``openpifpaf_torch_*`` module under ``tmp_path`` is
  registered by the port and left alone by the JAX package.
- ``video.FrameReader`` on a short MJPG ``.avi`` written with OpenCV:
  the frames, names and selection of JAX's reader; without OpenCV both
  refuse with the same ``ValueError``.
"""

import importlib
import json
import sys

import cv2
import numpy as np
import pytest
import torch

from openpifpaf_tpu import benchmark as jax_benchmark
from openpifpaf_tpu import configurable as jax_configurable
from openpifpaf_tpu import plugin as jax_plugin
from openpifpaf_tpu import transforms as jax_transforms
from openpifpaf_tpu import video as jax_video
from openpifpaf_tpu.datasets import torch_dataset as jax_torch_dataset
from openpifpaf_tpu_torch import benchmark, configurable, plugin, transforms
from openpifpaf_tpu_torch import video
from openpifpaf_tpu_torch.datasets import TorchDatasetAdapter
from openpifpaf_tpu_torch.plugins.coco import constants

STATS = {
    'a.npz': {'stats': [0.6512, 0.8, 0.7, 0.5, 0.75, 0.7, 0.85, 0.7, 0.6,
                        0.8],
              'text_labels': ['AP', 'AP0.5', 'AP0.75', 'APM', 'APL', 'AR',
                              'AR0.5', 'AR0.75', 'ARM', 'ARL'],
              'total_time': 12.34, 'decoder_time': 5.67},
    'b.npz': {'stats': [0.4, 0.6, 0.3, -1.0, 0.45, 0.5, 0.7, 0.4, -1.0,
                        0.5],
              'text_labels': ['AP', 'AP0.5', 'AP0.75', 'APM', 'APL', 'AR',
                              'AR0.5', 'AR0.75', 'ARM', 'ARL'],
              'total_time': 1.0},
}


def test_benchmark_table_equals_jax(tmp_path):
    (tmp_path / 'a.npz').write_bytes(b'x' * 1234567)
    tables = {}
    for name, main in (('jax', jax_benchmark.main),
                       ('port', benchmark.main)):
        out = tmp_path / name
        out.mkdir()
        for checkpoint, stats in STATS.items():
            with open(out / f'{checkpoint}.eval-toykp.stats.json', 'w') as f:
                json.dump(stats, f)
        assert main(['--checkpoints', str(tmp_path / 'a.npz'),
                     str(tmp_path / 'b.npz'), '--dataset=toykp',
                     '--output-dir', str(out)]) == 0
        tables[name] = (out / 'benchmark-toykp.md').read_bytes()
    assert tables['port'] == tables['jax']
    assert b'| a.npz | 65.1 | 80.0 | 70.0 | 50.0 | 75.0 | 12.3s | 5.7s ' \
        b'| 1.2MB |' in tables['port']


@pytest.mark.parametrize('module', [jax_configurable, configurable],
                         ids=['jax', 'port'])
def test_configurable(module):
    class Thing(module.Configurable):
        width = 3

    assert Thing().width == 3
    thing = Thing(width=5)
    assert thing.width == 5 and Thing.width == 3
    with pytest.raises(ValueError, match="Thing has no configuration "
                                         "attribute 'height'"):
        Thing(height=1)
    Thing.cli(None)
    Thing.configure(None)


def items(seed=0):
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, (13, 17, 3), dtype=np.uint8)
    kp = np.zeros((17, 3))
    kp[:5] = [[2, 3, 2], [4, 5, 2], [6, 3, 1], [8, 9, 2], [1, 1, 2]]
    anns = [{'keypoints': kp.reshape(-1).tolist(), 'bbox': [1, 1, 8, 9],
             'category_id': 1, 'iscrowd': 0}]
    return [image, (image, anns)]


def preprocess(package):
    return package.Compose([
        package.NormalizeAnnotations(constants.COCO_KEYPOINTS,
                                     constants.COCO_PERSON_SKELETON),
        package.EVAL_TRANSFORM])


def test_torch_dataset_adapter_matches_jax():
    want = jax_torch_dataset.TorchDatasetAdapter(
        items(), preprocess(jax_transforms))
    got = TorchDatasetAdapter(items(), preprocess(transforms))
    assert len(got) == len(want) == 2
    for i in range(2):
        (wi, wa, wm), (gi, ga, gm) = want[i], got[i]
        np.testing.assert_allclose(gi.permute(1, 2, 0).numpy(), wi,
                                   atol=1e-6, rtol=0)
        assert gm['dataset_index'] == wm['dataset_index'] == i
        for key in ('offset', 'scale', 'valid_area', 'width_height'):
            np.testing.assert_array_equal(gm[key], wm[key], err_msg=key)
        assert len(ga) == len(wa) == i
        for a, b in zip(ga, wa):
            np.testing.assert_array_equal(a.data, b.data)
    # without a preprocess: the image as the transforms take it
    bare_want = jax_torch_dataset.TorchDatasetAdapter(items())[0]
    bare = TorchDatasetAdapter(items(), index_field=None)[0]
    assert bare[2] == {}
    np.testing.assert_array_equal(bare[0].permute(1, 2, 0).numpy(),
                                  np.asarray(bare_want[0], np.float32))
    tensor_item = torch.from_numpy(items()[0]).permute(2, 0, 1)
    assert torch.equal(TorchDatasetAdapter([tensor_item])[0][0],
                       bare[0])
    with pytest.raises(TypeError, match='dataset item 0'):
        TorchDatasetAdapter([np.zeros((4, 4, 3), np.float32)])[0]  # pylint: disable=expression-not-assigned


FAKE_PLUGIN = '''
CALLS = []


def register():
    CALLS.append('registered')
'''


def test_plugin_discovers_the_port_prefix_only(tmp_path, monkeypatch):
    name = 'openpifpaf_torch_fake_plugin'
    (tmp_path / f'{name}.py').write_text(FAKE_PLUGIN)
    monkeypatch.syspath_prepend(str(tmp_path))
    importlib.invalidate_caches()
    monkeypatch.delitem(sys.modules, name, raising=False)
    monkeypatch.setattr(jax_plugin, 'REGISTERED', dict(jax_plugin.REGISTERED))
    jax_plugin.register()
    assert name not in sys.modules

    monkeypatch.setattr(plugin, 'REGISTERED', {})
    plugin.register()
    plugin.register()
    assert plugin.REGISTERED[name].CALLS == ['registered']
    assert 'openpifpaf_tpu_torch.plugins' in plugin.REGISTERED
    assert sorted(plugin.REGISTERED) == sorted([name, 'openpifpaf_tpu_torch.plugins'])
    monkeypatch.delitem(sys.modules, name)


@pytest.fixture(scope='module')
def avi(tmp_path_factory):
    """Seven 48 x 64 frames of MJPG, each a different colour field."""
    path = str(tmp_path_factory.mktemp('video') / 'clip.avi')
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*'MJPG'), 10.0,
                             (64, 48))
    assert writer.isOpened()
    rng = np.random.default_rng(0)
    for i in range(7):
        frame = np.zeros((48, 64, 3), np.uint8)
        frame[:, :, i % 3] = 40 * i
        frame[8:24, 8 + 4 * i:24 + 4 * i] = rng.integers(0, 256, 3)
        writer.write(frame)
    writer.release()
    return path


@pytest.mark.parametrize('selection, indices', [
    ((0, 1, None), [0, 1, 2, 3, 4, 5, 6]), ((2, 2, None), [2, 4, 6]),
    ((1, 3, 2), [1, 4])], ids=['all', 'start2_skip2', 'start1_skip3_max2'])
def test_frame_reader_video_file_matches_jax(avi, selection, indices):
    want = list(jax_video.FrameReader(avi, *selection))
    got = list(video.FrameReader(avi, *selection))
    assert [(i, n) for i, n, _ in got] == [(i, n) for i, n, _ in want] \
        == [(i, f'frame_{i:06d}') for i in indices]
    for (_, _, frame), (_, _, want_frame) in zip(got, want):
        assert frame.shape == (48, 64, 3) and frame.dtype == np.uint8
        np.testing.assert_array_equal(frame, want_frame)


def test_frame_reader_without_opencv(avi, monkeypatch):
    monkeypatch.setitem(sys.modules, 'cv2', None)
    messages = []
    for reader in (jax_video.FrameReader, video.FrameReader):
        with pytest.raises(ValueError) as info:
            list(reader(avi))
        messages.append(str(info.value))
    assert messages[0] == messages[1]
    assert 'OpenCV is not available' in messages[1]
