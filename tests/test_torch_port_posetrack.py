"""The port's PoseTrack data modules against the JAX package, on
synthesized trees (the repository holds none of the datasets).

- ``posetrack2018`` on ``chip_smoke.write_posetrack_tree`` (2 sequences x
  4 frames of 160 x 128 PNGs per split, the first frame of each sequence
  unannotated, two people with stable track ids): the same consecutive
  pairs in the same order with the same ``sequence_id``, raw frames equal
  to PIL's; training samples without augmentation (both frames exact, the
  CIF, CAF and TCAF targets within 1e-5); with augmentation, both frames
  of a pair drawn with the same parameters; the eval samples; every flag's
  default; the ``FileNotFoundError`` of a glob that matches nothing.
- ``cocokpst`` on ``chip_smoke.write_coco_tree``: the eval pairs (the pan
  seeded 123) and the training pairs on the same pan draws.
- A narrow tshufflenetv2k16 with posetrack2018's heads, written as a JAX
  checkpoint, through both packages' ``Evaluator`` on the tree: the COCO
  and PoseTrack stats within 1e-3 of JAX's, as
  ``test_torch_port_tracking_eval.py`` holds them.
"""

import argparse

import numpy as np
import pytest
import torch

import chip_smoke
from openpifpaf_tpu import encoder as jax_encoder
from openpifpaf_tpu import eval as jax_eval
from openpifpaf_tpu import predictor as jax_predictor
from openpifpaf_tpu.models import checkpoint as jax_checkpoint
from openpifpaf_tpu.models import heads as jax_heads
from openpifpaf_tpu.models import shufflenetv2k as jax_sn
from openpifpaf_tpu.models import tracking_base as jax_tracking
from openpifpaf_tpu.plugins.coco.cocokp import CocoKp as JaxCocoKp
from openpifpaf_tpu.plugins.coco.dataset import CocoDataset as JaxCocoDataset
from openpifpaf_tpu.plugins.posetrack import cocokpst as jax_cocokpst
from openpifpaf_tpu.plugins.posetrack import posetrack2018 as jax_posetrack
from openpifpaf_tpu_torch import eval as port_eval
from openpifpaf_tpu_torch import models
from openpifpaf_tpu_torch.models import checkpoint
from openpifpaf_tpu_torch.plugins.coco import CocoDataset, CocoKp
from openpifpaf_tpu_torch.plugins.posetrack import (CocoKpSt, PoseTrack2018,
                                                    constants)
from openpifpaf_tpu_torch.plugins.posetrack import posetrack2018
from openpifpaf_tpu_torch.predictor import Predictor

from test_torch_port_coco import assert_images_close, assert_meta_close
from test_torch_port_encoder import assert_targets_equal
from test_torch_port_encoder import numpy_painters  # noqa: F401  (fixture)
from test_torch_port_models import NARROW
from test_torch_port_tracking_model import random_tracking_variables

FRAME_SIZE = (160, 128)   # w, h
# the long edge: the rescale is the identity, so both packages' frames are
# exact
EDGE = 160
COCO_SIZES = ((129, 97), (97, 129)) * 3
COCO_EDGE = 129
TARGET_TOL = 1e-5
STATS_TOL = 1e-3
# the narrow model's confidence bias: poses are found on the tree
CONF_BIAS = 2.0


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module', name='tree')
def fixture_tree(tmp_path_factory):
    return chip_smoke.write_posetrack_tree(
        str(tmp_path_factory.mktemp('posetrack2018')), sequences=2,
        frames=4, size=FRAME_SIZE)


@pytest.fixture(name='modules')
def fixture_modules(tree, monkeypatch):
    """The JAX and port PoseTrack2018 modules on the tree."""
    for cls in (jax_posetrack.PoseTrack2018, PoseTrack2018):
        monkeypatch.setattr(cls, 'data_root', tree['root'])
        monkeypatch.setattr(cls, 'train_annotations', tree['train'])
        monkeypatch.setattr(cls, 'val_annotations', tree['val'])
        monkeypatch.setattr(cls, 'square_edge', EDGE)
        monkeypatch.setattr(cls, 'batch_size', 2)
    return jax_posetrack.PoseTrack2018(), PoseTrack2018()


def with_stride(dm):
    for meta in dm.head_metas:
        meta.base_stride = 16
    return dm


def numpy_tracking_encoders(metas):
    """The JAX tracking encoders on their numpy path."""
    cif, caf, tcaf = metas
    return jax_encoder.TrackingEncoders([
        jax_encoder.CifEncoder(cif, use_native=False),
        jax_encoder.CafEncoder(caf, use_native=False),
        jax_encoder.TcafEncoder(tcaf)])


def identity(images, anns, meta):
    return images, anns, meta


def test_pairs_order_and_sequence_ids(modules):
    jax_dm, dm = modules
    for pattern in ('train_annotations', 'val_annotations'):
        files = dm._annotation_files(getattr(dm, pattern))  # pylint: disable=protected-access
        assert files == jax_dm._annotation_files(getattr(jax_dm, pattern))  # pylint: disable=protected-access
        want = jax_posetrack.PoseTrack2018Dataset(files, jax_dm.data_root,
                                                  identity)
        got = posetrack2018.PoseTrack2018Dataset(files, dm.data_root,
                                                 identity)
        assert got.pairs == want.pairs
        assert len(got) == 6    # 3 annotated pairs per sequence
        for index in range(len(got)):
            images, anns_pair, meta = got[index]
            want_images, want_anns, want_meta = want[index]
            assert meta == want_meta
            for image, want_image in zip(images, want_images):
                assert_images_close(image, want_image.convert('RGB'), 0.0)
            for anns, w in zip(anns_pair, want_anns):
                assert len(anns) == len(w)
                for a, b in zip(anns, w):
                    assert a.keys() == b.keys()
                    np.testing.assert_array_equal(a['keypoints'],
                                                  b['keypoints'])
                    assert {k: a[k] for k in a if k != 'keypoints'} == \
                        {k: b[k] for k in b if k != 'keypoints'}
    assert got[0][1][0] == []                      # frame 0 unannotated
    tracks = {a['track_id'] for a in got[0][1][1]}
    assert tracks in ({0, 1}, {0, 1, 2})
    assert [got[i][2]['sequence_id'] for i in range(6)] == \
        ['001001_mpii_val'] * 3 + ['001002_mpii_val'] * 3


def test_train_samples_without_augmentation(modules, monkeypatch):
    jax_dm, dm = modules
    for cls in (jax_posetrack.PoseTrack2018, PoseTrack2018):
        monkeypatch.setattr(cls, 'augmentation', False)
    jax_dm, dm = with_stride(jax_dm), with_stride(dm)
    jax_pre = jax_dm._preprocess()  # pylint: disable=protected-access
    jax_pre.pair_steps[-1] = numpy_tracking_encoders(jax_dm.head_metas)
    files = dm._annotation_files(dm.train_annotations)  # pylint: disable=protected-access
    want_ds = jax_posetrack.PoseTrack2018Dataset(files, jax_dm.data_root,
                                                 jax_pre)
    got_ds = dm._train_dataset(dm.train_annotations, 0)  # pylint: disable=protected-access
    linked = []
    for index in range(len(got_ds)):
        images, targets, meta = got_ds[index]
        want_images, want_targets, want_meta = want_ds[index]
        for image, want in zip(images, want_images):
            assert image.shape == (3, EDGE, EDGE)
            assert_images_close(image, want, 0.0)
        assert meta['sequence_id'] == want_meta['sequence_id']
        assert_meta_close(want_meta, meta)
        for want, got in zip(want_targets, targets):
            assert_targets_equal(want, got, atol=TARGET_TOL)
        linked.append(float(targets[2]['conf'].sum()))
    # TCAF links the people of two annotated frames; frame 0 has none
    assert linked[0] == 0.0 and min(linked[1:3]) > 0


def test_augmented_pair_draws_the_same_parameters(modules):
    """Both frames of a pair through one augmented chain: made of the same
    frame twice, the pair's two images and targets must be equal."""
    _, dm = modules
    dm = with_stride(dm)
    ds = dm._train_dataset(dm.train_annotations, 3)  # pylint: disable=protected-access
    ds.pairs = [(s, curr, curr, anns, anns)
                for s, _, curr, _, anns in ds.pairs]
    scales = set()
    for index in range(len(ds)):
        (prev, curr), targets, meta = ds[index]
        torch.testing.assert_close(prev, curr, rtol=0, atol=0)
        cif = targets[0]
        np.testing.assert_array_equal(cif['conf'][0], cif['conf'][1])
        scales.add(tuple(np.round(meta['scale'], 6)))
    assert len(scales) > 1      # the draws change from pair to pair


def test_eval_samples(modules):
    jax_dm, dm = modules
    for (images, anns, metas), (want_images, want_anns, want_metas) in zip(
            dm.eval_loader(), jax_dm.eval_loader()):
        assert images.shape[0] == 2 * len(metas)
        assert_images_close(images.permute(0, 2, 3, 1).reshape(
            -1, EDGE, 3).permute(2, 0, 1), np.asarray(want_images).reshape(
                -1, EDGE, 3), 0.0)
        for got, want in zip(anns, want_anns):
            assert [a.id_ for a in got] == [a.id_ for a in want]
            for a, b in zip(got, want):
                np.testing.assert_allclose(a.data, b.data, atol=1e-4)
        for got, want in zip(metas, want_metas):
            assert got['sequence_id'] == want['sequence_id']
            assert_meta_close(want, got)


def parsed(cli):
    parser = argparse.ArgumentParser()
    cli(parser)
    return vars(parser.parse_args([]))


@pytest.mark.parametrize('name', ['posetrack2018', 'cocokpst'])
def test_flag_defaults_and_missing_files(name):
    jax_cls, cls = {
        'posetrack2018': (jax_posetrack.PoseTrack2018, PoseTrack2018),
        'cocokpst': (jax_cocokpst.CocoKpSt, CocoKpSt)}[name]
    want, got = parsed(jax_cls.cli), parsed(cls.cli)
    assert got == want
    assert all(key.startswith(name) for key in got)
    if name == 'posetrack2018':
        pattern = 'no-such-dir/*.json'
        with pytest.raises(FileNotFoundError) as want_error:
            jax_cls()._annotation_files(pattern)  # pylint: disable=protected-access
        with pytest.raises(FileNotFoundError) as got_error:
            cls()._annotation_files(pattern)  # pylint: disable=protected-access
        assert str(got_error.value) == str(want_error.value)


@pytest.fixture(name='coco_modules')
def fixture_coco_modules(tmp_path_factory, monkeypatch):
    tree = chip_smoke.write_coco_tree(
        str(tmp_path_factory.mktemp('coco')), sizes=COCO_SIZES)
    for cls in (JaxCocoKp, CocoKp):
        for key in ('train', 'val', 'eval'):
            monkeypatch.setattr(cls, f'{key}_annotations',
                                tree['person_keypoints'])
            monkeypatch.setattr(cls, f'{key}_image_dir', tree['images'])
    for cls in (jax_cocokpst.CocoKpSt, CocoKpSt):
        monkeypatch.setattr(cls, 'square_edge', COCO_EDGE)
        monkeypatch.setattr(cls, 'max_shift', 12.0)
    return tree, with_stride(jax_cocokpst.CocoKpSt()), with_stride(CocoKpSt())


def test_cocokpst_eval_pairs(coco_modules):
    tree, jax_dm, dm = coco_modules
    want = JaxCocoDataset(tree['images'], tree['person_keypoints'],
                          preprocess=jax_dm._eval_preprocess(),  # pylint: disable=protected-access
                          annotation_filter=True, min_kp_anns=1,
                          category_ids=[1])
    got = dm.eval_loader().dataset
    assert len(got) == len(want) > 1
    shifts = set()
    for index in range(len(got)):
        images, anns, meta = got[index]
        want_images, want_anns, want_meta = want[index]
        for image, want_image in zip(images, want_images):
            assert_images_close(image, want_image, 0.0)
        assert meta['sequence_id'] == want_meta['sequence_id']
        assert_meta_close(want_meta, meta)
        assert [a.id_ for a in anns] == [a.id_ for a in want_anns]
        for a, b in zip(anns, want_anns):
            np.testing.assert_allclose(a.data, b.data, atol=1e-4)
        shifts.add(float((images[1] - images[0]).abs().sum()))
    assert len(shifts) > 1


def test_cocokpst_train_pairs(coco_modules):
    """The training chain on the same pan draws: the port's pan draws from
    the dataset's generator, the JAX one from its own, seeded alike."""
    tree, jax_dm, dm = coco_modules
    jax_pre = jax_dm._preprocess()  # pylint: disable=protected-access
    jax_pre.transforms[-2].rng = np.random.default_rng(4)
    jax_pre.transforms[-1] = numpy_tracking_encoders(jax_dm.head_metas)
    want = JaxCocoDataset(tree['images'], tree['person_keypoints'],
                          preprocess=jax_pre, annotation_filter=True,
                          min_kp_anns=1, category_ids=[1])
    got = dm._train_dataset(tree['images'], tree['person_keypoints'], 4)  # pylint: disable=protected-access
    for index in range(len(got)):
        images, targets, meta = got[index]
        want_images, want_targets, want_meta = want[index]
        for image, want_image in zip(images, want_images):
            assert_images_close(image, want_image, 0.0)
        assert meta['sequence_id'] == want_meta['sequence_id']
        for w, g in zip(want_targets, targets):
            assert_targets_equal(w, g, atol=TARGET_TOL)


@pytest.fixture(scope='module', name='narrow_checkpoint')
def fixture_narrow_checkpoint(tmp_path_factory):
    """A narrow tshufflenetv2k16 with posetrack2018's heads, biases
    shifted so that poses are found, written by the JAX package."""
    metas = jax_posetrack.PoseTrack2018().head_metas
    module = jax_tracking.TrackingShell(
        basenet=jax_sn.ShuffleNetV2K(*NARROW),
        head_nets=[jax_heads.CompositeField4(meta=m, in_features=64)
                   for m in metas],
        head_paired=(False, False, True))
    variables = random_tracking_variables(module, seed=3)
    for i, meta in enumerate(metas):
        bias = variables['params'][f'head_nets_{i}']['conv']['bias'] \
            .reshape(meta.n_fields, meta.n_components)
        bias[:, 0] = CONF_BIAS
        bias[:, meta.n_components - meta.n_scales:] = 2.0
    path = str(tmp_path_factory.mktemp('narrow') / 'narrow.npz')
    jax_checkpoint.save(path, variables=variables, head_metas=metas,
                        basenet_name='tshufflenetv2k16', base_stride=16)
    return path, module


def test_eval_stats_against_jax(modules, narrow_checkpoint):
    jax_dm, dm = modules
    path, module = narrow_checkpoint
    header, variables = jax_checkpoint.load(path)
    jax_model = jax_tracking.TrackingModel(
        module, header['head_metas'], base_stride=16,
        basenet_name='tshufflenetv2k16', variables=variables)
    want = jax_eval.Evaluator(
        jax_dm, jax_predictor.Predictor(model=jax_model)).run()

    header, flat = checkpoint.load(path)
    metas = header['head_metas']
    shell = models.TrackingShell(
        models.ShuffleNetV2K(*NARROW),
        [models.CompositeField4(m, c) for m, c in zip(metas, (64, 64, 128))],
        (False, False, True))
    shell.load_state_dict(models.from_jax_variables(flat), strict=True)
    model = models.TrackingModel(shell, metas, base_stride=16,
                                 device=torch.device('cpu'), bf16=False)
    got = port_eval.Evaluator(dm, Predictor(model=model, device='cpu')).run()

    assert got['text_labels'] == want['text_labels']
    assert got['text_labels'][-6:] == ['MOTA', 'MOTP', 'misses',
                                       'false_positives', 'id_switches',
                                       'n_gt']
    assert got['n_images'] == want['n_images'] == 6
    np.testing.assert_allclose(got['stats'], want['stats'], atol=STATS_TOL)
    stats = dict(zip(got['text_labels'], got['stats']))
    assert stats['n_gt'] >= 12                  # 2 or 3 people x 6 pairs
    assert stats['n_gt'] - stats['misses'] + stats['false_positives'] > 0
