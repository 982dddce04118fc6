"""The port's training data path against the JAX package: toykp rendering,
the training transforms and the CIF/CAF encoders.

The same ground truth (numpy, from a seed) goes through both packages.
The JAX encoders run their numpy path (``use_native=False``), and so do
the port's (``numpy_painters``, which the other files that hold targets
import too); ``test_torch_port_native.py`` holds the C++ painters.  Masks must be equal bit for bit and the float targets within
1e-6; transforms must give the same meta and annotations, and images
within 1 grey level where the JAX package resizes with PIL
(``test_torch_port_predictor.py::test_rescale_against_pil``).
"""

import functools

import numpy as np
import PIL.Image
import pytest
import torch

from openpifpaf_tpu import encoder as jax_encoder
from openpifpaf_tpu import headmeta as jax_headmeta
from openpifpaf_tpu import transforms as jax_transforms
from openpifpaf_tpu.plugins.toykp.datamodule import ToyKp as JaxToyKp
from openpifpaf_tpu.plugins.toykp.datamodule import \
    ToyKpDataset as JaxToyKpDataset
from openpifpaf_tpu_torch import datasets, encoder, transforms
from openpifpaf_tpu_torch.plugins.coco import constants
from openpifpaf_tpu_torch.plugins.toykp import ToyKp, ToyKpDataset

from test_torch_port_models import coco_metas

SIZE = 97


def pin_numpy_painters(monkeypatch) -> None:
    """The port's CIF and CAF encoders built with ``use_native=False``
    unless told otherwise: the numpy painters that the JAX package's
    ``use_native=False`` encoders are held to."""
    for cls in (encoder.CifEncoder, encoder.CafEncoder):
        monkeypatch.setattr(cls, '__init__', functools.partialmethod(
            cls.__init__, use_native=False))


@pytest.fixture(scope='module', autouse=True)
def numpy_painters():
    """``pin_numpy_painters`` for a whole test module, its module-scoped
    fixtures included."""
    with pytest.MonkeyPatch.context() as monkeypatch:
        pin_numpy_painters(monkeypatch)
        yield


def metas_pair():
    ours, theirs = coco_metas(jax_headmeta), coco_metas()
    for m in ours + theirs:
        m.base_stride = 16
    return ours, theirs


def normalize(pkg):
    return pkg.NormalizeAnnotations(
        keypoints=constants.COCO_KEYPOINTS,
        skeleton=constants.COCO_PERSON_SKELETON,
        sigmas=constants.COCO_PERSON_SIGMAS,
        score_weights=constants.COCO_PERSON_SCORE_WEIGHTS)


def raw_anns(case, seed=0):
    """COCO-style annotation dicts: toykp people, plus a crowd box, or with
    keypoints on and beyond the image border."""
    gt = JaxToyKpDataset(1, SIZE, None, seed=seed).ground_truth(0)
    anns = [{'keypoints': kp.copy(), 'iscrowd': 0, 'category_id': 1,
             'bbox': [float(kp[:, 0].min()), float(kp[:, 1].min()), 10.0,
                      10.0]} for kp in gt]
    if case == 'crowd':
        anns.append({'keypoints': np.zeros((17, 3), np.float32),
                     'iscrowd': 1, 'bbox': [5.0, 40.5, 33.0, 20.0]})
        anns.append({'keypoints': np.zeros((17, 3), np.float32),
                     'iscrowd': 1, 'bbox': [-8.0, -3.0, 12.0, 9.0]})
    elif case == 'border':
        kp = anns[0]['keypoints']
        kp[0, :2] = (0.0, 0.0)
        kp[1, :2] = (SIZE - 1, 30.0)
        kp[2, :2] = (40.0, SIZE - 1)
        kp[3, :2] = (-3.5, 50.0)          # outside: only cells in the grid
        kp[4, :2] = (SIZE + 6.0, SIZE + 2.0)
        kp[5, 2] = 0.0                    # not visible: not painted
    return anns


def annotated(case):
    image = np.zeros((SIZE, SIZE, 3), np.uint8)
    _, jax_anns, _ = normalize(jax_transforms)(
        PIL.Image.fromarray(image), raw_anns(case), None)
    _, anns, _ = normalize(transforms)(
        torch.zeros(3, SIZE, SIZE), raw_anns(case), None)
    return image, jax_anns, anns


def assert_targets_equal(want, got, atol=1e-6):
    assert set(want) == set(got)
    for key, w in want.items():
        g = np.asarray(got[key])
        assert g.shape == w.shape and g.dtype == w.dtype, key
        if w.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=key)


@pytest.mark.parametrize('case', ['toykp', 'crowd', 'border'])
@pytest.mark.parametrize('head', [0, 1], ids=['cif', 'caf'])
def test_encoder_targets(case, head):
    (jax_meta, meta) = (m[head] for m in metas_pair())
    image, jax_anns, anns = annotated(case)
    cls = (jax_encoder.CifEncoder, jax_encoder.CafEncoder)[head]
    want = cls(jax_meta, use_native=False)(image, jax_anns, None)
    got = encoder.factory_head(meta)(torch.zeros(3, SIZE, SIZE), anns, None)
    assert_targets_equal(want, got)
    assert got['vec_mask'].any()
    if case == 'crowd':
        assert not got['conf_mask'].all()   # the crowd boxes


def test_render_is_bit_equal():
    for index in range(3):
        ours = JaxToyKpDataset(3, SIZE, None, seed=5)
        port = ToyKpDataset(3, SIZE, None, seed=5)
        gt = port.ground_truth(index)
        for a, b in zip(ours.ground_truth(index), gt):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(np.asarray(ours.render(index, gt)),
                                      port.render(index, gt))


def image_pair(h=SIZE, w=SIZE + 20, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    image = np.stack([127 + 120 * np.sin(xx / 7.0 + c) * np.cos(yy / 11.0)
                      for c in range(3)], -1).astype(np.uint8)
    image[rng.integers(0, h, 50), rng.integers(0, w, 50)] = 255
    return PIL.Image.fromarray(image), torch.as_tensor(image).permute(2, 0, 1) \
        .float()


def transform_pairs(rng_a, rng_b):
    """(JAX transform, port transform) for each ported training transform,
    each random one on its own generator seeded alike."""
    flip = (constants.COCO_KEYPOINTS, constants.HFLIP)
    return {
        'hflip': (jax_transforms.HFlip(*flip), transforms.HFlip(*flip)),
        'rescale_absolute': (jax_transforms.RescaleAbsolute(81),
                             transforms.RescaleAbsolute(81)),
        'rescale_relative': (
            jax_transforms.RescaleRelative((0.5, 2.0), rng=rng_a),
            transforms.RescaleRelative((0.5, 2.0), rng=rng_b)),
        'crop': (jax_transforms.Crop(64, rng=rng_a),
                 transforms.Crop(64, rng=rng_b)),
        'center_pad': (jax_transforms.CenterPad(129),
                       transforms.CenterPad(129)),
        'random_apply': (
            jax_transforms.RandomApply(jax_transforms.HFlip(*flip), 0.5,
                                       rng=rng_a),
            transforms.RandomApply(transforms.HFlip(*flip), 0.5, rng=rng_b)),
    }


def assert_same_sample(want, got, image_atol):
    (want_image, want_anns, want_meta), (image, anns, meta) = want, got
    want_image = np.asarray(want_image, np.float32)
    image = image.permute(1, 2, 0).numpy()
    assert image.shape == want_image.shape
    assert np.abs(image - want_image).max() <= image_atol
    assert len(anns) == len(want_anns)
    for a, b in zip(want_anns, anns):
        np.testing.assert_array_equal(a.data, b.data)
        np.testing.assert_array_equal(a.fixed_bbox, b.fixed_bbox)
        assert a.iscrowd == b.iscrowd
    for key in ('offset', 'scale', 'valid_area', 'width_height', 'hflip',
                'original_width_height'):
        np.testing.assert_array_equal(meta[key], want_meta[key], err_msg=key)
    assert (meta['horizontal_swap'] is None) == \
        (want_meta['horizontal_swap'] is None)


@pytest.mark.parametrize('name', list(transform_pairs(None, None)))
def test_transform(name):
    """Five draws of each transform on one image and its annotations:
    the same meta and annotations, images within 1 grey level (exactly
    equal where no resize is involved)."""
    rng_a, rng_b = np.random.default_rng(7), np.random.default_rng(7)
    jax_t, port_t = transform_pairs(rng_a, rng_b)[name]
    resizes = name.startswith('rescale')
    for i in range(5):
        pil, tensor = image_pair(seed=i)
        _, jax_anns, jax_meta = normalize(jax_transforms)(
            pil, raw_anns('crowd', seed=i), None)
        _, anns, meta = normalize(transforms)(tensor, raw_anns('crowd', seed=i),
                                              None)
        assert_same_sample(jax_t(pil, jax_anns, jax_meta),
                           port_t(tensor, anns, meta),
                           1.0 if resizes else 0.0)


def jax_toykp_sample(dataset_seed, index, rng, augmentation):
    """The JAX ToyKp training sample with its random transforms on ``rng``
    and the numpy encoders (``ToyKp._preprocess`` draws from unseeded
    generators and may take the C++ painters)."""
    dm = JaxToyKp()
    for m in dm.head_metas:
        m.base_stride = 16
    flip = jax_transforms.HFlip(constants.COCO_KEYPOINTS, constants.HFLIP)
    steps = [dm._normalize()]  # pylint: disable=protected-access
    if augmentation:
        steps += [jax_transforms.RandomApply(flip, 0.5, rng=rng),
                  jax_transforms.RescaleRelative((0.8, 1.25), rng=rng),
                  jax_transforms.Crop(SIZE, rng=rng),
                  jax_transforms.CenterPad(SIZE)]
    else:
        steps += [jax_transforms.RescaleAbsolute(SIZE),
                  jax_transforms.CenterPad(SIZE)]
    steps += [jax_transforms.TRAIN_TRANSFORM, jax_encoder.Encoders(
        [jax_encoder.CifEncoder(dm.head_metas[0], use_native=False),
         jax_encoder.CafEncoder(dm.head_metas[1], use_native=False)])]
    ds = JaxToyKpDataset(4, SIZE, jax_transforms.Compose(steps),
                         seed=dataset_seed)
    return ds[index]


@pytest.mark.parametrize('augmentation', [True, False])
def test_toykp_samples_and_collate(augmentation, monkeypatch):
    """Four training samples of the port's ToyKp against the JAX pipeline
    on the same draws: images within 1 grey level after normalization
    (1 / (255 * 0.224) in normalized units), targets as the encoders';
    then the collate: NCHW float32 images and per-head dicts of tensors."""
    monkeypatch.setattr(ToyKp, 'image_size', SIZE)
    monkeypatch.setattr(ToyKp, 'augmentation', augmentation)
    dm = ToyKp()
    for m in dm.head_metas:
        m.base_stride = 16
    rng, jax_rng = np.random.default_rng(11), np.random.default_rng(11)
    ds = ToyKpDataset(4, SIZE, dm.preprocess(rng), seed=0, rng=rng)
    samples = [ds[i] for i in range(4)]
    for i, (image, targets, meta) in enumerate(samples):
        want_image, want_targets, want_meta = jax_toykp_sample(0, i, jax_rng,
                                                               augmentation)
        assert image.shape == (3, SIZE, SIZE)
        diff = np.abs(image.permute(1, 2, 0).numpy() - want_image).max()
        assert diff <= 1.0 / (255 * 0.224) + 1e-6
        for want, got in zip(want_targets, targets):
            assert_targets_equal(want, got)
        np.testing.assert_array_equal(meta['offset'], want_meta['offset'])
    images, targets, metas = datasets.collate_images_targets_meta(samples)
    assert images.shape == (4, 3, SIZE, SIZE) and images.dtype == torch.float32
    assert targets[0]['vec'].shape == (4, 17, 1, 2, 7, 7)
    assert targets[1]['vec'].shape == (4, 19, 2, 2, 7, 7)
    assert targets[1]['conf_mask'].dtype == torch.bool
    assert len(metas) == 4
