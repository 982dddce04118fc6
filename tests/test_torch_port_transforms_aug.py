"""The port's augmentation and clean-up transforms against the JAX package.

Each transform runs alone on the same image (a PIL image in the JAX
package, a (3, H, W) tensor in uint8 levels in the port) and the same
annotations, with its random draws from generators seeded alike (or from a
stub that returns a chosen value).  Tolerances: images within 1 grey level
(``RotateBy90``, ``Deinterlace``, ``ImputeNaN`` and ``JpegCompression``
exactly equal);
keypoints, boxes and every meta value within 1e-4; the same annotations
kept.  The cases are those of ``tests/test_transforms.py`` and
``tests/test_misc_parity.py``, plus ``Blur`` at four sigmas (PIL's
extended box blur, not a sampled Gaussian), ``RotateUniform`` at three
angles with the filled border, ``ColorTint`` at several draws, and
``RandomChoice``'s ``ValueError`` on probabilities that do not sum to 1,
which both packages raise (a fault of the reference, kept).
"""

import importlib
import sys

import numpy as np
import PIL.Image
import pytest
import torch

from openpifpaf_tpu import transforms as jax_transforms
from openpifpaf_tpu.annotation import Annotation as JaxAnnotation
from openpifpaf_tpu_torch import transforms
from openpifpaf_tpu_torch.annotation import (Annotation, AnnotationCrowd,
                                             AnnotationDet)
from openpifpaf_tpu_torch.plugins.coco import constants

FLIP = (constants.COCO_KEYPOINTS, constants.HFLIP)


class Fixed:
    """A generator stub whose ``uniform`` returns one chosen value."""

    def __init__(self, value):
        self.value = value

    def uniform(self, low, high, size=None):
        assert low <= self.value <= high
        return self.value


def image_pair(h=97, w=129, seed=0):
    """A structured uint8 image: smooth waves, saturated specks and a flat
    block, as a PIL image and as the port's tensor."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    image = np.stack([127 + 120 * np.sin(xx / 7.0 + c) * np.cos(yy / 11.0)
                      for c in range(3)], -1).astype(np.uint8)
    image[rng.integers(0, h, 60), rng.integers(0, w, 60)] = 255
    image[h // 4:h // 2, w // 5:w // 2] = (240, 20, 90)
    return (PIL.Image.fromarray(image),
            torch.as_tensor(image).permute(2, 0, 1).float())


def ann_pair(offset=(0.0, 0.0), scale=(10.0, 5.0), center=(50.0, 25.0)):
    """One COCO person in both packages, with a box."""
    anns = []
    for cls in (JaxAnnotation, Annotation):
        ann = cls(constants.COCO_KEYPOINTS, constants.COCO_PERSON_SKELETON)
        ann.data[:, 0] = (constants.COCO_UPRIGHT_POSE[:, 0] * scale[0]
                          + center[0] + offset[0])
        ann.data[:, 1] = (constants.COCO_UPRIGHT_POSE[:, 1] * scale[1]
                          + center[1] + offset[1])
        ann.data[:, 2] = 2.0
        ann.data[3, 2] = 0.0
        ann.fixed_bbox = np.array([30.0 + offset[0], 10.0 + offset[1], 45.0,
                                   40.0], np.float32)
        anns.append(ann)
    return anns


def assert_meta_equal(want, got, atol=1e-4):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if key == 'horizontal_swap':
            assert (g is None) == (w is None)
            if w is not None:
                np.testing.assert_array_equal(g.perm, w.perm)
        elif key == 'rotation':
            assert set(g) == set(w)
            for k in w:
                if w[k] is None:
                    assert g[k] is None
                else:
                    assert abs(g[k] - w[k]) <= atol, (key, k)
        elif isinstance(w, (str, bool)):
            assert g == w, key
        else:
            np.testing.assert_allclose(np.asarray(g, float),
                                       np.asarray(w, float), atol=atol,
                                       rtol=0, err_msg=key)


def assert_same(want, got, *, image_atol=1.0):
    (want_image, want_anns, want_meta), (image, anns, meta) = want, got
    want_image = np.asarray(want_image, np.float32)
    image = image.permute(1, 2, 0).numpy()
    assert image.shape == want_image.shape
    assert np.abs(image - want_image).max() <= image_atol
    np.testing.assert_array_equal(image, np.round(image))
    assert len(anns) == len(want_anns)
    for a, b in zip(want_anns, anns):
        np.testing.assert_allclose(b.data, a.data, atol=1e-4, rtol=0)
        if a.fixed_bbox is None:
            assert b.fixed_bbox is None
        else:
            np.testing.assert_allclose(b.fixed_bbox, a.fixed_bbox, atol=1e-4)
    assert_meta_equal(want_meta, meta)


def run_both(jax_t, port_t, **kw):
    pil, tensor = image_pair(**kw)
    jax_ann, ann = ann_pair()
    return (jax_t(pil, [jax_ann], {'dataset_index': 3}),
            port_t(tensor, [ann], {'dataset_index': 3}))


@pytest.mark.parametrize('sigma', [0.5, 1.5, 3.0, 4.9])
def test_blur(sigma):
    want, got = run_both(jax_transforms.Blur(rng=Fixed(sigma)),
                         transforms.Blur(rng=Fixed(sigma)))
    assert_same(want, got)
    # a sampled Gaussian is off by several grey levels at these sigmas
    assert (got[0] - image_pair()[1]).abs().max() > 10


def test_blur_seeded_draws():
    jax_t = jax_transforms.Blur(rng=np.random.default_rng(3))
    port_t = transforms.Blur(rng=np.random.default_rng(3))
    for seed in range(3):
        assert_same(*run_both(jax_t, port_t, seed=seed))


@pytest.mark.parametrize('angle', [7.3, -23.9, 29.5])
def test_rotate_uniform(angle):
    """PIL's bilinear rotate with its fill: the border pixels included."""
    want, got = run_both(jax_transforms.RotateUniform(rng=Fixed(angle)),
                         transforms.RotateUniform(rng=Fixed(angle)))
    assert_same(want, got)
    fill = (got[0] == torch.tensor(transforms.PAD_FILL)[:, None, None]) \
        .all(0)
    assert fill[0, 0] and fill[-1, -1] and not fill[48, 64]


def test_rotate_uniform_below_a_tenth_of_a_degree():
    want, got = run_both(jax_transforms.RotateUniform(rng=Fixed(0.05)),
                         transforms.RotateUniform(rng=Fixed(0.05)))
    assert_same(want, got, image_atol=0.0)


def test_rotate_by_90_seeded_draws():
    jax_t = jax_transforms.RotateBy90(rng=np.random.default_rng(5))
    port_t = transforms.RotateBy90(rng=np.random.default_rng(5))
    angles = set()
    for seed in range(8):
        want, got = run_both(jax_t, port_t, seed=seed)
        assert_same(want, got, image_atol=0.0)
        angles.add(got[2]['rotation']['angle'])
    assert angles == {0.0, 90.0, 180.0, 270.0}


def test_rotate_by_90_pixel_consistency_and_inverse():
    """``tests/test_transforms.py``: a marked pixel moves to where the
    rotated keypoint says, and ``inverse_transform`` undoes the turn."""
    arr = torch.zeros(3, 120, 200)
    arr[0, 30, 50] = 255.0
    ann = Annotation(constants.COCO_KEYPOINTS, constants.COCO_PERSON_SKELETON)
    ann.data[:, 0] = np.linspace(20, 180, 17)
    ann.data[:, 1] = np.linspace(10, 110, 17)
    ann.data[:, 2] = 2.0
    ann.data[0] = (50.0, 30.0, 2.0)
    orig = ann.copy()
    t = transforms.RotateBy90(fixed_angle=90, rng=None)
    image, anns, meta = t(arr, [ann], None)
    y_px, x_px = np.argwhere(image[0].numpy() > 200).mean(axis=0)
    assert abs(anns[0].data[0, 0] - x_px) < 1.5
    assert abs(anns[0].data[0, 1] - y_px) < 1.5
    np.testing.assert_allclose(anns[0].inverse_transform(meta).data[:, :2],
                               orig.data[:, :2], atol=0.6)
    with pytest.raises(ValueError, match='multiples of 90'):
        transforms.RotateBy90(fixed_angle=45, rng=None)(arr, [], None)


def test_color_tint_draws():
    jax_t = jax_transforms.ColorTint(rng=np.random.default_rng(11))
    port_t = transforms.ColorTint(rng=np.random.default_rng(11))
    for seed in range(5):
        assert_same(*run_both(jax_t, port_t, seed=seed))
    # the extremes: full extrapolation and full desaturation
    for shift in (0.9, -0.9):
        assert_same(*run_both(jax_transforms.ColorTint(0.9, rng=Fixed(shift)),
                              transforms.ColorTint(0.9, rng=Fixed(shift))))


def test_jpeg_compression():
    """The port's JPEG round trip (its own encoder and decoder) gives PIL's
    pixels exactly."""
    jax_t = jax_transforms.JpegCompression(rng=np.random.default_rng(2))
    port_t = transforms.JpegCompression(rng=np.random.default_rng(2))
    assert_same(*run_both(jax_t, port_t), image_atol=0)


def test_jpeg_compression_without_pil(monkeypatch):
    """With PIL blocked (as on the card's machine) ``JpegCompression``
    gives what it gives with PIL present, and that is JAX's image."""
    def draw():
        t = transforms.JpegCompression(rng=np.random.default_rng(0))
        return t(image_pair()[1], [], None)[0]

    with_pil = draw()
    real = importlib.import_module

    def no_pil(name, *args):
        if name.startswith('PIL'):
            raise ImportError(name)
        return real(name, *args)

    monkeypatch.setattr(importlib, 'import_module', no_pil)
    for name in [m for m in sys.modules if m == 'PIL' or
                 m.startswith('PIL.')]:
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError):
        importlib.import_module('PIL.Image')
    assert torch.equal(draw(), with_pil)
    monkeypatch.undo()
    want = jax_transforms.JpegCompression(rng=np.random.default_rng(0))(
        image_pair()[0], [], None)[0]
    np.testing.assert_array_equal(
        with_pil.permute(1, 2, 0).numpy(), np.asarray(want, np.float32))


def test_random_choice_and_its_probability_fault():
    jax_t = jax_transforms.RandomChoice(
        [jax_transforms.HFlip(*FLIP), None], [0.6, 0.4],
        rng=np.random.default_rng(4))
    port_t = transforms.RandomChoice(
        [transforms.HFlip(*FLIP), None], [0.6, 0.4],
        rng=np.random.default_rng(4))
    flips = set()
    for seed in range(6):
        want, got = run_both(jax_t, port_t, seed=seed)
        assert_same(want, got, image_atol=0.0)
        flips.add(got[2]['hflip'])
    assert flips == {True, False}
    # cocokp's [orientation_invariant, 0.4] sums to 1 only at 0.6
    for pkg, image in zip((jax_transforms, transforms), image_pair()):
        bad = pkg.RandomChoice([None, None], [0.1, 0.4],
                               rng=np.random.default_rng(0))
        with pytest.raises(ValueError, match='sum to 1'):
            bad(image, [], None)


def test_deterministic_equal_choice():
    for salt in (0, 1):
        jax_t = jax_transforms.DeterministicEqualChoice(
            [jax_transforms.HFlip(*FLIP), None], salt=salt)
        port_t = transforms.DeterministicEqualChoice(
            [transforms.HFlip(*FLIP), None], salt=salt)
        want, got = run_both(jax_t, port_t)
        assert_same(want, got, image_atol=0.0)
        assert got[2]['hflip'] == (salt == 1)


def test_annotation_copy_and_min_size():
    pil, tensor = image_pair()
    small_jax, small = ann_pair(scale=(0.3, 0.15))
    big_jax, big = ann_pair()
    for pkg, image, anns in ((jax_transforms, pil, [small_jax, big_jax]),
                             (transforms, tensor, [small, big])):
        _, copied, _ = pkg.AnnotationCopy()(image, anns, None)
        assert copied[0] is not anns[0]
        np.testing.assert_array_equal(copied[0].data, anns[0].data)
    want = jax_transforms.MinSize(min_side=4.0)(pil, [small_jax, big_jax],
                                                None)
    got = transforms.MinSize(min_side=4.0)(tensor, [small, big], None)
    assert_same(want, got, image_atol=0.0)
    assert got[1] == [big]


def test_unclipped_area_and_sides():
    """``tests/test_misc_parity.py``'s cases."""
    pil = PIL.Image.fromarray(np.zeros((100, 150, 3), np.uint8))
    tensor = torch.zeros(3, 100, 150)
    for offsets, make in (
            (((0.0, 0.0), (130.0, 0.0)),
             lambda pkg: pkg.UnclippedArea(threshold=0.8)),
            (((0.0, 0.0), (-45.0, -25.0)),
             lambda pkg: pkg.UnclippedSides(margin=10.0,
                                            max_clipped_sides=1))):
        pairs = [ann_pair(offset=o) for o in offsets]
        jax_anns = [p[0] for p in pairs]
        anns = [p[1] for p in pairs]
        for ann in jax_anns + anns:
            ann.fixed_bbox = None
        want = make(jax_transforms)(pil, jax_anns, {})
        got = make(transforms)(tensor, anns, {})
        assert_same(want, got, image_atol=0.0)
        assert got[1] == [anns[0]]


@pytest.mark.parametrize('threshold', [5.0, 20.0, 200.0])
def test_scale_mix(threshold):
    want, got = run_both(jax_transforms.ScaleMix(threshold),
                         transforms.ScaleMix(threshold))
    assert_same(want, got)


def test_center_pad_tight():
    want, got = run_both(jax_transforms.CenterPadTight(16),
                         transforms.CenterPadTight(16))
    assert_same(want, got, image_atol=0.0)
    h, w = got[0].shape[1:]
    assert (w - 1) % 16 == 0 and (h - 1) % 16 == 0


@pytest.mark.parametrize('hflip', [False, True])
def test_multi_scale(hflip):
    """``tests/test_misc_parity.py``: each copy's meta maps it back to
    the same original coordinates; both packages give the same copies."""
    kw = dict(hflip_keypoints=constants.COCO_KEYPOINTS,
              hflip_table=constants.HFLIP) if hflip else {}
    pil, tensor = image_pair(h=100, w=150)
    jax_ann, ann = ann_pair()
    jax_out = jax_transforms.MultiScale([81, 161], **kw)(pil, [jax_ann], {})
    out = transforms.MultiScale([81, 161], **kw)(tensor, [ann], {})
    assert len(out[0]) == len(jax_out[0]) == (4 if hflip else 2)
    for want, got in zip(zip(*jax_out), zip(*out)):
        assert_same(want, got)
    first = out[1][0][0].inverse_transform(out[2][0])
    for anns, meta in zip(out[1], out[2]):
        np.testing.assert_allclose(anns[0].inverse_transform(meta).data[:, :2],
                                   first.data[:, :2], atol=1.5)


@pytest.mark.parametrize('h', [10, 11, 96, 97])
def test_deinterlace(h):
    """The PIL branch (the port's tensor) and the array branch, exact."""
    pil, tensor = image_pair(h=h, w=31, seed=h)
    want = jax_transforms.Deinterlace()(pil, [], {})
    got = transforms.Deinterlace()(tensor, [], {})
    assert_same(want, got, image_atol=0.0)
    comb = np.zeros((h, 8, 3), np.float32)
    comb[1::2] = 1.0
    want = jax_transforms.Deinterlace()(comb, [], {})
    got = transforms.Deinterlace()(comb, [], {})
    np.testing.assert_array_equal(got[0], want[0])
    assert_meta_equal(want[2], got[2])


def test_impute_nan():
    rng = np.random.default_rng(0)
    frame = rng.normal(size=(12, 9, 3)).astype(np.float32)
    frame[0, 0, 0] = np.nan
    frame[5, 3, 1] = np.inf
    want = jax_transforms.ImputeNaN()(frame.copy(), [], {})
    for image in (frame.copy(), torch.from_numpy(frame.copy())
                  .permute(2, 0, 1)):
        got = transforms.ImputeNaN()(image, [], {})
        out = got[0] if isinstance(got[0], np.ndarray) else \
            got[0].permute(1, 2, 0).numpy()
        np.testing.assert_array_equal(out, want[0])
        assert_meta_equal(want[2], got[2])
    # a frame without NaN passes as it is, in both layouts
    clean = torch.ones(3, 4, 4)
    assert transforms.ImputeNaN()(clean, [], {})[0] is clean


def test_to_annotations_converters():
    """``tests/test_transforms.py``: the converters, then the crowd and
    detection ground truth mapped back through a rescale and a pad."""
    from openpifpaf_tpu.annotation import AnnotationCrowd as JaxCrowd
    from openpifpaf_tpu.annotation import AnnotationDet as JaxDet

    raw = [
        {'keypoints': [50.0, 40.0, 2.0] * 17, 'bbox': [40, 30, 20, 20],
         'category_id': 1, 'iscrowd': 0, 'track_id': 4},
        {'bbox': [10, 10, 30, 15], 'category_id': 1, 'iscrowd': 0},
        {'bbox': [0, 0, 100, 50], 'category_id': 1, 'iscrowd': 1},
        {'keypoints': [5.0, 4.0, 2.0, 9.0, 12.0, 1.0] + [0.0] * 45,
         'category_id': 1, 'iscrowd': 1},
    ]
    outs = []
    for pkg, image in ((jax_transforms, image_pair()[0]),
                       (transforms, image_pair()[1])):
        to_anns = pkg.ToAnnotations([
            pkg.ToKpAnnotations(
                ['person'],
                keypoints_by_category={1: constants.COCO_KEYPOINTS},
                skeleton_by_category={1: constants.COCO_PERSON_SKELETON}),
            pkg.ToCrowdAnnotations(['person']),
        ])
        _, anns, _ = to_anns(image, [dict(r) for r in raw], None)
        dets = pkg.ToDetAnnotations(['person'])([dict(r) for r in raw])
        image, gt, meta = pkg.Compose([
            pkg.RescaleAbsolute(321), pkg.CenterPad(321)])(
                image, anns[1:] + dets, None)
        outs.append((anns, dets, [a.inverse_transform(meta) for a in gt]))
    (want_anns, want_dets, want_back), (anns, dets, back) = outs
    assert [type(a).__name__ for a in anns] == \
        [type(a).__name__ for a in want_anns] == \
        ['Annotation', 'AnnotationCrowd', 'AnnotationCrowd']
    assert isinstance(anns[0], Annotation)
    assert isinstance(anns[1], AnnotationCrowd) and \
        isinstance(want_anns[1], JaxCrowd)
    assert all(isinstance(d, AnnotationDet) for d in dets)
    assert all(isinstance(d, JaxDet) for d in want_dets)
    assert anns[0].categories == ['person'] and anns[0].id_ == 4
    np.testing.assert_array_equal(anns[0].data, want_anns[0].data)
    np.testing.assert_array_equal(anns[0].fixed_bbox, want_anns[0].fixed_bbox)
    for a, b in zip(want_anns[1:] + want_dets, anns[1:] + dets):
        assert a.json_data() == b.json_data()
    for a, b in zip(want_back, back):
        np.testing.assert_allclose(b.bbox, a.bbox, atol=1e-4)
    np.testing.assert_allclose(back[0].bbox, [0, 0, 100, 50], atol=0.5)


@pytest.mark.parametrize('probability', [0.0, 1.0])
def test_random_apply_probability_zero_and_one(probability):
    """``tests/test_transforms.py``: never and always applied."""
    want, got = run_both(
        jax_transforms.RandomApply(jax_transforms.HFlip(*FLIP), probability,
                                   rng=np.random.default_rng(0)),
        transforms.RandomApply(transforms.HFlip(*FLIP), probability,
                               rng=np.random.default_rng(0)))
    assert_same(want, got, image_atol=0.0)
    assert got[2]['hflip'] == (probability == 1.0)


def test_tensor_boundary_normalization():
    """``ImageToNumpy`` against the port's ``ImageToTensor``: the same
    ImageNet normalization, (3, H, W) in the port."""
    pil, tensor = image_pair(h=120, w=200)
    want, _, _ = jax_transforms.EVAL_TRANSFORM(pil, [], None)
    got, _, _ = transforms.EVAL_TRANSFORM(tensor, [], None)
    assert got.shape == (3, 120, 200) and got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(1, 2, 0).numpy(), want,
                               atol=1e-6)
