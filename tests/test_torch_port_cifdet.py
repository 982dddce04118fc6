"""The port's detection path against the JAX package: the CifDet head meta,
annotations, encoder, head and decode.

- ``headmeta.CifDet`` through the npz checkpoint header both ways, with a
  narrow ShuffleNetV2K that carries CIF, CAF and CifDet heads (the model
  ``--dataset toykp,cifar10`` trains): a JAX-written checkpoint loads in
  the port and its forward equals flax's within 1e-5 in f32 (the CifDet
  head at ``upsample_stride`` 1 and at 2, PixelShuffle and its crop); a
  port-written one loads in the JAX package with every variable equal.
- The CifDet encoder's six target arrays equal JAX's (bit for bit; the
  f32 ones within 1e-6) for random boxes and a crowd region, on cifar10's
  33 px canvas at stride 8 and on 81 px canvases at strides 16 and 8.
- The decode held to JAX's ``CifDet`` on the painted fields of
  ``tests/test_cifdet_decoder.py`` (5 components: an empty spread), on
  seeded random scenes (7 components, offsets converging on random
  centers) and on seeded random fields with shifted biases: categories
  equal, scores within 1e-5, boxes within 1e-3 px.  Both sides round the
  CifHr profiles to bf16, the port's CPU default.
- ``HFlip``, the rescale and pad transforms, ``inverse_transform`` and
  ``json_data`` on box-only annotations equal JAX's.
"""

import argparse

import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

from openpifpaf_tpu import annotation as jax_annotation
from openpifpaf_tpu import decoder as jax_decoder
from openpifpaf_tpu import encoder as jax_encoder
from openpifpaf_tpu import headmeta as jax_headmeta
from openpifpaf_tpu import transforms as jax_transforms
from openpifpaf_tpu.models import checkpoint as jax_checkpoint
from openpifpaf_tpu.models import heads as jax_heads
from openpifpaf_tpu.models import shell as jax_shell
from openpifpaf_tpu.models import shufflenetv2k as jax_sn
from openpifpaf_tpu_torch import (annotation, decoder, encoder, headmeta,
                                  models, transforms)
from openpifpaf_tpu_torch.plugins.cifar10 import CATEGORIES

import test_cifdet_decoder as painted
from test_torch_port_decode import one_torch_thread  # noqa: F401  (fixture)
from test_torch_port_encoder import assert_targets_equal
from test_torch_port_models import NARROW, coco_metas, random_variables


def det_meta(hm, categories=CATEGORIES, upsample_stride=2, stride=16):
    meta = hm.CifDet('cifdet', 'cifar10', categories=list(categories))
    meta.upsample_stride = upsample_stride
    meta.base_stride = stride
    return meta


def three_head_metas(hm, upsample_stride=2):
    """toykp's CIF and CAF heads and cifar10's CifDet head, in the order
    ``--dataset toykp,cifar10`` merges them."""
    metas = coco_metas(hm) + [det_meta(hm, upsample_stride=upsample_stride)]
    for i, meta in enumerate(metas):
        meta.head_index, meta.base_stride = i, 16
    return metas


def flax_three_heads(upsample_stride=2, seed=0):
    module = jax_shell.Shell(
        basenet=jax_sn.ShuffleNetV2K(*NARROW, dtype=jnp.float32),
        head_nets=[jax_heads.CompositeField4(meta=m, in_features=64,
                                             dtype=jnp.float32)
                   for m in three_head_metas(jax_headmeta, upsample_stride)])
    return module, random_variables(module, seed)


def port_three_heads(flat, head_metas, bf16=False):
    for meta in head_metas:
        meta.base_stride = 16
    shell = models.Shell(models.ShuffleNetV2K(*NARROW),
                         [models.CompositeField4(m, 64) for m in head_metas])
    shell.load_state_dict(models.from_jax_variables(flat), strict=True)
    return models.Model(shell, head_metas, base_stride=16,
                        device=torch.device('cpu'), bf16=bf16)


@pytest.mark.parametrize('upsample_stride', [1, 2])
def test_three_head_checkpoint_both_ways(upsample_stride, tmp_path):
    module, variables = flax_three_heads(upsample_stride)
    path = str(tmp_path / 'jax.npz')
    jax_checkpoint.save(path, variables=variables,
                        head_metas=three_head_metas(jax_headmeta,
                                                    upsample_stride),
                        basenet_name='shufflenetv2k16', base_stride=16,
                        epoch=2)
    header, flat = models.checkpoint.load(path)
    det = header['head_metas'][2]
    assert [(type(m).__name__, m.name) for m in header['head_metas']] == \
        [('Cif', 'cif'), ('Caf', 'caf'), ('CifDet', 'cifdet')]
    assert det.categories == CATEGORIES and det.n_components == 7
    assert (det.upsample_stride, det.head_index, det.base_stride) == \
        (upsample_stride, 2, 16)
    assert det.stride == 16 // upsample_stride

    model = port_three_heads(flat, header['head_metas'])
    x = np.random.default_rng(0).normal(size=(2, 65, 65, 3)).astype(np.float32)
    want = module.apply(variables, x, train=False)
    got = model.apply(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    side = (65 - 1) // det.stride + 1
    assert [tuple(g.shape) for g in got] == [
        (2, 17, 5, 5, 5), (2, 19, 9, 5, 5), (2, 10, 7, side, side)]
    for w, g in zip(want, got):
        assert np.abs(np.asarray(w) - g.numpy()).max() <= 1e-5
    # the served forward (the pair plan) gives the same fields
    for g, fast in zip(got, model(torch.from_numpy(x.transpose(0, 3, 1, 2)))):
        assert float((g - fast).abs().max()) <= 1e-5

    back = str(tmp_path / 'port.npz')
    models.checkpoint.save(
        back, variables=models.to_jax_variables(model.module.state_dict()),
        head_metas=model.head_metas, basenet_name='shufflenetv2k16',
        base_stride=16, epoch=2)
    jax_header, jax_vars = jax_checkpoint.load(back)
    jax_det = jax_header['head_metas'][2]
    assert isinstance(jax_det, jax_headmeta.CifDet)
    assert (jax_det.categories, jax_det.upsample_stride) == \
        (CATEGORIES, upsample_stride)
    want_flat = jax_checkpoint.flatten_tree(variables)
    got_flat = jax_checkpoint.flatten_tree(jax_vars)
    assert set(got_flat) == set(want_flat)
    for key, value in want_flat.items():
        np.testing.assert_array_equal(got_flat[key], value, err_msg=key)


def test_headmeta_matches_jax():
    want, got = det_meta(jax_headmeta), det_meta(headmeta)
    assert (got.n_fields, got.n_components, got.stride) == \
        (want.n_fields, want.n_components, want.stride) == (10, 7, 8)
    assert got.vector_offsets == want.vector_offsets == [True, False]
    assert models.checkpoint.headmeta_to_json(got) == \
        jax_checkpoint.headmeta_to_json(want)


# ------------------------------------------------------------- encoder
def box_anns(rng, side, n_categories, n=4):
    """Random boxes (some over the border, one pair on the same category)
    and a crowd region, as (JAX, port) annotation lists."""
    out = []
    for hm_ann in (jax_annotation, annotation):
        local = np.random.default_rng(rng)
        anns = []
        for i in range(n):
            wh = local.uniform(4, side, 2)
            xy = local.uniform(-wh / 2, side - wh / 2, 2)
            cat = 1 + (i % 2 if i < 2 else int(local.integers(n_categories)))
            anns.append(hm_ann.AnnotationDet(CATEGORIES[:n_categories]).set(
                cat, 1.0, [*xy, *wh]))
        crowd = hm_ann.Annotation(keypoints=[], skeleton=[])
        crowd.iscrowd = True
        crowd.fixed_bbox = np.array([0.0, 0.0, side / 4, side / 3],
                                    np.float32)
        anns.append(crowd)
        out.append(anns)
    return out


@pytest.mark.parametrize('side, stride, n_categories', [
    (33, 8, 10), (81, 16, 10), (81, 8, 3)],
    ids=['cifar10-33px-s8', '81px-s16', '81px-s8'])
@pytest.mark.parametrize('seed', [0, 1])
def test_encoder_matches_jax(side, stride, n_categories, seed):
    metas = []
    for hm in (jax_headmeta, headmeta):
        meta = det_meta(hm, CATEGORIES[:n_categories],
                        upsample_stride=16 // stride)
        metas.append(meta)
    jax_anns, anns = box_anns(seed, side, n_categories)
    want = jax_encoder.CifDetEncoder(metas[0])(
        np.zeros((side, side, 3), np.float32), jax_anns)
    got = encoder.factory_head(metas[1])(torch.zeros(3, side, side), anns)
    assert isinstance(encoder.factory_head(metas[1]), encoder.CifDetEncoder)
    assert got['vec'].shape == (n_categories, 2, 2, *(2 * [(side - 1)
                                                         // stride + 1]))
    assert got['conf'].sum() > 0 and not got['conf_mask'].all()
    assert_targets_equal(want, got)


# -------------------------------------------------------------- decode
def decode_both(fields, n_categories, stride=16, upsample_stride=1):
    """JAX's and the port's CifDet on the same (B, F, C, H, W) fields."""
    out = []
    for hm in (jax_headmeta, headmeta):
        meta = det_meta(hm, [f'c{i}' for i in range(n_categories)],
                        upsample_stride=upsample_stride, stride=stride)
        meta.head_index = 0
        out.append(meta)
    want = jax_decoder.CifDet(out[0]).batch_fields([fields])
    got = decoder.CifDet(out[1], device='cpu').batch_fields(
        [torch.from_numpy(fields)])
    return want, got


def assert_same_dets(want, got):
    """Categories equal, scores within 1e-5, boxes within 1e-3 px, in the
    same order."""
    assert [len(w) for w in want] == [len(g) for g in got]
    for want_i, got_i in zip(want, got):
        for w, g in zip(want_i, got_i):
            assert isinstance(g, annotation.AnnotationDet)
            assert g.category_id == w.category_id
            assert abs(g.score - w.score) <= 1e-5
            assert np.abs(g.bbox - w.bbox).max() <= 1e-3


def painted_fields(case):
    """The painted scenes of ``tests/test_cifdet_decoder.py``."""
    if case == 'single':
        return painted.paint_det(painted.empty_field(), 1, 80.0, 80.0,
                                 40.0, 24.0)
    if case == 'two_categories':
        field = painted.empty_field()
        painted.paint_det(field, 0, 80.0, 80.0, 30.0, 30.0)
        painted.paint_det(field, 1, 80.0, 80.0, 30.0, 30.0, conf=0.8)
        return field
    if case == 'nms':
        field = painted.empty_field(gh=21, gw=21)
        painted.paint_det(field, 0, 80.0, 80.0, 60.0, 60.0, conf=0.95)
        painted.paint_det(field, 0, 88.0, 80.0, 60.0, 60.0, conf=0.7)
        painted.paint_det(field, 0, 240.0, 240.0, 40.0, 40.0, conf=0.9)
        return field
    return painted.empty_field()


@pytest.mark.parametrize('case', ['single', 'two_categories', 'nms',
                                  'empty'])
def test_decode_painted(case):
    want, got = decode_both(painted_fields(case)[None], 2)
    assert_same_dets(want, got)
    assert len(got[0]) == {'single': 1, 'two_categories': 2, 'nms': 2,
                           'empty': 0}[case]


def random_scenes(seed, b, f, side, n_objects):
    """Raw 7-component fields: per category ``n_objects`` random boxes;
    each cell's offset points at its nearest box center (plus noise) and
    regresses that box's size, the cells near a center are confident, the
    rest below 0.5 on average; the spreads are N(0, 1)."""
    rng = np.random.default_rng(seed)
    field = np.empty((b, f, 7, side, side), np.float32)
    field[:, :, 0] = rng.normal(-1.0, 1.0, (b, f, side, side))
    field[:, :, 5:] = rng.normal(0.0, 1.0, (b, f, 2, side, side))
    jj, ii = np.mgrid[0:side, 0:side].astype(np.float32)
    for bi in range(b):
        for fi in range(f):
            centers = rng.uniform(0, side - 1, (n_objects, 2))
            wh = rng.uniform(2, 8, (n_objects, 2))
            d2 = ((ii[None] - centers[:, 0, None, None]) ** 2
                  + (jj[None] - centers[:, 1, None, None]) ** 2)
            near = d2.argmin(0)
            noise = rng.normal(0.0, [[[0.3]], [[0.3]], [[0.5]], [[0.5]]],
                               (4, side, side))
            field[bi, fi, 1] = centers[near, 0] - ii + noise[0]
            field[bi, fi, 2] = centers[near, 1] - jj + noise[1]
            field[bi, fi, 3] = wh[near, 0] + noise[2]
            field[bi, fi, 4] = wh[near, 1] + noise[3]
            field[bi, fi, 0] += np.where(d2.min(0) < 4.0,
                                         rng.uniform(2.0, 4.0), 0.0)
    return field


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('f, side, n_objects, upsample_stride', [
    (3, 21, 6, 1), (10, 5, 1, 2)], ids=['21x21-s16', 'cifar10-5x5-s8'])
def test_decode_random_scenes(seed, f, side, n_objects, upsample_stride):
    fields = random_scenes(seed, 2, f, side, n_objects)
    want, got = decode_both(fields, f, upsample_stride=upsample_stride)
    assert_same_dets(want, got)
    assert min(len(g) for g in got) >= 2


@pytest.mark.parametrize('seed', [0, 1])
def test_decode_shifted_random_fields(seed):
    """Seeded N(0, 1) fields with the confidence shifted by +2 and the box
    size by +20 cells: sigma = 0.1 x half the short side reaches the
    neighbouring cells (16 px), so the splats add up, and the boxes of
    neighbouring cells overlap: the local maxima, the top-k and the NMS
    all decide."""
    rng = np.random.default_rng(seed)
    fields = rng.normal(0.0, 1.0, (2, 4, 7, 15, 15)).astype(np.float32)
    fields[:, :, 0] += 2.0
    fields[:, :, 1:3] *= 0.5
    fields[:, :, 3:5] = np.abs(fields[:, :, 3:5]) * 2.0 + 20.0
    want, got = decode_both(fields, 4)
    assert_same_dets(want, got)
    assert min(len(g) for g in got) >= 1


def test_decoder_factory_and_flags():
    det = det_meta(headmeta)
    det.head_index = 0
    dec = decoder.factory([det], device='cpu')
    assert isinstance(dec, decoder.CifDet)
    parser = argparse.ArgumentParser()
    decoder.cli(parser)
    old = (decoder.CifDet.seed_threshold, decoder.CifDet.iou_threshold,
           decoder.CifDet.max_detections)
    try:
        decoder.configure(parser.parse_args([
            '--cifdet-seed-threshold=0.4', '--cifdet-iou-threshold=0.6',
            '--cifdet-max-detections=8']))
        config = dec.config_for((33, 33))
        assert (config.seed_threshold, config.iou_threshold,
                config.max_detections) == (0.4, 0.6, 8)
        assert (config.cifhr.sigma_factor, config.cifhr.min_sigma_px,
                config.cifhr.spacing, config.cifhr.profile_bf16) == \
            (0.1, 2.0, 2, True)
        # the card's f32 profiles on the CPU, for both decoders
        decoder.configure(parser.parse_args(['--cifhr-f32-profiles']))
        assert not dec.config_for((33, 33)).cifhr.profile_bf16
        cif, caf = three_head_metas(headmeta)[:2]
        assert not decoder.CifCaf(cif, caf, device='cpu').config_for(
            (33, 33)).cifhr.profile_bf16
    finally:
        (decoder.CifDet.seed_threshold, decoder.CifDet.iou_threshold,
         decoder.CifDet.max_detections) = old
        decoder.configure(parser.parse_args([]))


# ------------------------------------------------ box-only annotations
def box_only(hm_ann):
    det = hm_ann.AnnotationDet(CATEGORIES).set(3, 0.75, [3.5, 4.0, 10.0,
                                                        6.5])
    crowd = hm_ann.AnnotationCrowd(CATEGORIES).set(5, [1.0, 20.0, 7.0, 4.0])
    kp = hm_ann.Annotation(keypoints=[], skeleton=[])
    kp.fixed_bbox = np.array([2.0, 2.0, 30.0, 29.0], np.float32)
    return [det, crowd, kp]


def test_hflip_box_only_matches_jax():
    image = np.random.default_rng(0).integers(0, 256, (33, 40, 3),
                                              dtype=np.uint8)
    _, want, want_meta = jax_transforms.HFlip([], {})(
        PIL.Image.fromarray(image), box_only(jax_annotation), None)
    flipped, got, got_meta = transforms.HFlip([], {})(
        torch.from_numpy(image).permute(2, 0, 1).float(),
        box_only(annotation), None)
    np.testing.assert_array_equal(
        flipped.permute(1, 2, 0).numpy(),
        np.asarray(PIL.Image.fromarray(image).transpose(
            PIL.Image.FLIP_LEFT_RIGHT), np.float32))
    for w, g in zip(want, got):
        bbox_w = w.fixed_bbox if hasattr(w, 'fixed_bbox') else w.bbox
        bbox_g = g.fixed_bbox if hasattr(g, 'fixed_bbox') else g.bbox
        np.testing.assert_array_equal(bbox_g, bbox_w)
    np.testing.assert_array_equal(got_meta['valid_area'],
                                  want_meta['valid_area'])
    assert got_meta['hflip'] and want_meta['hflip']
    assert got[0].bbox.tolist() == [40 - 1 - 13.5, 4.0, 10.0, 6.5]


def test_box_only_transforms_and_inverse_match_jax():
    """Rescale, pad and flip box-only annotations, then map them back:
    both packages give the same boxes, json and the original boxes."""
    image = np.random.default_rng(1).integers(0, 256, (32, 48, 3),
                                              dtype=np.uint8)
    want_pre = jax_transforms.Compose([
        jax_transforms.HFlip([], {}), jax_transforms.RescaleAbsolute(65),
        jax_transforms.CenterPad(65)])
    got_pre = transforms.Compose([
        transforms.HFlip([], {}), transforms.RescaleAbsolute(65),
        transforms.CenterPad(65)])
    _, want, want_meta = want_pre(PIL.Image.fromarray(image),
                                  box_only(jax_annotation)[:2], None)
    _, got, got_meta = got_pre(
        torch.from_numpy(image).permute(2, 0, 1).float(),
        box_only(annotation)[:2], None)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.bbox, w.bbox, rtol=0, atol=1e-5)
        back_w, back_g = w.inverse_transform(want_meta), \
            g.inverse_transform(got_meta)
        np.testing.assert_allclose(back_g.bbox, back_w.bbox, rtol=0,
                                   atol=1e-5)
        assert back_g.json_data() == back_w.json_data()
    originals = box_only(annotation)[:2]
    for g, original in zip(got, originals):
        np.testing.assert_allclose(g.inverse_transform(got_meta).bbox,
                                   original.bbox, atol=1e-4)
