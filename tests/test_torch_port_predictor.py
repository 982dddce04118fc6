"""The port's Predictor and eval preprocessing against the JAX package's.

- The whole slice: the same narrow ShuffleNetV2K weights and the same
  numpy images go through the JAX ``Predictor`` and the port's
  ``Predictor(device='cpu')``.  The images' long edge is already the
  target, so the rescale is the identity on both sides and only the centre
  pad differs per image.  Required: equal annotation counts, keypoints and
  scores within the decode tolerances (xyv 1e-3, scores 1e-4) after
  ``inverse_transform``, and the same transform metadata.
- The rescale: the port has no PIL, so ``RescaleAbsolute`` runs as
  ``F.interpolate(bilinear, antialias=True)``; it is held against PIL's
  bilinear resize.
"""

import numpy as np
import PIL.Image
import pytest
import torch

from openpifpaf_tpu import models as jax_models
from openpifpaf_tpu import predictor as jax_predictor
from openpifpaf_tpu import transforms as jax_transforms
from openpifpaf_tpu.models import checkpoint as jax_checkpoint
from openpifpaf_tpu_torch import transforms
from openpifpaf_tpu_torch.predictor import Predictor

from test_torch_port_models import flax_narrow, port_narrow

LONG_EDGE = 129


def detecting_variables(variables, metas):
    """Seeded random weights give no detections (confidence ~0.5, scale
    ~0.7 cells); shifting the heads' confidence and scale biases makes
    every cell one, so seeds, CAF scoring, growth and NMS all run."""
    variables = jax_checkpoint.unflatten_tree(
        {k: np.array(v) for k, v in
         jax_checkpoint.flatten_tree(variables).items()})
    for i, meta in enumerate(metas):
        bias = variables['params'][f'head_nets_{i}']['conv']['bias']
        bias = bias.reshape(meta.n_fields, meta.n_components)
        bias[:, 0] = 2.0
        bias[:, meta.n_components - meta.n_scales:] = 3.0
    return variables


def test_predictor_matches_jax_predictor():
    module, variables, metas = flax_narrow()
    variables = detecting_variables(variables, metas)
    want_predictor = jax_predictor.Predictor(model=jax_models.Model(
        module, metas, base_stride=16, variables=variables))
    got_predictor = Predictor(
        model=port_narrow(jax_checkpoint.flatten_tree(variables)),
        device='cpu')
    want_predictor.long_edge = got_predictor.long_edge = LONG_EDGE

    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (LONG_EDGE, 96, 3), dtype=np.uint8),
              rng.integers(0, 256, (86, LONG_EDGE, 3), dtype=np.uint8)]
    want = list(want_predictor.numpy_images(images))
    got = list(got_predictor.numpy_images(images))
    assert len(want) == len(got) == 2
    for (want_anns, _, want_meta), (got_anns, _, got_meta) in zip(want, got):
        for key in ('offset', 'scale', 'valid_area', 'width_height'):
            np.testing.assert_array_equal(got_meta[key], want_meta[key],
                                          err_msg=key)
        assert len(got_anns) == len(want_anns) > 0
        want_anns = sorted(want_anns, key=lambda a: -a.score)
        got_anns = sorted(got_anns, key=lambda a: -a.score)
        for g, w in zip(got_anns, want_anns):
            np.testing.assert_allclose(g.data, w.data, atol=1e-3, rtol=0)
            assert abs(g.score - w.score) <= 1e-4
    # the centre pad moved the annotations back by its offset
    assert want[0][2]['offset'].tolist() == [-16.0, 0.0]

    # the single-image call and the json output decode the same poses
    one, _, _ = got_predictor.numpy_image(images[1])
    assert [a.score for a in one] == [a.score for a in got[1][0]]
    got_predictor.json_data = True
    dicts, _, _ = got_predictor.numpy_image(images[1])
    assert dicts == [a.json_data() for a in got[1][0]]


@pytest.mark.parametrize('hw, long_edge', [((200, 150), 129),
                                           ((97, 300), 129),
                                           ((60, 80), 129)])
def test_rescale_against_pil(hw, long_edge):
    """Down- and upscaling.  PIL resamples in 8-bit fixed point and rounds,
    the port in f32 and rounds: at most 1 level apart per pixel, 0.25 on
    average (0.13-0.20 measured on noise and smooth images), and the same
    ``inverse_transform`` metadata."""
    h, w = hw
    rng = np.random.default_rng(h)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([127 + 120 * np.sin(xx / 7.0 + c) * np.cos(yy / 11.0)
                       for c in range(3)], -1).astype(np.uint8)
    noise = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    for image in (smooth, noise):
        meta = transforms.init_meta(w, h)
        got, meta = transforms.rescale_absolute(
            torch.as_tensor(image).permute(2, 0, 1).float(), long_edge, meta)
        want, _, want_meta = jax_transforms.RescaleAbsolute(long_edge)(
            PIL.Image.fromarray(image), [], None)
        want = np.asarray(want, np.float32)
        got = got.permute(1, 2, 0).numpy()
        assert got.shape == want.shape
        assert max(got.shape[:2]) == long_edge
        diff = np.abs(got - want)
        assert diff.max() <= 1.0
        assert diff.mean() <= 0.25
        for key in ('offset', 'scale', 'valid_area'):
            np.testing.assert_allclose(meta[key], want_meta[key], rtol=1e-12,
                                       err_msg=key)


def test_preprocess_matches_jax_eval_transform():
    """Identity rescale, centre pad and ImageNet normalization: the same
    f32 operations in the same order, so 1e-6 (the last ulp of values
    up to ~2.6)."""
    image = np.random.default_rng(3).integers(0, 256, (70, LONG_EDGE, 3),
                                              dtype=np.uint8)
    got, meta = transforms.preprocess(image, LONG_EDGE, torch.device('cpu'))
    want, _, want_meta = jax_transforms.Compose([
        jax_transforms.RescaleAbsolute(LONG_EDGE),
        jax_transforms.CenterPad(LONG_EDGE),
        jax_transforms.EVAL_TRANSFORM,
    ])(PIL.Image.fromarray(image), [], None)
    np.testing.assert_allclose(got.permute(1, 2, 0).numpy(), want,
                               atol=1e-6, rtol=0)
    for key in ('offset', 'scale', 'valid_area', 'width_height'):
        np.testing.assert_array_equal(meta[key], want_meta[key],
                                      err_msg=key)
