"""The port's attention backbones against the JAX package's, on the CPU.

Swin, XCiT, BoTNet and HRFormer at narrow configurations, with the
harness of ``test_torch_port_backbones_cnn.py``: the same seeded flax
variables through both packages, f32 at 81 px within 1e-4 of the output
scale and bf16 at 64 px within 3% of the f32 output's scale.  81 px is
odd at every stride: Swin's 4x4/4 ``patch_embed`` pads unevenly under
flax's ``'SAME'`` (1 above, 2 below), its windows and HRFormer's are
padded to multiples of 7, HRFormer's nearest resizes are not integer
(3 -> 6 -> 11 -> 21), and BoTNet's position embeddings shrink from 32 to 6
(jax's antialiased linear resize).  ``test_mhsa2d_upsample`` holds BoTNet's
attention where the map is wider than 32 (the resize grows).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpifpaf_tpu.models import botnet as jax_botnet
from openpifpaf_tpu.models import hrformer as jax_hrformer
from openpifpaf_tpu.models import swin as jax_swin
from openpifpaf_tpu.models import xcit as jax_xcit
from openpifpaf_tpu_torch.models import botnet, hrformer, swin, xcit

from test_torch_port_backbones_cnn import (F32_TOL, backbone_variables,
                                           hold_backbone, port_backbone,
                                           unflatten)

ODD, EVEN = 81, 64


def test_swin():
    """embed 32, two blocks per stage so that every stage runs a shifted
    block, heads (1, 2, 4, 8)."""
    kw = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8))
    shape = hold_backbone(jax_swin.Swin(**kw),
                          jax_swin.Swin(**kw, dtype=jnp.bfloat16),
                          swin.Swin(**kw), odd=ODD, even=EVEN)
    assert shape == (2, 256, 6, 6)


def test_swin_helpers():
    """The window helpers and the static shift mask against the JAX
    package's."""
    for w in (3, 7):
        np.testing.assert_array_equal(swin.relative_position_index(w),
                                      jax_swin.relative_position_index(w))
    x = np.random.default_rng(0).normal(size=(2, 14, 21, 5)) \
        .astype(np.float32)
    windows = swin.window_partition(torch.from_numpy(x), 7)
    np.testing.assert_array_equal(
        windows.numpy(), np.asarray(jax_swin.window_partition(x, 7)))
    np.testing.assert_array_equal(
        swin.window_reverse(windows, 7, 14, 21).numpy(), x)
    block = jax_swin.SwinBlock(dim=8, num_heads=1, window=7, shift=3)
    np.testing.assert_array_equal(
        swin.shift_mask(14, 21, 7, 3), np.asarray(block._attn_mask(14, 21)))  # pylint: disable=protected-access


def test_xcit():
    kw = dict(embed_dim=64, depth=2, num_heads=8)
    shape = hold_backbone(jax_xcit.XCiT(**kw),
                          jax_xcit.XCiT(**kw, dtype=jnp.bfloat16),
                          xcit.XCiT(**kw), odd=ODD, even=EVEN)
    assert shape == (2, 64, 6, 6)
    np.testing.assert_array_equal(xcit._fourier_grid(6, 11, 32, 1e4),  # pylint: disable=protected-access
                                  jax_xcit._fourier_grid(6, 11, 32, 1e4))  # pylint: disable=protected-access


def test_botnet():
    """One block per stage; the last stage's map is 6 wide at 81 px."""
    layers = (1, 1, 1, 1)
    shape = hold_backbone(jax_botnet.BotNet(layers),
                          jax_botnet.BotNet(layers, dtype=jnp.bfloat16),
                          botnet.BotNet(layers), odd=ODD, even=EVEN)
    assert shape == (2, 2048, 6, 6)


@pytest.mark.parametrize('hw', [(36, 41), (9, 32)])
def test_mhsa2d_upsample(hw):
    """BoTNet's attention alone (dim 32, 4 heads) on maps wider than the
    embeddings' base of 32, and at it and below; f32 within 1e-4 of the
    output scale."""
    import jax  # pylint: disable=import-outside-toplevel

    module = jax_botnet.MHSA2D(32, 4)
    flat = backbone_variables(module, hw=(5, 5), channels=32,
                              call_kwargs={})
    net = port_backbone(botnet.MHSA2D(32, 4), flat)
    x = np.random.default_rng(2).normal(size=(2, *hw, 32)).astype(np.float32)
    want = np.asarray(jax.jit(module.apply)(unflatten(flat), x)) \
        .transpose(0, 3, 1, 2)
    with torch.no_grad():
        got = net(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    assert np.abs(want - got).max() <= F32_TOL * np.abs(want).max()
    for n_out in hw:
        resized = np.asarray(jax.image.resize(np.eye(32, dtype=np.float32),
                                              (32, n_out), 'linear'))
        np.testing.assert_allclose(botnet.linear_resize_matrix(32, n_out),
                                   resized, atol=1e-6)


def test_hrformer():
    """base 8, one module of one block per branch per stage; branches 21,
    11, 6 and 3 wide at 81 px."""
    kw = dict(base_channels=8, num_modules=(1, 1, 1), blocks_per_module=1)
    shape = hold_backbone(jax_hrformer.HRFormer(**kw),
                          jax_hrformer.HRFormer(**kw, dtype=jnp.bfloat16),
                          hrformer.HRFormer(**kw), odd=ODD, even=EVEN)
    assert shape == (2, 8 * 4 * 3 + 8 * 8, 6, 6)
    for n_in, n_out in ((3, 6), (6, 21), (11, 21), (21, 41)):
        want = np.asarray(jax_forward_nearest(n_in, n_out))
        np.testing.assert_array_equal(hrformer.nearest_index(n_in, n_out),
                                      want)


def jax_forward_nearest(n_in, n_out):
    """The source index of each output of ``jax.image.resize(nearest)``."""
    import jax  # pylint: disable=import-outside-toplevel

    return jax.image.resize(jnp.arange(n_in, dtype=jnp.float32), (n_out,),
                            'nearest').astype(jnp.int32)

