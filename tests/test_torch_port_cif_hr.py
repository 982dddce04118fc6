"""CifHr splat: the port's plain version against ``openpifpaf_tpu``.

``openpifpaf_tpu_torch.ops.cif_hr.accumulate`` on CPU tensors runs the
plain PyTorch version of the CUDA kernel ``csrc/cif_hr.cu``; the JAX
``cif_hr.accumulate`` (its einsum path, the oracle of the Pallas kernel
``accumulate_pallas`` in ``tests/test_pallas_ops.py``) is the reference.
The kernel itself runs only on the card and is held against this plain
version there by ``chip_smoke.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openpifpaf_tpu.ops import cif_hr as jax_cif_hr
from openpifpaf_tpu_torch.ops import cif_hr

from test_pallas_ops import synthetic_inputs


def run_both(inputs, out_hw, jax_config, **kw):
    want = jax_cif_hr.accumulate(*(jnp.asarray(a) for a in inputs),
                                 out_hw=out_hw, config=jax_config, **kw)
    config = cif_hr.CifHrConfig(**{
        f.name: getattr(jax_config, f.name)
        for f in dataclasses.fields(cif_hr.CifHrConfig)})
    got = cif_hr.accumulate(*(torch.from_numpy(a) for a in inputs),
                            out_hw=out_hw, config=config, **kw)
    if kw.get('return_overflow'):
        return ((np.asarray(want[0]), int(want[1])),
                (got[0].numpy(), int(got[1])))
    return np.asarray(want), got.numpy()


def out_hw_for(conf):
    _, h, w = conf.shape
    return ((h - 1) * 16 // 2 + 1, (w - 1) * 16 // 2 + 1)


@pytest.mark.parametrize('seed', [0, 1])
def test_f32_profiles_match(seed):
    """f32 profiles: atol 2e-5, the tolerance the Pallas kernel is held to
    against the same einsum (``test_pallas_ops.py``); only the summation
    order over cells differs."""
    inputs = synthetic_inputs(seed)
    config = jax_cif_hr.CifHrConfig(profile_bf16=False)
    want, got = run_both(inputs, out_hw_for(inputs[0]), config)
    assert got.shape == want.shape == (5, 65, 65)
    assert got.max() > 0.1
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_bf16_profiles_match():
    """bf16 profiles (the JAX default): both round the same f32 profile to
    bf16 and contract in f32.  atol 2e-4: an exp that differs by one f32
    ulp between the frameworks can round to a neighbouring bf16 value
    (2^-8 relative) for a cell weighted at most 1/16."""
    inputs = synthetic_inputs(0)
    config = jax_cif_hr.CifHrConfig(profile_bf16=True)
    want, got = run_both(inputs, out_hw_for(inputs[0]), config)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
    # and the rounding is really there: f32 profiles differ by more
    f32 = jax_cif_hr.CifHrConfig(profile_bf16=False)
    _, got32 = run_both(inputs, out_hw_for(inputs[0]), f32)
    assert np.abs(got32 - got).max() > 1e-5


def test_y_offset_and_no_clip():
    """A band of rows starting at ``y_offset_px``, unclipped (the banded
    decode's form); painted dense enough that sums exceed 1."""
    conf, x_px, y_px, scale_px = synthetic_inputs(2)
    conf = np.maximum(conf, 0.95).astype(np.float32)
    scale_px = (scale_px * 3.0).astype(np.float32)
    config = jax_cif_hr.CifHrConfig(profile_bf16=False)
    want, got = run_both((conf, x_px, y_px, scale_px), (20, 65), config,
                         y_offset_px=37.0, clip=False)
    assert got.shape == (5, 20, 65) and want.max() > 1.0
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-6)


def test_compaction_and_overflow_counter():
    """``max_active`` compaction engaged (81 cells > 2 * 16): the same
    cells survive (ties in confidence broken by lower index, as
    ``lax.top_k``) and the overflow counters agree."""
    inputs = synthetic_inputs(3)
    config = jax_cif_hr.CifHrConfig(profile_bf16=False, max_active=16)
    (want, want_drop), (got, got_drop) = run_both(
        inputs, out_hw_for(inputs[0]), config, return_overflow=True)
    assert want_drop == got_drop > 0
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    dense = jax_cif_hr.CifHrConfig(profile_bf16=False, max_active=0)
    (full, full_drop), _ = run_both(inputs, out_hw_for(inputs[0]), dense,
                                    return_overflow=True)
    assert full_drop == 0 and (full - got).max() > 1e-3


def test_min_scale_and_extra_mask():
    conf, x_px, y_px, scale_px = synthetic_inputs(4)
    extra = np.random.default_rng(4).uniform(size=conf.shape) > 0.3
    config = jax_cif_hr.CifHrConfig(profile_bf16=False, min_scale=25.0)
    want = np.asarray(jax_cif_hr.accumulate(
        *(jnp.asarray(a) for a in (conf, x_px, y_px, scale_px)),
        out_hw=out_hw_for(conf), config=config,
        extra_mask=jnp.asarray(extra)))
    got = cif_hr.accumulate(
        *(torch.from_numpy(a) for a in (conf, x_px, y_px, scale_px)),
        out_hw=out_hw_for(conf),
        config=cif_hr.CifHrConfig(profile_bf16=False, min_scale=25.0),
        extra_mask=torch.from_numpy(extra)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_all_masked_gives_exact_zeros():
    conf, x_px, y_px, scale_px = synthetic_inputs(0)
    conf = np.full_like(conf, 0.05)           # below v_threshold
    config = cif_hr.CifHrConfig(profile_bf16=False)
    got = cif_hr.accumulate(*(torch.from_numpy(a) for a in
                              (conf, x_px, y_px, scale_px)),
                            out_hw=(65, 65), config=config)
    assert torch.count_nonzero(got) == 0
    v = torch.zeros(2, 3, 16)
    out = cif_hr.accumulate_plain(v, v + 3.0, v + 5.0, v + 2.0,
                                  out_hw=(40, 40), spacing=2.0, truncate=1.0)
    assert out.shape == (2, 3, 40, 40) and torch.count_nonzero(out) == 0


def test_batched_equals_single_and_stays_on_plain_path():
    """(B, F, H, W) input is the per-image splat stacked; CPU tensors never
    reach the CUDA kernel's wrapper."""
    a = synthetic_inputs(5)
    b = synthetic_inputs(6)
    config = cif_hr.CifHrConfig(profile_bf16=False)
    before = cif_hr.KERNEL_LAUNCHES
    batched = cif_hr.accumulate(
        *(torch.from_numpy(np.stack([u, w])) for u, w in zip(a, b)),
        out_hw=(65, 65), config=config)
    singles = [cif_hr.accumulate(*(torch.from_numpy(u) for u in inp),
                                 out_hw=(65, 65), config=config)
               for inp in (a, b)]
    assert cif_hr.KERNEL_LAUNCHES == before
    torch.testing.assert_close(batched, torch.stack(singles), atol=1e-6,
                               rtol=0)
