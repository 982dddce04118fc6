"""CifHr splat: the port's plain version against ``openpifpaf_tpu``.

``openpifpaf_tpu_torch.ops.cif_hr.accumulate`` on CPU tensors runs the
plain PyTorch version of the CUDA kernel ``csrc/cif_hr.cu``; the JAX
``cif_hr.accumulate`` (its einsum path, the oracle of the Pallas kernel
``accumulate_pallas`` in ``tests/test_pallas_ops.py``) is the reference,
and the Pallas kernel itself (interpreted) is held to the plain splat too.
``tile_bins_plain``, the plain version of the kernel's first pass, is held
to what the second pass needs of it: a cell left out of a tile adds exactly
0 there.  The kernel itself runs only on the card and is held against these
plain versions there by ``chip_smoke.py``.
"""

import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openpifpaf_tpu.ops import cif_hr as jax_cif_hr
from openpifpaf_tpu_torch.ops import cif_hr
from openpifpaf_tpu_torch.ops.common import masked_top_k

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


# ------------------------------------------------- the kernel's tile binning
def cells(conf, x_px, y_px, scale_px, config=cif_hr.CifHrConfig()):
    """(1, F, N) float32 tensors (v, x, y, sigma) as ``accumulate`` hands
    them to the kernel."""
    f = conf.shape[0]
    v = np.where(conf > config.v_threshold, conf * config.neighbor_factor, 0.0)
    sigma = np.maximum(config.min_sigma_px, config.sigma_factor * scale_px)
    return tuple(torch.tensor(a.reshape(1, f, -1), dtype=torch.float32)
                 for a in (v, x_px, y_px, sigma))


def compacted(seed, k=40):
    """The ``k`` most confident cells in top-k order (positions unordered),
    as ``max_active`` compaction hands them on."""
    conf, x_px, y_px, scale_px = synthetic_inputs(seed)
    v, x, y, sigma = cells(conf, x_px, y_px, scale_px)
    _, idx, valid = masked_top_k(torch.from_numpy(conf).reshape(1, 5, -1),
                                 v != 0, k)
    v = torch.where(valid, torch.gather(v, 2, idx), 0.0)
    return (v, *(torch.gather(t, 2, idx) for t in (x, y, sigma)))


def far_outside(seed):
    conf, x_px, y_px, scale_px = synthetic_inputs(seed)
    x_px[:, :, :3] += 5000.0
    y_px[:, :3, :] -= 5000.0
    return cells(conf, x_px, y_px, scale_px)


def band(seed):
    conf, x_px, y_px, scale_px = synthetic_inputs(seed)
    return cells(np.maximum(conf, 0.95), x_px, y_px, scale_px * 3.0)


def whole_grid(seed):
    conf, x_px, y_px, scale_px = synthetic_inputs(seed)
    return cells(conf, x_px, y_px, scale_px * 100.0)


# name -> (cells, out_hw, y_offset_px, clip)
BIN_CASES = {
    'synthetic': (lambda: cells(*synthetic_inputs(0)), (65, 65), 0.0, True),
    'whole-grid window': (lambda: whole_grid(1), (65, 65), 0.0, True),
    'far outside': (lambda: far_outside(2), (65, 65), 0.0, True),
    'band unclipped': (lambda: band(3), (20, 65), 37.0, False),
    'odd grid': (lambda: cells(*synthetic_inputs(4)), (37, 53), 0.0, True),
    'n=63': (lambda: cells(*synthetic_inputs(5, h=7)), (49, 65), 0.0, True),
    'compacted': (lambda: compacted(6), (65, 65), 0.0, True),
}


def unpack(masks, n):
    """(B, F, T, W) int32 words -> (B, F, T, N) bool."""
    bits = (masks.long()[..., None] >> torch.arange(32)) & 1
    return bits.reshape(*masks.shape[:3], -1)[..., :n].bool()


def profiles(v, x, y, sigma, out_hw, spacing, truncate, y_offset_px):
    """Row profiles (with v) and column profiles, as ``accumulate_plain``."""
    hh, wh = out_hw
    ys = torch.arange(hh, dtype=torch.float32) * spacing + y_offset_px
    xs = torch.arange(wh, dtype=torch.float32) * spacing
    dy, dx = ys - y[..., None], xs - x[..., None]
    inv, tr = (0.5 / (sigma * sigma))[..., None], (truncate * sigma)[..., None]
    gy = torch.where(dy.abs() <= tr, torch.exp(-dy * dy * inv), 0.0)
    gx = torch.where(dx.abs() <= tr, torch.exp(-dx * dx * inv), 0.0)
    return gy * v[..., None], gx


def tile_slices(out_hw, tile):
    ty, tx = cif_hr.tile_grid(out_hw, tile)
    return [(slice(i * tile[0], (i + 1) * tile[0]),
             slice(j * tile[1], (j + 1) * tile[1]))
            for i in range(ty) for j in range(tx)]


@pytest.mark.parametrize('tile', [cif_hr.TILE, (8, 8), (16, 32)],
                         ids=lambda t: f'{t[0]}x{t[1]}')
@pytest.mark.parametrize('case', list(BIN_CASES))
def test_tile_bins_are_conservative(case, tile):
    """``tile_bins_plain`` leaves a (cell, tile) out only where the cell's
    row profile over the tile's rows or its column profile over the tile's
    columns is all exact zeros, so the cell adds exactly 0 there."""
    make, out_hw, y_off, _ = BIN_CASES[case]
    v, x, y, sigma = make()
    kw = dict(out_hw=out_hw, spacing=2.0, truncate=1.0, y_offset_px=y_off)
    masks = cif_hr.tile_bins_plain(v, x, y, sigma, tile=tile, **kw)
    n = v.shape[2]
    n_tiles = cif_hr.tile_grid(out_hw, tile)
    assert masks.dtype == torch.int32
    assert masks.shape == (1, 5, n_tiles[0] * n_tiles[1], -(-n // 32))
    binned = unpack(masks, n)
    assert not (binned & (v == 0)[:, :, None]).any()
    gy, gx = profiles(v, x, y, sigma, **kw)
    for t, (rows, cols) in enumerate(tile_slices(out_hw, tile)):
        zero = ((gy[..., rows] == 0).all(-1) | (gx[..., cols] == 0).all(-1))
        assert (binned[:, :, t] | zero).all(), t
    kept = (v != 0)[:, :, None].expand_as(binned)
    if case == 'whole-grid window':
        assert torch.equal(binned, kept)
    elif case == 'far outside':
        far = torch.zeros(5, 9, 9, dtype=torch.bool)
        far[:, :, :3] = far[:, :3, :] = True
        assert not binned[:, :, :, far.reshape(5, -1)[0]].any()
        assert binned.any()
    elif tile != cif_hr.TILE:
        assert 0 < int(binned.sum()) < int(kept.sum())


@pytest.mark.parametrize('tile', [cif_hr.TILE, (16, 32)],
                         ids=lambda t: f'{t[0]}x{t[1]}')
@pytest.mark.parametrize('case', list(BIN_CASES))
def test_splat_of_binned_cells_equals_plain(case, tile):
    """Each tile splatted from its own binned cells alone gives the plain
    splat of all cells (within 1e-6: only the einsum's order differs)."""
    make, out_hw, y_off, clip = BIN_CASES[case]
    inputs = make()
    kw = dict(out_hw=out_hw, spacing=2.0, truncate=1.0, y_offset_px=y_off)
    binned = unpack(cif_hr.tile_bins_plain(*inputs, tile=tile, **kw),
                    inputs[0].shape[2])
    want = cif_hr.accumulate_plain(*inputs, clip=clip, **kw)
    got = torch.full_like(want, float('nan'))
    for t, (rows, cols) in enumerate(tile_slices(out_hw, tile)):
        v = torch.where(binned[:, :, t], inputs[0], 0.0)
        got[..., rows, cols] = cif_hr.accumulate_plain(
            v, *inputs[1:], clip=clip, **kw)[..., rows, cols]
    assert want.max() > (1.0 if not clip else 0.01)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def test_tile_bins_bit_layout():
    """Bit ``c % 32`` of word ``c // 32``, tiles row-major; bit 31 reads as
    a negative int32."""
    n = 40
    v, x, y, sigma = (torch.zeros(1, 1, n) for _ in range(4))
    sigma += 2.0
    # cells 0 and 31 in tile (0, 0), cell 33 in tile (1, 1) of 2 x 2
    v[0, 0, [0, 31, 33]] = 0.5
    x[0, 0, 33], y[0, 0, 33] = 200.0, 100.0
    masks = cif_hr.tile_bins_plain(v, x, y, sigma, out_hw=(64, 128),
                                   spacing=2.0, truncate=1.0, tile=(32, 64))
    want = torch.zeros(1, 1, 4, 2, dtype=torch.int32)
    want[0, 0, 0, 0] = 1 - 2 ** 31            # bits 0 and 31
    want[0, 0, 3, 1] = 2                      # cell 33: word 1, bit 1
    assert torch.equal(masks, want)


@pytest.mark.parametrize('seed', [0, 1])
def test_plain_matches_pallas_kernel(seed):
    """The port's plain splat against the TPU kernel itself
    (``accumulate_pallas``, interpreted), atol 2e-5 as
    ``test_pallas_ops.py`` holds the kernel to the einsum path."""
    from openpifpaf_tpu.ops.pallas_cif_hr import accumulate_pallas

    conf, x_px, y_px, scale_px = synthetic_inputs(seed)
    v, x, y, sigma = cells(conf, x_px, y_px, scale_px)
    out_hw = out_hw_for(conf)
    want = np.asarray(accumulate_pallas(
        *(jnp.asarray(t[0].numpy()) for t in (v, x, y, sigma)),
        out_hw=out_hw, spacing=2.0, truncate=1.0, interpret=True))
    got = cif_hr.accumulate_plain(v, x, y, sigma, out_hw=out_hw,
                                  spacing=2.0, truncate=1.0)[0].numpy()
    assert got.shape == want.shape == (5, 65, 65) and want.max() > 0.1
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_kernel_wrappers_refuse_bad_operands():
    v = torch.zeros(1, 2, 8)
    before = (cif_hr.KERNEL_LAUNCHES, cif_hr.CUDA_LAUNCHES)
    kw = dict(out_hw=(4, 4), spacing=2.0, truncate=1.0)
    with pytest.raises(ValueError, match='CUDA tensor'):
        cif_hr.cif_hr_tile_bins(v, v, v, v, **kw)
    meta = torch.zeros(1, 2, 8, device='meta')
    with pytest.raises(ValueError, match='CUDA tensor'):
        cif_hr.cif_hr_accumulate(meta, meta, meta, meta, **kw)
    assert (cif_hr.KERNEL_LAUNCHES, cif_hr.CUDA_LAUNCHES) == before


def test_tile_matches_kernel_source():
    """``TILE``, the tile of ``tile_bins_plain`` and the mask scratch, is
    the TH x TW that ``csrc/cif_hr.cu`` is compiled with."""
    src = (pathlib.Path(cif_hr.__file__).parent.parent / 'csrc'
           / 'cif_hr.cu').read_text()
    found = tuple(int(re.search(rf'constexpr int {n} = (\d+);', src)[1])
                  for n in ('TH', 'TW'))
    assert found == cif_hr.TILE


# ------------------------------------------ K1 as a registered operator
OP = torch.ops.openpifpaf_tpu_torch.cif_hr_accumulate.default


def op_cells(b=2):
    """(v, x, y, sigma), each (B, F, N) float32, as ``accumulate`` hands
    them to the operator: ``synthetic_inputs`` of seeds 0.. (F = 5, 9 x 9
    cells), masked and scaled by the default configuration."""
    config = cif_hr.CifHrConfig()
    conf, x_px, y_px, scale_px = (np.stack(a) for a in zip(
        *(synthetic_inputs(seed) for seed in range(b))))
    v = np.where(conf > config.v_threshold, conf * config.neighbor_factor, 0)
    sigma = np.maximum(config.sigma_factor * scale_px, config.min_sigma_px)
    return tuple(torch.from_numpy(a.reshape(b, 5, -1).astype(np.float32))
                 for a in (v, x_px, y_px, sigma))


@pytest.mark.parametrize('clip, y_offset_px', [(True, 0.0), (False, 0.0),
                                                (True, 24.0)])
def test_operator_opcheck(clip, y_offset_px):
    torch.library.opcheck(OP, (*op_cells(), [33, 65], 2.0, 1.0, y_offset_px,
                               clip, True))


@pytest.mark.parametrize('profile_bf16', [True, False])
def test_operator_cpu_kernel_equals_plain(profile_bf16):
    """The operator's CPU implementation is ``accumulate_plain`` (bit for
    bit, no launch counted), and ``accumulate`` reaches it.  The schema
    carries ``profile_bf16`` for this implementation: the CUDA one (the
    kernel, ``_launch``) computes f32 profiles whatever it says, so on the
    card the decode has ``profile_bf16=False`` semantics; there
    ``chip_smoke.py`` holds it to ``accumulate_plain`` with f32
    profiles."""
    cells = op_cells()
    before = (cif_hr.KERNEL_LAUNCHES, cif_hr.CUDA_LAUNCHES)
    for clip, y_offset_px in ((True, 0.0), (False, 24.0)):
        got = OP(*cells, [33, 65], 2.0, 1.0, y_offset_px, clip, profile_bf16)
        want = cif_hr.accumulate_plain(
            *cells, out_hw=(33, 65), spacing=2.0, truncate=1.0,
            y_offset_px=y_offset_px, clip=clip, profile_bf16=profile_bf16)
        assert got.dtype == torch.float32 and torch.equal(got, want)
    conf, x_px, y_px, scale_px = (torch.from_numpy(a)
                                  for a in synthetic_inputs(0))
    config = cif_hr.CifHrConfig(profile_bf16=profile_bf16, max_active=0)
    got = cif_hr.accumulate(conf, x_px, y_px, scale_px, out_hw=(65, 65),
                            config=config)
    want = OP(*(t[:1] for t in op_cells()), [65, 65], 2.0, 1.0, 0.0, True,
              profile_bf16)[0]
    assert torch.equal(got, want)
    assert (cif_hr.KERNEL_LAUNCHES, cif_hr.CUDA_LAUNCHES) == before
    with pytest.raises(ValueError, match='CUDA tensor'):
        cif_hr._launch(*cells, [33, 65], 2.0, 1.0, 0.0, True, profile_bf16)


def test_operator_fake_shape():
    """The fake implementation: (B, F, Hh, Wh) float32 without computing,
    on fake tensors (as ``torch.export`` traces) and on the meta device."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cells = op_cells(b=3)
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(t) for t in cells]
        out = OP(*fake, [17, 40], 2.0, 1.0, 8.0, False, True)
    assert tuple(out.shape) == (3, 5, 17, 40) and out.dtype == torch.float32
    meta = OP(*(t.to('meta') for t in cells), [17, 40], 2.0, 1.0, 0.0, True,
              False)
    assert meta.device.type == 'meta' and tuple(meta.shape) == (3, 5, 17, 40)
