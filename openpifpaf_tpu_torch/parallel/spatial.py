"""Spatially banded CifHr and seeds over a process group.

Port of ``openpifpaf_tpu/parallel/spatial.py``.  For an image whose hires
maps outgrow one card, the CifHr accumulation is cut into bands of rows,
one per rank of a group:

- every rank holds the whole image's CIF fields (small) and takes its band
  of field rows; its band of hires rows is all of the map it ever holds;
- each rank splats its band's cells into its hires band widened by
  ``halo_px`` on both sides, with the port's ``cif_hr.accumulate``
  (``y_offset_px``, ``clip=False``; on the card that is one call of K1,
  ``cif_hr_accumulate``, per band);
- the two halo strips go to the neighbouring bands through ``all_gather``
  (JAX's ``ppermute`` between neighbours; the port uses collectives that
  NCCL and gloo both carry) and are summed in; the clip follows the sum;
- an ``all_reduce`` sums the overflow counter: the active cells whose
  blob reaches past the halo (their mass there is lost; enlarge
  ``halo_px`` if it is not 0).

``sharded_seeds`` blends each band's cells with its CifHr band widened by
the neighbours' strips, exchanges one-row strips for the 3x3 local maximum,
keeps each band's top ``max_seeds`` and merges them with an
``all_gather`` and a global top-k.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import mesh
from ..ops import cif_hr, seeds as seeds_mod
from ..ops.common import gather_field_grouped, masked_top_k


class ShardedCifHr(NamedTuple):
    hr: torch.Tensor              # (F, Hh / n, Wh): this rank's band, clipped
    halo_overflow: torch.Tensor   # () int32 over the group


@dataclasses.dataclass(frozen=True)
class SpatialConfig:
    halo_px: float = 64.0  # one-sided halo, px; must cover offset + reach


def _band_rows(h: int, hh: int, n: int, halo_px: float, spacing: float):
    """(field rows per band, hires rows per band, halo in hires rows), or
    the JAX version's errors."""
    if h % n or hh % n:
        raise ValueError(f'field rows {h} and hires rows {hh} must divide '
                         f'into {n} bands')
    hhb = hh // n
    halo_rows = int(round(halo_px / spacing))
    if halo_rows > hhb:
        raise ValueError(f'halo of {halo_rows} hires rows exceeds the band '
                         f'height {hhb}; use fewer ranks or a smaller '
                         'halo_px')
    return h // n, hhb, halo_rows


def _neighbours(strips: torch.Tensor, band: int, n: int, group):
    """Each rank's ``(2, ...)`` strips (for the band above, for the band
    below) gathered; returns (what the band above sent down, what the band
    below sent up), ``None`` at the image's edges."""
    got = mesh.all_gather(strips[None], group)
    return (got[band - 1, 1] if band > 0 else None,
            got[band + 1, 0] if band < n - 1 else None)


def sharded_cif_hr(conf: torch.Tensor, x_px: torch.Tensor,
                   y_px: torch.Tensor, scale_px: torch.Tensor, *, out_hw,
                   config: cif_hr.CifHrConfig,
                   spatial: SpatialConfig = SpatialConfig(),
                   group=None) -> ShardedCifHr:
    """This rank's band of ``cif_hr.accumulate``'s map.

    :param conf, x_px, y_px, scale_px: (F, H, W) of the whole image, on
        every rank; H and ``out_hw[0]`` must divide by the group's size
    :returns: the band of rows ``rank * Hh / n`` on, equal to the dense
        single-card map (``max_active=0``: a band never compacts) wherever
        the blobs stay within ``halo_px``, and the overflow counter
    """
    hh, wh = out_hw
    n, band = mesh.world(group), mesh.rank(group)
    hb, hhb, halo_rows = _band_rows(conf.shape[1], hh, n, spatial.halo_px,
                                    config.spacing)
    conf, x_px, y_px, scale_px = (t[:, band * hb:(band + 1) * hb]
                                  for t in (conf, x_px, y_px, scale_px))
    spacing = float(config.spacing)
    y0_px = (band * hhb - halo_rows) * spacing
    local = cif_hr.accumulate(
        conf, x_px, y_px, scale_px, out_hw=(hhb + 2 * halo_rows, wh),
        config=dataclasses.replace(config, max_active=0),
        y_offset_px=y0_px, clip=False)
    mid = local[:, halo_rows:halo_rows + hhb]
    if n > 1 and halo_rows > 0:
        from_above, from_below = _neighbours(
            torch.stack([local[:, :halo_rows], local[:, halo_rows + hhb:]]),
            band, n, group)
        mid = mid.clone()
        if from_below is not None:
            mid[:, hhb - halo_rows:] += from_below
        if from_above is not None:
            mid[:, :halo_rows] += from_above

    # active cells whose blob rows leave the widened band; rows beyond the
    # image (above band 0, below the last) do not exist, so no mass is
    # lost there
    active = conf > config.v_threshold
    sigma = torch.clamp(config.sigma_factor * scale_px,
                        min=config.min_sigma_px)
    reach = config.truncate * sigma
    band_hi_px = (band * hhb + hhb + halo_rows - 1) * spacing
    escaped = active & (((y_px - reach < y0_px - spacing) & (band > 0))
                        | ((y_px + reach > band_hi_px + spacing)
                           & (band < n - 1)))
    overflow = mesh.all_reduce(escaped.sum().to(torch.int32).reshape(1),
                               group)[0]
    return ShardedCifHr(hr=torch.clamp(mid, 0.0, 1.0),
                        halo_overflow=overflow)


def sharded_seeds(conf: torch.Tensor, x_px: torch.Tensor, y_px: torch.Tensor,
                  scale_px: torch.Tensor, cifhr: torch.Tensor, *,
                  hr_spacing: float, config: seeds_mod.SeedsConfig,
                  spatial: SpatialConfig = SpatialConfig(),
                  group=None) -> seeds_mod.Seeds:
    """``seeds.select`` over banded fields: conf, x_px, y_px, scale_px are
    (F, H, W) of the whole image on every rank, ``cifhr`` this rank's
    (F, Hh / n, Wh) band (``sharded_cif_hr``'s).  Returns the (S,) seeds
    of the image on every rank, equal to ``seeds.select`` on the whole map
    wherever the regressed targets stay within the halo."""
    n, band = mesh.world(group), mesh.rank(group)
    f, h, w = conf.shape
    hb, hhb, halo_rows = _band_rows(h, cifhr.shape[1] * n, n,
                                    spatial.halo_px, hr_spacing)
    conf, x_px, y_px, scale_px = (t[:, band * hb:(band + 1) * hb]
                                  for t in (conf, x_px, y_px, scale_px))
    wh = cifhr.shape[2]

    zeros = cifhr.new_zeros((f, halo_rows, wh))
    if n > 1 and halo_rows > 0:
        from_above, from_below = _neighbours(
            torch.stack([cifhr[:, :halo_rows], cifhr[:, -halo_rows:]]),
            band, n, group)
        hr_ext = torch.cat([zeros if from_above is None else from_above,
                            cifhr,
                            zeros if from_below is None else from_below], 1)
    else:
        hr_ext = torch.cat([zeros, cifhr, zeros], 1)

    # the blended value at each cell's regressed target, the target's row
    # clamped to the rows that exist in the image
    y0_px = (band * hhb - halo_rows) * hr_spacing
    y_lo = halo_rows * hr_spacing if band == 0 else 0.0
    y_hi = ((halo_rows + hhb - 1) if band == n - 1
            else (hhb + 2 * halo_rows - 1)) * hr_spacing
    y_rel = torch.clamp(y_px - y0_px, y_lo, y_hi)
    fields = torch.arange(f, device=conf.device)
    hr_v = gather_field_grouped(hr_ext[None], fields, x_px[None],
                                y_rel[None], hr_spacing)[0]
    v = (config.cifhr_blend * hr_v
         + (1.0 - config.cifhr_blend) * conf) * config.score_scale
    mask = (v > config.threshold) & (conf > config.min_conf)

    if config.local_max:
        # the 3x3 window crosses the bands' edges: one-row strips, zeros
        # beyond the image as in the JAX version (v >= 0, so a zero row
        # never masks a seed)
        row = v.new_zeros((f, 1, w))
        if n > 1:
            above, below = _neighbours(torch.stack([v[:, :1], v[:, -1:]]),
                                       band, n, group)
            v_ext = torch.cat([row if above is None else above, v,
                               row if below is None else below], 1)
        else:
            v_ext = torch.cat([row, v, row], 1)
        vmax = F.max_pool2d(v_ext[None], 3, stride=1, padding=(0, 1))[0]
        mask = mask & (v >= vmax)

    vals, idx, _ = masked_top_k(v.reshape(-1), mask.reshape(-1),
                                config.max_seeds)
    cand = torch.stack([vals, (idx // (hb * w)).float(),
                        x_px.reshape(-1)[idx], y_px.reshape(-1)[idx],
                        scale_px.reshape(-1)[idx]])
    cand = mesh.all_gather(cand[None], group).transpose(0, 1) \
        .reshape(5, -1)
    # jax.lax.top_k: descending, ties in index order
    top_v, top_i = torch.sort(cand[0], descending=True, stable=True)
    top_v, top_i = top_v[:config.max_seeds], top_i[:config.max_seeds]
    valid = top_v > torch.finfo(torch.float32).min * 0.5
    return seeds_mod.Seeds(v=torch.where(valid, top_v, 0.0),
                           f=cand[1, top_i].long(), x=cand[2, top_i],
                           y=cand[3, top_i], s=cand[4, top_i], valid=valid)
