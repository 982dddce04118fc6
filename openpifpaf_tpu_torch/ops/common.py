"""Shared decoder primitives: grid lookups, masked top-k, batched loops.

Port of ``openpifpaf_tpu/ops/common.py``.  The JAX decode is single-image
and ``vmap``-batched; here every op carries the batch axis B in front of
the JAX layout.  Coordinates are in image pixels.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

# Host synchronizations of the decode: each iteration of a fixpoint loop
# reads its convergence flag back to the host (``while_loop`` below).
HOST_SYNCS = 0


def while_loop(cond: Callable, body: Callable, state: Tuple[torch.Tensor, ...],
               active: torch.Tensor = None) -> Tuple[torch.Tensor, ...]:
    """``jax.vmap(jax.lax.while_loop)`` with the batch written out.

    Every state tensor has the batch axis in front; ``cond(state)`` gives a
    (B,) bool.  The loop runs while any image's condition holds, and an
    image whose condition is false is held fixed while the others go on —
    what ``vmap`` of a ``while_loop`` does.  ``body(state, running)`` gets
    the (B,) mask of images still iterating, so nested loops can stop early
    for images whose result will be discarded.  ``active`` (B,) optionally
    restricts the loop to a subset of images (an enclosing loop's mask).
    Each iteration costs one host sync to read the flag (``HOST_SYNCS``).
    """
    global HOST_SYNCS
    while True:
        running = cond(state)
        if active is not None:
            running = running & active
        HOST_SYNCS += 1
        if not bool(running.any()):
            return state
        new = body(state, running)
        state = tuple(_where_batch(running, n, o) for n, o in zip(new, state))


def _where_batch(mask: torch.Tensor, new: torch.Tensor,
                 old: torch.Tensor) -> torch.Tensor:
    return torch.where(mask.view(-1, *([1] * (new.dim() - 1))), new, old)


def gather_field(grids: torch.Tensor, f: torch.Tensor, x: torch.Tensor,
                 y: torch.Tensor, spacing: float = 1.0) -> torch.Tensor:
    """Bilinear lookup with a per-point field index (4-corner gather).

    grids: (B, F, Hg, Wg); f, x, y: (B, ...) broadcast-compatible -> (B, ...).
    Out-of-bounds coordinates are clamped to the grid (the JAX version's
    clipped reads).
    """
    b, nf, hg, wg = grids.shape
    gx = torch.clamp(x / spacing, 0.0, wg - 1.0)
    gy = torch.clamp(y / spacing, 0.0, hg - 1.0)
    x0f = torch.floor(gx)
    y0f = torch.floor(gy)
    fx = gx - x0f
    fy = gy - y0f
    x0 = x0f.long()
    y0 = y0f.long()
    x1 = torch.clamp(x0 + 1, max=wg - 1)
    y1 = torch.clamp(y0 + 1, max=hg - 1)
    bi = torch.arange(b, device=grids.device).view(b, *([1] * (x.dim() - 1)))
    base = (bi * nf + f.long()) * hg
    flat = grids.reshape(-1)

    def at(yy, xx):
        return flat[(base + yy) * wg + xx]

    return ((1 - fy) * ((1 - fx) * at(y0, x0) + fx * at(y0, x1))
            + fy * ((1 - fx) * at(y1, x0) + fx * at(y1, x1)))


def gather_field_grouped(grids: torch.Tensor, group_field: torch.Tensor,
                         x: torch.Tensor, y: torch.Tensor,
                         spacing: float = 1.0) -> torch.Tensor:
    """Bilinear lookup where every point of group ``g`` reads field
    ``group_field[g]``.

    grids: (B, F, Hg, Wg); group_field: (G,) int; x, y: (B, G, ...) -> same
    shape.  The 4-corner gather, as the JAX package runs it off the TPU
    (``common.py:141-146``); its MXU form is a TPU execution plan.
    """
    fb = group_field.view(1, -1, *([1] * (x.dim() - 2)))
    return gather_field(grids, fb, x, y, spacing)


def masked_top_k(values: torch.Tensor, mask: torch.Tensor, k: int):
    """Top-k of ``values`` where ``mask``, over the last axis.

    Returns (values_k, indices_k, valid_k); invalid slots have the most
    negative f32.  Ties keep the lower index first, as ``jax.lax.top_k``
    does: a stable descending sort (``torch.topk`` promises no tie order).
    Requests larger than the axis are padded so output shapes stay fixed.
    """
    neg = torch.finfo(torch.float32).min
    # a Python scalar, not a tensor made on the device: that would be a
    # synchronous host-to-device copy
    masked = torch.where(mask, values.float(), neg)
    n = masked.shape[-1]
    vals, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :min(k, n)], idx[..., :min(k, n)]
    if k > n:
        pad = (0, k - n)
        vals = torch.nn.functional.pad(vals, pad, value=neg)
        idx = torch.nn.functional.pad(idx, pad, value=0)
    return vals, idx, vals > neg * 0.5
