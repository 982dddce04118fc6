"""Shared decoder primitives: grid lookups, masked top-k, batched loops.

Port of ``openpifpaf_tpu/ops/common.py``.  The JAX decode is single-image
and ``vmap``-batched; here every op carries the batch axis B in front of
the JAX layout.  Coordinates are in image pixels.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from .. import debug_checks

# Host synchronizations of the decode: each iteration of a fixpoint loop
# reads its convergence flag back to the host (``while_loop`` below), and
# each array a debug view reads back (``read_back``).
HOST_SYNCS = 0


def read_back(tensor: torch.Tensor) -> np.ndarray:
    """``tensor`` as a numpy array on the host: one host sync, counted."""
    global HOST_SYNCS
    HOST_SYNCS += 1
    return tensor.cpu().numpy()


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

    Under ``torch.export`` the same loop is recorded as the higher-order
    operator ``torch._higher_order_ops.while_loop`` (``jax.lax.while_loop``'s
    counterpart), the mask carried in front of the state: its condition is
    ``running.any()``, its body ``step`` below, so the traced and the host
    loop compute the same iterations.  ``cond`` and ``body`` must then be
    traceable: outputs of the state's shapes, dtypes and devices, no
    Python branch on a tensor, writes only to tensors they created.
    """
    global HOST_SYNCS

    def running_of(state):
        running = cond(state)
        return running if active is None else running & active

    def step(running, state):
        new = body(state, running)
        return tuple(_where_batch(running, n, o) for n, o in zip(new, state))

    if torch.compiler.is_exporting():
        def hop_body(running, *state):
            state = step(running, state)
            return (running_of(state), *state)

        out = torch._higher_order_ops.while_loop(
            lambda running, *_: running.any(), hop_body,
            (running_of(state), *state))
        return tuple(out[1:])
    while True:
        running = running_of(state)
        HOST_SYNCS += 1
        if not bool(running.any()):
            return state
        state = step(running, state)


def _where_batch(mask: torch.Tensor, new: torch.Tensor,
                 old: torch.Tensor) -> torch.Tensor:
    return torch.where(mask.view(-1, *([1] * (new.dim() - 1))), new, old)


def gather_field(grids: torch.Tensor, f: torch.Tensor, x: torch.Tensor,
                 y: torch.Tensor, spacing: float = 1.0) -> torch.Tensor:
    """Bilinear lookup with a per-point field index (4-corner gather).

    grids: (B, F, Hg, Wg); f, x, y: (B, ...) broadcast-compatible -> (B, ...).
    Out-of-bounds coordinates are clamped to the grid (the JAX version's
    clipped reads).  Under ``--debug-checks`` non-finite coordinates and
    field indices outside [0, F) raise.
    """
    b, nf, hg, wg = grids.shape
    # a NaN coordinate reads a NaN value; raise under --debug-checks
    debug_checks.check_finite(x, 'gather_field: non-finite x')
    debug_checks.check_finite(y, 'gather_field: non-finite y')
    if debug_checks.enabled():
        debug_checks.check((f >= 0) & (f < nf),
                           'gather_field: field index out of bounds')
    gx = torch.clamp(x / spacing, 0.0, wg - 1.0)
    gy = torch.clamp(y / spacing, 0.0, hg - 1.0)
    x0f = torch.floor(gx)
    y0f = torch.floor(gy)
    fx = gx - x0f
    fy = gy - y0f
    # a NaN coordinate survives the clamp above; its index is clamped here,
    # as JAX clamps out-of-bounds gather indices (the value stays NaN)
    x0 = torch.clamp(x0f.long(), 0, wg - 1)
    y0 = torch.clamp(y0f.long(), 0, hg - 1)
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
