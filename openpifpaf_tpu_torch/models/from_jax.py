"""Carry the JAX package's flax variables over to the port's modules.

The mapping part of ``openpifpaf_tpu/models/converter.py``, in the other
direction: flax variables flattened with ``/`` keys (exactly as
``openpifpaf_tpu/models/checkpoint.flatten_tree`` writes them into an npz)
become a ``state_dict`` that the port's ``Shell`` loads with
``strict=True``.  The port's submodules carry the flax module names, so a
path maps by replacing ``/`` with ``.``:

- ``params/basenet/<path>/kernel`` -> ``basenet.<path>.weight``; conv
  kernels HWIO -> OIHW, which also takes a depthwise ``(kh, kw, 1, C)``
  kernel to ``(C, 1, kh, kw)``; Dense kernels ``(in, out)`` -> Linear
  ``(out, in)``
- ``params/basenet/<path>/{scale,bias}`` -> ``.weight`` / ``.bias``
  (BatchNorm, LayerNorm, GroupNorm; a conv's or a Dense's bias)
- ``params/basenet/<path>/<raw>`` -> ``basenet.<path>.<raw>`` unchanged,
  for the raw parameters of ``base.RAW_PARAMETERS`` (Swin's
  ``relative_position_bias_table``, BoTNet's ``rel_h``/``rel_w``, XCiT's
  ``temperature`` and ``gamma1..3``)
- ``batch_stats/basenet/<path>/{mean,var}`` -> ``.running_mean`` /
  ``.running_var`` (plus ``num_batches_tracked``)
- ``params/head_nets_<i>/conv/{kernel,bias}`` -> ``head_nets.<i>.conv.*``

Like ``converter.py:342-348`` it raises on any key it cannot map.
``to_jax_variables`` is the way back, for the checkpoints the port's
trainer writes: a port checkpoint loads into the JAX package.  It raises on
a key it cannot map too; only ``num_batches_tracked``, which flax does not
have, stays behind.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from .base import RAW_PARAMETERS

_BASENET = re.compile(
    r'^(params|batch_stats)/basenet/(?:((?:\w+/)*\w+)/)?(\w+)$')
_HEAD = re.compile(r'^params/head_nets_(\d+)/conv/(kernel|bias)$')
_LEAF = {('params', 'kernel'): 'weight', ('params', 'scale'): 'weight',
         ('params', 'bias'): 'bias', ('batch_stats', 'mean'): 'running_mean',
         ('batch_stats', 'var'): 'running_var'}
_LEAF.update({('params', raw): raw for raw in RAW_PARAMETERS})


def _kernel_to_torch(value: np.ndarray) -> np.ndarray:
    """Conv HWIO -> OIHW, Dense (in, out) -> (out, in)."""
    axes = (3, 2, 0, 1) if value.ndim == 4 else (1, 0)
    return np.ascontiguousarray(np.transpose(value, axes))


def from_jax_variables(flat: Mapping[str, np.ndarray]
                       ) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    unmapped = []
    for key, value in flat.items():
        value = np.array(value, np.float32)   # a writable copy
        m = _BASENET.match(key)
        if m and (m.group(1), m.group(3)) in _LEAF:
            coll, path, leaf = m.groups()
            module = '.'.join(['basenet'] + ([path.replace('/', '.')]
                                             if path else []))
            if leaf == 'kernel':
                if value.ndim not in (2, 4):
                    unmapped.append(key)
                    continue
                value = _kernel_to_torch(value)
            out[f'{module}.{_LEAF[coll, leaf]}'] = torch.from_numpy(value)
            if leaf == 'mean':
                out[f'{module}.num_batches_tracked'] = torch.tensor(0)
            continue
        m = _HEAD.match(key)
        if m:
            head_i, leaf = m.groups()
            if leaf == 'kernel':
                value = _kernel_to_torch(value)
            out[f'head_nets.{head_i}.conv.{"weight" if leaf == "kernel" else "bias"}'] = \
                torch.from_numpy(np.ascontiguousarray(value))
            continue
        unmapped.append(key)
    if unmapped:
        raise ValueError(f'{len(unmapped)} variables have no mapping onto the '
                         f'port\'s modules: {unmapped[:8]}')
    return out


_TO_LEAF = {'weight': ('params', 'scale'), 'bias': ('params', 'bias'),
            'running_mean': ('batch_stats', 'mean'),
            'running_var': ('batch_stats', 'var')}
_TO_LEAF.update({raw: ('params', raw) for raw in RAW_PARAMETERS})


def _kernel_to_jax(value: np.ndarray) -> np.ndarray:
    """Conv OIHW -> HWIO, Linear (out, in) -> (in, out)."""
    axes = (2, 3, 1, 0) if value.ndim == 4 else (1, 0)
    return np.ascontiguousarray(np.transpose(value, axes))


def to_jax_variables(state_dict: Mapping[str, torch.Tensor]
                     ) -> Dict[str, np.ndarray]:
    """A Shell's ``state_dict`` -> flat flax variables (``params/...``,
    ``batch_stats/...``), the keys ``from_jax_variables`` reads.  A
    ``weight`` of 4 dims (conv) or 2 (Linear) is a ``kernel``, of 1 dim a
    norm's ``scale``.  ``num_batches_tracked`` has no flax counterpart and
    is left out; any other key without a mapping raises."""
    out: Dict[str, np.ndarray] = {}
    for key, tensor in state_dict.items():
        value = tensor.detach().to('cpu', torch.float32).numpy()
        module, leaf = key.rsplit('.', 1)
        if leaf == 'num_batches_tracked':
            continue
        parts = module.split('.')
        if parts[0] == 'head_nets':
            path = f'head_nets_{parts[1]}/{"/".join(parts[2:])}'
        elif parts[0] == 'basenet':
            path = '/'.join(parts)
        else:
            raise ValueError(f'no flax mapping for {key}')
        if leaf == 'weight' and value.ndim in (2, 4):
            out[f'params/{path}/kernel'] = _kernel_to_jax(value)
            continue
        if leaf not in _TO_LEAF or (leaf == 'weight' and value.ndim != 1):
            raise ValueError(f'no flax mapping for {key}')
        coll, name = _TO_LEAF[leaf]
        out[f'{coll}/{path}/{name}'] = np.ascontiguousarray(value)
    return out
