"""Carry the JAX package's flax variables over to the port's modules.

The mapping part of ``openpifpaf_tpu/models/converter.py``, in the other
direction: flax variables flattened with ``/`` keys (exactly as
``openpifpaf_tpu/models/checkpoint.flatten_tree`` writes them into an npz)
become a ``state_dict`` that the port's ``Shell`` loads with
``strict=True``.  The port's submodules carry the flax module names, so a
path maps by replacing ``/`` with ``.``:

- ``params/basenet/<path>/kernel`` -> ``basenet.<path>.weight``; conv
  kernels HWIO -> OIHW, which also takes a depthwise ``(kh, kw, 1, C)``
  kernel to ``(C, 1, kh, kw)``
- ``params/basenet/<path>/{scale,bias}`` -> ``.weight`` / ``.bias`` (BN)
- ``batch_stats/basenet/<path>/{mean,var}`` -> ``.running_mean`` /
  ``.running_var`` (plus ``num_batches_tracked``)
- ``params/head_nets_<i>/conv/{kernel,bias}`` -> ``head_nets.<i>.conv.*``

Like ``converter.py:342-348`` it raises on any key it cannot map.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_BASENET = re.compile(
    r'^(params|batch_stats)/basenet/((?:\w+/)*\w+)/(kernel|scale|bias|mean|var)$')
_HEAD = re.compile(r'^params/head_nets_(\d+)/conv/(kernel|bias)$')
_LEAF = {('params', 'kernel'): 'weight', ('params', 'scale'): 'weight',
         ('params', 'bias'): 'bias', ('batch_stats', 'mean'): 'running_mean',
         ('batch_stats', 'var'): 'running_var'}


def _kernel_to_torch(value: np.ndarray) -> np.ndarray:
    """HWIO -> OIHW."""
    return np.ascontiguousarray(np.transpose(value, (3, 2, 0, 1)))


def from_jax_variables(flat: Mapping[str, np.ndarray]
                       ) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    unmapped = []
    for key, value in flat.items():
        value = np.asarray(value, np.float32)
        m = _BASENET.match(key)
        if m and (m.group(1), m.group(3)) in _LEAF:
            coll, path, leaf = m.groups()
            module = 'basenet.' + path.replace('/', '.')
            if leaf == 'kernel':
                if value.ndim != 4:
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
