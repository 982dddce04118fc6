"""Read the JAX package's checkpoint format with numpy.

Port of the reading half of ``openpifpaf_tpu/models/checkpoint.py``
(``:30-98``): a checkpoint is a flat ``.npz`` of ``collection/path/to/leaf``
arrays (``params/...``, ``batch_stats/...``) plus a ``__meta__`` entry that
holds a UTF-8 JSON header (basenet name, base stride, epoch, head metas).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Tuple

import numpy as np

from .. import headmeta as headmeta_mod

_HEADMETA_TYPES = {
    'Cif': headmeta_mod.Cif,
    'Caf': headmeta_mod.Caf,
}


def headmeta_from_json(d: dict) -> headmeta_mod.Base:
    d = dict(d)
    kind = d.pop('__type__')
    if kind not in _HEADMETA_TYPES:
        raise NotImplementedError(f'head meta type {kind} is not ported yet')
    cls = _HEADMETA_TYPES[kind]
    field_names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {k: v for k, v in d.items() if k in field_names}
    if kwargs.get('pose') is not None:
        kwargs['pose'] = np.asarray(kwargs['pose'], dtype=np.float32)
    meta = cls(**kwargs)
    meta.upsample_stride = d.get('upsample_stride', 1)
    meta.head_index = d.get('head_index')
    meta.base_stride = d.get('base_stride')
    return meta


def load(path: str) -> Tuple[dict, Dict[str, np.ndarray]]:
    """Returns (header, flat variables keyed ``collection/.../leaf``)."""
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    header = json.loads(bytes(flat.pop('__meta__')).decode('utf-8'))
    header['head_metas'] = [headmeta_from_json(m)
                            for m in header['head_metas']]
    return header, flat
