"""Read and write the JAX package's checkpoint format with numpy.

Port of ``openpifpaf_tpu/models/checkpoint.py`` (``:30-98``): a checkpoint
is a flat ``.npz`` of ``collection/path/to/leaf`` arrays (``params/...``,
``batch_stats/...``; the trainer's resume copy adds ``ema/...``) plus a
``__meta__`` entry that holds a UTF-8 JSON header (basenet name, base
stride, epoch, head metas, ``extra``).  ``models/from_jax.py`` maps such
keys to and from the port's ``state_dict``.  Loading runs no migration, as
the JAX package's ``load`` runs none; ``migrate.py`` upgrades old files.
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
    'CifDet': headmeta_mod.CifDet,
    'Tcaf': headmeta_mod.Tcaf,
}


def headmeta_to_json(meta: headmeta_mod.Base) -> dict:
    d = dataclasses.asdict(meta)
    d = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
         for k, v in d.items()}
    d['__type__'] = type(meta).__name__
    return d


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


def save(path: str, *, variables: Dict[str, np.ndarray], head_metas,
         basenet_name: str, base_stride: int, epoch: int = 0,
         extra_meta: dict = None) -> None:
    """``variables``: flat ``collection/.../leaf`` arrays (as
    ``from_jax.to_jax_variables`` gives them); ``extra_meta`` goes into the
    header's ``extra`` (the migrate CLI's ``converted_from``)."""
    header = {
        'format_version': 1,
        'basenet': basenet_name,
        'base_stride': base_stride,
        'epoch': epoch,
        'head_metas': [headmeta_to_json(m) for m in head_metas],
        'extra': extra_meta or {},
    }
    flat = dict(variables)
    flat['__meta__'] = np.frombuffer(
        json.dumps(header).encode('utf-8'), dtype=np.uint8).copy()
    np.savez(path, **flat)


def load(path: str) -> Tuple[dict, Dict[str, np.ndarray]]:
    """Returns (header, flat variables keyed ``collection/.../leaf``)."""
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    header = json.loads(bytes(flat.pop('__meta__')).decode('utf-8'))
    header['head_metas'] = [headmeta_from_json(m)
                            for m in header['head_metas']]
    return header, flat
