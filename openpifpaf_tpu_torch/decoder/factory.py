"""Decoder factory.

Port of the predict-path subset of ``openpifpaf_tpu/decoder/factory.py``:
the decoder is matched against the model's head metas.  The port has the
CifCaf decoder only.
"""

from __future__ import annotations

from .cifcaf import CifCaf
from .decoder import Decoder

DECODERS = (CifCaf,)


def factory(head_metas, *, device=None) -> Decoder:
    decoders = [d for cls in DECODERS
                for d in cls.factory(head_metas, device=device)]
    if len(decoders) != 1:
        raise ValueError(f'expected one decoder for head metas '
                         f'{[type(m).__name__ for m in head_metas]}, found '
                         f'{len(decoders)}')
    return decoders[0]
