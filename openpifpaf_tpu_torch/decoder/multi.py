"""Several decoders on one model's fields.

Port of ``openpifpaf_tpu/decoder/multi.py``.  Reference parity:
``src/openpifpaf/decoder/multi.py:~10``: each decoder decodes its own
heads, and an image's annotations are the decoders' lists in their order
(the factory's: CifCaf, then CifDet).
"""

from __future__ import annotations

from typing import List

from .decoder import Decoder


class Multi(Decoder):
    def __init__(self, decoders: List[Decoder]):
        self.decoders = decoders

    def __call__(self, fields) -> List:
        return [ann for d in self.decoders for ann in d(fields)]

    def batch_fields(self, fields, metas=None) -> List[List]:
        per_decoder = [d.batch_fields(fields, metas=metas)
                       for d in self.decoders]
        return [[ann for dec_out in per_decoder for ann in dec_out[i]]
                for i in range(len(per_decoder[0]))]
