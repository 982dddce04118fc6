"""Decoder base: batched field decoding.

Port of ``openpifpaf_tpu/decoder/decoder.py``.  Reference parity:
``src/openpifpaf/decoder/decoder.py``.  Fields stay on the device they were
computed on; the decode result crosses to the host once per batch.
"""

from __future__ import annotations

import argparse
from typing import List


class Decoder:
    """Base class for field decoders."""

    profile = None  # output file for a cProfile of decode (--profile-decoder)
    # the CPU decode's CifHr profiles: bf16-rounded as in the JAX package,
    # or f32 as the card's kernel computes them (--cifhr-f32-profiles)
    f32_profiles = False

    def profile_bf16(self, device) -> bool:
        """Whether the CifHr profiles of a decode on ``device`` round to
        bf16: on the CPU unless ``f32_profiles``; never on the card."""
        return device.type == 'cpu' and not self.f32_profiles

    @classmethod
    def cli(cls, parser: argparse.ArgumentParser) -> None:
        """Add decoder CLI options."""

    @classmethod
    def configure(cls, args: argparse.Namespace) -> None:
        """Apply parsed CLI options."""

    @classmethod
    def match(cls, head_metas) -> bool:
        """Can this decoder decode the given head metas?"""
        raise NotImplementedError

    def __call__(self, fields) -> List:
        """Decode a single image's fields into annotations."""
        raise NotImplementedError

    def batch_fields(self, fields, metas=None) -> List[List]:
        """Decode batched field tensors (list of (B, F, C, H, W))."""
        raise NotImplementedError
