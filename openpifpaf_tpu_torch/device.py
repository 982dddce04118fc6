"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: raise when CUDA is unavailable.

    There is no silent fallback to the CPU — a caller that wants the CPU
    (the tests) passes ``device='cpu'``.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'CUDA is not available; pass device="cpu" to run the '
                'plain PyTorch versions on the CPU')
        return torch.device('cuda')
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'device {device} requested but CUDA is not '
                           'available')
    return device
