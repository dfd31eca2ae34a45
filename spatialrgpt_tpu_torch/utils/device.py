"""Where the port's entry points run: on the card unless the caller asks
for another device."""

from __future__ import annotations

import torch


def card_device(device, what: str) -> torch.device:
    """``device`` when given; else the card, and without one an error that
    names ``what`` (the CPU only when the caller asks for it)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what}: the default device is a CUDA card and none is available; pass device='cpu' to "
                           "run on the CPU")
    return torch.device("cuda")
