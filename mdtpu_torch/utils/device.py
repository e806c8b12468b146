"""Device selection shared by every entry point of the package.

Entry points run on the card unless the caller names another device. A
request for the card on a machine without one raises: a run never carries
on quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``. Raises ``RuntimeError`` when a CUDA device
    is asked for (explicitly or by default) and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU with the kernels' plain PyTorch versions")
    return dev
