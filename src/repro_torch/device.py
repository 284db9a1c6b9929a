"""Device resolution for the port's entry points that create tensors."""
from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when a CUDA device is asked
    for and none is present -- the port never falls back to the CPU unless
    the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev
