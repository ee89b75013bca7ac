"""Where the port runs: a CUDA device by default, the CPU on request, and
never a silent fallback from one to the other."""
from __future__ import annotations

from typing import Any

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Any) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a GPU
    raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' was requested but no CUDA device "
                           "is available; pass device='cpu' to run the "
                           "plain-torch path")
    return dev
