"""Parameter initializers shared by the port's conv models."""
from __future__ import annotations

import math
from typing import Any

import torch

__all__ = ["normal", "zeros", "ones", "width"]


def normal(gen: torch.Generator, shape, device: Any) -> torch.Tensor:
    """Truncated normal on [-2, 2] scaled by 1/sqrt(shape[0]) — the JAX
    package's ``TreeMaker.param`` init (other random bits, same law).  On
    the ``meta`` device only the shape is made."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, device="meta")
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * (1.0 / math.sqrt(shape[0]))).to(device)


def zeros(n: int, device: Any) -> torch.Tensor:
    return torch.zeros((n,), dtype=torch.float32, device=device)


def ones(n: int, device: Any) -> torch.Tensor:
    return torch.ones((n,), dtype=torch.float32, device=device)


def width(c: int, mult: float) -> int:
    """A channel count scaled by ``width_mult`` (at least 1)."""
    return max(int(c * mult), 1)
