"""Parameter initializers shared by the port's models: the conv models'
``normal``/``zeros``/``ones``/``width``, and for the LM side the
mixed-precision ``DTypePolicy`` and the ``init``-mode ``TreeMaker`` (the
JAX package's ``models/common.py``; its ``abstract`` and ``axes`` modes
come with the dry-run and mesh slice)."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence

import torch

__all__ = ["normal", "zeros", "ones", "width", "cast", "DTypePolicy",
           "TreeMaker"]


def _trunc_normal(gen: torch.Generator, shape) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], fp32, on the generator's
    device."""
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t


def normal(gen: torch.Generator, shape, device: Any) -> torch.Tensor:
    """Truncated normal on [-2, 2] scaled by 1/sqrt(shape[0]) — the JAX
    package's ``TreeMaker.param`` init (other random bits, same law).  On
    the ``meta`` device only the shape is made."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, device="meta")
    return (_trunc_normal(gen, shape) * (1.0 / math.sqrt(shape[0]))).to(device)


def zeros(n: int, device: Any) -> torch.Tensor:
    return torch.zeros((n,), dtype=torch.float32, device=device)


def ones(n: int, device: Any) -> torch.Tensor:
    return torch.ones((n,), dtype=torch.float32, device=device)


def cast(tree: Any, dtype: torch.dtype) -> Any:
    """A nested dict of tensors with every tensor in ``dtype`` (the conv
    models' ``init_params(dtype=)``: drawn in fp32, then rounded once)."""
    if isinstance(tree, dict):
        return {k: cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def width(c: int, mult: float) -> int:
    """A channel count scaled by ``width_mult`` (at least 1)."""
    return max(int(c * mult), 1)


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    """Mixed-precision policy, the JAX package's: bf16 parameters and
    compute, fp32 reductions (norms, softmax, the loss, the SSD sums) and
    fp32 optimizer master copy and moments (``optim/adamw.py``, fp32 as
    in the JAX package).  Activations follow the parameters."""
    param: torch.dtype = torch.bfloat16
    compute: torch.dtype = torch.bfloat16
    accum: torch.dtype = torch.float32
    master: torch.dtype = torch.float32

    @classmethod
    def fp32(cls) -> "DTypePolicy":
        return cls(param=torch.float32, compute=torch.float32)


class TreeMaker:
    """Declare-once parameter trees, ``init`` mode: each ``param`` call
    draws one leaf from ``gen`` (on the generator's device) and puts it on
    ``device`` in the policy's parameter type."""

    def __init__(self, gen: torch.Generator, device: Any = "cuda",
                 dtype_policy: Optional[DTypePolicy] = None):
        self.gen = gen
        self.device = torch.device(device)
        self.dp = dtype_policy or DTypePolicy()

    def _uniform(self, shape, lo: float, hi: float) -> torch.Tensor:
        t = torch.empty(shape, dtype=torch.float32, device=self.gen.device)
        return t.uniform_(lo, hi, generator=self.gen)

    def param(self, shape: Sequence[int], init: str = "normal",
              scale: Optional[float] = None,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Declare one parameter.

        init: "normal" (trunc-normal, fan-in scaled unless ``scale``),
              "zeros", "ones", "ssm_a" (mamba A_log), "ssm_dt" (dt bias).
        """
        shape = tuple(int(s) for s in shape)
        dtype = dtype or self.dp.param
        if init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=self.device)
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device=self.device)
        if init == "ssm_a":    # A_log ~ log(uniform[1, 16]) (mamba2 default)
            x = torch.log(self._uniform(shape, 1.0, 16.0))
        elif init == "ssm_dt":  # dt bias = softplus^-1(uniform[1e-3, 1e-1])
            x = torch.log(torch.expm1(self._uniform(shape, 1e-3, 1e-1)))
        elif init == "normal":
            if scale is None:
                fan_in = shape[0] if len(shape) >= 2 else max(shape[-1], 1)
                scale = 1.0 / math.sqrt(fan_in)
            x = _trunc_normal(self.gen, shape) * scale
        else:
            raise ValueError(f"unknown init {init!r}")
        return x.to(device=self.device, dtype=dtype)
