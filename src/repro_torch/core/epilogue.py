"""Fused epilogue descriptor for the fold-streamed conv kernels.

The kernels flush the per-layer epilogue — bias add, folded batch-norm
scale/shift, residual add, ReLU or ReLU6, and VGG's 2x2/2 max-pool — at
the moment the last depth fold finishes, so a whole conv block is one
kernel launch and the pre-activation tensor never reaches device memory.

``Epilogue`` is a frozen (hashable) dataclass so it can ride along in the
engine's kernel memo keys (``ScheduleCache.kernel_for``).
``apply_epilogue`` is the plain-torch oracle used by the non-kernel impls.
The descriptor keeps every field of the JAX package's so graphs and
fusion rules stay identical; the port's fp32 kernels flush all of them
(``kernels/conv2d_ws.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["Epilogue", "apply_epilogue", "epilogue_out_hw", "maxpool2x2",
           "FUSED_RELU", "FUSED_RELU_POOL", "FUSED_RESIDUAL_RELU",
           "FUSED_BN_RELU6"]


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """What the kernel does to a finished output fold at flush time.

    bias     — add a per-filter bias (the caller supplies the vector).
    scale    — per-filter affine ``y*scale + shift`` (a folded inference
               batch-norm), applied after bias, before the residual.
    residual — add a skip-connection tensor shaped like the conv output,
               after bias/scale, before ReLU.  Incompatible with ``pool``.
    relu     — clamp at zero.
    relu6    — clamp to [0, 6]; exclusive with ``relu``.
    pool     — ``"max2"`` fuses a 2x2/2 max-pool (windows never straddle
               fold boundaries: the P block is rounded to even).
    """
    bias: bool = False
    relu: bool = False
    pool: Optional[str] = None
    residual: bool = False
    scale: bool = False
    relu6: bool = False

    def __post_init__(self) -> None:
        conflicts = self.conflicts()
        if conflicts:
            raise ValueError(conflicts[0])

    def conflicts(self) -> Tuple[str, ...]:
        """Every internal-consistency rule this epilogue violates."""
        out = []
        if self.pool not in (None, "max2"):
            out.append(f"unknown pool {self.pool!r} (want None|'max2')")
        if self.residual and self.pool:
            out.append("Epilogue(residual=True) cannot fuse a pool: "
                       "the shortcut adds to the un-pooled output")
        if self.relu and self.relu6:
            out.append("relu and relu6 are exclusive activations")
        return tuple(out)

    @property
    def identity(self) -> bool:
        return not (self.bias or self.relu or self.relu6 or self.pool
                    or self.residual or self.scale)

    @property
    def activation(self) -> bool:
        return self.relu or self.relu6

    def __str__(self) -> str:
        parts = [n for n in ("bias", "scale", "residual", "relu", "relu6")
                 if getattr(self, n)]
        if self.pool:
            parts.append(self.pool)
        return "+".join(parts) or "id"


FUSED_RELU = Epilogue(bias=True, relu=True)
FUSED_RELU_POOL = Epilogue(bias=True, relu=True, pool="max2")
FUSED_RESIDUAL_RELU = Epilogue(bias=True, relu=True, residual=True)
FUSED_BN_RELU6 = Epilogue(scale=True, relu6=True)


def epilogue_out_hw(epi: Optional[Epilogue], p: int, q: int
                    ) -> Tuple[int, int]:
    """Output spatial extent after the epilogue (floor semantics for pool)."""
    if epi is not None and epi.pool == "max2":
        return p // 2, q // 2
    return p, q


def maxpool2x2(y: torch.Tensor) -> torch.Tensor:
    """2x2/2 max-pool over the trailing two dims (floor on odd extents)."""
    *lead, p, q = y.shape
    y = y[..., : p // 2 * 2, : q // 2 * 2]
    y = y.reshape(*lead, p // 2, 2, q // 2, 2)
    return y.amax(dim=(-3, -1))


def apply_epilogue(y: torch.Tensor, b: Optional[torch.Tensor],
                   epi: Optional[Epilogue],
                   residual: Optional[torch.Tensor] = None,
                   scale: Optional[torch.Tensor] = None,
                   shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reference epilogue on an NCHW conv output (oracle for the kernels)."""
    if epi is None or epi.identity:
        return y
    if epi.bias:
        if b is None:
            raise ValueError("Epilogue(bias=True) needs a bias vector")
        y = y + b[None, :, None, None].to(y.dtype)
    if epi.scale:
        if scale is None or shift is None:
            raise ValueError("Epilogue(scale=True) needs scale and shift "
                             "vectors")
        y = (y * scale[None, :, None, None].to(y.dtype)
             + shift[None, :, None, None].to(y.dtype))
    if epi.residual:
        if residual is None:
            raise ValueError("Epilogue(residual=True) needs a residual "
                             "tensor")
        y = y + residual.to(y.dtype)
    if epi.relu:
        y = torch.relu(y)
    if epi.relu6:
        y = torch.clamp(y, 0.0, 6.0)
    if epi.pool == "max2":
        y = maxpool2x2(y)
    return y
