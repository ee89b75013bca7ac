"""Precision control shared by the plain references."""
from __future__ import annotations

import contextlib

import torch


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32's 10-bit mantissa, to nearest with
    ties to even, as the tensor cores round their operands: the control's
    precision, on any device."""
    i = t.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


def operand(t: torch.Tensor, tf32: bool) -> torch.Tensor:
    return round_tf32(t) if tf32 else t


@contextlib.contextmanager
def fp32_math(tf32: bool = False):
    """cuDNN convolutions and cuBLAS matmuls in plain fp32 (TF32 off), or,
    with ``tf32``, on their TF32 paths; the flags are restored after."""
    conv, mm = torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm
