"""The causal depthwise conv1d in front of the Mamba2 mixer's (x, B, C):
the port of the JAX package's ``kernels/conv1d_causal.py``.

    out[b, t, d] = sum_k w[k, d] * x[b, t - K + 1 + k, d]

``conv1d_causal_folded`` launches the hand-written CUDA kernel
(``csrc/conv1d_causal.cu``) on a CUDA tensor and runs its plain-torch
version on a CPU tensor.  The plain version is the reference's
``conv1d_causal_ref`` (``kernels/ref.py``): the kernel keeps its order and
rounding, so the two agree bit for bit.  Forward only; the backward comes
with the training slice.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.ref import conv1d_causal_ref as conv1d_causal_plain

__all__ = ["conv1d_causal_folded", "conv1d_causal_plain", "launch_counts",
           "reset_launch_counts", "KERNEL", "KMAX"]

KERNEL = "conv1d_causal"
KMAX = 8                  # the taps the kernel's register window holds
_ENTRY = {torch.float32: "conv1d_causal_f32",
          torch.bfloat16: "conv1d_causal_bf16"}
_LAUNCHES: Dict[str, int] = {KERNEL: 0}


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 3 or w.dim() != 2 or w.shape[1] != x.shape[2]:
        raise ValueError(f"conv1d_causal takes x (B, T, D) and w (K, D), "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")


def launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on a contiguous CUDA x (fp32 or bf16) and w on
    the same device; returns the (B, T, D) output in x's type.  w is
    widened to fp32 first (exact for bf16), as the kernel's sum takes it."""
    from repro_torch.kernels import build
    _check(x, w)
    if x.dtype not in _ENTRY:
        raise ValueError(f"the conv1d kernel takes fp32 or bf16 x, got "
                         f"{x.dtype}")
    if not x.is_contiguous() or w.device != x.device:
        raise ValueError(f"the conv1d kernel takes a contiguous x and w on "
                         f"{x.device}, got w on {w.device}")
    b, t_len, d = x.shape
    k = w.shape[0]
    if not 1 <= k <= KMAX:
        raise ValueError(f"the conv1d kernel holds 1..{KMAX} taps, got K={k}")
    w32 = w.float().contiguous()
    out = torch.empty_like(x)
    lib = build.library()
    err = getattr(lib, _ENTRY[x.dtype])(
        x.data_ptr(), w32.data_ptr(), out.data_ptr(), b, t_len, d, k,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.raise_on_error(lib, err, KERNEL)
    _LAUNCHES[KERNEL] += 1
    return out


def conv1d_causal_folded(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, T, D), w: (K, D) -> (B, T, D) in x's type.  On a CUDA tensor
    this launches the kernel (or raises); on a CPU tensor it runs the plain
    version."""
    _check(x, w)
    if x.device.type == "cuda":
        return launch(x, w)
    if x.device.type == "cpu":
        return conv1d_causal_plain(x, w)
    raise ValueError(f"conv1d_causal runs on cuda or cpu tensors, got "
                     f"{x.device}")


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES[KERNEL] = 0
