"""The causal depthwise conv1d in front of the Mamba2 mixer's (x, B, C):
the port of the JAX package's ``kernels/conv1d_causal.py``.

    out[b, t, d] = sum_k w[k, d] * x[b, t - K + 1 + k, d]

``conv1d_causal_folded`` launches the hand-written CUDA kernel
(``csrc/conv1d_causal.cu``) on a CUDA tensor and runs its plain-torch
version on a CPU tensor.  The kernel has two paths, picked by its launcher
from the operands: 16-byte words of channels over 8 steps a thread where
D is a multiple of the word (8 bf16, 4 fp32) and x, w and out sit on
16-byte boundaries (``vector_path``), one channel a thread otherwise.  The plain version is the reference's
``conv1d_causal_ref`` (``kernels/ref.py``): the kernel keeps its order and
rounding, so the two agree bit for bit.

The launch has no backward: ``conv1d_causal_folded`` and ``launch`` raise
under grad mode on an operand that requires grad.  The trainable op is
``kernels/ops.py:conv1d_causal``, whose backward puts dx through this same
kernel (the forward conv of the time-reversed gradient) and sums dw in
torch, so a training step launches the kernel in its backward too.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.ref import conv1d_causal_ref as conv1d_causal_plain

__all__ = ["conv1d_causal_folded", "conv1d_causal_plain", "launch",
           "vector_path", "launch_counts", "reset_launch_counts", "KERNEL",
           "KMAX"]

KERNEL = "conv1d_causal"
KMAX = 8                  # the taps the kernel's register window holds
# the C entry point by (x's type, w's type as the kernel reads it)
_ENTRY = {(torch.float32, torch.float32): "conv1d_causal_f32",
          (torch.bfloat16, torch.float32): "conv1d_causal_bf16",
          (torch.bfloat16, torch.bfloat16): "conv1d_causal_bf16_wbf16"}
_LAUNCHES: Dict[str, int] = {KERNEL: 0}
_GRAD_HINT = ", or train through kernels/ops.py:conv1d_causal"


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 3 or w.dim() != 2 or w.shape[1] != x.shape[2]:
        raise ValueError(f"conv1d_causal takes x (B, T, D) and w (K, D), "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")


def _operands(x: torch.Tensor, w: torch.Tensor):
    """Check a CUDA call; returns (w as the kernel reads it, the output,
    the C entry point).  A bf16 w beside a bf16 x (the model's types) goes
    as it is and the kernel widens it; any other w is widened to fp32 here.
    Both widenings are exact."""
    _check(x, w)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the conv1d kernel takes fp32 or bf16 x, got "
                         f"{x.dtype}")
    if not x.is_contiguous() or w.device != x.device:
        raise ValueError(f"the conv1d kernel takes a contiguous x and w on "
                         f"{x.device}, got w on {w.device}")
    if not 1 <= w.shape[0] <= KMAX:
        raise ValueError(f"the conv1d kernel holds 1..{KMAX} taps, got "
                         f"K={w.shape[0]}")
    wk = w.contiguous() if w.dtype == x.dtype == torch.bfloat16 \
        else w.float().contiguous()
    return wk, torch.empty_like(x), _ENTRY[(x.dtype, wk.dtype)]


def vector_path(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether the kernel's launcher takes the vector path for this call
    (asked of the launcher itself, with the operands ``launch`` would pass
    it)."""
    from repro_torch.kernels import build
    wk, out, _ = _operands(x, w)
    return bool(build.library().conv1d_causal_vector_path(
        x.data_ptr(), wk.data_ptr(), out.data_ptr(), x.shape[2],
        x.element_size()))


def launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on a contiguous CUDA x (fp32 or bf16) and w on
    the same device; returns the (B, T, D) output in x's type.  The sum
    takes w in fp32 (``_operands``: exact for a bf16 w)."""
    from repro_torch.kernels import build
    build.refuse_grad("the conv1d kernel launch", x, w, hint=_GRAD_HINT)
    wk, out, entry = _operands(x, w)
    b, t_len, d = x.shape
    lib = build.library()
    err = getattr(lib, entry)(
        x.data_ptr(), wk.data_ptr(), out.data_ptr(), b, t_len, d,
        w.shape[0], torch.cuda.current_stream(x.device).cuda_stream)
    build.raise_on_error(lib, err, KERNEL)
    _LAUNCHES[KERNEL] += 1
    return out


def conv1d_causal_folded(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, T, D), w: (K, D) -> (B, T, D) in x's type.  On a CUDA tensor
    this launches the kernel (or raises); on a CPU tensor it runs the plain
    version.  Under grad mode an operand that requires grad raises, on
    either device (no backward: ``kernels/ops.py:conv1d_causal`` is the
    trainable op)."""
    from repro_torch.kernels import build
    _check(x, w)
    build.refuse_grad("conv1d_causal_folded", x, w, hint=_GRAD_HINT)
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
