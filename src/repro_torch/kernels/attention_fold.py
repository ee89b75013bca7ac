"""Fold-streamed attention: the port of the JAX package's
``kernels/attention_fold.py`` (flash attention as the paper's dataflow —
the q tile the stationary Filter Fold, K/V tiles the streamed Image Folds,
the online (max, denominator, accumulator) the in-fabric reduction).

``flash_attention_folded`` launches the hand-written CUDA kernel
(``csrc/attention_fold.cu``) on CUDA tensors and runs its plain-torch
version on CPU tensors.  As in the JAX package, no model calls it: the
models run ``models/attention.py``'s ``_mha`` / ``_mha_blockwise``.
"""
from __future__ import annotations

from typing import Dict

import torch

__all__ = ["flash_attention_folded", "flash_attention_folded_plain",
           "launch_counts", "reset_launch_counts", "KERNEL", "HEAD_DIMS"]

KERNEL = "attention_fold"
HEAD_DIMS = (16, 32, 64, 128)     # the kernel's instances
_NEG = -1e30
_ENTRY = {torch.float32: "attention_fold_f32",
          torch.bfloat16: "attention_fold_bf16"}
_LAUNCHES: Dict[str, int] = {KERNEL: 0}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3] \
            or q.shape[2] % k.shape[2]:
        raise ValueError(f"attention takes q (B, T, H, hd) and k, v "
                         f"(B, S, KV, hd) with KV | H, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")


def _shrink(block: int, n: int) -> int:
    """The JAX wrapper's block: ``min(block, n)`` halved until it divides
    ``n``."""
    b = min(block, n)
    while n % b:
        b //= 2
    return b


def flash_attention_folded_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, *, causal: bool = True,
                                 window: int = 0,
                                 k_block: int = 256) -> torch.Tensor:
    """The kernel's function in torch ops: the kv blocks of the JAX
    kernel's grid (``k_block``, shrunk as its wrapper does) walked in
    order with the online softmax, fp32 math, output in q's type.  The q
    blocking changes no row's math, so it has no counterpart here."""
    _check(q, k, v)
    b, t, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    kb = _shrink(k_block, s)
    g = h // kvh
    qs = q.float().transpose(1, 2) * (hd ** -0.5)            # (B, H, T, hd)
    kf = k.float().transpose(1, 2).repeat_interleave(g, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(g, dim=1)
    qpos = torch.arange(t, device=q.device)[:, None]
    m = torch.full((b, h, t), _NEG, device=q.device)
    d = torch.zeros((b, h, t), device=q.device)
    acc = torch.zeros((b, h, t, hd), device=q.device)
    for k0 in range(0, s, kb):
        sc = qs @ kf[:, :, k0:k0 + kb].transpose(-1, -2)     # (B, H, T, kb)
        kpos = torch.arange(k0, k0 + kb, device=q.device)[None, :]
        mask = torch.ones((t, kb), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window > 0:
            mask &= kpos > qpos - window
        sc = torch.where(mask, sc, _NEG)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        d = d * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + p @ vf[:, :, k0:k0 + kb]
        m = m_new
    out = acc / torch.clamp(d, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, window: int) -> torch.Tensor:
    """Launch the kernel on contiguous CUDA operands of one type (fp32 or
    bf16); returns (B, T, H, hd) in q's type."""
    from repro_torch.kernels import build
    _check(q, k, v)
    build.refuse_grad("the attention kernel launch", q, k, v)
    if q.dtype not in _ENTRY:
        raise ValueError(f"the attention kernel takes fp32 or bf16, got "
                         f"{q.dtype}")
    for t in (q, k, v):
        if t.device != q.device or t.dtype != q.dtype \
                or not t.is_contiguous():
            raise ValueError(f"attention kernel operands must be contiguous "
                             f"{q.dtype} on {q.device}, got {t.dtype} on "
                             f"{t.device}")
    b, t_len, h, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"the attention kernel has head dims {HEAD_DIMS}, "
                         f"got {hd}")
    out = torch.empty_like(q)
    lib = build.library()
    err = getattr(lib, _ENTRY[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t_len,
        k.shape[1], h, k.shape[2], hd, int(causal), int(window),
        hd ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    build.raise_on_error(lib, err, KERNEL)
    _LAUNCHES[KERNEL] += 1
    return out


def flash_attention_folded(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           window: int = 0) -> torch.Tensor:
    """q: (B, T, H, hd), k/v: (B, S, KV, hd) with H % KV == 0 ->
    (B, T, H, hd).  The KV head of query head h is h // (H // KV).  On
    CUDA tensors this launches the kernel, on CPU tensors it runs the
    plain version at its default kv block.

    The JAX function's ``q_block`` / ``k_block`` (its Pallas grid's tiles)
    and ``interpret`` (Pallas's interpret mode) are not parameters here:
    the CUDA kernel picks its own tiles, and the plain version is the CPU
    path.

    It has no backward, as the JAX function (a Pallas call with no VJP)
    has none: under grad mode a q, k or v that requires grad raises, on
    either device."""
    from repro_torch.kernels import build
    _check(q, k, v)
    build.refuse_grad("flash_attention_folded", q, k, v)
    if q.device.type == "cuda":
        return launch(q, k, v, causal=causal, window=window)
    if q.device.type == "cpu":
        return flash_attention_folded_plain(q, k, v, causal=causal,
                                            window=window)
    raise ValueError(f"flash_attention_folded runs on cuda or cpu tensors, "
                     f"got {q.device}")


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES[KERNEL] = 0
