"""Plain-torch oracles: the fold kernels' (the ``"reference"`` policy's
conv and the tests' semantics oracle), the im2col GEMM baseline, one
``F.conv2d`` call at full fp32, and the causal conv1d's.

``conv2d_im2col`` is the GEMM-lowering baseline the paper argues against
(§II): it materializes the Toeplitz/im2col patch matrix and runs one big
matmul, discarding the 7-D structure."""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

__all__ = ["conv2d_direct", "conv2d_im2col", "conv2d_torch",
           "conv1d_causal_ref", "full_fp32"]


@contextlib.contextmanager
def full_fp32():
    """fp32 matmuls and convs without TF32 for the block, the flags put
    back after it."""
    mm, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cudnn


def conv2d_direct(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                  pad: int = 0, groups: int = 1) -> torch.Tensor:
    """Direct 7-loop convolution, vectorized as R*S shifted products.

    x: (N, C, X, Y)  w: (NF, C, R, S)  ->  (N, NF, P, Q)

    Walks the (R, S) loops explicitly and accumulates the partial sums in
    fp32, mirroring the paper's reduction order.  With ``groups > 1`` the
    weights are (NF, C/groups, R, S) and each filter contracts only its
    own group's channel slice (depthwise is groups == C).

    Int8 ``x`` and ``w`` give the exact int32 accumulator (the
    ``"reference"`` policy's int8 conv, the counterpart of
    ``lax.conv_general_dilated(..., preferred_element_type=int32)``): the
    partial sums accumulate in float64, which holds every integer below
    2^53 exactly, far above the worst case 127*127*(C/G)*R*S, and are
    returned as int32.  ``F.conv2d`` has no int8 path on either device.
    """
    n, c, _, _ = x.shape
    nf, cw, r, s = w.shape
    if c != cw * groups or nf % groups:
        raise ValueError(f"input has {c} channels, weights expect "
                         f"{cw}x{groups} (and groups={groups} must divide "
                         f"NF={nf})")
    xp = F.pad(x, (pad, pad, pad, pad)) if pad else x
    p = (xp.shape[2] - r) // stride + 1
    q = (xp.shape[3] - s) // stride + 1
    quantized = x.dtype == torch.int8
    if quantized and w.dtype != torch.int8:
        raise ValueError(f"int8 activations need int8 weights, got w dtype "
                         f"{w.dtype}")
    acc_dtype = torch.float64 if quantized else torch.float32
    out_dtype = torch.int32 if quantized else x.dtype
    if groups == 1:
        acc = torch.zeros((n, nf, p, q), dtype=acc_dtype, device=x.device)
        for ri in range(r):
            for si in range(s):
                win = xp[:, :, ri:ri + p * stride:stride,
                         si:si + q * stride:stride]      # (N, C, P, Q)
                acc = acc + torch.einsum("ncpq,fc->nfpq", win.to(acc_dtype),
                                         w[:, :, ri, si].to(acc_dtype))
        return acc.to(out_dtype)
    xg = xp.reshape(n, groups, cw, xp.shape[2], xp.shape[3])
    wg = w.reshape(groups, nf // groups, cw, r, s)
    acc = torch.zeros((n, groups, nf // groups, p, q), dtype=acc_dtype,
                      device=x.device)
    for ri in range(r):
        for si in range(s):
            win = xg[:, :, :, ri:ri + p * stride:stride,
                     si:si + q * stride:stride]          # (N, G, Cg, P, Q)
            acc = acc + torch.einsum("ngcpq,gfc->ngfpq", win.to(acc_dtype),
                                     wg[:, :, :, ri, si].to(acc_dtype))
    return acc.reshape(n, nf, p, q).to(out_dtype)


def conv2d_im2col(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                  pad: int = 0) -> torch.Tensor:
    """The GEMM baseline: im2col + one (N*P*Q, C*R*S) x (C*R*S, NF) matmul
    with fp32 sums (TF32 off), cast to x's type.  Dense only."""
    n, c, _, _ = x.shape
    nf, cw, r, s = w.shape
    if cw != c:
        raise ValueError(f"the im2col baseline is dense-only (grouped "
                         f"oracle: 'direct' or 'torch'): input has {c} "
                         f"channels, weights expect {cw}")
    # (N, C*R*S, P*Q), channel-major to match OIHW
    patches = F.unfold(x.float(), (r, s), padding=pad, stride=stride)
    p = (x.shape[2] + 2 * pad - r) // stride + 1
    q = (x.shape[3] + 2 * pad - s) // stride + 1
    wmat = w.float().reshape(nf, c * r * s).T             # (C*R*S, NF)
    with full_fp32():
        out = torch.matmul(patches.transpose(1, 2), wmat)  # (N, P*Q, NF)
    return out.transpose(1, 2).reshape(n, nf, p, q).to(x.dtype)


def conv2d_torch(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                 pad: int = 0, groups: int = 1) -> torch.Tensor:
    """One ``F.conv2d`` call with TF32 off (the counterpart of the JAX
    package's ``lax.conv_general_dilated`` oracle)."""
    with full_fp32():
        return F.conv2d(x, w, stride=stride, padding=pad, groups=groups)


def conv1d_causal_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d (the Mamba2 / Zamba2 block).

    x: (B, T, D)   w: (K, D)   ->  (B, T, D)
    out[b, t, d] = sum_k w[k, d] * x[b, t - K + 1 + k, d]

    The sum starts at 0 and adds the taps k = 0 .. K-1 in fp32 (w widened
    to fp32), each product and sum rounded on its own; the result is cast
    to x's type.
    """
    if x.dim() != 3 or w.dim() != 2 or w.shape[1] != x.shape[2]:
        raise ValueError(f"conv1d_causal takes x (B, T, D) and w (K, D), "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    k, t = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for ki in range(k):
        acc = acc + xp[:, ki:ki + t, :].float() * w[ki].float()
    return acc.to(x.dtype)
