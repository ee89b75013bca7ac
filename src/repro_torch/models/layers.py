"""Primitive layers: RMS and layer norms, RoPE and logit soft-capping
(the JAX package's ``models/layers.py``).  Norms and rotations compute in
fp32 and cast back to the input's type."""
from __future__ import annotations

import torch

from repro_torch.distributed.dtensor import (is_dtensor, place_like,
                                             replicated_like, run_local)

__all__ = ["rms_norm", "group_rms_norm", "layer_norm", "rope_freqs",
           "apply_rope", "softcap", "embed_rows"]


def embed_rows(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  On DTensors the vocab-parallel lookup: each
    rank takes the rows of its own vocab slice for its own tokens (zeros
    for a token outside the slice), a partial sum over the vocab split."""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    tokens = replicated_like(tokens, table)
    table = place_like(table, table, {0: 0})
    tokens = place_like(tokens, tokens, {0: 0})
    (rows, _), (lo, _) = compute_local_shape_and_global_offset(
        table.shape, table.device_mesh, table.placements)
    out = []
    for pt, pk in zip(table.placements, tokens.placements):
        out.append(Shard(0) if isinstance(pk, Shard)
                   else Partial() if isinstance(pt, Shard) else Replicate())

    def local(table, tokens):
        idx = tokens - lo
        inside = (idx >= 0) & (idx < rows)
        got = table[idx.clamp(0, rows - 1)]
        return got * inside[..., None].to(got.dtype)
    return run_local(local, table, tokens, out_placements=[out])


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    """RMSNorm; ``plus_one`` uses the (1+w) gemma parameterization."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    w = weight.float()
    y = y * (1.0 + w) if plus_one else y * w
    return y.to(x.dtype)


def group_rms_norm(x: torch.Tensor, weight: torch.Tensor, groups: int,
                   eps: float = 1e-6) -> torch.Tensor:
    """Per-group RMSNorm over the last dim (RWKV6's ln_x and the Mamba2
    gated norm normalize per head)."""
    *lead, d = x.shape
    xg = x.float().reshape(*lead, groups, d // groups)
    var = xg.square().mean(dim=-1, keepdim=True)
    y = (xg * torch.rsqrt(var + eps)).reshape(*lead, d)
    return (y * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    """Inverse frequencies for rotary embeddings; (head_dim // 2,) fp32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor) -> torch.Tensor:
    """x: (..., T, H, D); positions: broadcastable to (..., T)."""
    positions = replicated_like(positions, x)
    inv_freq = replicated_like(inv_freq, x)
    angles = positions[..., :, None, None].float() \
        * inv_freq[None, None, :]                      # (..., T, 1, D/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Logit soft-capping (gemma): cap * tanh(x / cap)."""
    return cap * torch.tanh(x / cap)
