"""Gradient compression for the data-parallel reduction: per-tensor
symmetric int8 with optional error feedback (the JAX package's
``distributed/compression.py``).

``int8_roundtrip`` quantizes and dequantizes every leaf, so the reduction
runs on values an int8 payload can carry: ``make_train_step(
compress_grads=True)`` applies it to the gradients.  ``ErrorFeedback``
carries the residual ``(g + e) - Q(g + e)`` to the next step.  The scheme
is ``core/quant.py``'s ``quantize_int8`` / ``dequantize_int8``.
``compressed_psum`` is the reduction with the int8 payload itself on the
wire: each rank's int8 values summed as int32 over a mesh axis's group,
the scales max-combined.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.core.quant import dequantize_int8, quantize_int8
from repro_torch.tree import leaves, tree_map, unflatten_like

__all__ = ["quantize_int8", "dequantize_int8", "int8_roundtrip",
           "compressed_psum", "ErrorFeedback"]


def int8_roundtrip(tree: Any) -> Any:
    def one(x):
        q, s = quantize_int8(x)
        return dequantize_int8(q, s, x.dtype)
    return tree_map(one, tree)


def compressed_psum(x: torch.Tensor, group_or_axis) -> torch.Tensor:
    """int8-quantize, all-reduce, dequantize: the sum over a group of
    ``x`` carried as int8 values (summed in int32, so up to 2^23 ranks
    cannot overflow) times the largest of the ranks' scales (the
    conservative combine).  ``group_or_axis`` is a process group, or an
    axis name of the sharding context's mesh, whose line through this
    rank is the group."""
    group = group_or_axis
    if isinstance(group_or_axis, str):
        from repro_torch.distributed.sharding import context_mesh
        group = context_mesh().group(group_or_axis)
    from repro_torch.distributed.comm import all_reduce
    q, s = quantize_int8(x)
    acc = all_reduce(q.to(torch.int32), group, "sum")
    smax = all_reduce(s.reshape(1), group, "max").reshape(())
    return (acc.float() * smax).to(x.dtype)


class ErrorFeedback:
    """Residual accumulator: g_hat = Q(g + e); e <- (g + e) - g_hat."""

    @staticmethod
    def init(tree: Any) -> Any:
        return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                              device=x.device), tree)

    @staticmethod
    def apply(tree: Any, residual: Any) -> Tuple[Any, Any]:
        ghat, res = [], []
        for g, e in zip(leaves(tree), leaves(residual)):
            tot = g.float() + e
            q, s = quantize_int8(tot)
            deq = dequantize_int8(q, s)
            ghat.append(deq.to(g.dtype))
            res.append(tot - deq)
        return unflatten_like(tree, ghat), unflatten_like(tree, res)
