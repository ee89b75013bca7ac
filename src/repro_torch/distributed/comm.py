"""The collectives the port's mesh paths run, over one process group.

Gathers and point-to-point transfers move raw bytes (each tensor viewed as
``uint8``), so every type crosses bit for bit and no backend needs to know
it.  Every collective hands its tensor to the group as it is: NCCL and
``distributed/hostgloo.py``'s group (ranks that share a card) take the
card's tensors, gloo the host's.  A collective over a group of one rank
is the identity and runs nothing, except ``all_reduce``, which always
runs (a one-rank NCCL reduction is how a one-rank mesh proves its
communicator).
"""
from __future__ import annotations

from typing import List

import torch

__all__ = ["group_size", "all_gather_cat", "all_reduce",
           "send", "recv", "global_rank"]


def group_size(group) -> int:
    import torch.distributed as dist
    return dist.get_world_size(group)


def global_rank(group, rank: int) -> int:
    """The global rank of ``group``'s rank ``rank``."""
    import torch.distributed as dist
    return dist.get_global_rank(group, rank)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.reshape(-1).view(torch.uint8) if t.numel() else \
        t.new_empty((0,), dtype=torch.uint8)


def all_gather_cat(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``t`` (one shape on all ranks), concatenated in rank
    order along ``dim``."""
    import torch.distributed as dist
    n = group_size(group)
    if n == 1:
        return t
    src = _bytes(t)
    parts: List[torch.Tensor] = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat([p.view(t.dtype).reshape(t.shape) for p in parts], dim)


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``t`` reduced over ``group`` (``op``: "sum" or "max"), a new
    tensor; ``t`` is left as it was."""
    import torch.distributed as dist
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
    buf = t.detach().clone()
    dist.all_reduce(buf, op=ops[op], group=group)
    return buf


def send(t: torch.Tensor, dst: int, group) -> None:
    """Send ``t``'s bytes to ``group``'s rank ``dst``."""
    import torch.distributed as dist
    dist.send(_bytes(t), dst=global_rank(group, dst), group=group)


def recv(like: torch.Tensor, src: int, group) -> torch.Tensor:
    """Receive a tensor of ``like``'s shape, type and device from
    ``group``'s rank ``src``."""
    import torch.distributed as dist
    buf = _bytes(torch.empty_like(like))
    dist.recv(buf, src=global_rank(group, src), group=group)
    return buf.view(like.dtype).reshape(like.shape)
