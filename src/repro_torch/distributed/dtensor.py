"""The helpers that let the LM path run on ``DTensor`` operands (a sharded
step laid out by ``distributed/sharding.distribute_tree``), each the
identity or the plain op on plain tensors, so the one-rank and mesh-less
paths keep their bits.

A tensor the model builds itself (a mask, a position, a zero state) goes
through ``replicated_like`` before it meets a DTensor.  The cores that
every rank computes on its own shards (the attention scores, the SSD and
WKV recurrences, the causal conv, the MoE experts) run through
``run_local``: the plain code on each rank's local tensors, the operands
laid out first (``place_like``) so that no collective is needed inside,
as an SPMD partitioner splits them.  Importing this module imports no
part of ``torch.distributed``."""
from __future__ import annotations

import contextlib
import threading
from typing import Any

import torch

__all__ = ["is_dtensor", "replicated_like", "arange_like", "place_like",
           "placed_like", "placements_as", "run_local", "in_local_region",
           "einsum"]

_LOCAL = threading.local()


def in_local_region() -> bool:
    """Whether this thread runs inside ``run_local`` on local shards
    (where a sharding constraint has nothing to constrain)."""
    return getattr(_LOCAL, "depth", 0) > 0


@contextlib.contextmanager
def _local_region():
    _LOCAL.depth = getattr(_LOCAL, "depth", 0) + 1
    try:
        yield
    finally:
        _LOCAL.depth -= 1


def is_dtensor(x: Any) -> bool:
    """Whether ``x`` is a ``DTensor`` (a shard of a sharded step's
    operand)."""
    if type(x) is torch.Tensor or not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def replicated_like(t: torch.Tensor, *refs: Any) -> torch.Tensor:
    """``t``, a tensor the model builds itself, as a DTensor replicated on
    every rank of the mesh of the first ``DTensor`` among ``refs`` (the
    operands it will meet); ``t`` itself when none of them is one, or
    when ``t`` already is."""
    if is_dtensor(t):
        return t
    for r in refs:
        if is_dtensor(r):
            from torch.distributed.tensor import DTensor, Replicate
            mesh = r.device_mesh
            return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                      run_check=False)
    return t


def arange_like(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``arange(x.shape[dim])`` on ``x``'s device; on a ``DTensor`` laid
    out as ``x``'s dim ``dim`` is (each rank holds the indices of its own
    slice), so comparing it with ``x``'s indices moves nothing."""
    n = x.shape[dim]
    if not is_dtensor(x):
        return torch.arange(n, device=x.device)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    d = dim % x.ndim
    placements = [Shard(0) if isinstance(p, Shard) and p.dim == d
                  else Replicate() for p in x.placements]
    mesh = x.device_mesh
    (size,), (offset,) = compute_local_shape_and_global_offset(
        (n,), mesh, placements)
    local = torch.arange(offset, offset + size, device=x.device)
    return DTensor.from_local(local, mesh, placements, shape=(n,),
                              stride=(1,), run_check=False)


def place_like(x: torch.Tensor, ref: torch.Tensor,
               dims: dict) -> torch.Tensor:
    """``x`` (a DTensor) redistributed so that its dim ``dims[d]`` is split
    over the mesh dims over which ``ref``'s dim ``d`` is, and every other
    dim of ``x`` is whole on each rank (a dim of ``ref`` missing from
    ``dims`` is not carried over)."""
    want = placements_as(ref, {d: e % x.ndim for d, e in dims.items()})
    if tuple(want) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def placed_like(x: Any, ref: Any) -> Any:
    """``x`` redistributed to ``ref``'s placements where both are
    DTensors (a step's result handed back in its argument's layout, as
    ``jax.jit``'s ``out_shardings`` does), else ``x``."""
    if is_dtensor(x) and is_dtensor(ref) and x.placements != ref.placements:
        return x.redistribute(ref.device_mesh, ref.placements)
    return x


def placements_as(ref: torch.Tensor, dims: dict):
    """``ref``'s placements with its dim ``d`` renamed ``dims[d]`` (a
    split of a dim missing from ``dims`` dropped)."""
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(dims[p.dim]) if isinstance(p, Shard) and p.dim in dims
            else Replicate() for p in ref.placements]


def run_local(fn, *args, out_placements):
    """``fn`` on the local tensors of ``args``, each rank on its own
    shards, its tensor outputs made DTensors again with
    ``out_placements`` (a list of placements per output) on the mesh of
    the first DTensor argument: ``local_map``, with each argument's
    gradient placements worked out (an argument replicated on a mesh dim
    that another splits gets a partial-sum gradient there).  The caller
    lays the arguments out so that the region needs no collective.
    Without a DTensor argument it is ``fn(*args)``."""
    dts = [a for a in args if is_dtensor(a)]
    if not dts:
        return fn(*args)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = dts[0].device_mesh
    split = [any(isinstance(a.placements[m], Shard) for a in dts)
             for m in range(mesh.ndim)]
    grads = tuple(
        [Partial() if isinstance(p, Replicate) and split[m] else p
         for m, p in enumerate(a.placements)] if is_dtensor(a) else None
        for a in args)
    outs = (list(out_placements[0]) if len(out_placements) == 1
            else tuple(list(p) for p in out_placements))
    with _local_region():
        return local_map(fn, outs, in_grad_placements=grads,
                         device_mesh=mesh)(*args)


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum``.  On DTensors every rank contracts its own shards:
    on each mesh dim one index letter stays split (the first operand's
    that is split there), the operands holding that letter are laid out
    split on it and the others whole, and the result is split on it, or
    a partial sum where the einsum contracts it."""
    if not any(is_dtensor(o) for o in ops):
        return torch.einsum(eq, *ops)
    from torch.distributed.tensor import Partial, Replicate, Shard
    subs, out = eq.replace(" ", "").split("->")
    subs = subs.split(",")
    ref = next(o for o in ops if is_dtensor(o))
    mesh = ref.device_mesh
    ops = [replicated_like(o, ref) for o in ops]
    want = [[Replicate()] * mesh.ndim for _ in ops]
    out_pl = []
    for m in range(mesh.ndim):
        letter = next((s[o.placements[m].dim] for s, o in zip(subs, ops)
                       if isinstance(o.placements[m], Shard)), None)
        if letter is None:
            out_pl.append(Replicate())
            continue
        for i, s in enumerate(subs):
            if letter in s:
                want[i][m] = Shard(s.index(letter))
        out_pl.append(Shard(out.index(letter)) if letter in out
                      else Partial())
    ops = [o if tuple(o.placements) == tuple(w) else o.redistribute(mesh, w)
           for o, w in zip(ops, want)]
    return run_local(lambda *a: torch.einsum(eq, *a), *ops,
                     out_placements=[out_pl])
