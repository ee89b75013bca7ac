"""A process group for ranks that share one card: the card's tensors cross
between the ranks' processes through CUDA IPC buffers on that card, and
gloo carries the synchronisation.

NCCL refuses two ranks on one device, so two ranks on one card join over
gloo; gloo moves a card's tensor through the host and over a TCP socket,
which made a sharded zamba2-1.2b train step on two such ranks spend
nearly all its time in collectives.  This group keeps the data on the
card: each rank owns a staging buffer on the card that the other ranks
open once through CUDA IPC (``_CardExchange``).  A collective copies this
rank's operand into its buffer, waits for its stream, meets the other
ranks (a two-number gloo all-reduce on the host), and reads every rank's
operand straight from their buffers; two buffers a rank, used in turn,
keep a rank from overwriting one that another rank still reads.  Host
tensors go through gloo's all-gather (``_HostExchange``); both exchanges
hand the same collective code every rank's operand in rank order, so a
reduction sums in rank order, in fp32 for a floating type, and every
rank gets the same bits.

``register()`` makes the backend ``HOST_GLOO`` known to
``torch.distributed`` (once a process); ``launch/mesh.py`` starts a
group over it where ``pick_backend`` says gloo and the ranks compute on a
card.  Importing this module registers nothing and starts no group.
"""
from __future__ import annotations

import functools
import pickle
import time
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["HOST_GLOO", "register", "HostGlooGroup"]

HOST_GLOO = "hostgloo"
_ALIGN = 2 << 20                 # a staging buffer grows in 2 MiB steps


def _done(value=None):
    """A finished ``Work`` (the collective ran to its end before it was
    returned)."""
    from torch._C._distributed_c10d import _create_work_from_future
    from torch.futures import Future
    fut = Future()
    fut.set_result(value)
    return _create_work_from_future(fut)


def _raw(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes, a flat uint8 view (of a contiguous copy if need be)."""
    t = t.contiguous()
    return t.reshape(-1).view(torch.uint8) if t.numel() else \
        t.new_empty((0,), dtype=torch.uint8)


class _Gloo:
    """Gloo's collectives on host tensors, each waited for."""

    def __init__(self, gloo):
        self.pg = gloo

    def allgather(self, outs: List[torch.Tensor], t: torch.Tensor) -> None:
        self.pg.allgather([outs], [t]).wait()

    def allreduce_max(self, t: torch.Tensor) -> torch.Tensor:
        o = dist.AllreduceOptions()
        o.reduceOp = dist.ReduceOp.MAX
        self.pg.allreduce([t], o).wait()
        return t


class _HostExchange:
    """Every rank's operand bytes, on the host, by one gloo all-gather."""

    def __init__(self, gloo: _Gloo, size: int):
        self.gloo, self.size = gloo, size

    def __call__(self, src: torch.Tensor) -> List[torch.Tensor]:
        mine = _raw(src)
        parts = [torch.empty_like(mine) for _ in range(self.size)]
        self.gloo.allgather(parts, mine)
        return parts


class _CardExchange:
    """Every rank's operand bytes, read in place from each rank's staging
    buffers on the card (CUDA IPC).  All ranks must pass operands of one
    size (checked at each exchange's meeting).

    Two buffers a rank, used in turn: exchange k writes buffer k % 2
    while the others may still read buffer (k - 1) % 2; they finished
    reading buffer k % 2 (exchange k - 2) before they met at exchange
    k - 1, since a rank waits for its stream before every meeting.  So
    an exchange is one copy in, one meeting and the reads."""

    def __init__(self, gloo: _Gloo, rank: int, size: int):
        self.gloo, self.rank, self.size = gloo, rank, size
        self.cap = 0
        self.calls = 0
        self.buffers: List[List[torch.Tensor]] = [[], []]

    def _meet(self, nbytes: int) -> None:
        """Wait for this rank's stream (its copy in, its reads of earlier
        exchanges), then for every rank: all arrive with the same
        ``nbytes``."""
        torch.cuda.current_stream().synchronize()
        seen = self.gloo.allreduce_max(torch.tensor([nbytes, -nbytes],
                                                    dtype=torch.int64))
        if int(seen[0]) != -int(seen[1]):
            raise ValueError(f"a collective on one card got operands of "
                             f"{-int(seen[1])} to {int(seen[0])} bytes "
                             "across the ranks")

    def _grow(self, nbytes: int, device: torch.device) -> None:
        """Larger staging buffers on every rank, each opened by the others
        through CUDA IPC (after a meeting: no rank reads the old ones).
        The buffers outlive the collective that made them, which may run
        under ``torch.inference_mode``: they are made as normal tensors,
        so that a collective outside that mode can write them."""
        with torch.inference_mode(False), torch.no_grad():
            self._open(nbytes, device)

    def _open(self, nbytes: int, device: torch.device) -> None:
        from torch.multiprocessing.reductions import reduce_tensor
        self._meet(nbytes)
        self.buffers = [[], []]
        cap = max(nbytes, 2 * self.cap)
        self.cap = -(-cap // _ALIGN) * _ALIGN
        mine = [torch.empty(self.cap, dtype=torch.uint8, device=device)
                for _ in range(2)]
        blob = torch.frombuffer(bytearray(pickle.dumps(
            [reduce_tensor(t) for t in mine])), dtype=torch.uint8)
        lens = [torch.empty(1, dtype=torch.int64) for _ in range(self.size)]
        self.gloo.allgather(lens, torch.tensor([blob.numel()]))
        padded = torch.zeros(max(int(n) for n in lens), dtype=torch.uint8)
        padded[:blob.numel()] = blob
        blobs = [torch.empty_like(padded) for _ in range(self.size)]
        self.gloo.allgather(blobs, padded)
        for r in range(self.size):
            if r == self.rank:
                opened = mine
            else:
                opened = [fn(*args) for fn, args in pickle.loads(
                    blobs[r][:int(lens[r])].numpy().tobytes())]
            for k in range(2):
                self.buffers[k].append(opened[k])

    def __call__(self, src: torch.Tensor) -> List[torch.Tensor]:
        mine = _raw(src)
        n = mine.numel()
        if n > self.cap:
            self._grow(n, src.device)
        bufs = self.buffers[self.calls % 2]
        self.calls += 1
        bufs[self.rank][:n].copy_(mine)
        self._meet(n)                        # every rank's operand is in
        return [b[:n] for b in bufs]


def _typed(raw: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return raw.view(like.dtype).reshape(like.shape)


def _reduce(parts: List[torch.Tensor], op, size: int) -> torch.Tensor:
    """``parts`` (every rank's operand, one type) reduced in rank order:
    a floating sum in fp32, rounded once."""
    op = getattr(op, "op", op)               # a ReduceOp's RedOpType
    if op in (dist.ReduceOp.SUM, dist.ReduceOp.AVG):
        wide = parts[0].is_floating_point()
        acc = parts[0].float() if wide else parts[0].clone()
        for p in parts[1:]:
            acc = acc + (p.float() if wide else p)
        if op == dist.ReduceOp.AVG:
            acc = acc / size
        return acc.to(parts[0].dtype)
    pick = {dist.ReduceOp.MAX: torch.maximum,
            dist.ReduceOp.MIN: torch.minimum}[op]
    acc = parts[0]
    for p in parts[1:]:
        acc = pick(acc, p)
    return acc


def _counted(fn):
    """Count a collective's calls and host seconds in ``stats``; a
    collective that another one runs is counted in that one alone."""
    @functools.wraps(fn)
    def run(self, *args, **kwargs):
        if self._depth:
            return fn(self, *args, **kwargs)
        self._depth += 1
        t0 = time.perf_counter()
        try:
            return fn(self, *args, **kwargs)
        finally:
            self._depth -= 1
            st = self.stats
            st["calls"] += 1
            st["seconds"] += time.perf_counter() - t0
            st["by_op"][fn.__name__] = st["by_op"].get(fn.__name__, 0) + 1
    return run


class HostGlooGroup(dist.ProcessGroup):
    """A process group of ``size`` ranks (this one ``rank``) over
    ``store``: the card's operands cross through CUDA IPC buffers, the
    host's through gloo, and every collective has run to its end when it
    returns.  ``stats`` counts the collectives this rank ran on the group
    and the host seconds they took."""

    def __init__(self, store, rank: int, size: int, timeout):
        super().__init__(rank, size)
        self._rank, self._size = rank, size
        self._gloo = _Gloo(dist.ProcessGroupGloo(store, rank, size, timeout))
        self._host = _HostExchange(self._gloo, size)
        self._card = _CardExchange(self._gloo, rank, size)
        self.stats = {"calls": 0, "seconds": 0.0, "by_op": {}}
        self._depth = 0

    def size(self) -> int:
        return self._size

    def getBackendName(self) -> str:
        return HOST_GLOO

    def _set_group_name(self, name: str) -> None:
        self._name = name
        super()._set_group_name(name)

    @property
    def group_name(self) -> str:
        """The name ``torch.distributed`` gave this group (a group of
        Python collectives holds no backend to keep it)."""
        return self._name

    def _parts(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` (one shape and type on all ranks), in rank
        order, on ``t``'s device."""
        ex = self._card if t.device.type == "cuda" else self._host
        return [_typed(p, t) for p in ex(t)]

    # -- reductions -------------------------------------------------------
    @_counted
    def allreduce(self, tensor_list, opts=None):
        op = (opts or dist.AllreduceOptions()).reduceOp
        for t in tensor_list:
            t.copy_(_reduce(self._parts(t), op, self._size))
        return _done(tensor_list)

    @_counted
    def allreduce_coalesced(self, tensor_list, opts=None):
        return self.allreduce(tensor_list, opts)

    @_counted
    def reduce_scatter_single(self, output, input, opts=None):
        """This rank's ``size``-th of ``input``, reduced over the ranks."""
        op = (opts or dist.ReduceScatterOptions()).reduceOp
        parts = [p.reshape(self._size, -1)[self._rank]
                 for p in self._parts(input)]
        output.copy_(_reduce(parts, op, self._size).view(output.shape))
        return _done([output])

    _reduce_scatter_base = reduce_scatter_single

    @_counted
    def reduce_scatter(self, output_tensors, input_tensors, opts=None):
        """Each output the reduction of its list's ``rank``-th tensor (the
        list's tensors of one shape)."""
        for out, parts in zip(output_tensors, input_tensors):
            self.reduce_scatter_single(
                out, torch.cat([p.reshape(-1) for p in parts]), opts)
        return _done(output_tensors)

    @_counted
    def reduce_scatter_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            self.reduce_scatter_single(o, i, opts)
        return _done(outputs)

    # -- gathers ----------------------------------------------------------
    @_counted
    def all_gather_single(self, output, input, opts=None):
        rows = output.view(self._size, -1)
        for r, p in enumerate(self._parts(input)):
            rows[r].copy_(p.reshape(-1))
        return _done([output])

    @_counted
    def allgather(self, output_tensors, input_tensors, opts=None):
        for outs, t in zip(output_tensors, input_tensors):
            for o, p in zip(outs, self._parts(t)):
                o.copy_(p.view(o.shape))
        return _done(output_tensors)

    _allgather_base = all_gather_single

    @_counted
    def allgather_into_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            self.all_gather_single(o, i, opts)
        return _done(outputs)

    @_counted
    def broadcast(self, tensor_list, opts=None):
        root = (opts or dist.BroadcastOptions()).rootRank
        for t in tensor_list:
            t.copy_(self._parts(t)[root])
        return _done(tensor_list)

    @_counted
    def all_to_all_single(self, output, input,
                          output_split_sizes: Optional[Sequence[int]],
                          input_split_sizes: Optional[Sequence[int]],
                          opts=None):
        """Block j of this rank's input to rank j (blocks along the first
        dim, even where no splits are given): every rank's input
        gathered on the host, each rank keeping the blocks sent to it."""
        n = self._size
        ins = list(input_split_sizes or [input.shape[0] // n] * n)
        sizes = [torch.empty(n, dtype=torch.int64) for _ in range(n)]
        self._gloo.allgather(sizes, torch.tensor(ins, dtype=torch.int64))
        src = torch.zeros((max(int(s.sum()) for s in sizes),)
                          + tuple(input.shape[1:]), dtype=input.dtype)
        src[:input.shape[0]] = input.cpu()
        gathered = [torch.empty_like(src) for _ in range(n)]
        self._gloo.allgather(gathered, src)
        got = torch.cat([g[int(s[:self._rank].sum()):][:int(s[self._rank])]
                         for g, s in zip(gathered, sizes)])
        outs = list(output_split_sizes or [output.shape[0] // n] * n)
        if got.shape[0] != sum(outs):
            raise ValueError(f"all_to_all: {got.shape[0]} rows for an "
                             f"output of {sum(outs)}")
        output.copy_(got)
        return _done([output])

    alltoall_base = all_to_all_single

    @_counted
    def alltoall(self, output_tensor_list, input_tensor_list, opts=None):
        out = [t.shape[0] for t in output_tensor_list]
        dst = torch.empty((sum(out),) + tuple(output_tensor_list[0].shape[1:]),
                          dtype=output_tensor_list[0].dtype)
        self.all_to_all_single(dst, torch.cat(list(input_tensor_list)), out,
                               [t.shape[0] for t in input_tensor_list])
        for o, piece in zip(output_tensor_list, dst.split(out)):
            o.copy_(piece)
        return _done(output_tensor_list)

    @_counted
    def barrier(self, opts=None):
        self._gloo.allreduce_max(torch.zeros(1))
        return _done()

    # -- point to point -----------------------------------------------------
    @_counted
    def send(self, tensors, dst: int, tag: int = 0):
        for t in tensors:
            self._gloo.pg.send([t.cpu().contiguous()], dst, tag).wait()
        return _done()

    @_counted
    def recv(self, tensors, src: int, tag: int = 0):
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype)
            self._gloo.pg.recv([h], src, tag).wait()
            t.copy_(h)
        return _done(tensors)


def _create(store, rank, size, timeout):
    return HostGlooGroup(store, rank, size, timeout)


def register() -> str:
    """Make ``HOST_GLOO`` a ``torch.distributed`` backend (for host and
    card tensors) in this process, once; returns its name."""
    if not hasattr(dist.Backend, HOST_GLOO.upper()):
        dist.Backend.register_backend(HOST_GLOO, _create,
                                      devices=["cpu", "cuda"])
    return HOST_GLOO
