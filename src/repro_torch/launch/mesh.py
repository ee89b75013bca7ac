"""Device meshes: named axes over the ranks of a ``torch.distributed``
process group, one rank a process (the JAX package's ``launch/mesh.py``).

A ``Mesh`` has an ordered ``shape`` (axis name -> size) and, where ranks
exist, a ``torch.distributed.device_mesh.DeviceMesh`` that holds one
process group per axis line.  ``make_local_mesh(data, model)`` is the
serving and test mesh; ``make_mesh`` builds any other (the pipeline's
``pod`` stage axis); ``make_production_mesh`` is the planning mesh of the
production geometry: one pod of 16x16 (data x model), or two pods with a
leading ``pod`` axis that carries only the data-parallel reduction.  By
default it has no ranks: building it starts nothing and touches no
device, and the sharding rules (``distributed/sharding.py``) read its
shape alone.  With ``fake=True`` (``make_fake_mesh``) it is the mesh the
dry-run traces the sharded step on: a ``"fake"`` process group of 256 or
512 ranks in this one process, as rank 0, whose collectives move nothing
and return at once, under a CPU ``DeviceMesh`` with the same axis names.
This module is the only one that starts such a group.

The process group: with one rank and none running, ``make_mesh`` starts
one itself on a free localhost port.  With more ranks it joins the group
the caller started (``start_process_group`` in each rank's process, or
the ``env://`` variables).  The backend follows from the ranks and the
device (``pick_backend``): NCCL when every rank has a card of its own,
gloo on the CPU (``device="cpu"``) or when the ranks outnumber the
visible cards.  A card that is not there raises, as
``device.resolve_device`` does: nothing falls back to gloo on the CPU.

Two ranks on one card cannot share NCCL, which refuses two ranks on one
device, so such a mesh runs over ``distributed/hostgloo.py``'s group:
the card's tensors cross between the ranks through CUDA IPC buffers on
the card, gloo carries the meetings.  The ``DeviceMesh`` has the type of
the device the ranks compute on, so a ``DTensor``'s shards stay on the
card.
"""
from __future__ import annotations

import math
import os
import socket
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.device import resolve_device

__all__ = ["Mesh", "make_mesh", "make_local_mesh", "make_production_mesh",
           "make_fake_mesh", "end_fake_group", "start_process_group",
           "pick_backend", "free_port", "mesh_from_flag", "rank"]


class Mesh:
    """Named mesh axes, in order, and the ranks behind them (if any).
    ``dm_axes`` names the mesh axes each dim of ``device_mesh`` carries:
    one axis a dim, or, on the dry-run's fake mesh, ``pod`` and ``data``
    joined in one dim (pod major)."""

    def __init__(self, shape: Dict[str, int], device_mesh=None,
                 device: Optional[torch.device] = None,
                 dm_axes: Optional[Sequence[Tuple[str, ...]]] = None):
        self.shape = dict(shape)
        self.device_mesh = device_mesh
        self.device = device
        self.dm_axes = (tuple(tuple(g) for g in dm_axes) if dm_axes
                        else tuple((a,) for a in self.shape))

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def has_ranks(self) -> bool:
        return self.device_mesh is not None

    def _need_ranks(self) -> None:
        if self.device_mesh is None:
            raise RuntimeError(f"the mesh {self.shape} has no ranks (a "
                               "planning mesh): it runs no collective")

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (0 on an axis of size 1)."""
        if self.shape.get(axis, 1) == 1:
            return 0
        self._need_ranks()
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        self._need_ranks()
        return self.device_mesh.get_group(axis)

    @property
    def backend(self) -> Optional[str]:
        if self.device_mesh is None:
            return None
        import torch.distributed as dist
        return dist.get_backend()

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, ranks={self.has_ranks}, "
                f"device={self.device})")


def free_port() -> int:
    """A free TCP port on localhost (for a process group's rendezvous)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def pick_backend(world_size: int, device: Any = "cuda") -> str:
    """The process-group backend for ``world_size`` ranks computing on
    ``device``: gloo on the CPU or when the ranks outnumber the visible
    cards (NCCL refuses two ranks on one card), else NCCL."""
    dev = resolve_device(device)
    if dev.type == "cpu" or world_size > torch.cuda.device_count():
        return "gloo"
    return "nccl"


def start_process_group(rank: int, world_size: int, port: int, *,
                        device: Any = "cuda") -> None:
    """Join rank ``rank`` of ``world_size`` to a process group whose
    rendezvous is ``tcp://localhost:port``, over ``pick_backend``'s
    backend.  Each rank's process calls it before ``make_mesh``."""
    _init_group(world_size, device, init_method=f"tcp://localhost:{port}",
                rank=rank)


def _init_group(world_size: int, device: Any, **kw) -> None:
    """``init_process_group`` over ``pick_backend``'s backend; gloo for
    ranks that compute on a card is ``distributed/hostgloo.py``'s group
    (the card's tensors cross through CUDA IPC buffers)."""
    import torch.distributed as dist
    backend = pick_backend(world_size, device)
    if backend == "gloo" and resolve_device(device).type == "cuda":
        from repro_torch.distributed.hostgloo import register
        backend = register()
    if "rank" in kw:
        kw["world_size"] = world_size
    dist.init_process_group(backend, **kw)


def _ensure_group(n: int, dev: torch.device) -> None:
    """Check the running process group's size; with none running, start
    a one-rank group (n == 1) or join the ``env://`` one."""
    import torch.distributed as dist
    if not dist.is_initialized():
        if n == 1:
            start_process_group(0, 1, free_port(), device=dev)
        elif all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                            "MASTER_ADDR", "MASTER_PORT")):
            _init_group(n, dev, init_method="env://")
        else:
            raise RuntimeError(
                f"a mesh of {n} ranks needs a running process group: call "
                "start_process_group in each rank's process first (or set "
                "RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT)")
    if dist.get_world_size() != n:
        raise ValueError(f"the process group has {dist.get_world_size()} "
                         f"ranks, the mesh needs {n}")


def make_mesh(shape: Sequence[int], axis_names: Sequence[str], *,
              device: Any = "cuda") -> Mesh:
    """A mesh of ``shape`` over the ranks of the process group (started
    here when none is running); ``device`` is the device each rank
    computes on."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {shape} and axes {axis_names} differ in "
                         "length")
    dev = resolve_device(device)
    _ensure_group(math.prod(shape), dev)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    dm = init_device_mesh(dev.type, shape, mesh_dim_names=axis_names)
    return Mesh(dict(zip(axis_names, shape)), dm, dev)


def make_local_mesh(data: int = 1, model: int = 1, *,
                    device: Any = "cuda") -> Mesh:
    """A (data x model) mesh over the process group's ranks."""
    return make_mesh((data, model), ("data", "model"), device=device)


def mesh_from_flag(flag: str, device: Any = "cuda") -> Optional[Mesh]:
    """The launchers' ``--mesh DATAxMODEL``: None for an empty flag, else
    ``make_local_mesh(DATA, MODEL)`` (a 1x1 mesh starts its own one-rank
    group, a larger one joins the ``env://`` group its launcher, such as
    ``torchrun``, set up)."""
    if not flag:
        return None
    try:
        data, model = (int(t) for t in flag.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh {flag!r} is not DATAxMODEL, e.g. 2x1")
    return make_local_mesh(data, model, device=device)


def rank() -> int:
    """This process's rank in the running process group (0 without one)."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def make_production_mesh(*, multi_pod: bool = False,
                         fake: bool = False) -> Mesh:
    """The production geometry: 16x16 (data, model), or 2x16x16 (pod,
    data, model) with ``multi_pod``.  Without ranks, or with ``fake`` on
    a fake process group of 256 or 512 ranks (``make_fake_mesh``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if fake:
        return make_fake_mesh(shape, axes)
    return Mesh(dict(zip(axes, shape)))


def make_fake_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """A mesh of ``shape`` over a ``"fake"`` process group started here:
    every rank of it lives in this process as rank 0, and its collectives
    return at once and move nothing.  Its ``DeviceMesh`` has the card's
    device type, so ``DTensor`` moves a shard from one dim to another by
    an all-to-all, as over NCCL (over gloo's CPU mesh it gathers and
    slices instead), while its local tensors stay ``meta``: nothing
    reaches a device.  ``pod`` and ``data`` share one device-mesh dim
    (``Mesh.dm_axes``): the rules map them together only (the batch,
    ZeRO-1, a long decode's cache sequence), and DTensor's redistribution
    planner, which searches the placements of every mesh dim, does not
    finish on three dims for the attention's five-dim einsum operands.  A
    fake group already running is ended first; a real one makes this
    raise (its ranks would be lost)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {shape} and axes {axis_names} differ in "
                         "length")
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()} process group of "
                f"{dist.get_world_size()} ranks is running: a fake mesh "
                "would replace it (end it first)")
        end_fake_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    groups = [(a,) for a in axis_names]
    if "pod" in axis_names and "data" in axis_names:
        i, j = axis_names.index("pod"), axis_names.index("data")
        if j != i + 1:
            raise ValueError(f"pod and data must be adjacent: {axis_names}")
        groups[i:j + 1] = [("pod", "data")]
    sizes = dict(zip(axis_names, shape))
    dm_shape = tuple(math.prod(sizes[a] for a in g) for g in groups)
    dm = DeviceMesh("cuda", torch.arange(math.prod(shape)).reshape(dm_shape),
                    mesh_dim_names=tuple("_".join(g) for g in groups))
    return Mesh(sizes, dm, torch.device("meta"), dm_axes=groups)


def end_fake_group() -> None:
    """End the running fake process group, if one is (a real one is left
    alone)."""
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()
