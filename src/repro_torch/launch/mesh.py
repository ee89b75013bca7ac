"""Device meshes: named axes over the ranks of a ``torch.distributed``
process group, one rank a process (the JAX package's ``launch/mesh.py``).

A ``Mesh`` has an ordered ``shape`` (axis name -> size) and, where ranks
exist, a ``torch.distributed.device_mesh.DeviceMesh`` that holds one
process group per axis line.  ``make_local_mesh(data, model)`` is the
serving and test mesh; ``make_mesh`` builds any other (the pipeline's
``pod`` stage axis); ``make_production_mesh`` is the planning mesh of the
production geometry: one pod of 16x16 (data x model), or two pods with a
leading ``pod`` axis that carries only the data-parallel reduction.  It
has no ranks: building it starts nothing and touches no device, and the
sharding rules (``distributed/sharding.py``) read its shape alone.

The process group: with one rank and none running, ``make_mesh`` starts
one itself on a free localhost port.  With more ranks it joins the group
the caller started (``start_process_group`` in each rank's process, or
the ``env://`` variables).  The backend follows from the ranks and the
device (``pick_backend``): NCCL when every rank has a card of its own,
gloo on the CPU (``device="cpu"``) or when the ranks outnumber the
visible cards.  A card that is not there raises, as
``device.resolve_device`` does: nothing falls back to gloo on the CPU.

Two ranks on one card cannot share NCCL, which refuses two ranks on one
device, so such a mesh runs over gloo and its collectives move the card's
tensors through the host (``distributed/comm.py``); its ``DeviceMesh`` is
then a CPU mesh (gloo's transport), while ``Mesh.device`` stays the card
the rank computes on.
"""
from __future__ import annotations

import math
import os
import socket
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.device import resolve_device

__all__ = ["Mesh", "make_mesh", "make_local_mesh", "make_production_mesh",
           "start_process_group", "pick_backend", "free_port"]


class Mesh:
    """Named mesh axes, in order, and the ranks behind them (if any)."""

    def __init__(self, shape: Dict[str, int], device_mesh=None,
                 device: Optional[torch.device] = None):
        self.shape = dict(shape)
        self.device_mesh = device_mesh
        self.device = device

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
    import torch.distributed as dist
    dist.init_process_group(pick_backend(world_size, device),
                            init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world_size)


def _ensure_group(n: int, dev: torch.device) -> str:
    """The running process group's backend; with none running, start a
    one-rank group (n == 1) or join the ``env://`` one."""
    import torch.distributed as dist
    if not dist.is_initialized():
        if n == 1:
            start_process_group(0, 1, free_port(), device=dev)
        elif all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                            "MASTER_ADDR", "MASTER_PORT")):
            dist.init_process_group(pick_backend(n, dev),
                                    init_method="env://")
        else:
            raise RuntimeError(
                f"a mesh of {n} ranks needs a running process group: call "
                "start_process_group in each rank's process first (or set "
                "RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT)")
    if dist.get_world_size() != n:
        raise ValueError(f"the process group has {dist.get_world_size()} "
                         f"ranks, the mesh needs {n}")
    return dist.get_backend()


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
    backend = _ensure_group(math.prod(shape), dev)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    dm = init_device_mesh("cuda" if backend == "nccl" else "cpu", shape,
                          mesh_dim_names=axis_names)
    return Mesh(dict(zip(axis_names, shape)), dm, dev)


def make_local_mesh(data: int = 1, model: int = 1, *,
                    device: Any = "cuda") -> Mesh:
    """A (data x model) mesh over the process group's ranks."""
    return make_mesh((data, model), ("data", "model"), device=device)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production geometry without ranks: 16x16 (data, model), or
    2x16x16 (pod, data, model) with ``multi_pod``."""
    if multi_pod:
        return Mesh({"pod": 2, "data": 16, "model": 16})
    return Mesh({"data": 16, "model": 16})
