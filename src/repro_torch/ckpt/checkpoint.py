"""Atomic checkpoints with exact resume, in the JAX package's on-disk
format (``ckpt/checkpoint.py``), so a checkpoint written by either package
restores in the other bit for bit.

Layout (one directory per step):

    <dir>/step_000000120/
        meta.json                 step, the bf16 leaves' keys, extra
        arrays/<leaf-path>.npy    one file per leaf, the key path joined
                                  by "__" (bf16 saved as its uint16 view)
        COMMIT                    written last: a checkpoint without it is
                                  torn and ignored

The tree is written to ``.tmp_step_*`` and renamed into place, which is
atomic on POSIX.  Leaves are walked in ``jax.tree_util``'s order (a dict's
keys sorted), so the key paths are the JAX package's.  Restart contract:
save at step k, restore, and the parameters and optimizer state are the
saved ones bitwise, and the data pipeline's cursor (in ``extra``) replays
batch k + 1 next.

A tree of ``DTensor`` leaves (a mesh run's parameters and ZeRO-1 state)
is saved by every rank together: each leaf is gathered whole
(``full_tensor``), rank 0 alone writes, and every rank waits on a barrier
before the call returns.  The files are those of a one-rank save of the
full tree, byte for byte, so a mesh checkpoint restores on one rank and
in the JAX package.  ``restore_checkpoint`` reads the full arrays on
every rank and lays each out as the ``DTensor`` leaf of ``tree_like``
is laid out (each rank keeps its own slice; nothing crosses ranks).
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.dtensor import is_dtensor
from repro_torch.tree import leaves_with_path, unflatten_like

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "cleanup_old"]

_SEP = "__"


def _flatten(tree) -> List[Tuple[str, Any]]:
    return [(_SEP.join(str(k) for k in path), leaf)
            for path, leaf in leaves_with_path(tree)]


def _to_numpy(leaf) -> Tuple[np.ndarray, bool]:
    """(the array to save, whether it is a bf16 leaf's uint16 view)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), True
        return t.numpy(), False
    return np.asarray(leaf), False


def _writer() -> bool:
    """Whether this process writes a checkpoint of ``DTensor`` leaves:
    rank 0 of the process group."""
    import torch.distributed as dist
    return dist.get_rank() == 0


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[Dict] = None,
                    keep: int = 3) -> Path:
    """Write ``tree`` (tensors on any device, or arrays) as step ``step``,
    with ``extra`` (JSON) in its meta, then keep the newest ``keep``
    committed steps.  A tree with ``DTensor`` leaves is saved by every
    rank of the process group: each leaf gathered in turn, rank 0
    writing, all ranks leaving together (a barrier)."""
    flat = _flatten(tree)
    sharded = any(is_dtensor(leaf) for _, leaf in flat)
    base = Path(directory)
    final = base / f"step_{step:09d}"
    if sharded and not _writer():
        for _, leaf in flat:                # the gathers rank 0 runs
            if is_dtensor(leaf):
                leaf.full_tensor()
        _barrier()
        return final
    tmp = base / f".tmp_step_{step:09d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    (tmp / "arrays").mkdir(parents=True)
    bf16_keys = []
    for key, leaf in flat:
        arr, bf16 = _to_numpy(leaf.full_tensor() if is_dtensor(leaf)
                              else leaf)
        if bf16:
            bf16_keys.append(key)
        np.save(tmp / "arrays" / f"{key}.npy", arr)
    meta = {"step": step, "bf16_keys": bf16_keys, "extra": extra or {}}
    (tmp / "meta.json").write_text(json.dumps(meta))
    (tmp / "COMMIT").write_text("ok")       # commit marker last
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                        # atomic on POSIX
    cleanup_old(directory, keep=keep)
    if sharded:
        _barrier()
    return final


def _barrier() -> None:
    import torch.distributed as dist
    dist.barrier()


def latest_step(directory: str) -> Optional[int]:
    base = Path(directory)
    if not base.exists():
        return None
    steps = sorted(int(p.name.split("_")[1]) for p in base.glob("step_*")
                   if (p / "COMMIT").exists())
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, tree_like: Any,
                       step: Optional[int] = None
                       ) -> Tuple[Any, int, Dict]:
    """Restore into the structure of ``tree_like`` (values ignored): each
    leaf a tensor of the saved type on the device of ``tree_like``'s leaf
    (the CPU for a leaf that is not a tensor), a ``DTensor`` leaf's as a
    ``DTensor`` of the same mesh and placements holding this rank's
    slice.  Returns (tree, step, extra)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    d = Path(directory) / f"step_{step:09d}"
    if not (d / "COMMIT").exists():
        raise FileNotFoundError(f"checkpoint {d} is torn (no COMMIT)")
    meta = json.loads((d / "meta.json").read_text())
    bf16 = set(meta.get("bf16_keys", []))
    vals = []
    for key, like in _flatten(tree_like):
        arr = np.load(d / "arrays" / f"{key}.npy")
        if key in bf16:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if is_dtensor(like):
            vals.append(_laid_out_like(t, like))
            continue
        dev = like.device if isinstance(like, torch.Tensor) else "cpu"
        vals.append(t.to(dev))
    return unflatten_like(tree_like, vals), step, meta.get("extra", {})


def _laid_out_like(full: torch.Tensor, like) -> torch.Tensor:
    """``full`` as a ``DTensor`` laid out as ``like``: this rank's slice
    of it, on ``like``'s local device, under ``like``'s mesh and
    placements."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    if tuple(full.shape) != tuple(like.shape):
        raise ValueError(f"a saved leaf of shape {tuple(full.shape)} for "
                         f"one of {tuple(like.shape)}")
    shape, offset = compute_local_shape_and_global_offset(
        full.shape, like.device_mesh, like.placements)
    local = full[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
    return DTensor.from_local(
        local.to(like.to_local().device, copy=True).contiguous(),
        like.device_mesh, like.placements, run_check=False,
        shape=full.shape, stride=full.stride())


def cleanup_old(directory: str, keep: int = 3) -> None:
    base = Path(directory)
    steps = sorted((int(p.name.split("_")[1]), p)
                   for p in base.glob("step_*") if (p / "COMMIT").exists())
    for _, p in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(p)
    for p in base.glob(".tmp_step_*"):      # torn writes
        shutil.rmtree(p)
