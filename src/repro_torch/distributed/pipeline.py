"""Pipeline parallelism over the ``pod`` axis: the GPipe fill-drain
schedule (the JAX package's ``distributed/pipeline.py``).

Each stage rank owns ``n_layers / n_stages`` contiguous layers of a
stacked block tree; activations move stage -> stage + 1 with a ``send``
/ ``recv`` of their bytes between neighbouring ranks, microbatched so the
bubble is (n_stages - 1) / (n_micro + n_stages - 1) of the ticks.  Within
a stage the layers run as in the model.

``make_pipelined_stack(mesh=None)`` is the sequential emulation (every
stage in turn, in one process: what the mesh path must equal bit for
bit); with a mesh it runs ``pipeline_apply`` over the mesh's stage axis,
one rank a stage.
"""
from __future__ import annotations

from typing import Callable, List

import torch

from repro_torch.tree import leaves, tree_map

__all__ = ["gpipe_schedule", "pipeline_apply", "split_stages",
           "make_pipelined_stack"]


def split_stages(stacked_params, n_stages: int):
    """Split a layer-stacked param tree into n_stages contiguous chunks on
    a leading stage axis: (L, ...) -> (S, L/S, ...) (views, no copy)."""
    def one(a):
        n = a.shape[0]
        if n % n_stages:
            raise ValueError(f"{n} layers do not split into {n_stages} "
                             "stages")
        return a.reshape(n_stages, n // n_stages, *a.shape[1:])
    return tree_map(one, stacked_params)


def gpipe_schedule(n_micro: int, n_stages: int) -> List[List[int]]:
    """(tick, stage) -> microbatch index processed (or -1 = bubble)."""
    ticks = n_micro + n_stages - 1
    return [[t - s if 0 <= t - s < n_micro else -1
             for s in range(n_stages)] for t in range(ticks)]


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bits as int32 (sign-extended for a 2-byte type)."""
    if t.element_size() == 4:
        return t.view(torch.int32)
    if t.element_size() == 2:
        return t.view(torch.int16).to(torch.int32)
    raise TypeError(f"no bit reduction for {t.dtype}")


def _from_bits(b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if torch.empty((), dtype=dtype).element_size() == 4:
        return b.view(dtype)
    return b.to(torch.int16).view(dtype)


def pipeline_apply(stage_fn: Callable, stage_params, x_micro: torch.Tensor,
                   *, n_stages: int, mesh, axis_name: str = "pod"
                   ) -> torch.Tensor:
    """Run the GPipe schedule on this rank's stage of ``mesh``'s
    ``axis_name``.

    stage_fn(params_slice, act) -> act : applies one stage's layers.
    stage_params : this rank's stage of the layers.
    x_micro : (n_micro, mb, T, D) input activations — only stage 0 reads
        them; the other stages receive from their left neighbour.

    Returns the (n_micro, mb, T, D) outputs on every stage: the last
    stage's, replicated by the closing all-reduce.  That reduction adds
    the outputs' bits as int32, every other stage contributing zeros, so
    the sum is the last stage's outputs bit for bit (a float sum would
    turn a -0.0 into +0.0).
    """
    from repro_torch.distributed.comm import all_reduce, recv, send
    if mesh.shape.get(axis_name) != n_stages:
        raise ValueError(f"mesh axis {axis_name!r} has "
                         f"{mesh.shape.get(axis_name)} ranks, the pipeline "
                         f"{n_stages} stages")
    group = mesh.group(axis_name)
    stage = mesh.axis_index(axis_name)
    n_micro = x_micro.shape[0]
    outs = torch.zeros_like(x_micro)
    act = None
    for t in range(n_micro + n_stages - 1):
        mb = t - stage                         # microbatch at this stage
        if not 0 <= mb < n_micro:
            continue                           # a bubble
        src = x_micro[mb] if stage == 0 else recv(x_micro[0], stage - 1,
                                                  group)
        act = stage_fn(stage_params, src)
        if stage < n_stages - 1:
            send(act, stage + 1, group)
        else:
            outs[mb] = act
    return _from_bits(all_reduce(_bits(outs), group, "sum"), outs.dtype)


def _stage(tree, s: int):
    return tree_map(lambda a: a[s], tree)


def make_pipelined_stack(cfg, layer_fn: Callable, *, n_stages: int,
                         mesh=None, axis_name: str = "pod"):
    """A pipelined version of a homogeneous layer stack.

    layer_fn(lp, x) -> x : one layer (the model's loop body).
    Returns run(stacked_params, x_micro):
      * mesh=None  — the sequential emulation (every stage in turn);
      * mesh given — ``pipeline_apply`` over ``axis_name``, this rank's
        stage of ``stacked_params``.
    """
    def stage_fn(params_slice, act):
        for i in range(leaves(params_slice)[0].shape[0]):
            act = layer_fn(_stage(params_slice, i), act)
        return act

    if mesh is None:
        def run_seq(stacked_params, x_micro):
            staged = split_stages(stacked_params, n_stages)
            outs = []
            for m in range(x_micro.shape[0]):
                act = x_micro[m]
                for s in range(n_stages):
                    act = stage_fn(_stage(staged, s), act)
                outs.append(act)
            return torch.stack(outs)
        return run_seq

    def run_mesh(stacked_params, x_micro):
        staged = split_stages(stacked_params, n_stages)
        local = _stage(staged, mesh.axis_index(axis_name))
        return pipeline_apply(stage_fn, local, x_micro, n_stages=n_stages,
                              mesh=mesh, axis_name=axis_name)
    return run_mesh

