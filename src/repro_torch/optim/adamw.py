"""AdamW with fp32 master weights and global-norm clipping (the JAX
package's ``optim/adamw.py``).

The state is ``{"step": 0-d int32, "mu", "nu", "master"}``, the last three
fp32 trees of the parameters' structure; the update is functional (new
tensors, the old state untouched), so a step can be retried or compared.
The parameters are the master weights rounded to their own type.
``abstract_opt_state`` is the state of an abstract (``meta``) parameter
tree, nothing allocated, and ``opt_state_axes`` its logical axes, which
``distributed/sharding.zero1_shardings`` binds to the mesh.

On a sharded step (``DTensor`` leaves) each gradient is redistributed to
its moments' ZeRO-1 placements before the update, and the new master to
its parameter's placements after it: the JAX dry-run's ``in_shardings``
/ ``out_shardings`` of the train step.  On plain tensors both are the
identity.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.distributed.dtensor import placed_like, replicated_like
from repro_torch.tree import leaves, tree_map, unflatten_like

__all__ = ["AdamWConfig", "init_opt_state", "abstract_opt_state",
           "opt_state_axes", "adamw_update", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # a function of the 0-d step tensor (``optim/schedules.py``)
    schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


def init_opt_state(params) -> Dict[str, Any]:
    """Zero moments and an fp32 master copy of ``params``; the step counter
    (0-d int32) sits on the first leaf's device."""
    first = leaves(params)[0]
    return {
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
        "mu": tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                             device=x.device), params),
        "nu": tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                             device=x.device), params),
        "master": tree_map(lambda x: x.detach().to(torch.float32,
                                                   copy=True), params),
    }


def abstract_opt_state(abstract_params) -> Dict[str, Any]:
    """The state's ``meta`` mirror: fp32 ``mu`` / ``nu`` / ``master`` of
    the parameters' shapes and a 0-d int32 ``step`` (no allocation)."""
    def f32(t):
        return tree_map(lambda x: torch.empty(x.shape, dtype=torch.float32,
                                              device="meta"), t)
    return {"step": torch.empty((), dtype=torch.int32, device="meta"),
            "mu": f32(abstract_params), "nu": f32(abstract_params),
            "master": f32(abstract_params)}


def opt_state_axes(param_axes_tree) -> Dict[str, Any]:
    """The state's logical axes: the parameters' for the moments and the
    master copy, none for the step."""
    return {"step": (), "mu": param_axes_tree, "nu": param_axes_tree,
            "master": param_axes_tree}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over the leaves (in tree order) of each leaf's fp32
    sum of squares."""
    total = None
    for x in leaves(tree):
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: clip by the global norm, bias-corrected moments,
    decoupled weight decay on the master weights.  Returns (new_params,
    new_state, {"grad_norm", "lr"})."""
    step = state["step"] + 1
    lr = cfg.schedule(step) if cfg.schedule is not None else cfg.lr
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-12), max=1.0)
             if cfg.grad_clip > 0 else 1.0)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()

    def upd(g, mu, nu, master, p):
        g = placed_like(g, mu).float() * scale
        mu = cfg.b1 * mu + (1 - cfg.b1) * g
        nu = cfg.b2 * nu + (1 - cfg.b2) * torch.square(g)
        mhat = mu / b1c
        nhat = nu / b2c
        new_master = master - lr * (mhat / (torch.sqrt(nhat) + cfg.eps)
                                    + cfg.weight_decay * master)
        return mu, nu, new_master, placed_like(new_master, p).to(p.dtype)

    out = [upd(*a) for a in zip(leaves(grads), leaves(state["mu"]),
                                leaves(state["nu"]), leaves(state["master"]),
                                leaves(params))]
    new_state = {"step": step,
                 "mu": unflatten_like(grads, [o[0] for o in out]),
                 "nu": unflatten_like(grads, [o[1] for o in out]),
                 "master": unflatten_like(grads, [o[2] for o in out])}
    new_params = unflatten_like(grads, [o[3] for o in out])
    return new_params, new_state, {
        "grad_norm": gnorm,
        "lr": lr * replicated_like(torch.ones((), device=step.device), step)}

