"""The train step: loss -> grads -> AdamW, with optional microbatch
gradient accumulation, remat policy and int8 gradient compression (the
JAX package's ``train/steps.py``).

The step runs eagerly: the forward and the autograd backward go through
the model's ops (the conv1d kernel on the card, in the forward and in the
backward's dx), then ``optim/adamw.py`` updates a new parameter tree.
The parameters and the optimizer state passed in are not changed.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import api
from repro_torch.models.settings import attn_impl as attn_ctx
from repro_torch.models.settings import remat as remat_ctx
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.tree import leaves, unflatten_like

__all__ = ["make_train_step", "lm_grads", "batch_to"]


def batch_to(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return {k: (torch.from_numpy(np.asarray(v)) if not isinstance(
        v, torch.Tensor) else v).to(device) for k, v in batch.items()}


def lm_grads(params, cfg, batch: Dict[str, torch.Tensor], *,
             aux_coef: float = 0.01
             ) -> Tuple[Dict[str, torch.Tensor], Any]:
    """``api.lm_loss`` at ``params`` and its gradient: (metrics {"loss",
    "aux_loss"}, grads, a tree of ``params``' structure, each leaf in its
    parameter's type).  The parameters are taken as new autograd leaves
    (no copy); a parameter the loss does not read gets zeros, as
    ``jax.grad`` gives it."""
    live = [t.detach().requires_grad_(True) for t in leaves(params)]
    total, metrics = api.lm_loss(unflatten_like(params, live), cfg, batch,
                                 aux_coef=aux_coef)
    grads = torch.autograd.grad(total, live, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, live)]
    return ({k: v.detach() for k, v in metrics.items()},
            unflatten_like(params, grads))


def make_train_step(cfg, opt_cfg: Optional[AdamWConfig] = None, *,
                    aux_coef: float = 0.01,
                    n_micro: int = 1,
                    remat: str = "none",
                    attn_impl: str = "naive",
                    compress_grads: bool = False
                    ) -> Callable:
    """Build ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``batch`` holds tensors (or numpy arrays) of the global
    batch, moved to the parameters' device.

    ``n_micro`` > 1 splits the batch into that many microbatches along its
    first axis and accumulates their fp32 grads (and metrics), divided by
    ``n_micro``, as the JAX package's ``lax.scan`` does.  ``remat`` is the
    checkpoint policy of ``models/settings.py`` and ``attn_impl`` the
    attention implementation, each set for the step; ``compress_grads``
    round-trips the grads through int8 (``distributed/compression.py``)
    before the update.
    """
    opt_cfg = opt_cfg or AdamWConfig()

    def step(params, opt_state, batch):
        batch = batch_to(batch, leaves(params)[0].device)
        with remat_ctx(remat), attn_ctx(attn_impl):
            if n_micro == 1:
                metrics, grads = lm_grads(params, cfg, batch,
                                          aux_coef=aux_coef)
            else:
                rows = next(iter(batch.values())).shape[0] // n_micro
                dev = leaves(params)[0].device
                g_acc = [torch.zeros(t.shape, dtype=torch.float32,
                                     device=t.device)
                         for t in leaves(params)]
                metrics = {k: torch.zeros((), dtype=torch.float32,
                                          device=dev)
                           for k in ("loss", "aux_loss")}
                for i in range(n_micro):
                    mb = {k: v[i * rows:(i + 1) * rows]
                          for k, v in batch.items()}
                    m, g = lm_grads(params, cfg, mb, aux_coef=aux_coef)
                    g_acc = [a + b.float() for a, b in zip(g_acc, leaves(g))]
                    metrics = {k: metrics[k] + m[k] for k in metrics}
                grads = unflatten_like(params, [g / n_micro for g in g_acc])
                metrics = {k: v / n_micro for k, v in metrics.items()}
        if compress_grads:
            from repro_torch.distributed.compression import int8_roundtrip
            grads = int8_roundtrip(grads)
        new_params, new_opt, opt_m = adamw_update(params, grads, opt_state,
                                                  opt_cfg)
        return new_params, new_opt, dict(metrics, **opt_m)

    return step
