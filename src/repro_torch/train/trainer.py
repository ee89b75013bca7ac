"""Training loop with checkpoint/restart, heartbeats, straggler hooks and a
preemption-safe exit (the JAX package's ``train/trainer.py``).

Restart contract, as there: a run that checkpoints at step k and a new
``Trainer`` that restores from it go on with the same parameters,
optimizer state and batches as one uninterrupted run.  The parameters are
drawn on ``device`` from a ``torch.Generator`` seeded with
``TrainerConfig.seed`` (the JAX package splits a ``PRNGKey`` of that seed).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.ckpt.checkpoint import (latest_step, restore_checkpoint,
                                         save_checkpoint)
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.ft.fault_tolerance import (HeartbeatMonitor, PreemptionGuard,
                                            StragglerDetector)
from repro_torch.models import api
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.train.steps import batch_to, make_train_step

__all__ = ["TrainerConfig", "Trainer"]


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10
    seed: int = 0
    n_micro: int = 1
    remat: str = "none"
    aux_coef: float = 0.01


class Trainer:
    """``run()`` trains ``cfg`` from fresh parameters, or from the newest
    checkpoint in ``tcfg.ckpt_dir``, up to ``tcfg.total_steps``; the batches
    come from ``TokenPipeline(data_cfg)`` (its cursor restored with the
    checkpoint) or from the iterator passed to ``run``.  ``step_fn``
    replaces the step ``make_train_step`` would build."""

    def __init__(self, cfg, tcfg: TrainerConfig,
                 opt_cfg: Optional[AdamWConfig] = None,
                 data_cfg: Optional[DataConfig] = None,
                 step_fn: Optional[Callable] = None,
                 device: Any = "cuda"):
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.opt_cfg = opt_cfg or AdamWConfig()
        self.data_cfg = data_cfg
        self.step_fn = step_fn or make_train_step(
            cfg, self.opt_cfg, aux_coef=tcfg.aux_coef,
            n_micro=tcfg.n_micro, remat=tcfg.remat)
        self.guard = PreemptionGuard().install()
        self.heartbeat = HeartbeatMonitor(n_ranks=1)
        self.straggler = StragglerDetector(n_ranks=1)
        self.history: list = []

    # ------------------------------------------------------------------
    def init_or_restore(self):
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        params = api.init_params(self.cfg, gen, device=self.device)
        opt = init_opt_state(params)
        start = 0
        data_state = {"step": 0}
        if self.tcfg.ckpt_dir and latest_step(self.tcfg.ckpt_dir) is not None:
            tree = {"params": params, "opt": opt}
            tree, start, extra = restore_checkpoint(self.tcfg.ckpt_dir, tree)
            params, opt = tree["params"], tree["opt"]
            data_state = extra.get("data", {"step": start})
        pipe = None
        if self.data_cfg is not None:
            pipe = TokenPipeline(self.data_cfg)
            pipe.restore(data_state)
        return params, opt, start, pipe

    def run(self, batches=None):
        params, opt, start, pipe = self.init_or_restore()
        assert pipe is not None or batches is not None
        for step in range(start, self.tcfg.total_steps):
            batch = (pipe.next_batch() if pipe is not None
                     else next(batches))
            batch = batch_to(batch, self.device)
            t0 = time.monotonic()
            params, opt, metrics = self.step_fn(params, opt, batch)
            step_time = time.monotonic() - t0
            self.heartbeat.beat(0, step)
            self.straggler.record(0, step_time)
            if (step + 1) % self.tcfg.log_every == 0 or step == start:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(step=step + 1, step_time_s=round(step_time, 4))
                self.history.append(m)
                print(f"step {step+1}: loss={m['loss']:.4f} "
                      f"grad_norm={m['grad_norm']:.3f} "
                      f"({step_time:.2f}s)", flush=True)
            want_ckpt = self.tcfg.ckpt_dir and (
                (step + 1) % self.tcfg.ckpt_every == 0
                or step + 1 == self.tcfg.total_steps
                or self.guard.requested)
            if want_ckpt:
                save_checkpoint(
                    self.tcfg.ckpt_dir, step + 1,
                    {"params": params, "opt": opt},
                    extra={"data": pipe.state() if pipe else {"step": step + 1}})
            if self.guard.requested:
                print(f"preemption requested: checkpointed at step "
                      f"{step+1}, exiting cleanly", flush=True)
                break
        self.guard.uninstall()
        return params, opt
