"""Training loop with checkpoint/restart, heartbeats, straggler hooks and a
preemption-safe exit (the JAX package's ``train/trainer.py``).

Restart contract, as there: a run that checkpoints at step k and a new
``Trainer`` that restores from it go on with the same parameters,
optimizer state and batches as one uninterrupted run.  The parameters are
drawn on ``device`` from a ``torch.Generator`` seeded with
``TrainerConfig.seed`` (the JAX package splits a ``PRNGKey`` of that seed).

On a mesh (``mesh=``, a ``launch/mesh.py`` mesh over this process's
rank) the step is the JAX package's sharded train step: every rank draws
the same parameters and builds the same global batch, and lays them out
by ``launch/specs.step_layout`` (the parameters by their axes, the AdamW
state in the ZeRO-1 layout with its step replicated, the batch over the
data axes); the step runs on the ``DTensor``s under the mesh's sharding
context.  A one-rank mesh keeps plain tensors under the context (the
mesh-less step's bits).  Checkpoints gather every leaf and rank 0 writes
them (``ckpt/checkpoint.py``); a restart on the same mesh goes on bitwise.
A preemption signal on any rank stops every rank after the same step
(the guard's flag is reduced over the ranks each step), and rank 0 alone
prints and keeps ``history``.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.ckpt.checkpoint import (latest_step, restore_checkpoint,
                                         save_checkpoint)
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.dtensor import is_dtensor
from repro_torch.ft.fault_tolerance import (HeartbeatMonitor, PreemptionGuard,
                                            StragglerDetector)
from repro_torch.launch.specs import step_layout
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
    replaces the step ``make_train_step`` would build.  ``mesh``: train
    on that mesh's ranks (every rank constructs and runs its own
    ``Trainer`` on the same arguments)."""

    def __init__(self, cfg, tcfg: TrainerConfig,
                 opt_cfg: Optional[AdamWConfig] = None,
                 data_cfg: Optional[DataConfig] = None,
                 step_fn: Optional[Callable] = None,
                 device: Any = "cuda", mesh=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.mesh = mesh
        self.rank = 0
        if mesh is not None:
            if mesh.device is None or mesh.device.type != self.device.type:
                raise ValueError(f"the mesh computes on {mesh.device}, the "
                                 f"Trainer on {self.device}")
            import torch.distributed as dist
            self.rank = dist.get_rank()
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
    def layout(self, rows: int):
        """The mesh train step's layout over ``rows`` batch rows (None
        without a mesh)."""
        if self.mesh is None:
            return None
        return step_layout(self.cfg, "train", self.mesh, rows)

    def init_or_restore(self, rows: Optional[int] = None):
        """(params, optimizer state, first step, pipeline); on a mesh of
        more than one rank the trees laid out for ``rows`` batch rows
        (``data_cfg``'s global batch by default)."""
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        params = api.init_params(self.cfg, gen, device=self.device)
        if self._sharded():
            if rows is None:
                rows = self.data_cfg.global_batch
            p_sh, o_sh, _ = self.layout(rows).shardings
            opt = init_opt_state(params, o_sh)
            params = shd.distribute_tree(params, p_sh)
        else:
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

    def _sharded(self) -> bool:
        """Whether the step runs on ``DTensor``s (a mesh of more than one
        rank)."""
        return self.mesh is not None and self.mesh.size > 1

    def _stop_requested(self) -> bool:
        """The preemption guard's flag, on a mesh of more ranks the
        largest of every rank's: all stop after the same step."""
        if not self._sharded():
            return self.guard.requested
        from repro_torch.distributed.comm import all_reduce
        flag = torch.tensor([int(self.guard.requested)], dtype=torch.int32,
                            device=self.device)
        return bool(all_reduce(flag, None, op="max").item())

    def run(self, batches=None):
        rows = None
        if batches is not None and self.data_cfg is None:
            first = next(batches)
            rows = int(next(iter(first.values())).shape[0])
            batches = itertools.chain([first], batches)
        b_sh = None
        if self.mesh is not None:
            lay = self.layout(rows or self.data_cfg.global_batch)
            b_sh = lay.shardings[2] if self._sharded() else None
            shd.set_context(self.mesh, lay.rules)
        try:
            return self._loop(rows, batches, b_sh)
        finally:
            if self.mesh is not None:
                shd.clear_context()
            self.guard.uninstall()

    def _loop(self, rows, batches, b_sh):
        """The steps, from the fresh or restored trees (made here, so no
        caller holds the first trees while the loop makes new ones)."""
        params, opt, start, pipe = self.init_or_restore(rows)
        assert pipe is not None or batches is not None
        for step in range(start, self.tcfg.total_steps):
            batch = (pipe.next_batch() if pipe is not None
                     else next(batches))
            batch = batch_to(batch, self.device)
            if b_sh is not None:
                batch = shd.distribute_tree(batch, b_sh)
            t0 = time.monotonic()
            params, opt, metrics = self.step_fn(params, opt, batch)
            step_time = time.monotonic() - t0
            self.heartbeat.beat(0, step)
            self.straggler.record(0, step_time)
            if (step + 1) % self.tcfg.log_every == 0 or step == start:
                m = {k: _scalar(v) for k, v in metrics.items()}
                m.update(step=step + 1, step_time_s=round(step_time, 4))
                if self.rank == 0:
                    self.history.append(m)
                    print(f"step {step+1}: loss={m['loss']:.4f} "
                          f"grad_norm={m['grad_norm']:.3f} "
                          f"({step_time:.2f}s)", flush=True)
            stop = self._stop_requested()
            want_ckpt = self.tcfg.ckpt_dir and (
                (step + 1) % self.tcfg.ckpt_every == 0
                or step + 1 == self.tcfg.total_steps
                or stop)
            if want_ckpt:
                save_checkpoint(
                    self.tcfg.ckpt_dir, step + 1,
                    {"params": params, "opt": opt},
                    extra={"data": pipe.state() if pipe else {"step": step + 1}})
            if stop:
                if self.rank == 0:
                    print(f"preemption requested: checkpointed at step "
                          f"{step+1}, exiting cleanly", flush=True)
                break
        return params, opt


def _scalar(v) -> float:
    """A metric as a float (a ``DTensor`` read whole)."""
    return float(v.full_tensor() if is_dtensor(v) else v)
