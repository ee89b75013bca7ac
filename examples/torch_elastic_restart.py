"""Fault-tolerance demo on the port: heartbeat failure detection ->
elastic re-mesh -> restart from a checkpoint with the data cursor exact
(the JAX package's ``examples/elastic_restart.py``).

Simulates the 1000-node operational loop in one process:
  1. train with checkpoints;
  2. a worker goes silent (heartbeat timeout) mid-run -> declared dead;
  3. the elastic planner re-solves the mesh for the surviving devices,
     keeping the TP degree and the exact global batch
     (dp x per_dev x accum);
  4. a fresh ``Trainer`` restores the last committed checkpoint, with
     the plan's gradient accumulation as its microbatches, and finishes.

    PYTHONPATH=src python examples/torch_elastic_restart.py [--device cpu]

Each phase is a function of its own (``train_with_checkpoints``,
``phase_control_plane``, ``replan``, ``restart_trainer``), so a caller
can drive it at another size: ``chip_smoke.py``'s ``[elastic]`` feeds
the control plane a two-rank run's beats and restarts zamba2-1.2b's
two-rank checkpoint on the survivor's mesh.
"""
import argparse
import shutil
import tempfile

from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.ft.fault_tolerance import (HeartbeatMonitor,
                                            solve_elastic_mesh)
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

ARCH = "qwen3-4b"
SEQ_LEN, GLOBAL_BATCH, LR = 48, 8, 1e-3
FIRST_STEPS, LAST_STEPS, CKPT_EVERY, LOG_EVERY = 30, 60, 10, 10
N_RANKS, DEAD_RANK, TIMEOUT_S = 512, 217, 60.0
# losing rank 217 takes its host's 4 chips: 512 -> 508 available
AVAILABLE, MODEL_PARALLEL, PLAN_BATCH = 508, 16, 256


def setup():
    """(reduced qwen3-4b, its 8 x 48 token pipeline, AdamW at lr 1e-3)."""
    cfg = get_config(ARCH, reduced=True)
    data = DataConfig(vocab=cfg.vocab, seq_len=SEQ_LEN,
                      global_batch=GLOBAL_BATCH)
    return cfg, data, AdamWConfig(lr=LR)


def train_with_checkpoints(cfg, data, opt, ckpt_dir, device,
                           total_steps=FIRST_STEPS, ckpt_every=CKPT_EVERY):
    """Phase 1: train to ``total_steps``, a checkpoint every
    ``ckpt_every`` into ``ckpt_dir`` (from the newest one there, if
    any).  Returns the ``Trainer`` (its ``history``)."""
    t = Trainer(cfg, TrainerConfig(total_steps=total_steps,
                                   ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                                   log_every=LOG_EVERY),
                opt_cfg=opt, data_cfg=data, device=device)
    t.run()
    return t


def phase_control_plane(n_ranks=N_RANKS, dead_rank=DEAD_RANK,
                        step=FIRST_STEPS, timeout_s=TIMEOUT_S, beats=()):
    """Phase 2: ``HeartbeatMonitor`` on an injected clock.  ``beats``, a
    run's own (seconds, rank, step) beats, arrive first; from the latest
    of them every rank beats ``step``, then at 1.5 x ``timeout_s`` every
    rank but ``dead_rank`` beats ``step + 1``, and at 7/3 x ``timeout_s``
    (the demo's 140 s at 60: the live ranks silent 50 s, the dead one
    140 s) the monitor is asked.  Returns its dead ranks."""
    clock = [0.0]
    mon = HeartbeatMonitor(n_ranks=n_ranks, timeout_s=timeout_s,
                           clock=lambda: clock[0])
    for t, rank, s in sorted(beats):
        clock[0] = t
        mon.beat(rank, s)
    start = clock[0]
    for r in range(n_ranks):
        mon.beat(r, step)
    clock[0] = start + 1.5 * timeout_s
    for r in range(n_ranks):
        if r != dead_rank:
            mon.beat(r, step + 1)
    clock[0] = start + timeout_s * 7 / 3
    return mon.dead_ranks()


def replan(available=AVAILABLE, model_parallel=MODEL_PARALLEL,
           global_batch=PLAN_BATCH, max_per_device_batch=64):
    """Phase 3: the mesh for the survivors, the TP degree and the global
    batch kept (asserted)."""
    plan = solve_elastic_mesh(available_devices=available,
                              model_parallel=model_parallel,
                              global_batch=global_batch,
                              max_per_device_batch=max_per_device_batch)
    assert plan.mesh_shape[1] == model_parallel              # TP preserved
    assert (plan.mesh_shape[0] * plan.per_device_batch
            * plan.grad_accum) == global_batch               # batch preserved
    return plan


def plan_line(plan, available=AVAILABLE):
    return (f"elastic plan: mesh {plan.mesh_shape} ({plan.devices_used} of "
            f"{available} devices, {plan.dropped_devices} idle), "
            f"per-device batch {plan.per_device_batch} x accum "
            f"{plan.grad_accum}")


def restart_trainer(plan, cfg, data, opt, ckpt_dir, device,
                    total_steps=LAST_STEPS, ckpt_every=LAST_STEPS // 2,
                    log_every=LOG_EVERY, mesh=False, **tcfg):
    """Phase 4: a fresh ``Trainer`` that restores the newest committed
    checkpoint in ``ckpt_dir`` and runs to ``total_steps``, each step's
    batch split into the plan's ``grad_accum`` microbatches.  ``mesh``:
    train on ``make_local_mesh(*plan.mesh_shape)`` over the process
    group's ranks (one started here if none runs); ``tcfg``: the other
    ``TrainerConfig`` fields."""
    if data.global_batch % plan.grad_accum:
        raise ValueError(f"a global batch of {data.global_batch} does not "
                         f"split into {plan.grad_accum} microbatches")
    on = None
    if mesh:
        from repro_torch.launch.mesh import make_local_mesh
        on = make_local_mesh(*plan.mesh_shape, device=device)
    return Trainer(cfg, TrainerConfig(total_steps=total_steps,
                                      ckpt_dir=ckpt_dir,
                                      ckpt_every=ckpt_every,
                                      log_every=log_every,
                                      n_micro=plan.grad_accum, **tcfg),
                   opt_cfg=opt, data_cfg=data, device=device, mesh=on)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    args = ap.parse_args(argv)
    cfg, data, opt = setup()
    ckpt = tempfile.mkdtemp(prefix="repro_torch_elastic_")
    try:
        # --- phase 1: run to step 30 with checkpoints every 10 ----------
        t1 = train_with_checkpoints(cfg, data, opt, ckpt, args.device)

        # --- phase 2: control plane: a rank goes silent ------------------
        dead = phase_control_plane()
        print(f"heartbeat monitor: dead ranks = {dead}")
        assert dead == [DEAD_RANK]

        # --- phase 3: elastic re-plan for the survivors ------------------
        plan = replan()
        print(plan_line(plan))

        # --- phase 4: restart from the checkpoint and finish -------------
        t2 = restart_trainer(plan, cfg, data, opt, ckpt, args.device)
        t2.run()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    # restored from step 30: the next step logged is 31
    assert t2.history[0]["step"] == FIRST_STEPS + 1
    first = t1.history[0]["loss"]
    last = t2.history[-1]["loss"]
    print(f"\nloss {first:.3f} -> {last:.3f} across failure + re-mesh + "
          f"restart")
    assert last < first
    print("OK: survived the failure with exact data-cursor resume")


if __name__ == "__main__":
    main()
