"""Training launcher (the JAX package's ``launch/train.py``)::

    python -m repro_torch.launch.train --arch zamba2-1.2b --device cpu
    python -m repro_torch.launch.train --arch zamba2-1.2b --full \\
        --batch 4 --seq 1024 --steps 6 --remat full --ckpt-dir ckpt

The reduced config by default; ``--full`` is the published widths (on the
card; zamba2 at B=4 x 1024 needs ``--remat full`` beside its AdamW
state).  Batches come from the synthetic ``TokenPipeline``, the learning
rate warms up and decays on a cosine, and with ``--ckpt-dir`` the run
checkpoints every ``--ckpt-every`` steps and resumes from the newest
checkpoint there.  Prints a line per logged step (the first, then every
tenth) and, last, a JSON summary (the logged steps, the first and last
logged loss, seconds).

``--mesh DATAxMODEL`` trains on a ``launch/mesh.py`` mesh, one process a
rank (``Trainer(mesh=)``: the JAX package's sharded train step on
``DTensor``s): a 1x1 mesh starts its own one-rank group, a larger one
joins the group its launcher (``torchrun``) set up through the
``env://`` variables, over ``pick_backend``'s backend (NCCL when each
rank has a card of its own, gloo on the CPU or when ranks share a card).
Rank 0 prints the step lines and the summary.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

from repro_torch.configs.registry import arch_names, get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.mesh import mesh_from_flag, rank
from repro_torch.models.settings import REMAT_MODES
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=arch_names())
    ap.add_argument("--full", action="store_true",
                    help="use the full config (on the card)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--remat", default="none", choices=REMAT_MODES)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default="",
                    help='optional "DATAxMODEL" mesh, e.g. "2x1" (one '
                         "process a rank)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=not args.full)
    opt = AdamWConfig(lr=args.lr,
                      schedule=warmup_cosine(args.lr, args.warmup,
                                             args.steps))
    data = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch, seed=args.seed,
                      frontend=cfg.frontend, frontend_len=cfg.frontend_len,
                      d_model=cfg.d_model)
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every, remat=args.remat,
                         n_micro=args.n_micro, seed=args.seed)
    mesh = mesh_from_flag(args.mesh, args.device)
    trainer = Trainer(cfg, tcfg, opt_cfg=opt, data_cfg=data,
                      device=args.device, mesh=mesh)
    t0 = time.perf_counter()
    trainer.run()
    hist = trainer.history
    summary = {"arch": cfg.name, "device": str(trainer.device),
               "mesh": None if mesh is None else dict(mesh.shape),
               "steps_logged": [h["step"] for h in hist],
               "first_loss": hist[0]["loss"] if hist else None,
               "last_loss": hist[-1]["loss"] if hist else None,
               "seconds": time.perf_counter() - t0}
    if rank() == 0:
        print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
