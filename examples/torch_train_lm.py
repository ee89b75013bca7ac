"""End-to-end training on the port with checkpoint/restart: trains an LM
on the deterministic synthetic pipeline to the midpoint, checkpointing,
then a new ``Trainer`` restores from disk and finishes the run, and the
loss must have fallen across the boundary.

    PYTHONPATH=src python examples/torch_train_lm.py --arch qwen3-4b \\
        --steps 200 [--device cpu]
"""
import argparse
import shutil
import tempfile

from repro_torch.configs.registry import arch_names, get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.train.trainer import Trainer, TrainerConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", choices=arch_names())
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    args = ap.parse_args()

    cfg = get_config(args.arch, reduced=True)
    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    data = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch, frontend=cfg.frontend,
                      frontend_len=cfg.frontend_len, d_model=cfg.d_model)
    opt = AdamWConfig(lr=1e-3, schedule=warmup_cosine(1e-3, 20, args.steps))

    # phase 1: train to the midpoint, checkpointing
    half = args.steps // 2
    t1 = Trainer(cfg, TrainerConfig(total_steps=half, ckpt_dir=ckpt_dir,
                                    ckpt_every=max(half // 2, 1),
                                    log_every=20), opt_cfg=opt,
                 data_cfg=data, device=args.device)
    t1.run()
    first_loss = t1.history[0]["loss"]

    # phase 2: a NEW trainer restores from disk and finishes the run, the
    # node-failure recovery path
    t2 = Trainer(cfg, TrainerConfig(total_steps=args.steps,
                                    ckpt_dir=ckpt_dir, ckpt_every=half,
                                    log_every=20),
                 opt_cfg=opt, data_cfg=data, device=args.device)
    t2.run()
    final_loss = t2.history[-1]["loss"]
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(f"\nloss {first_loss:.3f} -> {final_loss:.3f} across a "
          f"checkpoint/restart boundary")
    assert final_loss < first_loss, "loss did not improve"
    print("OK: loss fell and training survived the restart")


if __name__ == "__main__":
    main()
