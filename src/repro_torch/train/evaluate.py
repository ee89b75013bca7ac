"""Evaluation harness: perplexity and token accuracy over a held-out
stream (the JAX package's ``train/evaluate.py``), deterministic through
the same pipeline seeds."""
from __future__ import annotations

import math
from typing import Dict, Iterable

import torch

from repro_torch.train.steps import batch_to
from repro_torch.tree import leaves

__all__ = ["evaluate", "make_eval_step"]


def make_eval_step(cfg):
    """``step(params, batch)`` -> {"nll_sum", "tokens", "correct"}: the
    teacher-forced NLL and top-1 hits over the labels >= 0, 0-d fp32
    tensors."""
    @torch.no_grad()
    def step(params, batch):
        from repro_torch.models import encdec, transformer
        if cfg.is_encdec:
            lg = encdec.forward(params, cfg, batch)
        else:
            lg = transformer.forward(params, cfg, batch["tokens"],
                                     extra_embeds=batch.get("patches"))
            if cfg.frontend == "vlm":
                lg = lg[:, cfg.frontend_len:]
        labels = batch["labels"]
        mask = labels >= 0
        lab = labels.clamp(min=0).long()
        logp = torch.log_softmax(lg.float(), dim=-1)
        nll = -torch.gather(logp, -1, lab[..., None])[..., 0]
        correct = (torch.argmax(lg, -1) == lab) & mask
        m = mask.float()
        return {"nll_sum": torch.sum(nll * m), "tokens": torch.sum(m),
                "correct": torch.sum(correct.float())}
    return step


def evaluate(params, cfg, batches: Iterable[Dict], max_batches: int = 8
             ) -> Dict[str, float]:
    step = make_eval_step(cfg)
    dev = leaves(params)[0].device
    tot = {"nll_sum": 0.0, "tokens": 0.0, "correct": 0.0}
    for i, b in enumerate(batches):
        if i >= max_batches:
            break
        out = step(params, batch_to(b, dev))
        for k in tot:
            tot[k] += float(out[k])
    nll = tot["nll_sum"] / max(tot["tokens"], 1.0)
    return {"nll": nll, "ppl": float(math.exp(min(nll, 30.0))),
            "token_acc": tot["correct"] / max(tot["tokens"], 1.0),
            "tokens": tot["tokens"]}
