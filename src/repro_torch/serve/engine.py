"""Batched token serving: a continuous-batching request queue over the
decode step (the JAX package's ``serve/engine.py``, whose behaviour it
keeps exactly, its quirks included).

Slots model continuous batching at a fixed batch width: a slot is free or
holds a request; a decode step advances every row of the batch; finished
slots are refilled from the queue.  Per-slot positions live on the host,
the cache on the device.  As in the JAX engine:

* a slot is prefilled by stepping its prompt through the *decode* step
  (never the prefill step, so serving launches no conv1d kernel);
* each of those decode calls advances every batch row: while slot j
  prefills, the other rows' Mamba2 state and conv tail advance and their
  KV cache is written at ``pos[j]``;
* a refilled slot keeps the previous request's recurrent state (its
  position is reset; no state is cleared);
* a step runs every slot at ``pos = max(pos[active])``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.serve.steps import make_decode_step

__all__ = ["Request", "BatchEngine", "token_serving_summary"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray             # (S,) int32
    max_new_tokens: int = 16
    output: Optional[List[int]] = None
    done: bool = False


class BatchEngine:
    """``params`` lie on ``device`` already.  ``prefill_s`` and
    ``decode_s`` sum the host time of the prompt-stepping decode calls and
    of the engine's decode steps (each ends reading the next tokens back,
    so the device work is inside)."""

    def __init__(self, cfg, params, *, batch: int, max_len: int,
                 cache_dtype: torch.dtype = torch.bfloat16,
                 device: Any = "cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.batch = batch
        self.max_len = max_len
        self.cache = api.init_cache(cfg, batch, max_len, dtype=cache_dtype,
                                    device=self.device)
        self.decode = make_decode_step(cfg)
        self.pos = np.zeros(batch, np.int32)          # next write index
        self.slots: List[Optional[Request]] = [None] * batch
        self.tokens = np.zeros(batch, np.int32)       # last token per slot
        self.queue: List[Request] = []
        self.prefill_s = self.decode_s = 0.0
        self.prefill_calls = self.decode_steps = 0

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        req.output = []
        self.queue.append(req)

    def _token_vec(self) -> torch.Tensor:
        return torch.from_numpy(self.tokens.astype(np.int64)).to(self.device)

    def _prefill_one(self, slot: int, req: Request) -> None:
        """Prefill a single slot by stepping its prompt through decode."""
        t0 = time.perf_counter()
        for tok in req.prompt:
            tok_vec = self._token_vec()
            tok_vec[slot] = int(tok)
            nxt, _, self.cache = self.decode(
                self.params, tok_vec, self.cache, int(self.pos[slot]))
            self.tokens[slot] = int(nxt[slot].item())
            self.pos[slot] += 1
            self.prefill_calls += 1
        self.prefill_s += time.perf_counter() - t0

    def _refill(self) -> None:
        for slot in range(self.batch):
            if self.slots[slot] is None and self.queue:
                req = self.queue.pop(0)
                self.slots[slot] = req
                self.pos[slot] = 0
                self._prefill_one(slot, req)

    # ------------------------------------------------------------------
    def step(self) -> int:
        """One decode step over all active slots; returns #active."""
        self._refill()
        active = [s for s in range(self.batch) if self.slots[s] is not None]
        if not active:
            return 0
        # one position for the whole batch: the largest active one
        t0 = time.perf_counter()
        pos = int(self.pos[active].max())
        nxt, _, self.cache = self.decode(self.params, self._token_vec(),
                                         self.cache, pos)
        nxt = nxt.cpu().numpy()
        self.decode_s += time.perf_counter() - t0
        self.decode_steps += 1
        for s in active:
            req = self.slots[s]
            req.output.append(int(nxt[s]))
            self.tokens[s] = int(nxt[s])
            self.pos[s] += 1
            if (len(req.output) >= req.max_new_tokens
                    or self.pos[s] >= self.max_len):
                req.done = True
                self.slots[s] = None
        return len(active)

    def run(self, max_steps: int = 10_000) -> None:
        steps = 0
        while (self.queue or any(s is not None for s in self.slots)) \
                and steps < max_steps:
            self.step()
            steps += 1


def token_serving_summary(arch: str = "zamba2-1.2b", *, full: bool = False,
                          batch: int = 4, max_len: int = 64,
                          prompt_len: int = 8, new_tokens: int = 12,
                          requests: int = 8, seed: int = 0,
                          device: Any = "cuda") -> dict:
    """Serve ``requests`` random prompts through a ``BatchEngine`` over
    random weights from ``seed`` (the bf16 policy; ``full`` for the
    published widths, else ``reduced()``) and return what it did: requests
    done and lost, tokens, tokens/s, and the time of the prompt-stepping
    decode calls (``prefill_ms``) and of the engine's decode steps."""
    dev = resolve_device(device)
    cfg = get_config(arch, reduced=not full)
    params = api.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    engine = BatchEngine(cfg, params, batch=batch, max_len=max_len,
                         device=dev)
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, prompt_len,
                                               dtype=np.int32),
                    max_new_tokens=new_tokens) for i in range(requests)]
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    engine.run()
    elapsed = time.perf_counter() - t0
    done = sum(r.done for r in reqs)
    toks = sum(len(r.output) for r in reqs)
    return {
        "arch": cfg.name, "device": str(dev), "batch": batch,
        "max_len": max_len, "prompt_len": prompt_len,
        "new_tokens": new_tokens, "requests": requests,
        "requests_done": done, "requests_lost": requests - done,
        "tokens": toks, "elapsed_s": elapsed, "tokens_per_s": toks / elapsed,
        "prefill_calls": engine.prefill_calls,
        "prefill_ms": 1e3 * engine.prefill_s,
        "decode_steps": engine.decode_steps,
        "decode_step_ms": 1e3 * engine.decode_s / max(engine.decode_steps, 1),
        "outputs": {r.rid: r.output for r in reqs[:3]},
    }
