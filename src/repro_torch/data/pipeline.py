"""Deterministic sharded synthetic/memmap token pipeline: the port's own
copy of the JAX package's ``data/pipeline.py``.  It is numpy only (no
torch, no JAX), so for one ``DataConfig`` its batches are the JAX
package's bit for bit; the train step moves them to the device.

Real-framework properties kept:
  * deterministic per (seed, step, dp_rank) — restart-safe: resuming from a
    checkpoint at step k regenerates exactly the batches k, k+1, ...
  * shard-aware: each DP rank materializes only its slice of the global
    batch (host-side analogue of the batch PartitionSpec)
  * two sources: "synthetic" (zipf-ish token stream with structure so loss
    can actually fall) and "memmap" (packed .bin token files, the standard
    pretraining layout)
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ["DataConfig", "TokenPipeline"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    source: str = "synthetic"          # synthetic | memmap
    memmap_path: Optional[str] = None
    dp_rank: int = 0
    dp_size: int = 1
    frontend: str = "none"             # adds patches / src_embeds stubs
    frontend_len: int = 0
    d_model: int = 0

    @property
    def local_batch(self) -> int:
        assert self.global_batch % self.dp_size == 0
        return self.global_batch // self.dp_size


class TokenPipeline:
    """Iterator of training batches: {"tokens", "labels" [, stubs]}."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        self.cfg = cfg
        self.step = start_step
        if cfg.source == "memmap":
            assert cfg.memmap_path, "memmap source needs a path"
            self._data = np.memmap(cfg.memmap_path, dtype=np.uint16,
                                   mode="r")
        else:
            self._data = None

    # -- deterministic generation -----------------------------------------
    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.cfg.seed, step, self.cfg.dp_rank))

    def _synthetic(self, step: int) -> np.ndarray:
        """Markov-ish stream: next token = (a*tok + b) % V with noise, so a
        model can learn structure and the loss curve is meaningful."""
        cfg = self.cfg
        rng = self._rng(step)
        b, s, v = cfg.local_batch, cfg.seq_len, cfg.vocab
        toks = np.empty((b, s + 1), np.int64)
        toks[:, 0] = rng.integers(0, v, size=b)
        noise = rng.random((b, s)) < 0.1
        rand = rng.integers(0, v, size=(b, s))
        for t in range(s):
            nxt = (toks[:, t] * 31 + 7) % v
            toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        return toks

    def _memmap_batch(self, step: int) -> np.ndarray:
        cfg = self.cfg
        n_tokens = len(self._data)
        per = cfg.seq_len + 1
        rows = []
        base = step * cfg.global_batch + cfg.dp_rank * cfg.local_batch
        for i in range(cfg.local_batch):
            off = ((base + i) * per) % max(n_tokens - per, 1)
            rows.append(np.asarray(self._data[off:off + per], np.int64))
        return np.stack(rows)

    def next_batch(self) -> Dict[str, np.ndarray]:
        step = self.step
        self.step += 1
        toks = (self._memmap_batch(step) if self._data is not None
                else self._synthetic(step))
        batch = {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
        cfg = self.cfg
        if cfg.frontend == "vlm":
            rng = self._rng(step)
            batch["patches"] = rng.standard_normal(
                (cfg.local_batch, cfg.frontend_len, cfg.d_model)
            ).astype(np.float32)
        elif cfg.frontend == "audio":
            rng = self._rng(step)
            batch["src_embeds"] = rng.standard_normal(
                (cfg.local_batch, cfg.seq_len, cfg.d_model)
            ).astype(np.float32)
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()

    # -- checkpointable cursor --------------------------------------------
    def state(self) -> Dict[str, int]:
        return {"step": self.step}

    def restore(self, state: Dict[str, int]) -> None:
        self.step = int(state["step"])
