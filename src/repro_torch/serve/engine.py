"""Batched token serving: a continuous-batching request queue over the
decode step (the JAX package's ``serve/engine.py``, whose behaviour it
keeps exactly, its quirks included).

Slots model continuous batching at a fixed batch width: a slot is free or
holds a request; a decode step advances every row of the batch; finished
slots are refilled from the queue.  Per-slot positions live on the host,
the cache on the device.  The JAX engine jits its decode step with the
cache donated; here the step writes the cache in place and, on a CUDA
device, runs as one CUDA graph (``CapturedDecode``).  As in the JAX
engine:

* a slot is prefilled by stepping its prompt through the *decode* step
  (never the prefill step, so serving launches no conv1d kernel);
* each of those decode calls advances every batch row: while slot j
  prefills, the other rows' recurrent state (Mamba2's state and conv
  tail, RWKV-6's WKV state and token shifts) advances and their KV cache
  is written at ``pos[j]``;
* a refilled slot keeps the previous request's recurrent state (its
  position is reset; no state is cleared);
* a step runs every slot at ``pos = max(pos[active])``;
* the enc-dec family decodes over the zero cross K/V of ``max_len`` rows
  that ``init_cache`` makes (no source is encoded).

On a mesh (``mesh=``) the decode step is the JAX package's sharded one:
every rank runs the same engine on the same requests (SPMD).  The
parameters and the cache are laid out by ``launch/specs.step_layout``'s
decode layout (the cache's batch over the data axes where the batch
divides by them, else its sequence), the token vector over the batch
axis; the next tokens are gathered for the slot logic on the host.  The
step runs eagerly and returns a new cache: a CUDA graph cannot hold the
collectives' meetings on the host, so a mesh of more than one rank never
captures (``decode_mode`` "eager").  A one-rank mesh keeps plain tensors under the
mesh's sharding context and the captured step: the mesh-less engine's
bits.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.engine import _tensor_leaves
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.launch.specs import step_layout
from repro_torch.models import api
from repro_torch.models.common import DTypePolicy
from repro_torch.serve.steps import make_decode_step

__all__ = ["Request", "CapturedDecode", "BatchEngine",
           "token_serving_summary"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray             # (S,) int32
    max_new_tokens: int = 16
    output: Optional[List[int]] = None
    done: bool = False


class CapturedDecode:
    """The counterpart of ``jax.jit(make_decode_step(cfg),
    donate_argnums=(2,))``: ``step`` is a donated decode step (it writes
    the new cache into the one it is given), called as
    ``step(params, token, cache, pos)``.

    On a CUDA device the first call captures it as one CUDA graph: a
    warm-up call on a side stream over a copy of the cache (lazy set-up
    happens there, and the real cache does not advance), then the capture
    into a ``torch.cuda.CUDAGraph`` with a memory pool of its own, under
    ``torch.inference_mode`` with ``capture_error_mode="thread_local"``
    (an operation that would synchronise with the host raises), reading
    a static (B,) token tensor and a static 0-d position.  Every call
    copies the tokens into the static token (from pageable host memory
    the copy returns once CUDA has staged it, with no synchronisation)
    and fills the static position, replays the graph,
    and returns clones of the next tokens and logits with the cache: the
    very tensors passed in, advanced one step.  Reading the next tokens
    back is the call's only synchronisation, as ``np.asarray(nxt)`` is in
    the JAX engine.

    Parameters and cache are captured by address: a call whose tensors
    sit at other addresses than at the capture captures again
    (``captures`` counts the captures).  Nothing falls back to the eager
    step on a CUDA device: a failed capture or replay raises.  On the CPU
    the step runs eagerly."""

    def __init__(self, step: Callable, device: torch.device):
        self.step = step
        self.device = device
        self.captures = 0
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._token: Optional[torch.Tensor] = None    # static (B,) int64
        self._pos: Optional[torch.Tensor] = None      # static 0-d int64
        self._out: Tuple[torch.Tensor, ...] = ()      # static nxt, logits
        self._held: Tuple[torch.Tensor, ...] = ()
        self._ptrs: Tuple[int, ...] = ()

    def _capture(self, params: Dict[str, Any], token: torch.Tensor,
                 cache: Dict[str, Any], leaves: List[torch.Tensor],
                 ptrs: Tuple[int, ...]) -> None:
        # the old graph and its pool go before the new capture
        self._graph, self._out = None, ()
        with torch.inference_mode(False):
            # normal tensors, so calls outside inference mode can fill them
            self._token = torch.zeros(token.shape, dtype=torch.long,
                                      device=self.device)
            self._pos = torch.zeros((), dtype=torch.long, device=self.device)
        scratch = _clone_tree(cache)
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side), torch.inference_mode():
            self.step(params, self._token, scratch, self._pos)
        main.wait_stream(side)
        del scratch
        graph = torch.cuda.CUDAGraph()
        with torch.inference_mode(), torch.cuda.graph(
                graph, capture_error_mode="thread_local"):
            nxt, logits, _ = self.step(params, self._token, cache,
                                       self._pos)
        self._graph, self._out = graph, (nxt, logits)
        self._held, self._ptrs = tuple(leaves), ptrs
        self.captures += 1

    def __call__(self, params: Dict[str, Any], token: torch.Tensor,
                 cache: Dict[str, Any], pos) -> Tuple[torch.Tensor,
                                                       torch.Tensor, Any]:
        if self.device.type != "cuda":
            return self.step(params, token.to(self.device), cache, pos)
        leaves = _tensor_leaves(cache, _tensor_leaves(params, []))
        ptrs = tuple(t.data_ptr() for t in leaves)
        if self._graph is None or ptrs != self._ptrs:
            self._capture(params, token, cache, leaves, ptrs)
        self._token.copy_(token, non_blocking=True)
        self._pos.fill_(int(pos))
        self._graph.replay()
        nxt, logits = self._out
        return nxt.clone(), logits.clone(), cache


def _clone_tree(tree):
    """A copy of a dict tree of tensors."""
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.clone()


class BatchEngine:
    """``params`` lie on ``device`` already (on a mesh, the whole tree on
    every rank: the engine lays it out).  Without a mesh of more than one
    rank the cache is allocated once and every step writes into it
    (``decode``, a ``CapturedDecode`` of the donated step: one CUDA graph
    on a CUDA device); on one, ``decode`` is the eager sharded step.
    ``prefill_s`` and ``decode_s`` sum the host time of the
    prompt-stepping decode calls and of the engine's decode steps (each
    ends reading the next tokens back, so the device work is inside)."""

    def __init__(self, cfg, params, *, batch: int, max_len: int,
                 cache_dtype: torch.dtype = torch.bfloat16,
                 device: Any = "cuda", mesh=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        self.mesh = mesh
        self.layout = (None if mesh is None
                       else step_layout(cfg, "decode", mesh, batch))
        cache = api.init_cache(cfg, batch, max_len, dtype=cache_dtype,
                               device=self.device)
        if self.sharded:
            p_sh, self._token_sharding, c_sh, _ = self.layout.shardings
            params = shd.distribute_tree(params, p_sh)
            cache = shd.distribute_tree(cache, c_sh)
            self.decode = make_decode_step(cfg)
        else:
            self.decode = CapturedDecode(make_decode_step(cfg, donate=True),
                                         self.device)
        self.params = params
        self.cache = cache
        self.pos = np.zeros(batch, np.int32)          # next write index
        self.slots: List[Optional[Request]] = [None] * batch
        self.tokens = np.zeros(batch, np.int32)       # last token per slot
        self.queue: List[Request] = []
        self.prefill_s = self.decode_s = 0.0
        self.prefill_calls = self.decode_steps = 0

    @property
    def sharded(self) -> bool:
        """Whether the step runs on ``DTensor``s (a mesh of more than one
        rank)."""
        return self.mesh is not None and self.mesh.size > 1

    @property
    def decode_mode(self) -> str:
        """"captured" (one CUDA graph a step) or "eager"."""
        return ("captured" if self.device.type == "cuda"
                and not self.sharded else "eager")

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        req.output = []
        self.queue.append(req)

    def _token_vec(self) -> torch.Tensor:
        """The last token of every slot, on the host."""
        return torch.from_numpy(self.tokens.astype(np.int64))

    def _next_tokens(self, tok_vec: torch.Tensor, pos: int) -> np.ndarray:
        """One decode call: the next token of every row, on the host.  On
        a mesh the call runs under its sharding context, the tokens laid
        out over the batch axis and the next ones gathered."""
        if self.mesh is None:
            nxt, _, self.cache = self.decode(self.params, tok_vec,
                                             self.cache, pos)
            return nxt.cpu().numpy()
        shd.set_context(self.mesh, self.layout.rules)
        try:
            if self.sharded:
                tok_vec = self._token_sharding.distribute(
                    tok_vec.to(self.device))
            nxt, _, self.cache = self.decode(self.params, tok_vec,
                                             self.cache, pos)
            if self.sharded:
                nxt = nxt.full_tensor()
        finally:
            shd.clear_context()
        return nxt.cpu().numpy()

    def _prefill_one(self, slot: int, req: Request) -> None:
        """Prefill a single slot by stepping its prompt through decode."""
        t0 = time.perf_counter()
        for tok in req.prompt:
            tok_vec = self._token_vec()
            tok_vec[slot] = int(tok)
            nxt = self._next_tokens(tok_vec, int(self.pos[slot]))
            self.tokens[slot] = int(nxt[slot])
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
        nxt = self._next_tokens(self._token_vec(), pos)
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
                          device: Any = "cuda", mesh=None,
                          fp32: bool = False,
                          record_logits: bool = False) -> dict:
    """Serve ``requests`` random prompts through a ``BatchEngine`` (on
    ``mesh``, or none) over random weights from ``seed`` (the bf16
    policy, or fp32 weights and cache with ``fp32``; ``full`` for the
    published widths, else ``reduced()``) and return what it did:
    requests done and lost, tokens, tokens/s, the time of the
    prompt-stepping decode calls (``prefill_ms``) and of the engine's
    decode steps, the decode mode and the mesh; with ``record_logits``
    also every decode call's logits, whole, as fp32 numpy arrays
    (``step_logits``: each call reads them back, which its time then
    includes)."""
    dev = resolve_device(device)
    cfg = get_config(arch, reduced=not full)
    policy = DTypePolicy.fp32() if fp32 else None
    params = api.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed),
        dtype_policy=policy, device=dev)
    engine = BatchEngine(cfg, params, batch=batch, max_len=max_len,
                         cache_dtype=torch.float32 if fp32
                         else torch.bfloat16, device=dev, mesh=mesh)
    del params
    logits: List[np.ndarray] = []
    if record_logits:
        step = engine.decode

        def decode(*args):
            out = step(*args)
            lg = out[1].full_tensor() if engine.sharded else out[1]
            logits.append(lg.float().cpu().numpy())
            return out
        engine.decode = decode
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
    out = {
        "arch": cfg.name, "device": str(dev), "batch": batch,
        "max_len": max_len, "prompt_len": prompt_len,
        "new_tokens": new_tokens, "requests": requests,
        "requests_done": done, "requests_lost": requests - done,
        "tokens": toks, "elapsed_s": elapsed, "tokens_per_s": toks / elapsed,
        "prefill_calls": engine.prefill_calls,
        "prefill_ms": 1e3 * engine.prefill_s,
        "decode_steps": engine.decode_steps,
        "decode_step_ms": 1e3 * engine.decode_s / max(engine.decode_steps, 1),
        "decode": engine.decode_mode,
        "mesh": None if mesh is None else dict(mesh.shape),
        "outputs": {r.rid: r.output for r in reqs[:3]},
    }
    if record_logits:
        out["step_logits"] = logits
    return out
