"""Deterministic, seedable fault injection for the serving runtime.

A ``ChaosInjector`` wraps the engine's compiled forwards and injects
faults on a **fixed schedule**: a map from primary-dispatch index to a
``Fault``.  Three fault kinds model the failure classes the runtime must
absorb:

* ``kernel`` — the dispatch raises ``ChaosKernelFault`` (a crashed or
  rejected kernel launch).  Recovery: the engine degrades the batch to
  the reference forward.
* ``nan``    — the dispatch "completes" but its outputs are all-NaN (a
  silently corrupting kernel).  Recovery: the engine's non-finite output
  check catches it and degrades the batch.
* ``slow``   — the dispatch sleeps ``slow_s`` before running (a
  straggling device).  Recovery: none needed; the watchdog must flag it.

Schedules are pure data (``{dispatch_index: Fault}``) built
deterministically from a seed by ``ChaosInjector.from_profile`` — the
same ``(profile, seed)`` always injects the same faults at the same
dispatch indices, so every recovery path is exercised reproducibly by
tests and the CI chaos smoke.  Scheduled faults fire on the **primary**
dispatch stream only; recovery dispatches (the reference fallback and
quarantine bisection) see them never — otherwise a recovery could chase
its own injected faults forever and determinism would depend on recovery
depth.

The one content-dependent hook, ``fault_on_nan_input``, models a kernel
that crashes on poisoned data: *any* wrapped call (primary or recovery)
whose input contains a non-finite value raises.  This is what the
quarantine-bisection tests use — a poison request then fails every batch
it is part of, on every ladder rung, until bisection has isolated it.

On a CUDA device the hooks stay on the host: ``slow`` sleeps before the
launch, ``nan`` returns a new ``torch.full_like`` tensor (it never writes
into a captured graph's static output), and only ``fault_on_nan_input``
reads the input back (one synchronisation per wrapped call, and only
when it is enabled).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np

import torch

from repro_torch.obs.trace import NULL_TRACER, TID_DISPATCH

__all__ = ["Fault", "ChaosKernelFault", "ChaosInjector", "PROFILES",
           "PROFILE_EXPECTATIONS", "chaos_summary",
           "ChaosVerificationError"]


def _all_finite(x) -> bool:
    """Whether every value of ``x`` (a tensor on any device, or an array)
    is finite; a CUDA tensor is read back for it."""
    if isinstance(x, torch.Tensor):
        return bool(torch.isfinite(x).all())
    return bool(np.isfinite(np.asarray(x)).all())


class ChaosKernelFault(RuntimeError):
    """The injected analogue of a crashed/rejected kernel launch."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault.  ``kind`` is kernel | nan | slow."""
    kind: str
    slow_s: float = 0.0

    def __post_init__(self):
        if self.kind not in ("kernel", "nan", "slow"):
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             "(want kernel|nan|slow)")


PROFILES = ("kernel-fault", "nan", "slow-batch", "mixed")

# what a chaos run under each profile must have exercised (checked by the
# CI smoke): metric-name -> the robustness counter that must be nonzero
PROFILE_EXPECTATIONS: Dict[str, tuple] = {
    "kernel-fault": ("degraded_batches",),
    "nan": ("degraded_batches", "nonfinite_batches"),
    "slow-batch": ("hung_batches",),
    "mixed": ("degraded_batches",),
}


class ChaosInjector:
    """Wraps forwards; injects the schedule; counts what it did.

    ``call(fn, x, stream)`` is the single entry point the engine uses for
    every forward it runs.  ``stream="primary"`` consumes one dispatch
    index from the fixed schedule; ``stream="recovery"`` never does (see
    module docstring).  ``injected`` tallies every fault actually fired,
    so tests can assert the schedule ran as written.
    """

    def __init__(self, schedule: Optional[Mapping[int, Fault]] = None, *,
                 fault_on_nan_input: bool = False,
                 sleep: Callable[[float], None] = time.sleep,
                 profile: Optional[str] = None, seed: Optional[int] = None,
                 tracer=None):
        self.schedule: Dict[int, Fault] = dict(schedule or {})
        self.fault_on_nan_input = fault_on_nan_input
        self._sleep = sleep
        self.profile = profile
        self.seed = seed
        self.dispatches = 0
        self.injected: Dict[str, int] = {"kernel": 0, "nan": 0, "slow": 0,
                                         "poison": 0}
        # every fired fault also lands in the trace as an error-tagged
        # instant event; the engine wires its tracer in when it adopts
        # the injector (NULL_TRACER default = no-op)
        self.tracer = tracer if tracer is not None else NULL_TRACER

    @classmethod
    def from_profile(cls, profile: str, seed: int, *, period: int = 3,
                     horizon: int = 256, slow_s: float = 0.4,
                     fault_on_nan_input: bool = True,
                     sleep: Callable[[float], None] = time.sleep
                     ) -> "ChaosInjector":
        """Build the named profile's fixed schedule from a seed.

        The schedule places one fault every ``period`` primary dispatches
        up to ``horizon``, phase-shifted by a seeded offset in
        ``[1, period]`` — dispatch 0 is always clean so the admission
        EWMA's first observation is a healthy batch.  ``mixed`` cycles
        kernel -> nan -> slow.  Same (profile, seed, period, horizon,
        slow_s) -> same schedule, always.
        """
        if profile not in PROFILES:
            raise ValueError(f"unknown chaos profile {profile!r} "
                             f"(want one of {PROFILES})")
        rng = np.random.default_rng(seed)
        offset = 1 + int(rng.integers(0, period))
        kinds = {"kernel-fault": ["kernel"], "nan": ["nan"],
                 "slow-batch": ["slow"],
                 "mixed": ["kernel", "nan", "slow"]}[profile]
        schedule = {}
        for i, idx in enumerate(range(offset, horizon, period)):
            kind = kinds[i % len(kinds)]
            schedule[idx] = Fault(kind=kind,
                                  slow_s=slow_s if kind == "slow" else 0.0)
        return cls(schedule, fault_on_nan_input=fault_on_nan_input,
                   sleep=sleep, profile=profile, seed=seed)

    def describe(self) -> dict:
        """The schedule as reportable data (lands in the bench JSON)."""
        return {
            "profile": self.profile, "seed": self.seed,
            "fault_on_nan_input": self.fault_on_nan_input,
            "schedule": {str(i): f.kind
                         for i, f in sorted(self.schedule.items())},
            "injected": dict(self.injected),
        }

    def call(self, fn: Callable, x, stream: str = "primary"):
        """Run one wrapped forward, injecting whatever the schedule says.

        The NaN-output fault runs the real forward first (so timing and
        tracing behave normally) and then replaces the result with NaN of
        the same shape — exactly what a silently corrupting kernel looks
        like from the host.
        """
        if self.fault_on_nan_input and not _all_finite(x):
            self.injected["poison"] += 1
            self.tracer.instant("chaos.poison", cat="error",
                                tid=TID_DISPATCH, stream=stream)
            raise ChaosKernelFault(
                "kernel fault on poisoned (non-finite) input")
        fault = None
        if stream == "primary":
            fault = self.schedule.get(self.dispatches)
            self.dispatches += 1
        if fault is None:
            return fn(x)
        self.tracer.instant(f"chaos.{fault.kind}", cat="error",
                            tid=TID_DISPATCH,
                            dispatch=self.dispatches - 1,
                            error=f"injected {fault.kind} fault")
        if fault.kind == "kernel":
            self.injected["kernel"] += 1
            raise ChaosKernelFault(
                f"injected kernel fault at dispatch {self.dispatches - 1}")
        if fault.kind == "slow":
            self.injected["slow"] += 1
            self._sleep(fault.slow_s)
            return fn(x)
        # nan: complete the dispatch, corrupt the result (a new tensor:
        # a captured forward's static output is never written)
        self.injected["nan"] += 1
        out = fn(x)
        if isinstance(out, torch.Tensor):
            return torch.full_like(out, float("nan"))
        return np.full(np.shape(out), np.nan, np.float32)


# --------------------------------------------------------------------------
# The chaos smoke harness (CLI + CI entry point)
# --------------------------------------------------------------------------

class ChaosVerificationError(AssertionError):
    """The chaos run violated a recovery invariant; message lists all."""


def _direct_logits(engine, images: np.ndarray, policy: str) -> np.ndarray:
    """Oracle forward: ``compile_network`` at the request's own size (no
    padding, no batching), eager (``jit=False``: a captured forward is
    bitwise its eager one), on the engine's device, sharing its schedule
    cache and, for int8, its ``QuantRecipe``."""
    from repro_torch.core.engine import compile_network
    c = engine.compiler
    net = compile_network(
        engine.params, c.graph,
        (images.shape[0], engine.batcher.chan, engine.batcher.img,
         engine.batcher.img),
        policy=policy, cache=c.cache, jit=False, device=engine.device,
        precision=c.precision, quant=c.quant)
    with torch.inference_mode():
        out = net(engine.params, torch.from_numpy(images).to(engine.device))
    return out.cpu().numpy()


def verify_chaos_run(engine, requests: List, inputs: List[np.ndarray], *,
                     profile: str, shedding: bool) -> List[str]:
    """Check every recovery invariant after a chaos run; return the
    violations (empty = clean).

    * zero lost requests: every submitted request is terminal;
    * healthy-path logits bitwise-equal to a direct ``compile_network``
      forward under the serving policy;
    * degraded-batch logits bitwise-equal to the reference forward;
    * the profile's expected robustness counters are nonzero (the chaos
      actually exercised the recovery path it targets);
    * with shedding configured, at least one request was shed or expired.
    """
    problems: List[str] = []
    for req, images in zip(requests, inputs):
        if not req.outcome.terminal:
            problems.append(f"request {req.rid} never reached a terminal "
                            f"outcome (stuck {req.outcome.value})")
            continue
        if req.outcome.value != "ok":
            continue
        oracle_policy = (engine.compiler.policy
                         if req.served_by == "primary" else "reference")
        want = _direct_logits(engine, images, oracle_policy)
        if not np.array_equal(req.logits, want):
            problems.append(
                f"request {req.rid} ({req.served_by}) logits differ from "
                f"the direct {oracle_policy!r} forward")
    rb = engine.metrics_dict()["robustness"]
    if rb["lost_requests"]:
        problems.append(f"{rb['lost_requests']} request(s) lost")
    for counter in PROFILE_EXPECTATIONS[profile]:
        if not rb[counter]:
            problems.append(f"profile {profile!r}: expected nonzero "
                            f"{counter}, got 0")
    if shedding and not (rb["shed"] + rb["expired"]):
        problems.append("deadlines configured but nothing was shed or "
                        "expired")
    return problems


def chaos_summary(model: str, *, profile: str, seed: int,
                  requests: int = 12, img: int = 32,
                  width_mult: float = 0.0625, classes: int = 10,
                  policy: str = "auto", buckets=(1, 2, 4, 8),
                  deadline_s: float = 0.001, deadline_every: int = 3,
                  hang_timeout_s: float = 0.15, slow_s: float = 0.4,
                  period: int = 3, tracer=None, registry=None,
                  device="cuda", precision: str = "fp32",
                  verbose: bool = False) -> dict:
    """Run the deterministic chaos smoke: a mixed-size request stream with
    periodic deadlines, served under an injected fault schedule, then
    verified against every recovery invariant (``verify_chaos_run``).

    Requests are submitted *interleaved* with serving (submit one, step
    one) so the admission controller has live EWMAs when the deadlined
    requests arrive — the shed path is exercised, not just the expired
    one.  The default ``deadline_s`` (1 ms) sits deterministically below
    any real batch service time, so every deadlined request sheds on any
    machine — the smoke exercises the path without timing assumptions.
    Raises ``ChaosVerificationError`` on any violation; returns the
    engine metrics dict (with the chaos schedule attached) otherwise.
    The weights are random, made from a generator seeded with 0; the
    requests and the schedule come from ``seed``.
    """
    from repro_torch.core.engine import resolve_execution
    from repro_torch.models.zoo import get_conv_model
    from repro_torch.serve.vision import VisionEngine

    spec = get_conv_model(model)
    _, dev = resolve_execution(policy, device)     # raises without a GPU
    gen = torch.Generator(device=dev).manual_seed(0)
    params = spec.init_params(gen, width_mult=width_mult, img=img,
                              classes=classes, device=dev)
    chaos = ChaosInjector.from_profile(profile, seed, slow_s=slow_s,
                                       period=period)
    engine = VisionEngine(params, spec.to_graph(), img=img, policy=policy,
                          buckets=buckets, chaos=chaos,
                          hang_timeout_s=hang_timeout_s, tracer=tracer,
                          registry=registry, device=dev,
                          precision=precision)
    engine.warmup()
    rng = np.random.default_rng(seed)
    max_n = engine.batcher.policy.max_width
    sizes = rng.integers(1, max_n + 1, requests)
    submitted, inputs = [], []
    for i, n in enumerate(sizes):
        images = rng.standard_normal((int(n), 3, img, img)).astype(
            np.float32)
        dl = (deadline_s if deadline_every and i and i % deadline_every == 0
              else None)
        submitted.append(engine.submit(images, deadline_s=dl))
        inputs.append(images)
        engine.step()                      # interleave: EWMAs go live early
    engine.run()                           # drain the tail
    problems = verify_chaos_run(engine, submitted, inputs, profile=profile,
                                shedding=bool(deadline_every))
    if problems:
        raise ChaosVerificationError(
            f"chaos run ({model}, {profile}, seed {seed}) violated "
            f"{len(problems)} invariant(s):\n  " + "\n  ".join(problems))
    if registry is not None:
        engine.snapshot_registry(registry)
    d = engine.metrics_dict()
    d["chaos"] = chaos.describe()
    d["workload"] = {"model": model, "profile": profile, "seed": seed,
                     "requests": int(requests), "policy": policy,
                     "precision": precision, "device": str(dev),
                     "deadline_s": deadline_s,
                     "deadline_every": deadline_every}
    if verbose:
        rb = d["robustness"]
        print(f"CHAOS_OK {model}/{profile}/seed={seed}: "
              f"{rb['outcomes']} degraded={rb['degraded_batches']} "
              f"shed={rb['shed']} expired={rb['expired']} "
              f"hung={rb['hung_batches']} "
              f"injected={d['chaos']['injected']}")
    return d
