"""Serving launcher: token requests through the continuous-batching
``BatchEngine`` (``serve/engine.py``), or — with ``--vision`` — an image
request stream through the vision engine (``serve/vision.py``).

    python -m repro_torch.launch.serve --device cpu
    python -m repro_torch.launch.serve --arch zamba2-1.2b --full
    python -m repro_torch.launch.serve --arch rwkv6-1.6b --device cpu
    python -m repro_torch.launch.serve --vision --model mobilenetv2
    python -m repro_torch.launch.serve --vision --model resnet18 --width 1.0
    python -m repro_torch.launch.serve --vision --model vgg16 --device cpu
    python -m repro_torch.launch.serve --vision --precision int8 \
        --device cpu --width 0.0625
    python -m repro_torch.launch.serve --vision --model mobilenetv2 \
        --device cpu --autotune --tuning-path tuning.json \
        --trace trace.json --metrics-json metrics.json
    python -m repro_torch.launch.serve --vision --device cpu \
        --chaos 7 --chaos-profile mixed
    python -m repro_torch.launch.serve --vision --mesh 1x1
    torchrun --nproc-per-node 2 -m repro_torch.launch.serve --vision \
        --device cpu --mesh 1x2
    torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
        --arch qwen3-4b --device cpu --mesh 2x1

The token path serves ``--requests`` random prompts of ``--prompt-len``
tokens, ``--new-tokens`` each, at batch width ``--batch``, over random
weights from ``--seed`` (the bf16 policy; ``--full`` for the published
widths, else the reduced config), and prints requests done/lost, tokens,
tokens/s and the prefill/decode times as one JSON object.  Every
``--arch`` of ``configs/registry.py`` serves: the dense attention family
(llama3-8b, qwen3-4b, qwen2.5-14b, gemma3-12b), the MoE pair
(granite-moe-1b-a400m, qwen2-moe-a2.7b), rwkv6-1.6b, zamba2-1.2b, the VLM
internvl2-26b (tokens only: the engine steps prompts through decode) and
the enc-dec seamless-m4t-medium (over a zero cross cache: the engine
never prefills, as the JAX engine does not).  With ``--mesh`` the token
path serves on the mesh's ranks (``BatchEngine(mesh=)``: the parameters
and cache laid out by the decode step's layout, the step eager on more
than one rank) and the summary names the mesh and the decode mode.

The vision path serves a deterministic mixed-size request stream through
the bucketed compiled forwards of any registered conv model
(``models/zoo.py``, ``--model``) and prints the summary (images/s, latency
percentiles, slot occupancy, fold reuse, robustness counters,
served-vs-direct check) as one JSON object; with ``--precision int8``
that object sits under the key ``serving_int8`` (the JAX launcher's
section name).  It runs under a ``PreemptionGuard``: on SIGTERM/SIGINT
the engine stops admitting, drains everything in flight and still
prints its metrics.  ``--autotune`` measures the schedules on the
device (``--tuning-path`` persists them as JSON); ``--deadline-s`` puts
an SLO on every ``--deadline-every``-th request.

``--mesh DATAxMODEL`` serves the vision path on a ``launch/mesh.py`` mesh
(``serve/vision.py``: rows over the data axis, conv filters over the
model axis), one process a rank: a 1x1 mesh starts its own one-rank
group, a larger one joins the group its launcher (``torchrun``) set up
through the ``env://`` variables (NCCL when each rank has a card of its
own, gloo on the CPU or when ranks share a card).  Rank 0 prints the
summary.

``--chaos SEED`` runs the deterministic fault-injection smoke instead
(``serve/chaos.py``, profile ``--chaos-profile``): the stream is served
under an injected fault schedule and every recovery invariant is
verified; a violation raises ``ChaosVerificationError`` (a nonzero
exit), and the summary prints under the key ``chaos``.
``--hang-timeout-s`` is its watchdog's hang threshold.

``--trace PATH`` writes the request lifecycle as Chrome trace-event JSON
and ``--metrics-json PATH`` the metrics registry's snapshot (serving,
robustness and foldlint counters); ``python -m repro_torch.obs.report
--validate-trace PATH --expect-requests N`` and ``--validate-metrics
PATH`` check them.  No other file is written: ``--bench-json`` (the perf
snapshot the JAX package's ``check_bench`` gate reads) waits for the
port's ``benchmark`` PR, which defines the port's benchmark.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

from repro_torch.core.engine import POLICIES
from repro_torch.serve.chaos import PROFILES as CHAOS_PROFILES


def make_obs(args):
    """(tracer, registry) per the ``--trace`` / ``--metrics-json`` flags —
    ``None`` for whichever is off, so the serving hot paths keep their
    no-op recorders."""
    tracer = registry = None
    if args.trace:
        from repro_torch.obs.trace import Tracer
        tracer = Tracer(time.monotonic)
    if args.metrics_json:
        from repro_torch.obs.metrics import MetricsRegistry
        registry = MetricsRegistry()
    return tracer, registry


def lint_into_registry(registry, model: str, *, img: int,
                       width_mult: float, device="cuda") -> None:
    """Fold the static verifier's finding counts into the registry, so one
    snapshot carries perf + robustness + lint health."""
    from repro_torch.analysis.foldlint import lint_model
    summary = lint_model(model, img=img, width_mult=width_mult,
                         device=device)
    by_sev = {}
    for f in summary["report"]["findings"]:
        by_sev[f["severity"]] = by_sev.get(f["severity"], 0) + 1
    for sev in ("error", "warning", "info"):
        registry.counter("foldlint_findings_total",
                         "Static verifier findings by severity",
                         severity=sev).set_total(by_sev.get(sev, 0))
    registry.gauge("foldlint_ok", "1 when no error-severity findings"
                   ).set(1.0 if summary["ok"] else 0.0)


def write_obs_artifacts(args, tracer, registry) -> None:
    """Write the ``--trace`` and ``--metrics-json`` files (their notes go
    to stderr: stdout carries the summary's JSON)."""
    import sys
    if tracer is not None:
        tracer.save(args.trace)
        print(f"# wrote Chrome trace ({len(tracer.events)} events) "
              f"to {args.trace}", file=sys.stderr)
    if registry is not None:
        lint_into_registry(registry, args.model, img=args.img,
                           width_mult=args.width, device=args.device)
        with open(args.metrics_json, "w") as f:
            json.dump(registry.snapshot(), f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"# wrote metrics snapshot ({len(registry)} series) "
              f"to {args.metrics_json}", file=sys.stderr)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from repro_torch.configs.registry import arch_names
    from repro_torch.models.zoo import conv_model_names
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--requests", type=int, default=None,
                    help="requests to serve (tokens: 8, vision: 32)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and the requests")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain-torch "
                         "versions)")
    # token serving
    ap.add_argument("--arch", default="zamba2-1.2b", choices=arch_names(),
                    help="LM architecture (configs/registry.py)")
    ap.add_argument("--full", action="store_true",
                    help="the published widths (else the reduced config)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=12)
    # vision serving
    ap.add_argument("--vision", action="store_true",
                    help="serve an image stream through the compiled "
                         "fold-schedule engine instead of token decode")
    ap.add_argument("--model", default="vgg16", choices=conv_model_names(),
                    help="registered conv model to serve (models/zoo.py)")
    ap.add_argument("--width", type=float, default=0.0625,
                    help="model width multiplier (1.0 is full width)")
    ap.add_argument("--img", type=int, default=32)
    ap.add_argument("--buckets", default="1,2,4,8",
                    help="comma-separated batch bucket widths")
    ap.add_argument("--policy", choices=POLICIES, default="auto",
                    help="auto/kernel: the fold kernels; reference: the "
                         "plain-torch direct conv")
    ap.add_argument("--precision", choices=("fp32", "int8"), default="fp32",
                    help="streamed conv precision of the compiled forwards")
    ap.add_argument("--mesh", default="",
                    help='optional "DATAxMODEL" mesh, e.g. "2x1" (one '
                         "process a rank)")
    ap.add_argument("--autotune", action="store_true",
                    help="measure each schedule's candidates on the device "
                         "instead of the analytical ranking")
    ap.add_argument("--tuning-path", default="",
                    help="JSON file the measured schedules load from and "
                         "save to")
    # observability
    ap.add_argument("--trace", default="", metavar="PATH",
                    help="write a Chrome trace-event JSON of the full "
                         "request lifecycle (open in Perfetto)")
    ap.add_argument("--metrics-json", default="", metavar="PATH",
                    help="write the bounded metrics-registry snapshot "
                         "(perf + robustness + foldlint health)")
    # robustness / fault injection
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help="per-request SLO in seconds (0 = no deadlines); "
                         "requests past it are shed or expired")
    ap.add_argument("--deadline-every", type=int, default=1,
                    help="attach the deadline to every Nth request "
                         "(1 = all)")
    ap.add_argument("--hang-timeout-s", type=float, default=30.0,
                    help="watchdog hang threshold for a single dispatch")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="run the deterministic fault-injection smoke with "
                         "this seed instead of the plain serve (vision only; "
                         "a recovery-invariant violation exits nonzero)")
    ap.add_argument("--chaos-profile", default="mixed",
                    choices=CHAOS_PROFILES,
                    help="which fault schedule --chaos injects")
    args = ap.parse_args(argv)
    if not args.vision:
        return token_main(args)
    if args.chaos is not None:
        return chaos_main(args)
    return vision_main(args)


def vision_main(args) -> dict:
    from repro_torch.ft.fault_tolerance import PreemptionGuard
    from repro_torch.serve.vision import serving_summary
    from repro_torch.launch.mesh import mesh_from_flag, rank
    mesh = mesh_from_flag(args.mesh, args.device)
    tracer, registry = make_obs(args)
    with PreemptionGuard() as guard:    # SIGTERM -> stop admitting, drain
        summary = serving_summary(
            args.model, requests=args.requests or 32, img=args.img,
            width_mult=args.width, policy=args.policy,
            buckets=tuple(int(b) for b in args.buckets.split(",")),
            seed=args.seed, autotune=args.autotune,
            tuning_path=args.tuning_path or None,
            deadline_s=args.deadline_s or None,
            deadline_every=args.deadline_every, guard=guard,
            tracer=tracer, registry=registry, device=args.device,
            precision=args.precision, mesh=mesh)
    write_obs_artifacts(args, tracer, registry)
    # an int8 summary prints under its own key, as the JAX launcher files
    # it under its own section beside the fp32 one
    out = summary if args.precision == "fp32" else \
        {f"serving_{args.precision}": summary}
    if rank() == 0:
        print(json.dumps(out, indent=1, sort_keys=True))
    return summary


def chaos_main(args) -> dict:
    """The deterministic fault-injection smoke: serve under an injected
    fault schedule and verify every recovery invariant
    (``ChaosVerificationError`` propagates: a nonzero exit)."""
    from repro_torch.serve.chaos import chaos_summary
    tracer, registry = make_obs(args)
    summary = chaos_summary(
        args.model, profile=args.chaos_profile, seed=args.chaos,
        requests=args.requests or 12, img=args.img, width_mult=args.width,
        policy=args.policy,
        buckets=tuple(int(b) for b in args.buckets.split(",")),
        deadline_s=args.deadline_s if args.deadline_s > 0 else 0.001,
        deadline_every=args.deadline_every,
        hang_timeout_s=args.hang_timeout_s, tracer=tracer,
        registry=registry, device=args.device, precision=args.precision)
    write_obs_artifacts(args, tracer, registry)
    print(json.dumps({"chaos": summary}, indent=1, sort_keys=True))
    return summary


def token_main(args) -> dict:
    from repro_torch.launch.mesh import mesh_from_flag, rank
    from repro_torch.serve.engine import token_serving_summary
    summary = token_serving_summary(
        args.arch, full=args.full, batch=args.batch, max_len=args.max_len,
        prompt_len=args.prompt_len, new_tokens=args.new_tokens,
        requests=args.requests or 8, seed=args.seed, device=args.device,
        mesh=mesh_from_flag(args.mesh, args.device))
    if rank() == 0:
        print(json.dumps(summary, indent=1, sort_keys=True))
    return summary


if __name__ == "__main__":
    main()
