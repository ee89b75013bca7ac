"""Observability report CLI.

Three jobs, one entry point:

* ``python -m repro_torch.obs.report --model vgg16 [--device cpu]`` —
  compile the zoo model's graph (reference policy, no forward runs) on
  ``--device`` (default ``cuda``, like foldlint's CLI) and print the
  per-schedule analytical table: the MAVeC model's eq-10 utilization,
  eq-12 GFLOP/s and modeled bytes per dataflow — the model-side half of
  the live ``FoldStreamCounters`` table the serving engine streams.
  ``--json`` emits the same as a machine-readable snapshot.
* ``python -m repro_torch.obs.report --validate-trace t.json`` — schema-check
  a ``--trace`` artifact (Chrome trace-event JSON) and, with
  ``--expect-requests N``, assert the zero-loss invariant: every one of
  the N submitted requests has a lifetime span carrying a terminal
  outcome.
* ``python -m repro_torch.obs.report --validate-metrics m.json`` — schema-check
  a ``--metrics-json`` artifact.

Exit status is 0 only if every requested check passes — this is what
CI's observability smoke job runs against the serve artifacts.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List

from repro_torch.obs.metrics import validate_metrics_snapshot
from repro_torch.obs.trace import validate_trace

__all__ = ["main", "check_trace_outcomes"]

TERMINAL_OUTCOMES = ("ok", "rejected", "expired", "failed")


def check_trace_outcomes(trace: dict, expect_requests: int) -> List[str]:
    """The zero-loss invariant, read off the trace: every submitted
    request's lifetime span (``cat == "request"``) ends with exactly one
    terminal outcome in its args."""
    problems: List[str] = []
    seen = {}
    for ev in trace.get("traceEvents", []):
        if not isinstance(ev, dict) or ev.get("cat") != "request":
            continue
        if ev.get("ph") != "X":
            continue
        args = ev.get("args", {})
        rid = args.get("request_id")
        outcome = args.get("outcome")
        if rid is None:
            problems.append(f"request span {ev.get('name')!r} has no "
                            "request_id")
            continue
        if rid in seen:
            problems.append(f"request {rid}: more than one lifetime span")
        seen[rid] = outcome
        if outcome not in TERMINAL_OUTCOMES:
            problems.append(f"request {rid}: outcome {outcome!r} is not "
                            f"one of {TERMINAL_OUTCOMES}")
    if len(seen) != expect_requests:
        problems.append(f"trace has {len(seen)} request lifetime spans, "
                        f"expected {expect_requests}")
    return problems


def _load(path: str):
    with open(path) as f:
        return json.load(f)


def _report_model(args) -> int:
    # imports deferred: the validate-only paths need no torch
    import torch

    from repro_torch.core.engine import resolve_execution
    from repro_torch.core.folds import PEArray
    from repro_torch.models import zoo
    from repro_torch.obs.folds import FoldStreamCounters
    spec = zoo.get_conv_model(args.model)
    _, dev = resolve_execution("reference", args.device)
    params = spec.init_params(torch.Generator(device=dev).manual_seed(0),
                              width_mult=args.width, img=args.img,
                              classes=args.classes, device=dev)
    net = zoo.compile_forward(spec, params, img=args.img,
                              batch=args.batch, policy="reference",
                              jit=False, verify=False, device=dev)
    rp, cp = (int(d) for d in args.pe.split("x"))
    fc = FoldStreamCounters(pe=PEArray(rp, cp))
    fc.observe_compile(net.layer_schedules)
    if args.json:
        print(json.dumps(fc.as_dict(), indent=1, sort_keys=True))
    else:
        print(f"{args.model} (img={args.img}, width={args.width}, "
              f"batch={args.batch})")
        print(fc.table())
        print(f"fold reuse: {net.fold_reuse()}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="per-schedule utilization table + observability "
                    "artifact validation")
    ap.add_argument("--model", help="zoo model to report on")
    ap.add_argument("--img", type=int, default=32)
    ap.add_argument("--width", type=float, default=0.0625)
    ap.add_argument("--classes", type=int, default=10)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda or cpu: where --model's network is built")
    ap.add_argument("--pe", default="16x16",
                    help="PE array for the analytical side (RPxCP)")
    ap.add_argument("--json", action="store_true",
                    help="emit the table as JSON")
    ap.add_argument("--validate-trace", metavar="PATH",
                    help="schema-check a Chrome trace-event artifact")
    ap.add_argument("--expect-requests", type=int, default=None,
                    help="with --validate-trace: require N request "
                         "lifetime spans with terminal outcomes")
    ap.add_argument("--validate-metrics", metavar="PATH",
                    help="schema-check a --metrics-json artifact")
    args = ap.parse_args(argv)

    if not (args.model or args.validate_trace or args.validate_metrics):
        ap.error("nothing to do: pass --model and/or --validate-*")

    rc = 0
    if args.validate_trace:
        trace = _load(args.validate_trace)
        problems = validate_trace(trace)
        if args.expect_requests is not None and not problems:
            problems += check_trace_outcomes(trace, args.expect_requests)
        n_req = sum(1 for ev in trace.get("traceEvents", [])
                    if isinstance(ev, dict) and ev.get("cat") == "request")
        if problems:
            rc = 1
            print(f"TRACE INVALID ({args.validate_trace}):")
            for p in problems:
                print(f"  - {p}")
        else:
            print(f"trace ok: {len(trace['traceEvents'])} events, "
                  f"{n_req} request spans ({args.validate_trace})")
    if args.validate_metrics:
        snap = _load(args.validate_metrics)
        problems = validate_metrics_snapshot(snap)
        if problems:
            rc = 1
            print(f"METRICS INVALID ({args.validate_metrics}):")
            for p in problems:
                print(f"  - {p}")
        else:
            n = sum(len(snap.get(k, {})) for k in
                    ("counters", "gauges", "histograms"))
            print(f"metrics ok: {n} series ({args.validate_metrics})")
    if args.model:
        rc = max(rc, _report_model(args))
    return rc


if __name__ == "__main__":
    sys.exit(main())
