"""foldlint — run every static verifier over a model zoo network (the JAX
package's ``analysis/foldlint.py``).

    PYTHONPATH=src python -m repro_torch.analysis.foldlint --model all \\
        [--json] [--device cpu|cuda]

For each model (vgg16 / resnet18 / mobilenetv2) the linter:

  1. builds the registered ``StreamGraph`` + init params and runs the
     structural/shape lint (``graph_check.lint_graph``);
  2. compiles the network through the fold-schedule engine (kernel mode,
     ``verify=False`` — foldlint *is* the verifier and wants findings,
     not a first-error exception — and ``jit=False``);
  3. diffs the engine's fused graph against the independent
     fusion-legality re-derivation (``graph_check.check_fusion``);
  4. re-walks the lowered graph and, for every conv layer, proves the
     clamped ``ConvBlockPlan`` (``plan_check``), the launch's index maps
     (``index_check`` over ``fold_kernel_spec``) and its CTA tile
     (``index_check.check_launch_tile``: coverage and shared memory) at
     the card's SM count (the H100's 132 on the CPU: ``fold_tile`` is a
     pure function of the launch and the SM count);
  5. runs the compiled forward once and audits what it launched
     (``launch_audit.audit_launches``): one fold-kernel call per conv, no
     4-D epilogue math outside the fused kernels.

The default device is ``cuda``, as for every entry point of the port.
Exit status is 1 when any error-severity finding survives; ``--json``
emits one machine-readable object per model on stdout.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Any, Iterator, Optional, Tuple

import torch

from repro_torch.analysis.graph_check import check_fusion, lint_graph
from repro_torch.analysis.index_check import (check_kernel_spec,
                                              check_launch_tile)
from repro_torch.analysis.launch_audit import audit_launches
from repro_torch.analysis.plan_check import check_plan
from repro_torch.analysis.report import Report
from repro_torch.device import resolve_device
from repro_torch.kernels.conv2d_ws import _sm_count, fold_kernel_spec

__all__ = ["lint_model", "main", "parser", "MODELS", "H100_SM_COUNT"]

MODELS = ("vgg16", "resnet18", "mobilenetv2")

# the JAX package's zoo footprint: big enough that every dataflow and fold
# geometry is exercised, small enough that --model all on the CPU stays a
# few seconds
DEFAULT_IMG = 32
DEFAULT_WIDTH = 0.0625
DEFAULT_CLASSES = 10
DEFAULT_BATCH = 1
# the SMs of an H100 SXM: the CTA tiles proven on the CPU are the card's
H100_SM_COUNT = 132


def sm_count(device: torch.device) -> int:
    """The SM count the CTA tiles are chosen for: the card's own on a CUDA
    device, the H100's on the CPU."""
    if device.type == "cuda":
        return _sm_count(device)
    return H100_SM_COUNT


def _check_layers(net, params, input_shape: Tuple[int, ...], sms: int,
                  rep: Report) -> int:
    """Re-walk the lowered graph and prove every conv layer's plan, kernel
    index maps and CTA tile (on the network's operand type: int8 for an
    int8 schedule, else its parameters', so a bf16 network's WS, OS and
    psum launches prove tensor-core tiles).  Mirrors the engine's shape walk
    (pool demotion included) but reports findings instead of raising."""
    from repro_torch.core.epilogue import epilogue_out_hw
    from repro_torch.core.graph import DEPTHWISE
    from repro_torch.core.loopnest import ConvLoopNest

    g = net.graph
    scheds: Iterator = iter(net.layer_schedules)
    shapes = {g.input: tuple(input_shape)}
    checked = 0
    for nd in g.nodes:
        srcs = [shapes.get(i) for i in nd.all_inputs()]
        if any(s is None for s in srcs):
            continue
        if nd.op == "conv":
            n_, chan, h, w_ = srcs[0]
            nf, cin, r, s = (int(d) for d in params[nd.param]["w"].shape)
            groups = chan if nd.groups == DEPTHWISE else nd.groups
            cv = ConvLoopNest(n=n_, nf=nf, c=chan, r=r, s=s, x=h, y=w_,
                              stride=nd.stride, pad=nd.pad, groups=groups)
            sname, sched = next(scheds)
            where = f"{nd.name}[{sched.dataflow}]"
            if sname != nd.name:
                rep.add("plan.groups-mismatch", where,
                        f"layer_schedules order diverged: engine recorded "
                        f"{sname!r} where the graph walk sees {nd.name!r}")
                return checked
            epi = nd.epilogue
            if epi is not None and epi.pool and (cv.p < 2 or cv.q < 2):
                epi = dataclasses.replace(epi, pool=None)
            if sched.key.precision == "int8":
                # the kernel sees the requantized epilogue: bias folded
                # into the dequant shift, scale always on
                from repro_torch.core.quant import requant_epilogue
                epi = requant_epilogue(epi)
            plan = sched.plan.clamped(cv.nf, cv.c, cv.p)
            layer_rep = check_plan(cv, plan, where=where,
                                   precision=sched.key.precision)
            if layer_rep.ok:
                try:
                    spec = fold_kernel_spec(
                        (cv.n, cv.c, cv.padded_x, cv.padded_y),
                        (cv.nf, cv.c // groups, cv.r, cv.s),
                        stride=cv.stride, plan=plan,
                        dataflow=sched.dataflow, epilogue=epi,
                        groups=groups)
                except ValueError as e:
                    rep.add("index.rank", where,
                            f"fold_kernel_spec rejected the launch: {e}")
                else:
                    layer_rep.extend(check_kernel_spec(spec, where=where))
                    if layer_rep.ok:
                        layer_rep.extend(check_launch_tile(
                            spec, cv.n, sms, where=where,
                            dtype=torch.int8
                            if sched.key.precision == "int8"
                            else net.dtype))
            rep.extend(layer_rep)
            checked += 1
            po, qo = epilogue_out_hw(nd.epilogue, cv.p, cv.q)
            shapes[nd.name] = (n_, nf, po, qo)
        elif nd.op in ("bias", "batchnorm", "relu", "relu6"):
            shapes[nd.name] = srcs[0]
        elif nd.op == "maxpool2":
            n_, cch, h, w_ = srcs[0]
            shapes[nd.name] = (n_, cch, h // 2, w_ // 2)
        elif nd.op == "global_avgpool":
            shapes[nd.name] = (*srcs[0][:2], 1, 1)
        elif nd.op == "residual_add":
            shapes[nd.name] = srcs[0]
        elif nd.op == "flatten":
            size = 1
            for d in srcs[0][1:]:
                size *= d
            shapes[nd.name] = (srcs[0][0], size)
        elif nd.op == "dense":
            shapes[nd.name] = (srcs[0][0],
                               int(params[nd.param]["w"].shape[1]))
    return checked


def lint_model(name: str, *, img: int = DEFAULT_IMG,
               width_mult: float = DEFAULT_WIDTH,
               classes: int = DEFAULT_CLASSES,
               batch: int = DEFAULT_BATCH,
               policy: str = "kernel",
               precision: str = "fp32",
               device: Any = "cuda") -> dict:
    """Run the full verifier stack over one zoo model; returns a
    machine-readable summary dict (``report`` holds the findings).
    ``precision`` is the engine's (``"fp32"`` or ``"int8"``) or
    ``"bf16"``: the fp32 lowering on bf16 parameters
    (``init_params(dtype=torch.bfloat16)``), whose convs stream bf16."""
    from repro_torch.models import zoo
    dev = resolve_device(device)
    spec = zoo.get_conv_model(name)
    bf16 = precision == "bf16"
    params = spec.init_params(torch.Generator(device=dev).manual_seed(0),
                              width_mult=width_mult, img=img,
                              classes=classes, device=dev,
                              dtype=torch.bfloat16 if bf16 else
                              torch.float32)
    original = spec.to_graph()
    input_shape = (batch, 3, img, img)
    sms = sm_count(dev)

    rep = Report()
    rep.extend(lint_graph(original, params, input_shape))
    summary = {"model": name, "input_shape": list(input_shape),
               "precision": precision, "device": str(dev), "sm_count": sms,
               "conv_layers": 0, "fold_calls": 0, "launches": {},
               "audited": False}
    if rep.errors:
        # a structurally broken graph cannot be compiled, let alone audited
        summary["report"] = rep.as_dict()
        summary["ok"] = False
        return summary

    net = zoo.compile_forward(name, params, img=img, batch=batch,
                              policy=policy, jit=False, verify=False,
                              precision="fp32" if bf16 else precision,
                              device=dev)
    if net.fused:
        rep.extend(check_fusion(original, net.graph))
    summary["conv_layers"] = _check_layers(net, params, input_shape, sms,
                                           rep)

    audit = audit_launches(net, params, input_shape, net.dtype)
    rep.extend(audit.findings)
    summary["fold_calls"] = audit.fold_calls
    summary["launches"] = audit.launches
    summary["audited"] = True
    summary["report"] = rep.as_dict()
    summary["ok"] = not rep.errors
    return summary


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.foldlint",
        description="statically verify the fold-schedule lowering of a "
                    "model zoo network")
    ap.add_argument("--model", default="all",
                    choices=MODELS + ("all",),
                    help="which zoo model to lint (default: all)")
    ap.add_argument("--img", type=int, default=DEFAULT_IMG)
    ap.add_argument("--width-mult", type=float, default=DEFAULT_WIDTH)
    ap.add_argument("--classes", type=int, default=DEFAULT_CLASSES)
    ap.add_argument("--batch", type=int, default=DEFAULT_BATCH)
    ap.add_argument("--policy", default="kernel",
                    choices=("kernel", "auto", "reference"),
                    help="execution policy to compile under "
                         "(default: kernel)")
    ap.add_argument("--precision", default="fp32",
                    choices=("fp32", "int8", "bf16"),
                    help="streaming precision to compile under; bf16 "
                         "lowers bf16 parameters in fp32 mode "
                         "(default: fp32)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the network compiles and its audited call "
                         "runs (default: cuda)")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON object per model on stdout")
    return ap


def main(argv: Optional[list] = None) -> int:
    args = parser().parse_args(argv)

    names = MODELS if args.model == "all" else (args.model,)
    failed = False
    for name in names:
        summary = lint_model(name, img=args.img,
                             width_mult=args.width_mult,
                             classes=args.classes, batch=args.batch,
                             policy=args.policy, precision=args.precision,
                             device=args.device)
        failed |= not summary["ok"]
        if args.json:
            print(json.dumps(summary, sort_keys=True))
            continue
        rep = summary["report"]
        status = "ok" if summary["ok"] else "FAIL"
        print(f"foldlint {name}: {status} "
              f"({summary['conv_layers']} conv layers, "
              f"{summary['fold_calls']} fold calls "
              f"{summary['launches']}, {len(rep['findings'])} finding(s))")
        for f in rep["findings"]:
            print(f"  {f['severity']}[{f['code']}] {f['where']}: "
                  f"{f['message']}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
