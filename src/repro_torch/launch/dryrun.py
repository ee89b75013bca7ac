"""The multi-pod dry-run (the JAX package's ``launch/dryrun.py``): every
(arch x shape) cell's step traced as the sharded program of the
production mesh, 16x16 or 2x16x16, and its per-device memory, cost and
collectives recorded.

The JAX package lowers and compiles the SPMD-partitioned step against
512 fake host devices and reads XLA's analyses.  The port has no
partitioner: it lays the step's parameters, optimizer state, cache and
batch out as ``DTensor``s of ``meta`` local tensors
(``distributed/sharding.distribute_tree``) on a fake process group of 256
or 512 ranks in this one process (``launch/mesh.make_production_mesh(
fake=True)``), and runs the step under ``op_cost.analyze_step``, which
counts rank 0's local ops and the collectives ``DTensor`` runs.
Nothing is allocated and nothing reaches a device: a planning tool, as
in the JAX package.  The output goes to ``build/dryrun/`` (one JSON per
cell, the JAX package's keys).

The trace is of the stack at two depths, two and three repeats of its
layer pattern (a layer; gemma3's local:global group; zamba2's group of
mamba2 layers and the shared block, with the remainder layers in both),
after a warm-up trace, and the counts are taken to the full depth
linearly: every count is a sum over the layers, so the full stack's is
the first depth's plus the repeats' increments, as the JAX walker scales
a ``while`` body by its trip count (``trip_counts``).  A stack of one
repeat is not cut to: DTensor lays out the gradients of a stack of one
layer otherwise than those of more (rwkv6's train step).  A stack of
three repeats or fewer, or an enc-dec whose two stacks differ in depth,
is traced whole.  The increment is exact where DTensor lays a tensor
out the same way at every depth, as it does the parameters, the cache
(each layer's new recurrent state is laid out as its cache layer) and
the activations.  ZeRO-1's layout of the optimizer state can follow the
depth (the data axes fold onto the layers dim only where the depth
divides by them): where it does, the cut depths trace the loss and
gradients alone and the AdamW update is traced on its own at the full
depth.  The per-device argument, donated and result bytes are the full
depth's, from the abstract trees and their shardings.

    python -m repro_torch.launch.dryrun --arch all --shape all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import time
import traceback
from pathlib import Path
from typing import Optional, Sequence, Tuple

from repro_torch.configs.base import SHAPES, ShapeSpec
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.core.mapping import PartitionSpec
from repro_torch.distributed import sharding as shd
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.mesh import (Mesh, end_fake_group, make_fake_mesh,
                                     make_production_mesh)
from repro_torch.models import api
from repro_torch.models.common import map_axes
from repro_torch.models.settings import attn_impl as attn_ctx
from repro_torch.models.settings import remat as remat_ctx
from repro_torch.op_cost import OpCost, analyze_step, local_bytes
from repro_torch.optim.adamw import (AdamWConfig, abstract_opt_state,
                                     adamw_update)
from repro_torch.roofline import roofline_terms
from repro_torch.serve.steps import make_decode_step, make_prefill_step
from repro_torch.train.steps import lm_grads, make_train_step
from repro_torch.tree import leaves

__all__ = ["model_flops_for", "build_cell", "analyze", "run_cell", "main",
           "cell_inputs", "argument_bytes", "depth_plan", "RESULTS"]

RESULTS = Path(__file__).resolve().parents[3] / "build" / "dryrun"


def model_flops_for(cfg, shape) -> float:
    """Analytic MODEL_FLOPS for the step (6ND train / 2ND forward)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch      # decode: 1 token/seq


def _dp_size(mesh):
    return int(mesh.shape.get("pod", 1)) * int(mesh.shape.get("data", 1))


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def _mesh_axes(shape: Sequence[int]) -> Tuple[str, ...]:
    return ("pod", "data", "model")[-len(shape):]


def _batch_shardings(axes_tree, rules, mesh):
    return map_axes(lambda a: shd.NamedSharding(mesh, shd.spec_for(a, rules)),
                    axes_tree)


def cell_inputs(cfg, shape: ShapeSpec, mesh: Mesh, rules, *,
                remat: str = "dots", attn_impl: str = "naive"):
    """(step, abstract arguments, their ``NamedSharding``s, donated
    argument indices) of a cell: the JAX dry-run's ``in_shardings`` and
    ``donate_argnums`` (``repro/launch/dryrun.py:66-131``)."""
    params_abs = api.init_params(cfg, abstract=True)
    axes = api.param_axes(cfg)
    p_sh = shd.tree_shardings(axes, rules, mesh)
    repl = shd.NamedSharding(mesh, PartitionSpec())
    if shape.kind == "train":
        opt_abs = abstract_opt_state(params_abs)
        z1 = shd.zero1_shardings(axes, params_abs, rules, mesh)
        o_sh = {"step": repl, "mu": z1, "nu": z1, "master": z1}
        batch_abs = specs_mod.train_batch_specs(cfg, shape)
        b_sh = _batch_shardings(specs_mod.train_batch_axes(cfg), rules, mesh)
        step = make_train_step(cfg, AdamWConfig(), remat=remat,
                               attn_impl=attn_impl)
        return (step, (params_abs, opt_abs, batch_abs), (p_sh, o_sh, b_sh),
                (0, 1))
    max_len = shape.seq_len + (cfg.frontend_len
                               if cfg.frontend == "vlm" else 0)
    cache_abs = api.init_cache(cfg, shape.global_batch, max_len,
                               src_len=specs_mod.src_len_for(cfg, shape),
                               abstract=True)
    c_sh = shd.tree_shardings(api.cache_axes(cfg), rules, mesh)
    if shape.kind == "prefill":
        batch_abs = specs_mod.prefill_batch_specs(cfg, shape)
        b_sh = _batch_shardings(specs_mod.prefill_batch_axes(cfg), rules,
                                mesh)
        step = make_prefill_step(cfg, attn_impl=attn_impl)
        return (step, (params_abs, batch_abs, cache_abs), (p_sh, b_sh, c_sh),
                (2,))
    token_abs, pos_abs = specs_mod.decode_input_specs(cfg, shape)
    tok_sh = shd.NamedSharding(mesh, shd.spec_for(("batch",), rules))
    step = make_decode_step(cfg)
    return (step, (params_abs, token_abs, cache_abs, pos_abs),
            (p_sh, tok_sh, c_sh, repl), (2,))


def _sharded_bytes(tree, shardings) -> int:
    """Bytes one rank holds of an abstract tree under its shardings."""
    if isinstance(tree, dict):
        return sum(_sharded_bytes(tree[k], shardings[k]) for k in tree)
    if isinstance(tree, (list, tuple)):
        return sum(_sharded_bytes(t, s) for t, s in zip(tree, shardings))
    n = 1
    for d in shardings.local_shape(tree.shape):
        n *= d
    return n * tree.element_size()


def _rules_for(cfg, shape, mesh, seq_shard_kv=None):
    shard_batch = shape.global_batch % _dp_size(mesh) == 0
    if seq_shard_kv is None:
        seq_shard_kv = shape.kind == "decode" and not shard_batch
    return (shd.make_rules(cfg, mesh, seq_shard_kv=seq_shard_kv,
                           shard_batch=shard_batch),
            bool(seq_shard_kv), shard_batch)


def argument_bytes(arch: str, shape_name: str, multi_pod: bool,
                   **kw) -> int:
    """Per-device bytes of a cell's step arguments (parameters, optimizer
    state and batch, or parameters, batch or token and cache) at full
    size, from the abstract trees and the rules alone: no trace."""
    cfg, shape = get_config(arch), SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules, _, _ = _rules_for(cfg, shape, mesh)
    _, args, shardings, _ = cell_inputs(cfg, shape, mesh, rules, **kw)
    return _sharded_bytes(args, shardings)


def depth_plan(cfg) -> Optional[Tuple[int, int, int, int]]:
    """(unit, remainder, repeats, traced depth at two repeats) of the
    stack's layer pattern, or None when it is traced whole."""
    if cfg.global_every and cfg.sliding_window:
        unit = cfg.global_every
    else:
        unit = cfg.shared_attn_every or 1
    rem = cfg.n_layers % unit
    trips = cfg.n_layers // unit
    if trips <= 3 or (cfg.is_encdec and cfg.enc_layers != cfg.n_layers):
        return None
    return unit, rem, trips, 2 * unit + rem


def _at_depth(cfg, n: int):
    if cfg.is_encdec:
        return dataclasses.replace(cfg, n_layers=n, enc_layers=n)
    return dataclasses.replace(cfg, n_layers=n)


def _distributed(args, shardings):
    return tuple(shd.distribute_tree(a, s) if isinstance(a, dict)
                 else s.distribute(a) for a, s in zip(args, shardings))


def _traced(fn, *args, **kw):
    """(``analyze_step``'s cost of ``fn(*args)``, its result)."""
    box = []

    def run(*a):
        box.append(fn(*a))
        return box[0]
    return analyze_step(run, *args, **kw), box[0]


def _trace(cfg, shape, mesh, rules, remat, attn_impl, keep_ops):
    """The step at ``cfg``'s depth: (cost, its result)."""
    step, args, shardings, donate = cell_inputs(
        cfg, shape, mesh, rules, remat=remat, attn_impl=attn_impl)
    return _traced(step, *_distributed(args, shardings),
                   donate_argnums=donate, keep_ops=keep_ops)


def _trace_grads(cfg, shape, mesh, rules, remat, attn_impl, keep_ops):
    """The train step's loss and gradients (``lm_grads``, under the
    step's remat and attention) at ``cfg``'s depth: (cost, (metrics,
    grads))."""
    _, args, shardings, _ = cell_inputs(cfg, shape, mesh, rules)
    params, _, batch = _distributed(args, shardings)

    def grads(p, b):
        with remat_ctx(remat), attn_ctx(attn_impl):
            return lm_grads(p, cfg, b)
    return _traced(grads, params, batch, keep_ops=keep_ops)


def _widened(t, full):
    """A ``meta`` DTensor of ``full``'s global shape laid out as the
    DTensor ``t`` is."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    local, _ = compute_local_shape_and_global_offset(
        full.shape, t.device_mesh, t.placements)
    return DTensor.from_local(
        torch.empty(local, dtype=t.dtype, device="meta"), t.device_mesh,
        t.placements, run_check=False, shape=full.shape,
        stride=torch.empty(full.shape, device="meta").stride())


def _trace_update(cfg, shape, mesh, rules, grads, keep_ops):
    """The train step's AdamW update of ``cfg``'s parameters and ZeRO-1
    state at its depth, on gradients laid out as ``grads`` (a cut
    depth's) are: (cost, result)."""
    _, args, shardings, _ = cell_inputs(cfg, shape, mesh, rules)
    params, opt, _ = _distributed(args, shardings)
    return _traced(lambda p, g, s: adamw_update(p, g, s, AdamWConfig()),
                   params, map_axes(_widened, grads, args[0]), opt,
                   donate_argnums=(0, 2), keep_ops=keep_ops)


def _linear(c2: OpCost, c3: OpCost, trips: int) -> OpCost:
    """``c2 + (trips - 2) * (c3 - c2)``: the counts at ``trips`` repeats
    of the layer pattern from those at two (``c2``) and three (``c3``)."""
    cost = c2.scaled(3 - trips)
    cost.add(c3.scaled(trips - 2))
    cost.ops = c2.ops
    return cost


def _zero1_specs(cfg, shape, mesh, rules):
    """ZeRO-1's spec of each optimizer-state leaf at ``cfg``'s depth."""
    return [sh.spec for sh in leaves(
        cell_inputs(cfg, shape, mesh, rules)[2][1]["mu"])]


def _extrapolated(cfg, shape, mesh, rules, remat, attn_impl, keep_ops,
                  plan) -> OpCost:
    """The step's cost at ``cfg``'s depth from traces at cut depths
    (``depth_plan``).  Where ZeRO-1's layout at a cut depth is not the
    full depth's (the data axes fold onto the layers dim only where the
    depth divides by them), the cut depths trace the loss and gradients
    alone and the AdamW update is traced on its own at the full depth.
    The argument, donated and result bytes are the full depth's, from
    the abstract trees and their shardings: the donated results in the
    layout traced, the rest (the loss, the next token, the logits) as
    traced."""
    unit, rem, trips, d2 = plan
    cut = (_at_depth(cfg, d2), _at_depth(cfg, d2 + unit))
    split = shape.kind == "train" and any(
        _zero1_specs(c, shape, mesh, rules)
        != _zero1_specs(cfg, shape, mesh, rules) for c in cut)
    trace = _trace_grads if split else _trace
    # a first trace warms DTensor's caches: an op's first dispatch runs
    # work of its own (a decomposition, an index plan) that its later
    # dispatches skip, and the two traces must differ by the repeats' ops
    trace(cut[0], shape, mesh, rules, remat, attn_impl, False)
    c2, r2 = trace(cut[0], shape, mesh, rules, remat, attn_impl, keep_ops)
    c3, _ = trace(cut[1], shape, mesh, rules, remat, attn_impl, False)
    cost = _linear(c2, c3, trips)
    cost.trip_counts = {"dec" if cfg.is_encdec else "blocks": trips}
    _, args, shardings, donate = cell_inputs(cfg, shape, mesh, rules)
    if split:
        metrics, grads = r2
        upd, r2 = _trace_update(cfg, shape, mesh, rules, grads, keep_ops)
        # the update starts beside the gradients and the loss (the grads
        # trace's result); its own ops' peak comes on top of them
        peak = max(cost.peak_bytes, cost.out_bytes + upd.peak_bytes)
        cost.add(upd)
        cost.peak_bytes = peak
        cost.ops = None if c2.ops is None else c2.ops + upd.ops
        r2 = r2 + (metrics,)
    cost.out_bytes = float(sum(
        local_bytes(map_axes(_widened, r, args[i]) if i in donate else r)
        for i, r in enumerate(r2)))
    cost.arg_bytes = float(_sharded_bytes(args, shardings))
    cost.alias_bytes = float(sum(_sharded_bytes(args[i], shardings[i])
                                 for i in donate))
    return cost


def build_cell(arch: str, shape_name, multi_pod: bool, *,
               remat: str = "dots", attn_impl: str = "naive",
               seq_shard_kv=None, extra=None,
               mesh_shape: Optional[Sequence[int]] = None,
               keep_ops: bool = False):
    """Trace one cell.  Returns (``OpCost`` per device, meta dict), or
    (None, the skip record).  ``shape_name`` may be a ``ShapeSpec``;
    ``mesh_shape`` replaces the production mesh by a fake one of that
    shape (the tests' 2x2 and 2x1x2)."""
    cfg = get_config(arch)
    if extra:
        cfg = dataclasses.replace(cfg, **extra)
    shape = (shape_name if isinstance(shape_name, ShapeSpec)
             else SHAPES[shape_name])
    if not cfg.runs_shape(shape):
        return None, {"skipped": True,
                      "reason": f"{arch} is full-attention; {shape.name} "
                                "requires sub-quadratic (DESIGN.md §6)"}
    if mesh_shape is None:
        mesh = make_production_mesh(multi_pod=multi_pod, fake=True)
    else:
        mesh = make_fake_mesh(mesh_shape, _mesh_axes(mesh_shape))
    t0 = time.time()
    # DTensor logs each two-step redistribution of a partial sum over
    # both mesh axes; the trace counts them
    quiet = logging.getLogger("torch.distributed.tensor._redistribute")
    level = quiet.level
    quiet.setLevel(logging.ERROR)
    try:
        rules, seq_shard_kv, shard_batch = _rules_for(cfg, shape, mesh,
                                                      seq_shard_kv)
        shd.set_context(mesh, rules)
        plan = depth_plan(cfg)
        if plan is None:
            cost, _ = _trace(cfg, shape, mesh, rules, remat, attn_impl,
                             keep_ops)
            depths = [cfg.n_layers]
        else:
            cost = _extrapolated(cfg, shape, mesh, rules, remat, attn_impl,
                                 keep_ops, plan)
            depths = [plan[3], plan[3] + plan[0]]
    finally:
        quiet.setLevel(level)
        shd.clear_context()
        end_fake_group()
    meta = {
        "arch": arch, "shape": shape.name,
        "mesh": ("x".join(map(str, mesh_shape)) if mesh_shape
                 else _mesh_name(multi_pod)),
        "chips": mesh.size,
        "kind": shape.kind,
        "remat": remat if shape.kind == "train" else None,
        "attn_impl": attn_impl,
        "seq_shard_kv": bool(seq_shard_kv),
        "shard_batch": bool(shard_batch),
        # the trace's seconds (the JAX package's compile seconds)
        "compile_s": time.time() - t0,
        "traced_depths": depths,
        "ops_counted": cost.n_ops,
    }
    return cost, meta


def analyze(cost: OpCost, meta, cfg, shape):
    """The cell's record: ``meta``, the per-device memory and the
    roofline.  ``argument_bytes`` / ``output_bytes`` are the exact
    per-rank bytes of the step's DTensor arguments and results,
    ``alias_bytes`` the donated arguments'; ``temp_bytes`` is the port's
    estimate: the peak of live bytes the step's own ops held, less its
    results."""
    rep = roofline_terms(cost, chips=meta["chips"],
                         model_flops=model_flops_for(cfg, shape))
    temp = max(cost.peak_bytes - cost.out_bytes, 0.0)
    out = dict(meta)
    out["memory"] = {
        "argument_bytes": cost.arg_bytes,
        "output_bytes": cost.out_bytes,
        "temp_bytes": temp,
        "temp_bytes_is": "estimate: peak live bytes of the traced ops, "
                         "less the results",
        "alias_bytes": cost.alias_bytes,
        "total_per_device": (cost.arg_bytes + cost.out_bytes + temp
                             - cost.alias_bytes),
    }
    out["roofline"] = rep.as_dict()
    out["trip_counts"] = cost.trip_counts
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool, outdir: Path,
             save_trace: bool = False, tag_suffix=None, **kw):
    """Trace, analyze and write one cell's JSON; a failure is recorded
    (``ok: false``, its error and traceback), not raised."""
    cfg = get_config(arch)
    if kw.get("extra"):
        cfg = dataclasses.replace(cfg, **kw["extra"])
    tag = f"{arch}__{shape_name}__{_mesh_name(multi_pod)}"
    if tag_suffix:
        tag += f"__{tag_suffix}"
    out_path = outdir / f"{tag}.json"
    outdir.mkdir(parents=True, exist_ok=True)
    try:
        cost, meta = build_cell(arch, shape_name, multi_pod,
                                keep_ops=save_trace, **kw)
        if cost is None:
            result = meta | {"arch": arch, "shape": shape_name,
                             "mesh": _mesh_name(multi_pod)}
        else:
            result = analyze(cost, meta, cfg, SHAPES[shape_name])
            if save_trace:
                (outdir / f"{tag}.ops.txt").write_text("".join(
                    f"{name}\t{shapes}\t{flops:.6g}\t{nbytes:.6g}\n"
                    for name, shapes, flops, nbytes in cost.ops or ()))
        result["ok"] = True
    except Exception as e:  # record the failure for the cell's reader
        result = {"arch": arch, "shape": shape_name, "ok": False,
                  "mesh": _mesh_name(multi_pod),
                  "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()[-4000:]}
    out_path.write_text(json.dumps(result, indent=1, default=str))
    return result


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="multi-pod dry-run")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--out", default=str(RESULTS))
    ap.add_argument("--save-trace", action="store_true",
                    help="write each cell's counted ops (<tag>.ops.txt)")
    ap.add_argument("--remat", default="dots")
    ap.add_argument("--attn-impl", default="naive",
                    choices=["naive", "blockwise"])
    ap.add_argument("--extra", default=None,
                    help="JSON dict of ArchConfig field overrides")
    ap.add_argument("--remat-override", default=None)
    ap.add_argument("--tag", default=None,
                    help="suffix for the result filename")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    outdir = Path(args.out)
    archs = list(ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]
    extra = json.loads(args.extra) if args.extra else None
    failed = 0
    for arch in archs:
        for sname in shapes:
            for mp in meshes:
                tag = f"{arch}__{sname}__{_mesh_name(mp)}"
                if args.skip_existing and (outdir / f"{tag}.json").exists():
                    prev = json.loads((outdir / f"{tag}.json").read_text())
                    if prev.get("ok"):
                        print(f"[skip] {tag}")
                        continue
                t0 = time.time()
                r = run_cell(arch, sname, mp, outdir,
                             save_trace=args.save_trace, remat=args.remat,
                             attn_impl=args.attn_impl, extra=extra,
                             tag_suffix=args.tag)
                failed += not r.get("ok")
                status = ("SKIP(" + r.get("reason", "")[:40] + ")"
                          if r.get("skipped") else
                          "OK" if r.get("ok") else
                          "FAIL " + r.get("error", "")[:120])
                print(f"[{time.time()-t0:7.1f}s] {tag}: {status}",
                      flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
