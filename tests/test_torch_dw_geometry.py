"""The depthwise kernel's launch geometry on the CPU: ``dw_geometry``'s
pick (the outputs along Q a thread owns, the rows and channels a CTA)
proven by ``check_launch_tile`` on MobileNetV2's 17 depthwise layers at
batch 1, 2, 4 and 8 and on the kernel's unit cases at every strip, seeded
geometry faults found, and a thread-by-thread emulation of the kernel's
thread-to-output map (``dw_kernel`` in ``csrc/fold_conv.cuh``: each
thread's taps R then S, its epilogue, its 2x2 pool window) held bitwise
against the plain depthwise walk at every strip, in fp32, bf16 and
int8."""
import dataclasses
import functools
import pathlib
import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.index_check import (check_dw_geometry,  # noqa: E402
                                              check_launch_tile)
from repro_torch.core.epilogue import Epilogue as TEpilogue  # noqa: E402
from repro_torch.core.mapping import ConvBlockPlan as TPlan  # noqa: E402
from repro_torch.kernels import conv2d_ws as t_kern  # noqa: E402
from test_torch_fold_conv import (DW_CUDA_CASES, _dw_plan,  # noqa: E402
                                  _epi_operands, _inputs)

SMS = 132          # the H100's SMs
BATCHES = (1, 2, 4, 8)
N_DW_LAYERS = 17   # MobileNetV2's depthwise convs


@functools.lru_cache(maxsize=None)
def _zoo_dw_specs(batch):
    """MobileNetV2's depthwise launches at full width, img 32, as the
    engine compiles them (weights on the meta device)."""
    from repro_torch.core.epilogue import Epilogue
    from repro_torch.models import zoo
    spec = zoo.get_conv_model("mobilenetv2")
    params = spec.init_params(torch.Generator(), img=32, device="meta")
    net = zoo.compile_forward(spec, params, img=32, batch=batch,
                              device="meta")
    epis = {nd.name: nd.epilogue or Epilogue() for nd in net.graph.nodes
            if nd.op == "conv"}
    nests = dict(net.layer_nests)
    out = []
    for name, sched in net.layer_schedules:
        if sched.dataflow != "depthwise":
            continue
        cv = nests[name]
        out.append((name, t_kern.fold_kernel_spec(
            (cv.n, cv.c, cv.padded_x, cv.padded_y),
            (cv.nf, cv.c // cv.groups, cv.r, cv.s), stride=cv.stride,
            plan=sched.plan, dataflow="depthwise", epilogue=epis[name],
            groups=cv.groups)))
    return tuple(out)


def _case_spec(case):
    n, c, x_, y_, r, stride, pad, epi, forced = case
    return t_kern.fold_kernel_spec(
        (n, c, x_ + 2 * pad, y_ + 2 * pad), (c, 1, r, r), stride=stride,
        plan=_dw_plan(TPlan, forced, c), dataflow="depthwise",
        epilogue=TEpilogue(**epi), groups=c)


def test_zoo_has_the_expected_depthwise_layers():
    assert len(_zoo_dw_specs(4)) == N_DW_LAYERS


@pytest.mark.parametrize("layer", range(N_DW_LAYERS))
@pytest.mark.parametrize("batch", BATCHES)
def test_dw_geometry_is_proven_on_zoo_layers(batch, layer):
    """The pick and every other strip of each zoo layer pass the launch
    check; the pick is the widest strip with ``DW_WARPS_PER_SM`` warps an
    SM where one has them, else the narrowest."""
    name, spec = _zoo_dw_specs(batch)[layer]
    rep = check_launch_tile(spec, batch, SMS, where=name)
    assert rep.ok, rep.findings
    pick = t_kern.dw_geometry(spec, batch, SMS)
    choices = t_kern.dw_tq_choices(spec)
    assert choices == t_kern.DW_TQS
    geoms = {t: t_kern.dw_geometry(spec, batch, SMS, tq=t) for t in choices}
    for t, g in geoms.items():
        assert check_dw_geometry(spec, batch, g, where=name).ok
        assert g.threads <= t_kern.DW_THREADS and g.pairs
    full = [t for t, g in geoms.items()
            if g.warps_per_sm >= t_kern.DW_WARPS_PER_SM]
    assert pick == geoms[max(full) if full else min(choices)]


@pytest.mark.parametrize("case", DW_CUDA_CASES)
def test_dw_geometry_is_proven_on_the_kernel_cases(case):
    spec = _case_spec(case)
    n = case[0]
    assert check_launch_tile(spec, n, SMS).ok
    pool = case[7].get("pool") == "max2"
    assert t_kern.dw_tq_choices(spec) == (t_kern.DW_POOL_TQS if pool
                                          else t_kern.DW_TQS)
    for t in t_kern.dw_tq_choices(spec):
        for sms in (1, SMS):
            rep = check_dw_geometry(
                spec, n, t_kern.dw_geometry(spec, n, sms, tq=t))
            assert rep.ok, rep.findings


def _seeds(g):
    """Seeded faults of a geometry and the finding each must raise."""
    return {
        "strip short": (dataclasses.replace(
            g, strips=g.strips - 1, threads=g.chans * g.rows
            * (g.strips - 1)), "dw.coverage"),
        "channel block lost": (dataclasses.replace(
            g, grid=(g.grid[0], g.grid[1] - 1, g.grid[2])), "dw.coverage"),
        "image lost": (dataclasses.replace(
            g, grid=(g.grid[0], g.grid[1], g.grid[2] - 1)), "dw.coverage"),
        "threads short": (dataclasses.replace(g, threads=g.threads - 1),
                          "dw.coverage"),
        "CTA too wide": (dataclasses.replace(
            g, chans=g.chans * 2, threads=g.threads * 2 + 128),
            "dw.cta-threads"),
        "no such strip": (dataclasses.replace(g, tq=3), "dw.shape"),
        "pairs on odd rows": (dataclasses.replace(g, pairs=not g.pairs),
                              "dw.shape"),
    }


@pytest.mark.parametrize("fault", list(_seeds(
    t_kern.dw_geometry(_case_spec(DW_CUDA_CASES[0]), 2, SMS))))
def test_dw_geometry_check_finds_seeded_faults(fault):
    case = DW_CUDA_CASES[0]
    spec = _case_spec(case)
    bad, code = _seeds(t_kern.dw_geometry(spec, case[0], SMS))[fault]
    assert code in check_dw_geometry(spec, case[0], bad).codes()


def test_dw_geometry_check_finds_a_split_pool_window():
    """A strip of one column under the fused pool: not a strip the kernel
    has, and each 2x2 window's columns in two threads."""
    case = next(c for c in DW_CUDA_CASES if c[7].get("pool"))
    spec = _case_spec(case)
    g = t_kern.dw_geometry(spec, case[0], SMS)
    strips = spec.q // 2 * 2
    bad = dataclasses.replace(g, tq=1, strips=strips, rows=1, chans=1,
                              threads=strips,
                              grid=(spec.p_pad // 2, spec.c, case[0]))
    codes = check_dw_geometry(spec, case[0], bad).codes()
    assert "dw.pool-split" in codes and "dw.shape" in codes


def test_dw_geometry_picks_the_measured_strips():
    """MobileNetV2's depthwise layers at batch 4 on 132 SMs: TQ 4 on the
    32x32 layer of 96 channels, 8 on that of 144, 2 elsewhere (the strips
    PERF.md's sweep found fastest or within its spread)."""
    picks = {name: t_kern.dw_geometry(spec, 4, SMS).tq
             for name, spec in _zoo_dw_specs(4)}
    wide = {"b1_dw": 4, "b2_dw": 8}
    assert picks == {name: wide.get(name, 2) for name in picks}


def test_dw_geometry_refuses_a_row_too_wide():
    """Rows wider than DW_THREADS strips of the widest: no strip fits,
    the pick raises and the check reports it."""
    spec = t_kern.fold_kernel_spec((1, 2, 3, 1027), (2, 1, 3, 3),
                                   dataflow="depthwise", groups=2)
    assert t_kern.dw_tq_choices(spec) == ()
    with pytest.raises(ValueError, match="no depthwise strip"):
        t_kern.dw_geometry(spec, 1, SMS)
    assert check_launch_tile(spec, 1, SMS).codes() == ["dw.shape"]


def test_dw_constants_match_the_kernel_source():
    """``DW_THREADS``, ``DW_MAX_CHANS``, the strips and the pool's strips
    are the kernel's: its constants, its TQ instances, and the strips
    launch_dw takes under the pool."""
    src = (pathlib.Path(t_kern.__file__).parent / "csrc"
           / "fold_conv.cuh").read_text()
    assert re.search(r"constexpr int DW_THREADS = (\d+);", src).group(1) \
        == str(t_kern.DW_THREADS)
    assert re.search(r"constexpr int DW_MAX_CHANS = (\d+);", src).group(1) \
        == str(t_kern.DW_MAX_CHANS)
    launch = src[src.index("void launch_dw_tq("):]
    launch = launch[:launch.index("\n}\n")]
    tqs = [int(t) for t in re.findall(r"launch_dw_taps<T, A, KR, KS, ST, "
                                      r"(\d+)>", launch)]
    assert tuple(sorted(tqs)) == t_kern.DW_TQS
    assert "tq == 2 || tq == 4 || (tq == 8 && span == 1)" in src
    assert t_kern.DW_POOL_TQS == (2, 4)


# --------------------------------------------------------------------------
# The kernel's thread-to-output map, emulated thread by thread
# --------------------------------------------------------------------------

def emulate_dw_launch(spec, geom, xp, wp, vec, res):
    """What ``dw_kernel`` computes on ``geom``, thread by thread (every
    thread of every CTA at once, as tensors): the thread's channel, output
    row and strip from its block and thread ids as the kernel takes them
    (its CTA is (strips, rows, chans) threads: ``tid`` runs x fastest),
    each of its outputs summed over the taps R then S from 0 (the plain
    walk's arithmetic: a product, then a sum), its epilogue,
    and each 2x2 pool window finished inside the thread.  Returns the
    padded output and how many times each element was written."""
    n = xp.shape[0]
    pool = spec.epilogue.pool == "max2"
    span = 2 if pool else 1
    po, qo = spec.p_pad // span, spec.q // span
    qlim, st, tq = span * qo, spec.stride, geom.tq
    epi = spec.epilogue
    acc_dtype = torch.int32 if xp.dtype == torch.int8 else torch.float32
    bz, by, bx, tid = (t.reshape(-1) for t in torch.meshgrid(
        torch.arange(geom.grid[2]), torch.arange(geom.grid[1]),
        torch.arange(geom.grid[0]), torch.arange(geom.threads),
        indexing="ij"))
    strip = tid % geom.strips
    u = tid // geom.strips
    rl, cl = u % geom.rows, u // geom.rows
    op, c = bx * geom.rows + rl, by * geom.chans + cl
    live = (cl < geom.chans) & (op < po) & (c < spec.c)
    bz, c, op, q0 = bz[live], c[live], op[live], strip[live] * tq
    nq = torch.clamp(qlim - q0, max=tq)
    x, w = xp.to(acc_dtype), wp.to(acc_dtype)
    best = []
    for dp in range(span):
        p = op * span + dp
        row = []
        for j in range(tq):
            qq = torch.clamp(q0 + j, max=qlim - 1)   # past nq: not stored
            acc = torch.zeros(c.shape, dtype=acc_dtype)
            for r in range(spec.r):
                for s in range(spec.s):
                    acc = acc + x[bz, c, p * st + r, qq * st + s] \
                        * w[c, 0, r, s]
            v = acc.float()
            if epi.bias:
                v = v + vec[c, 0]
            if epi.scale:
                v = v * vec[c, 1] + vec[c, 2]
            if epi.residual:
                v = v + res[bz, c, p, qq].float()
            if epi.relu:
                v = torch.relu(v)
            if epi.relu6:
                v = torch.clamp(v, 0.0, 6.0)
            row.append(v)
        best.append(row)
    out = torch.full(spec.output.array_shape, float("nan"))
    count = torch.zeros(spec.output.array_shape, dtype=torch.int32)
    for k in range(tq // span):
        if pool:
            val = torch.maximum(
                torch.maximum(best[0][2 * k], best[0][2 * k + 1]),
                torch.maximum(best[1][2 * k], best[1][2 * k + 1]))
            real = 2 * k < nq
        else:
            val, real = best[0][k], k < nq
        at = (bz[real], c[real], op[real], (q0[real] // span) + k)
        out[at] = val[real]
        count.index_put_(at, torch.ones_like(c[real], dtype=torch.int32),
                         accumulate=True)
    return out, count


EMU_CASES = DW_CUDA_CASES + [
    (2, 6, 13, 15, 5, 1, 2, {"scale": True, "relu6": True, "pool": "max2"},
     None),                                          # 5x5 + pool
    (3, 5, 10, 10, 3, 1, 1, {"bias": True, "scale": True, "residual": True,
                             "relu6": True}, None),  # every step at once
    (4, 96, 8, 8, 3, 2, 1, {"scale": True, "relu6": True}, None),
]
EMU_PARAMS = [(i, t) for i, case in enumerate(EMU_CASES)
              for t in t_kern.dw_tq_choices(_case_spec(case))]


def _emu_operands(case, dtype):
    n, c, x_, y_, r, stride, pad, epi, forced = case
    x, w, _ = (torch.from_numpy(a) for a in
               _inputs(n, c, x_ + 2 * pad, y_ + 2 * pad, c, r, r, seed=31))
    w = w[:, :1].contiguous()
    p, q = (x_ + 2 * pad - r) // stride + 1, (y_ + 2 * pad - r) // stride + 1
    ops = {k: torch.from_numpy(v) for k, v in
           _epi_operands(epi, n, c, p, q, seed=31).items()}
    if dtype == torch.int8:
        x = (x * 40).round().clamp(-127, 127).to(torch.int8)
        w = (w * 40).round().clamp(-127, 127).to(torch.int8)
    elif dtype == torch.bfloat16:
        x, w = x.to(dtype), w.to(dtype)
        if "residual" in ops:
            ops["residual"] = ops["residual"].to(dtype)
    return x, w, dict(stride=stride, plan=_dw_plan(TPlan, forced, c),
                      dataflow="depthwise", epilogue=TEpilogue(**epi),
                      groups=c, **ops)


@pytest.mark.parametrize("case_tq", EMU_PARAMS,
                         ids=[f"case{i}-tq{t}" for i, t in EMU_PARAMS])
def test_emulated_thread_map_is_bitwise_the_plain_walk(case_tq):
    """Every output of the launch written by exactly one emulated thread,
    the padding channels by none, and the values bitwise the plain walk's
    (which runs the same products and sums in the same order), in fp32,
    bf16 (widened) and int8, at this strip and at ``dw_geometry``'s pick
    on 1 and 132 SMs."""
    i, tq = case_tq
    case = EMU_CASES[i]
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        x, w, kw = _emu_operands(case, dtype)
        spec, *ops = t_kern.prepare(
            x, w, kw["stride"], kw["plan"], "depthwise", kw.get("bias"),
            kw["epilogue"], kw["groups"], kw.get("residual"),
            kw.get("scale"), kw.get("shift"))
        want = t_kern._plain_dw_walk(spec, *ops)
        for g in (t_kern.dw_geometry(spec, x.shape[0], SMS, tq=tq),
                  t_kern.dw_geometry(spec, x.shape[0], 1, tq=tq)):
            got, count = emulate_dw_launch(spec, g, *ops)
            c = spec.c
            assert bool((count[:, :c] == 1).all())
            assert bool((count[:, c:] == 0).all())
            assert torch.equal(got[:, :c], want[:, :c]), (dtype, g)
