"""The tensor-core tiles of the bf16 weight-stationary, output-stationary
and psum-staging kernels (``csrc/fold_conv_tc.cuh``), on the CPU: what the
tile chooser picks, that the analysis proves it, and the kernels' sum
order as data.

* Every WS, OS and psum launch of the zoo's main paths in bf16 (VGG-16 at
  224, batch 1 and 4, and at 32, batch 4; ResNet-18 and MobileNetV2 at 32,
  batch 4; the psum launches of VGG-16's layers at 224) picks a tile of
  ``TC_TILES`` at the H100's 132 SMs, within a CTA's 232,448 bytes of
  shared memory, and ``check_launch_tile`` proves it.
* The fp32 and int8 picks of the same launches (WS, OS and psum), and the
  bf16 WS and psum picks, are the parent commits', held against tables
  recorded from them.
* The kernels' sum order, mirrored here from the constants
  ``fold_conv_tc.cuh`` compiles with (the mirror's step and chunk are
  read from the header, and the wrapper prices shared memory with the
  same ones), gives the same 16-tap steps at batch 1, 2, 4 and 8, with
  every tensor-core tile, and in the WS walk (fold by fold) and the OS one
  (every fold in one walk) of each zoo OS layer.
* ``compile_network(verify=True)`` on a bf16 VGG-16 (width 0.25) proves
  tensor-core tiles; a bf16 WS launch no tensor-core tile fits raises;
  seeded faults of the OS weight ring are found.

The ``cuda`` cases, which skip here, hold each tensor-core tile against
the plain walk, bf16 OS bitwise equal to bf16 WS, and a bf16 trunk
bitwise across batch widths on the card.
"""
import dataclasses
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.index_check import check_launch_tile  # noqa: E402
from repro_torch.analysis.plan_check import check_tile_residency  # noqa
from repro_torch.analysis.report import FoldLintError  # noqa: E402
from repro_torch.core import engine as t_engine  # noqa: E402
from repro_torch.core.epilogue import Epilogue  # noqa: E402
from repro_torch.core.mapping import ConvBlockPlan  # noqa: E402
from repro_torch.core.quant import requant_epilogue  # noqa: E402
from repro_torch.kernels import conv2d_ws as t_kern  # noqa: E402
from repro_torch.models import zoo  # noqa: E402

BF16 = torch.bfloat16
SMS = 132               # the H100's SMs
PATHS = {"vgg16_224_b1": ("vgg16", 224, 1), "vgg16_224_b4": ("vgg16", 224, 4),
         "vgg16_32_b4": ("vgg16", 32, 4), "resnet18_32_b4": ("resnet18", 32, 4),
         "mobilenetv2_32_b4": ("mobilenetv2", 32, 4)}
TAG = {"weight_stationary": "ws", "output_stationary": "os",
       "weight_stationary_psum": "ps"}

# (layer:dataflow:tile:M tiles a CTA) of every WS / OS / psum launch at 132
# SMs in fp32, recorded from the parent commit; int8 picks the same tiles
PARENT_PICKS = {
    "vgg16_224_b1": (
        "conv1_1:ws:0:2 conv1_1:ps:0:2 conv1_2:ws:5:3 conv1_2:ps:5:3 "
        "conv2_1:ws:4:2 conv2_1:ps:4:2 conv2_2:ws:4:3 conv2_2:ps:4:3 "
        "conv3_1:ws:4:2 conv3_1:ps:4:2 conv3_2:ws:5:2 conv3_2:ps:5:2 "
        "conv3_3:ws:5:2 conv3_3:ps:5:2 conv4_1:ws:5:1 conv4_1:ps:5:1 "
        "conv4_2:ws:3:2 conv4_2:ps:3:2 conv4_3:ws:3:2 conv4_3:ps:3:2 "
        "conv5_1:ws:2:1 conv5_1:ps:2:1 conv5_2:ws:2:1 conv5_2:ps:2:1 "
        "conv5_3:ws:2:1 conv5_3:ps:2:1"),
    "vgg16_224_b4": (
        "conv1_1:ws:0:8 conv1_2:ws:5:12 conv2_1:ws:5:6 conv2_2:ws:4:12 "
        "conv3_1:ws:4:7 conv3_2:ws:5:7 conv3_3:ws:5:6 conv4_1:ws:5:4 "
        "conv4_2:ws:2:11 conv4_3:ws:2:11 conv5_1:ws:3:2 conv5_2:ws:3:2 "
        "conv5_3:ws:3:2"),
    "vgg16_32_b4": (
        "conv1_1:ws:1:1 conv1_2:ws:2:1 conv2_1:os:0:1 conv2_2:os:2:1 "
        "conv3_1:os:1:1 conv3_2:os:1:1 conv3_3:os:6:1 conv4_1:os:1:1 "
        "conv4_2:os:1:1 conv4_3:os:6:1 conv5_1:os:1:1 conv5_2:os:1:1 "
        "conv5_3:os:6:1"),
    "resnet18_32_b4": (
        "stem:ws:1:1 s1b0_c1:ws:0:1 s1b0_c2:ws:0:1 s1b1_c1:ws:0:1 "
        "s1b1_c2:ws:0:1 s2b0_c1:os:0:1 s2b0_down:os:1:1 s2b0_c2:os:0:1 "
        "s2b1_c1:os:0:1 s2b1_c2:os:0:1 s3b0_c1:os:1:1 s3b0_down:os:1:1 "
        "s3b0_c2:os:1:1 s3b1_c1:os:1:1 s3b1_c2:os:1:1 s4b0_c1:os:1:1 "
        "s4b0_down:os:1:1 s4b0_c2:os:1:1 s4b1_c1:os:1:1 s4b1_c2:os:1:1"),
    "mobilenetv2_32_b4": (
        "stem:ws:1:1 b0_proj:ws:1:1 b1_exp:ws:1:1 b1_proj:ws:1:1 "
        "b2_exp:ws:1:1 b2_proj:ws:1:1 b3_exp:ws:1:1 b3_proj:os:1:1 "
        "b4_exp:os:1:1 b4_proj:os:1:1 b5_exp:os:1:1 b5_proj:os:1:1 "
        "b6_exp:os:1:1 b6_proj:os:1:1 b7_exp:os:1:1 b7_proj:os:1:1 "
        "b8_exp:os:1:1 b8_proj:os:1:1 b9_exp:os:1:1 b9_proj:os:1:1 "
        "b10_exp:os:1:1 b10_proj:os:1:1 b11_exp:os:1:1 b11_proj:os:1:1 "
        "b12_exp:os:1:1 b12_proj:os:1:1 b13_exp:os:1:1 b13_proj:os:1:1 "
        "b14_exp:os:1:1 b14_proj:os:1:1 b15_exp:os:1:1 b15_proj:os:1:1 "
        "b16_exp:os:1:1 b16_proj:os:1:1 head:os:0:1"),
}

# (layer:dataflow:tile:M tiles a CTA) of every bf16 WS and psum launch at
# 132 SMs, recorded from the parent commit (its tensor-core tiles, before
# OS joined them)
PARENT_BF16_PICKS = {
    "vgg16_224_b1": (
        "conv1_1:ws:4:1 conv1_1:ps:4:1 conv1_2:ws:4:3 conv1_2:ps:4:3 "
        "conv2_1:ws:2:2 conv2_1:ps:2:2 conv2_2:ws:5:2 conv2_2:ps:5:2 "
        "conv3_1:ws:5:1 conv3_1:ps:5:1 conv3_2:ws:3:2 conv3_2:ps:3:2 "
        "conv3_3:ws:3:2 conv3_3:ps:3:2 conv4_1:ws:3:1 conv4_1:ps:3:1 "
        "conv4_2:ws:1:2 conv4_2:ps:1:2 conv4_3:ws:1:2 conv4_3:ps:1:2 "
        "conv5_1:ws:0:1 conv5_1:ps:0:1 conv5_2:ws:0:1 conv5_2:ps:0:1 "
        "conv5_3:ws:0:1 conv5_3:ps:0:1"),
    "vgg16_224_b4": (
        "conv1_1:ws:4:3 conv1_2:ws:4:12 conv2_1:ws:4:6 conv2_2:ws:5:6 "
        "conv3_1:ws:5:4 conv3_2:ws:3:7 conv3_3:ws:3:7 conv4_1:ws:3:4 "
        "conv4_2:ws:1:7 conv4_3:ws:1:7 conv5_1:ws:1:2 conv5_2:ws:1:2 "
        "conv5_3:ws:1:2"),
    "vgg16_32_b4": "conv1_1:ws:0:1 conv1_2:ws:0:1",
    "resnet18_32_b4": (
        "stem:ws:0:1 s1b0_c1:ws:0:1 s1b0_c2:ws:0:1 s1b1_c1:ws:0:1 "
        "s1b1_c2:ws:0:1"),
    "mobilenetv2_32_b4": (
        "stem:ws:0:1 b0_proj:ws:0:1 b1_exp:ws:0:1 b1_proj:ws:0:1 "
        "b2_exp:ws:0:1 b2_proj:ws:0:1 b3_exp:ws:0:1"),
}


def _launches(path):
    """(layer, launch spec, batch) of every WS / OS launch of a main path
    at full width, and of VGG-16 224 b1's layers as psum launches, as the
    engine compiles them (shapes only: the parameters live on ``meta``)."""
    name, img, batch = PATHS[path]
    spec_ = zoo.get_conv_model(name)
    params = spec_.init_params(torch.Generator(), img=img, device="meta")
    net = zoo.compile_forward(spec_, params, img=img, batch=batch,
                              device="meta", verify=False)
    scheds, nests = dict(net.layer_schedules), dict(net.layer_nests)
    for nd in net.graph.nodes:
        if nd.op != "conv" or scheds[nd.name].dataflow == "depthwise":
            continue
        cv, sched = nests[nd.name], scheds[nd.name]
        epi = nd.epilogue
        if epi is not None and epi.pool and (cv.p < 2 or cv.q < 2):
            epi = dataclasses.replace(epi, pool=None)
        plan = sched.plan.clamped(cv.nf, cv.c, cv.p)
        dfs = [sched.dataflow]
        if path == "vgg16_224_b1":
            dfs.append("weight_stationary_psum")
        for df in dfs:
            yield nd.name, t_kern.fold_kernel_spec(
                (cv.n, cv.c, cv.padded_x, cv.padded_y),
                (cv.nf, cv.c // cv.groups, cv.r, cv.s), stride=cv.stride,
                plan=plan, dataflow=df,
                epilogue=None if df == "weight_stationary_psum" else epi,
                groups=cv.groups), cv.n


@pytest.mark.parametrize("path", sorted(PATHS))
def test_bf16_ws_and_psum_launches_run_proven_tensor_core_tiles(path):
    """Every bf16 WS, OS and psum launch runs a proven tensor-core tile
    (OS one of all ``TC_TILES``, WS and psum one of the first
    ``TC_WS_TILES``)."""
    tc = 0
    for layer, spec, n in _launches(path):
        tile = t_kern.fold_tile(spec, n, SMS, dtype=BF16)
        count = len(t_kern.TC_TILES) \
            if spec.dataflow == "output_stationary" else t_kern.TC_WS_TILES
        assert tile.core == "tc" and 0 <= tile.index < count, layer
        assert tile.dataflow == spec.dataflow
        assert tile.smem <= 232_448, (layer, tile.smem)
        assert tile.kf == spec.plan.c_block * spec.r * spec.s
        rep = check_launch_tile(spec, n, SMS, where=layer, dtype=BF16)
        assert rep.findings == [], [str(f) for f in rep.findings]
        tc += 1
    assert tc == {"vgg16_224_b1": 26, "vgg16_224_b4": 13, "vgg16_32_b4": 13,
                  "resnet18_32_b4": 20, "mobilenetv2_32_b4": 35}[path]


@pytest.mark.parametrize("path", sorted(PATHS))
def test_bf16_ws_and_psum_picks_are_the_parents(path):
    """OS's new tiles (and its pricing in the tile model) move no bf16 WS
    or psum pick."""
    got = [f"{layer}:{TAG[spec.dataflow]}:{tile.index}:{tile.m_per_cta}"
           for layer, spec, n in _launches(path)
           if spec.dataflow != "output_stationary"
           for tile in [t_kern.fold_tile(spec, n, SMS, dtype=BF16)]]
    assert got == PARENT_BF16_PICKS[path].split()


@pytest.mark.parametrize("path", ["vgg16_32_b4", "resnet18_32_b4",
                                  "mobilenetv2_32_b4"])
def test_bf16_os_layers_stream_their_weights_by_16_byte_copies(path):
    """Every bf16 OS launch of the zoo has K and Kf multiples of 8 taps:
    the kernel's weight ring takes the 16-byte ``cp.async`` path
    (``tc_load_chunk``), never its 2-byte loads."""
    for layer, spec, _ in _launches(path):
        if spec.dataflow == "output_stationary":
            k = spec.c_pad // spec.groups * spec.r * spec.s
            assert k % 8 == 0 and spec.plan.c_block * spec.r * spec.s % 8 \
                == 0, layer


@pytest.mark.parametrize("path", sorted(PATHS))
def test_fp32_and_int8_picks_are_the_parents(path):
    want = PARENT_PICKS[path].split()
    for dtype in (torch.float32, torch.int8):
        got = []
        for layer, spec, n in _launches(path):
            if dtype == torch.int8 and spec.epilogue is not None and \
                    spec.dataflow != "weight_stationary_psum":
                spec = dataclasses.replace(
                    spec, epilogue=requant_epilogue(spec.epilogue))
            tile = t_kern.fold_tile(spec, n, SMS, dtype=dtype)
            assert tile.core == "ffma"
            got.append(f"{layer}:{TAG[spec.dataflow]}:{tile.index}:"
                       f"{tile.m_per_cta}")
        assert got == want, dtype


CSRC = pathlib.Path(t_kern.__file__).parent / "csrc"


def _kernel_constants():
    """(taps of one MMA step, taps of a gather chunk) as the tensor-core
    kernels compile them: the k of ``mma.sync ... m16n8k<k>`` in
    ``mma.cuh``, the rounding of ``tc_kpad`` and ``TC_BK`` in
    ``fold_conv_tc.cuh``."""
    mma = (CSRC / "mma.cuh").read_text()
    tc = (CSRC / "fold_conv_tc.cuh").read_text()
    mma_k = {int(k) for k in re.findall(r"mma\.sync\.aligned\.m16n8k(\d+)",
                                         mma)}
    kpad = re.search(r"int tc_kpad\(int kf\) \{ return \(kf \+ (\d+)\) / "
                     r"(\d+) \* (\d+); \}", tc)
    bk = re.search(r"constexpr int TC_BK = (\d+);", tc)
    assert len(mma_k) == 1 and kpad and bk
    step = mma_k.pop()
    assert [int(g) for g in kpad.groups()] == [step - 1, step, step]
    return step, int(bk.group(1))


def _ring_constants():
    """(OS's chunk, stages of the OS weight ring, tiles WS and psum run,
    the tiles) as ``fold_conv_tc.cuh`` compiles them."""
    tc = (CSRC / "fold_conv_tc.cuh").read_text()
    os_bk = re.search(r"constexpr int TC_OS_BK = (\d+);", tc)
    stages = re.search(r"constexpr int TC_STAGES = (\d+);", tc)
    ws = re.search(r"constexpr int TC_WS_TILES = (\d+);", tc)
    tiles = re.findall(r"using TcTile(\d+) = TcTile<(\d+), (\d+), (\d+), "
                       r"(\d+)>;", tc)
    assert os_bk and stages and ws and tiles
    return (int(os_bk.group(1)), int(stages.group(1)), int(ws.group(1)),
            tuple(tuple(int(v) for v in t[1:]) for t in tiles))


def _k_steps(kf, total, dataflow="weight_stationary", bk=None):
    """The tensor-core kernels' sum order, as data, walked as ``tc_run``
    walks it: WS and psum call it once per depth fold, OS once for every
    fold, chunk j of its walk being chunk j % nk of fold j // nk (nk
    chunks a fold); each depth fold [cf·Kf, (cf+1)·Kf) of the ``total``
    taps in chunks of ``bk`` taps (``TC_BK`` by default), each chunk in MMA
    steps from the fold's first tap; (fold, chunk, first tap, end) of each
    step, the last end of a fold clipped to the fold (the taps past it are
    zeros in the kernel).  Its inputs are the layer's depth and fold
    alone, and the tile's chunk, which paces the loads and is no part of
    the sum's order (``_chain``)."""
    step, bk_ws = _kernel_constants()
    bk = bk or bk_ws
    steps, folds = -(-kf // step), total // kf
    nk = -(-steps * step // bk)
    if dataflow == "output_stationary":
        walks = [[(j // nk, j % nk) for j in range(folds * nk)]]
    else:
        walks = [[(cf, kc) for kc in range(nk)] for cf in range(folds)]
    out = []
    for walk in walks:
        for cf, kc in walk:
            k0 = cf * kf
            for kk in range(min(bk // step, steps - kc * (bk // step))):
                k = k0 + kc * bk + kk * step
                out.append((cf, kc, k, min(k + step, k0 + kf)))
    return tuple(out)


def _tile_steps(tile):
    """``_k_steps`` of one launch's tile, in its chunks (OS: up to
    ``TC_OS_BK`` taps, ``tile_chunk``)."""
    return _k_steps(tile.kf, tile.k_len * tile.folds, tile.dataflow,
                    t_kern.tile_chunk(tile.dataflow != "output_stationary",
                                      tile.bm, tile.threads))


def _chain(steps):
    """The order of each output's sum: its (fold, first tap, end) steps;
    the chunks that pace a walk's loads are not part of it."""
    return tuple((f, a, b) for f, _, a, b in steps)


def _x_shape(spec, n):
    """An input of ``n`` images that gives ``spec``'s layer its outputs."""
    return (n, spec.c, (spec.p - 1) * spec.stride + spec.r,
            spec.inputs[0].array_shape[3])


def _steps_ok(steps, total, kf):
    """Ascending 16-tap steps, each inside one depth fold, starting at each
    fold's first tap, covering [0, total) once."""
    assert steps[0][2] == 0 and steps[-1][3] == total
    for (f0, _, a0, b0), (f1, _, a1, b1) in zip(steps, steps[1:]):
        assert a1 == b0 and f1 in (f0, f0 + 1)
    for f, _, a, b in steps:
        assert f * kf <= a < b <= (f + 1) * kf and b - a <= 16
        assert (a - f * kf) % 16 == 0


def test_wrapper_constants_are_the_kernels():
    """The wrapper prices a tensor-core tile's shared memory (``tile_smem``)
    with the MMA step, gather chunk and OS ring the kernels compile with,
    and picks from the kernels' tiles, OS from all of them, WS and psum
    from the first ``TC_WS_TILES``."""
    assert (t_kern.MMA_K, t_kern.TC_BK) == _kernel_constants()
    assert (t_kern.TC_OS_BK, t_kern.TC_STAGES, t_kern.TC_WS_TILES,
            t_kern.TC_TILES) == _ring_constants()
    # OS's chunk (TcOs): up to 128 taps, a thread gathering at most 16
    assert [t_kern.tile_chunk(False, wtm * wm, 32 * wm * wn)
            for wtm, _, wm, wn in t_kern.TC_TILES] == [64] * 6 + [128] * 2
    assert t_kern.tile_count("tc", "output_stationary") == 8
    assert t_kern.tile_count("tc", "weight_stationary_psum") == 6


@pytest.mark.parametrize("path", ["vgg16_224_b1", "resnet18_32_b4",
                                  "mobilenetv2_32_b4"])
def test_k_steps_depend_on_the_layer_alone(path):
    """The tensor-core kernels' 16-tap steps of each bf16 WS / OS / psum
    launch are the same at batch 1, 2, 4 and 8 and with every
    tensor-core tile that fits: the depth and fold each tile runs come
    from the layer."""
    for layer, spec, _ in _launches(path):
        seen = set()
        for n in (1, 2, 4, 8):
            spec_n = t_kern.fold_kernel_spec(
                _x_shape(spec, n),
                (spec.nf, spec.c // spec.groups, spec.r, spec.s),
                stride=spec.stride, plan=spec.plan, dataflow=spec.dataflow,
                epilogue=spec.epilogue, groups=spec.groups)
            for tile in t_kern.tile_candidates(spec_n, n, SMS, BF16):
                steps = _tile_steps(tile)
                _steps_ok(steps, tile.k_len * tile.folds, tile.kf)
                seen.add(_chain(steps))
        assert len(seen) == 1, layer
        kf = spec.plan.c_block * spec.r * spec.s
        total = spec.c_pad // spec.groups * spec.r * spec.s
        assert next(iter(seen)) == _chain(_k_steps(kf, total)), layer


@pytest.mark.parametrize("path", ["vgg16_32_b4", "resnet18_32_b4",
                                  "mobilenetv2_32_b4"])
def test_ws_and_os_step_lists_are_identical_on_every_zoo_os_layer(path):
    """For each of the zoo's 54 OS layers at 32 b4, the 16-tap steps of
    its OS launch (every fold in one walk, the accumulators in registers,
    chunks of ``TC_OS_BK``) and of the same layer and plan launched
    weight-stationary (fold by fold through the slab, chunks of
    ``TC_BK``) are one chain, with every tile either runs."""
    os_layers = 0
    for layer, spec, n in _launches(path):
        if spec.dataflow != "output_stationary":
            continue
        os_layers += 1
        ws = t_kern.fold_kernel_spec(
            _x_shape(spec, n), (spec.nf, spec.c // spec.groups, spec.r, spec.s),
            stride=spec.stride, plan=spec.plan, dataflow="weight_stationary",
            epilogue=spec.epilogue, groups=spec.groups)
        lists = {_chain(_tile_steps(t)) for s_ in (spec, ws)
                 for t in t_kern.tile_candidates(s_, n, SMS, BF16)}
        assert {t.dataflow for t in t_kern.tile_candidates(ws, n, SMS, BF16)
                } == {"weight_stationary"}, layer
        assert len(lists) == 1, layer
        kf = spec.plan.c_block * spec.r * spec.s
        total = spec.c_pad // spec.groups * spec.r * spec.s
        assert lists.pop() == _chain(_k_steps(kf, total)), layer
    assert os_layers == {"vgg16_32_b4": 11, "resnet18_32_b4": 15,
                         "mobilenetv2_32_b4": 28}[path]


def test_k_steps_of_forced_depth_folds():
    """g_c = 3 folds of 17 channels (Kf 153, not a multiple of 16): the
    tile runs folds of 153 taps, 459 in all; each fold's steps start at
    its own first tap, in 3 chunks of up to 4 steps; the last step of a
    fold is short (its taps past Kf are zeros in the kernel)."""
    spec = t_kern.fold_kernel_spec(
        (3, 51, 9, 9), (13, 51, 3, 3),
        plan=ConvBlockPlan(nf_block=8, c_block=17, p_block=3,
                           grid=(2, 3, 3), vmem_bytes=0))
    assert spec.cg_folds == 3
    tile = t_kern.fold_tile(spec, 3, SMS, dtype=BF16)
    assert (tile.kf, tile.k_len * tile.folds) == (153, 3 * 153)
    steps = _k_steps(tile.kf, tile.k_len * tile.folds)
    _steps_ok(steps, 3 * 153, 153)
    assert [s for s in steps if s[2] % 153 == 0] == [
        (0, 0, 0, 16), (1, 0, 153, 169), (2, 0, 306, 322)]
    assert len(steps) == 3 * 10 and steps[9] == (0, 2, 144, 153)
    assert [s[1] for s in steps[:10]] == [0] * 4 + [1] * 4 + [2] * 2
    os_spec = dataclasses.replace(spec, dataflow="output_stationary")
    os_tile = t_kern.fold_tile(os_spec, 3, SMS, dtype=BF16)
    assert (os_tile.kf, os_tile.k_len, os_tile.folds) == (153, 459, 1)
    os_steps = _k_steps(153, 459, "output_stationary", t_kern.TC_OS_BK)
    _steps_ok(os_steps, 3 * 153, 153)
    assert _chain(os_steps) == _chain(steps)
    assert [s[1] for s in os_steps[:10]] == [0] * 8 + [1] * 2


def test_compile_network_verify_proves_bf16_tensor_core_tiles():
    """``compile_network(verify=True)`` on a bf16 VGG-16 (width 0.25, 224,
    batch 1) passes, and its schedules proven at 132 SMs on bf16 operands
    are tensor-core tiles for all 13 WS layers."""
    from repro_torch.models import vgg
    params = vgg.init_params(torch.Generator().manual_seed(0),
                             width_mult=0.25, img=224, device="cpu",
                             dtype=BF16)
    net = vgg.compile_forward(params, img=224, batch=1, device="cpu",
                              verify=True)
    assert net.dtype == BF16
    epis = {nd.name: nd.epilogue for nd in net.graph.nodes
            if nd.op == "conv"}
    nests = dict(net.layer_nests)
    cores = []
    for name, sched in net.layer_schedules:
        cv = nests[name]
        t_engine._verify_schedule(name, cv, sched, epis[name], cv.groups,
                                  SMS, BF16)
        spec = t_kern.fold_kernel_spec(
            (cv.n, cv.c, cv.padded_x, cv.padded_y),
            (cv.nf, cv.c, cv.r, cv.s),
            plan=sched.plan.clamped(cv.nf, cv.c, cv.p),
            dataflow=sched.dataflow, epilogue=epis[name])
        cores.append(t_kern.fold_tile(spec, 1, SMS, dtype=BF16).core)
    assert cores == ["tc"] * 13


def _wide_spec():
    """A 7x7 depth fold of 512 channels: Kf 25,088, whose bf16 filter
    tile at BN 16 alone takes 803 KB."""
    return t_kern.fold_kernel_spec(
        (1, 512, 20, 20), (64, 512, 7, 7),
        plan=ConvBlockPlan(nf_block=64, c_block=512, p_block=14,
                           grid=(1, 1, 1), vmem_bytes=0))


def test_a_bf16_launch_no_tensor_core_tile_fits_raises():
    """No fallback: no FFMA tile and no plain walk for a CUDA launch."""
    spec = _wide_spec()
    assert t_kern.tile_candidates(spec, 1, SMS, BF16) == []
    with pytest.raises(ValueError, match="no tc CTA tile"):
        t_kern.fold_tile(spec, 1, SMS, dtype=BF16)
    with pytest.raises(FoldLintError):
        cv = t_engine.ConvLoopNest(n=1, nf=64, c=512, r=7, s=7, x=14, y=14,
                                   stride=1, pad=3)
        sched = t_engine.ConvSchedule(
            key=t_engine.ScheduleKey.from_loopnest(cv, "fp32"), nest=cv,
            plan=spec.plan, dataflow="weight_stationary", costs=())
        t_engine._verify_schedule("wide", cv, sched, None, 1, SMS, BF16)
    assert check_launch_tile(spec, 1, SMS, dtype=BF16).codes() == [
        "plan.smem-overflow"]


# tensor-core tile -> its seeded defect and the code it must carry
SEEDED = {
    "an FFMA tile on a bf16 WS launch": (
        lambda spec: t_kern.fold_tile(spec, 4, SMS), "tile.shape"),
    "smem off the tile's shape": (
        lambda spec: dataclasses.replace(
            t_kern.fold_tile(spec, 4, SMS, dtype=BF16), smem=1024),
        "tile.shape"),
    "warp tile off its TC_TILES entry": (
        lambda spec: dataclasses.replace(
            t_kern.fold_tile(spec, 4, SMS, dtype=BF16), bn=8),
        "tile.shape"),
    "last M tile uncovered": (
        lambda spec: (lambda t: dataclasses.replace(
            t, grid=(t.grid[0] - 1, t.grid[1])))(
                t_kern.fold_tile(spec, 4, SMS, dtype=BF16)),
        "tile.m-coverage"),
}


# the OS weight ring: its seeded defect and the code it must carry
SEEDED_OS = {
    "a resident fold's bytes recorded for an OS tile": (
        lambda spec: (lambda t: dataclasses.replace(t, smem=t_kern.tile_smem(
            "tc", True, t.bm, t.bn, t.kf, t.k_len, t.threads)))(
                t_kern.fold_tile(spec, 4, SMS, dtype=BF16)),
        "tile.shape"),
    "a WS tile on an OS launch": (
        lambda spec: t_kern.fold_tile(dataclasses.replace(
            spec, dataflow="weight_stationary"), 4, SMS, index=0,
            dtype=BF16),
        "tile.shape"),
    "OS's small-M tile on a WS launch": (
        lambda spec: dataclasses.replace(
            t_kern.fold_tile(spec, 4, SMS, index=6, dtype=BF16),
            dataflow="weight_stationary"),
        "tile.shape"),
    "an FFMA tile on a bf16 OS launch": (
        lambda spec: t_kern.fold_tile(spec, 4, SMS), "tile.shape"),
    "last M tile uncovered": (
        lambda spec: (lambda t: dataclasses.replace(
            t, grid=(t.grid[0] - 1, t.grid[1])))(
                t_kern.fold_tile(spec, 4, SMS, index=6, dtype=BF16)),
        "tile.m-coverage"),
}


def _deep_os_spec():
    """VGG-16's conv5_1 at 32, batch 4 (2x2 outputs, Kf 4608): no resident
    fold of 64 filters fits a CTA, the OS ring does."""
    return t_kern.fold_kernel_spec(
        (4, 512, 4, 4), (512, 512, 3, 3), dataflow="output_stationary",
        epilogue=Epilogue(bias=True, relu=True))


@pytest.mark.parametrize("case", sorted(SEEDED_OS))
def test_os_ring_check_flags_seeded_tiles(case):
    spec = _deep_os_spec()
    assert check_launch_tile(spec, 4, SMS, dtype=BF16).ok
    for index in range(len(t_kern.TC_TILES)):
        assert check_launch_tile(
            spec, 4, SMS, tile=t_kern.fold_tile(spec, 4, SMS, index=index,
                                                dtype=BF16), dtype=BF16).ok
    make, code = SEEDED_OS[case]
    rep = check_launch_tile(spec, 4, SMS, tile=make(spec), dtype=BF16)
    assert rep.has(code), [str(f) for f in rep.findings]


def test_os_residency_proves_the_ring_not_a_resident_fold():
    """An OS tensor-core tile at Kf 4608 and BN 64 takes its ring's bytes
    and is proven; the same tile read as a WS one (a resident fold of
    4608 taps x 64 filters, 590 KB) and an OS tile whose ring is
    understated (512 filters a stage recorded as 64) are
    plan.smem-overflow."""
    spec = _deep_os_spec()
    tile = t_kern.fold_tile(spec, 4, SMS, index=6, dtype=BF16)
    assert tile.smem == t_kern.tile_smem("tc", False, 16, 64, 4608, 4608,
                                         128)
    assert tile.resident >= 2 and check_tile_residency(tile).ok
    assert check_tile_residency(dataclasses.replace(
        tile, dataflow="weight_stationary")).codes() == ["plan.smem-overflow"]
    assert check_tile_residency(dataclasses.replace(
        tile, bn=512)).codes() == ["plan.smem-overflow"]


@pytest.mark.parametrize("case", sorted(SEEDED))
def test_tensor_core_tile_check_flags_seeded_tiles(case):
    spec = t_kern.fold_kernel_spec(
        (4, 64, 58, 58), (128, 64, 3, 3), dataflow="weight_stationary",
        epilogue=Epilogue(bias=True, relu=True))
    assert check_launch_tile(spec, 4, SMS, dtype=BF16).ok
    make, code = SEEDED[case]
    rep = check_launch_tile(spec, 4, SMS, tile=make(spec), dtype=BF16)
    assert rep.has(code), [str(f) for f in rep.findings]


def test_tensor_core_residency_recomputes_the_tiles_bytes():
    """A tensor-core tile whose recorded bytes understate its resident
    filter tile is plan.smem-overflow all the same."""
    spec = t_kern.fold_kernel_spec((1, 512, 16, 16), (512, 512, 3, 3))
    tile = t_kern.fold_tile(spec, 1, SMS, dtype=BF16)
    assert check_tile_residency(tile).ok
    lied = dataclasses.replace(tile, kf=4 * tile.kf, smem=tile.smem)
    assert check_tile_residency(lied).codes() == ["plan.smem-overflow"]


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the tensor-core kernels are "
                    "CUDA-only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _within_bf16(got, want, extra=None):
    """One bf16 step of each element (widened by the depth folds'
    magnitudes for psum) plus 1e-4·max(1, max|plain|)."""
    g, w = got.float(), want.float()
    mag = w.abs() if extra is None else w.abs() + extra
    assert got.dtype == want.dtype == BF16 and got.shape == want.shape
    assert ((g - w).abs() <= 2.0 ** -7 * mag
            + 1e-4 * max(1.0, w.abs().max().item())).all()


# (tile, dataflow) of every tensor-core kernel instance
TC_CASES = [(t, df) for df in ("weight_stationary", "weight_stationary_psum",
                               "output_stationary")
            for t in range(t_kern.tile_count("tc", df))]


@pytest.mark.cuda
@pytest.mark.parametrize("forced", [(8, 8, 4), (4, 3, 3), (8, 2, 4)],
                         ids=["gc1", "gc3", "gc4"])
@pytest.mark.parametrize("tile,dataflow", TC_CASES,
                         ids=[f"{t}-{df}" for t, df in TC_CASES])
def test_cuda_tensor_core_tile_matches_plain_walk(cuda_device, tile, forced,
                                                 dataflow):
    """Each tensor-core tile of each kernel forced through the launcher at
    g_c = 1, 3 and 4 with a ragged P and Q (9 x 10 outputs), bias + ReLU
    on WS and OS."""
    rng = np.random.default_rng(31)
    x = torch.from_numpy(rng.standard_normal((2, 8, 11, 12))).to(
        cuda_device, BF16)
    w = torch.from_numpy(rng.standard_normal((8, 8, 3, 3)) / 24 ** 0.5).to(
        cuda_device, BF16)
    b = torch.from_numpy(rng.standard_normal(8)).to(cuda_device, BF16)
    nf_b, c_b, p_b = forced
    plan = ConvBlockPlan(nf_block=nf_b, c_block=c_b, p_block=p_b,
                         grid=(-(-8 // nf_b), -(-8 // c_b), -(-9 // p_b)),
                         vmem_bytes=0)
    psum = dataflow == "weight_stationary_psum"
    epi = Epilogue() if psum else Epilogue(bias=True, relu=True)
    kw = dict(plan=plan, dataflow=dataflow, epilogue=epi,
              bias=None if psum else b)
    spec, *ops = t_kern.prepare(x, w, 1, plan, dataflow, kw["bias"], epi, 1,
                                None, None, None)
    got = t_kern._finish(spec, t_kern.LAUNCHERS[dataflow](spec, *ops,
                                                          tile=tile), BF16)
    extra = torch.nn.functional.conv2d(x.float().abs(), w.float().abs()) \
        if psum else None
    _within_bf16(got, t_kern.conv2d_folded_plain(x, w, **kw), extra)


@pytest.mark.cuda
@pytest.mark.parametrize("forced", [None, (16, 48, 3), (16, 17, 3)],
                         ids=["planned", "gc2", "gc3-kf153"])
def test_cuda_bf16_os_is_bitwise_bf16_ws(cuda_device, forced):
    """bf16 OS, every tensor-core tile, gives the bits of bf16 WS, every
    tile and M-tile share, on one layer and plan: 2 images of 96 (51)
    channels, 9 x 10 outputs, 40 filters, bias + ReLU + 2x2 pool; its own
    plan, g_c = 2, and g_c = 3 folds of 153 taps (the 2-byte weight
    path)."""
    rng = np.random.default_rng(37)
    c = 51 if forced and forced[1] == 17 else 96
    x = torch.from_numpy(rng.standard_normal((2, c, 11, 12))).to(
        cuda_device, BF16)
    w = torch.from_numpy(rng.standard_normal((40, c, 3, 3))
                         / (9 * c) ** 0.5).to(cuda_device, BF16)
    b = torch.from_numpy(rng.standard_normal(40)).to(cuda_device, BF16)
    plan = None if forced is None else ConvBlockPlan(
        nf_block=forced[0], c_block=forced[1], p_block=forced[2],
        grid=(-(-40 // forced[0]), c // forced[1], 3), vmem_bytes=0)
    epi = Epilogue(bias=True, relu=True, pool="max2")
    outs = []
    for df in ("output_stationary", "weight_stationary"):
        spec, *ops = t_kern.prepare(x, w, 1, plan, df, b, epi, 1, None,
                                    None, None)
        for t in t_kern.tile_candidates(spec, 2, t_kern._sm_count(
                cuda_device), BF16):
            outs.append(t_kern._finish(spec, t_kern.LAUNCHERS[df](
                spec, *ops, tile=t.index), BF16))
    _within_bf16(outs[0], t_kern.conv2d_folded_plain(
        x, w, plan=plan, dataflow="output_stationary", epilogue=epi, bias=b))
    assert len(outs) > 8 and all(torch.equal(o, outs[0]) for o in outs)


@pytest.mark.cuda
def test_cuda_bf16_trunk_is_bitwise_across_batch_widths(cuda_device):
    """A bf16 VGG-16 trunk (width 0.25, 64 x 64: every layer WS) gives row
    i's bits at batch 1 and at batch 4."""
    from repro_torch.core.engine import compile_network
    from repro_torch.models import vgg
    params = vgg.init_params(
        torch.Generator(device=cuda_device).manual_seed(5), width_mult=0.25,
        img=64, device=cuda_device, dtype=BF16)
    x4 = torch.randn(4, 3, 64, 64, device=cuda_device).to(BF16)
    trunks = {b: compile_network(params, vgg.to_graph(include_head=False),
                                 (b, 3, 64, 64), device=cuda_device)
              for b in (1, 4)}
    with torch.inference_mode():
        t4 = trunks[4](params, x4)
        for i in range(4):
            assert torch.equal(trunks[1](params, x4[i:i + 1])[0], t4[i])
