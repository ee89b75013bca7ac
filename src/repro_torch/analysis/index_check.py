"""Symbolic index-map coverage and race analyzer, and the CTA-tile check
(the JAX package's ``analysis/index_check.py``, plus the card's own launch
geometry).

A ``FoldKernelSpec`` (``kernels/conv2d_ws.py:fold_kernel_spec``) exposes a
launch's fold grid and every operand's block index map as data.
This module enumerates the grid x index-map product — no tracing, no
arrays — and proves the mapping discipline the paper's loop-nest
decomposition assumes:

  index.rank          an index map returns the wrong number of indices
  index.block-align   an operand's array shape is not an exact multiple
                      of its block (a partial edge tile would clamp)
  index.oob           a grid point addresses a block beyond the (padded)
                      array bounds
  index.rows-window   the in-kernel row window of the last P fold runs
                      past the padded input rows
  index.group-offset  a WS/OS input or weight block is not addressed by
                      the group of the current filter fold
  index.dw-offset     a depthwise input/weight block is not addressed by
                      the grid's channel fold
  index.write-race    two grid points alias the same output block while
                      differing on an axis that is neither the depth-fold
                      (reduction) axis nor a disjoint in-block sub-slice
                      axis — the second visit clobbers the first
  index.coverage      the set of output tiles written differs from the
                      exact tiling of the padded output (missed or
                      duplicated tiles)

Exactly-once output writes follow from ``write-race`` + ``coverage``:
every tile is visited, and revisits happen only along axes that
accumulate into (or sub-slice) the same resident block.

On the card a WS / OS / psum launch runs the fold grid as CTA tiles
(``kernels/conv2d_ws.py:fold_tile``, the mirror of ``launch_tile`` in
``csrc/fold_conv.cuh`` and, for bf16, of ``launch_tc_tile`` in
``csrc/fold_conv_tc.cuh``): output pixels flattened over (n, p, q) in
tiles of ``bm``, each group's filters in tiles of ``bn``.
``check_launch_tile`` proves that geometry, CTA by CTA, as the kernel
derives it:

  tile.shape          the tile is not of the core the launch's operand
                      type runs on (``tile_core``) or not one its dataflow
                      may run (``tile_count``), or its fields disagree
                      with its entry of ``TILES`` / ``TC_TILES`` or with
                      the launch (dataflow, pixel count, depth fold,
                      shared memory: OS's weight ring, WS's resident fold)
  tile.m-coverage     the CTAs' M-tile ranges do not cover every output
                      pixel exactly once
  tile.n-coverage     the filter tiles do not cover every group's filters
                      exactly once
  tile.group-straddle a filter tile spans two groups
  tile.fold-coverage  psum's depth folds (or a WS / OS CTA's one fold) do
                      not cover the group's depth exactly

with the tile's shared memory proven by ``plan_check``'s residency rule
(``plan.smem-overflow``).  A depthwise launch has no CTA tile but a thread
geometry (``kernels/conv2d_ws.py:dw_geometry``, the mirror of
``launch_dw`` in ``csrc/fold_conv.cuh``: TQ outputs along Q a thread,
ROWS x CHANS a CTA), proven the same way, thread by thread of a CTA:

  dw.shape            the strip is not one the kernel has for the launch
                      (``dw_tq_choices``; none fits is the same finding),
                      or the geometry's strips, threads, grid or pair
                      loads disagree with the launch
  dw.cta-threads      a CTA has more threads than ``DW_THREADS``, more
                      rows or channels than the launch (or than
                      ``DW_MAX_CHANS``), or a grid axis past the card's
                      limit
  dw.coverage         the threads do not cover every output (image,
                      channel, row, column) of the launch exactly once
  dw.pool-split       a 2x2 pool window spans two threads' strips
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Iterable, Iterator, Optional, Set, Tuple

import torch

from repro_torch.analysis.plan_check import check_tile_residency
from repro_torch.analysis.report import Report
from repro_torch.kernels.conv2d_ws import (DW_MAX_CHANS, DW_THREADS,
                                           DwGeometry,
                                           FoldKernelSpec, FoldTile,
                                           OperandSpec, dw_geometry,
                                           dw_tq_choices, fold_tile,
                                           tile_core, tile_count, tile_shape,
                                           tile_smem)

__all__ = ["check_kernel_spec", "check_launch_tile", "check_dw_geometry",
           "MAX_POINTS"]

# full enumeration cap; past it each grid axis is sampled at its
# boundary/middle strata (races found in a sample are still real — only
# the coverage proof needs exhaustiveness and is skipped)
MAX_POINTS = 200_000

GridPoint = Tuple[int, ...]


def _axis_samples(extent: int) -> Iterable[int]:
    if extent <= 6:
        return range(extent)
    return sorted({0, 1, extent // 2, extent - 2, extent - 1})


def _grid_points(grid: Tuple[int, ...]) -> Tuple[Iterator[GridPoint], bool]:
    total = math.prod(grid)
    if total <= MAX_POINTS:
        return itertools.product(*(range(g) for g in grid)), True
    return itertools.product(*(_axis_samples(g) for g in grid)), False


def _eval_map(op: OperandSpec, pt: GridPoint) -> Tuple[int, ...]:
    return tuple(int(i) for i in op.index_map(*pt))


def check_kernel_spec(spec: FoldKernelSpec, where: str = "kernel") -> Report:
    """Prove in-bounds reads, correct group offsets, write-race freedom,
    and exactly-once output coverage for one kernel launch."""
    rep = Report()
    axes = {name: i for i, name in enumerate(spec.grid_axes)}
    operands = (*spec.inputs, spec.output)

    # static block geometry first — a malformed operand poisons the rest
    for op in operands:
        loc = f"{where}:{op.role}"
        if len(op.block) != len(op.array_shape):
            rep.add("index.rank", loc,
                    f"block rank {len(op.block)} != array rank "
                    f"{len(op.array_shape)}")
            return rep
        for d, (b, a) in enumerate(zip(op.block, op.array_shape)):
            if b < 1 or a % b:
                rep.add("index.block-align", loc,
                        f"dim {d}: block {b} does not tile array extent "
                        f"{a} exactly — an edge tile would clamp and "
                        f"break the fold geometry")

    # the in-kernel row window of the last P fold must stay inside the
    # padded rows: row0 + (p_block-1)*stride + R <= x_rows
    g_p = spec.grid[axes["p"]]
    rows_top = ((g_p - 1) * spec.p_block * spec.stride
                + (spec.p_block - 1) * spec.stride + spec.r)
    if rows_top > spec.x_rows:
        rep.add("index.rows-window", f"{where}:x",
                f"last P fold reads input rows up to {rows_top} but the "
                f"padded input has {spec.x_rows} rows")
    if not rep.ok:
        return rep

    points, exhaustive = _grid_points(spec.grid)
    allowed: Set[int] = set(spec.inner_sliced_axes)
    if spec.reduction_axis is not None:
        allowed.add(spec.reduction_axis)
    writers: Dict[Tuple[int, ...], GridPoint] = {}
    reported: Set[Tuple[str, str]] = set()   # (code, operand) dedupe

    def add_once(code: str, role: str, message: str) -> None:
        if (code, role) not in reported:
            reported.add((code, role))
            rep.add(code, f"{where}:{role}", message)

    dw = spec.dataflow == "depthwise"
    for pt in points:
        for op in operands:
            try:
                idx = _eval_map(op, pt)
            except TypeError:
                add_once("index.rank", op.role,
                         f"index map rejects the {len(spec.grid)}-d grid "
                         f"point {pt} (wrong arity)")
                return rep
            if len(idx) != len(op.block):
                add_once("index.rank", op.role,
                         f"index map returned {len(idx)} indices for a "
                         f"rank-{len(op.block)} block at grid {pt}")
                continue
            for d, (i, b, a) in enumerate(zip(idx, op.block,
                                              op.array_shape)):
                if i < 0 or (i + 1) * b > a:
                    add_once("index.oob", op.role,
                             f"grid {pt} -> block index {idx}: dim {d} "
                             f"addresses elements [{i * b}, {(i + 1) * b})"
                             f" of an extent-{a} array")
            # per-group offset discipline (paper: a depth fold streams
            # channels of the group its filter fold belongs to)
            if dw:
                cc = pt[axes["c"]]
                if op.role == "x" and idx[1] != cc:
                    add_once("index.dw-offset", op.role,
                             f"grid {pt}: depthwise input reads channel "
                             f"fold {idx[1]}, not the grid's fold {cc}")
                if op.role == "w" and idx[0] != cc:
                    add_once("index.dw-offset", op.role,
                             f"grid {pt}: depthwise weights read filter "
                             f"fold {idx[0]}, not the grid's fold {cc}")
            else:
                f, cc = pt[axes["nf"]], pt[axes["c"]]
                if op.role == "x":
                    want = (f // spec.nfg_folds) * spec.cg_folds + cc
                    if idx[1] != want:
                        add_once("index.group-offset", op.role,
                                 f"grid {pt}: input reads channel fold "
                                 f"{idx[1]} but filter fold {f} lives in "
                                 f"group {f // spec.nfg_folds} (want "
                                 f"fold {want})")
                if op.role == "w" and idx[:2] != (f, cc):
                    add_once("index.group-offset", op.role,
                             f"grid {pt}: weight block {idx[:2]} != the "
                             f"grid's (filter, depth) folds ({f}, {cc})")
        out_idx = _eval_map(spec.output, pt)
        first = writers.setdefault(out_idx, pt)
        if first is not pt:
            diff = {d for d in range(len(pt)) if pt[d] != first[d]}
            if not diff <= allowed:
                bad = sorted(diff - allowed)
                names = ", ".join(spec.grid_axes[d] for d in bad)
                add_once("index.write-race", "out",
                         f"grid points {first} and {pt} both write output "
                         f"block {out_idx} but differ on non-reduction "
                         f"axis ({names}): the later visit clobbers the "
                         f"earlier one")

    if exhaustive:
        tiles = tuple(a // b for a, b in zip(spec.output.array_shape,
                                             spec.output.block))
        expect = math.prod(tiles)
        if len(writers) != expect:
            missing = expect - len(writers)
            example = next((t for t in itertools.product(
                *(range(t) for t in tiles)) if t not in writers), None)
            rep.add("index.coverage", f"{where}:out",
                    f"{len(writers)} of {expect} output tiles written "
                    f"({missing} {'missed' if missing > 0 else 'extra'}"
                    f"{f', e.g. {example}' if example else ''}): the "
                    f"padded output is not tiled exactly once")
    return rep


def _ranges_cover(ranges, extent: int) -> Tuple[int, int]:
    """(elements of [0, extent) covered by no range, by more than one);
    ``ranges`` are half-open, clipped to ``extent``."""
    missed = twice = cur = 0
    for lo, hi in sorted((max(lo, 0), min(hi, extent)) for lo, hi in ranges
                         if min(hi, extent) > max(lo, 0)):
        missed += max(0, lo - cur)
        twice += max(0, min(cur, hi) - lo)
        cur = max(cur, hi)
    return missed + extent - cur, twice


def check_dw_geometry(spec: FoldKernelSpec, n: int, geom: DwGeometry,
                      where: str = "kernel") -> Report:
    """Prove one depthwise launch's thread geometry as ``dw_kernel``
    decodes it: thread (x, y, z) of CTA (bx, by, bz), a CTA of (strips,
    rows, chans) threads, ``t`` = x + strips * (y + rows * z) in all,
    owns strip x (columns x*tq .. +tq, clipped at the row's ``qlim``
    pre-pool columns) of output row ``bx*rows + y`` (a pooled row: both
    pre-pool rows) of channel ``by*chans + z`` of image ``bz``, and idles
    past the launch's rows or channels."""
    rep = Report()
    loc = f"{where}:dw"
    pool = spec.epilogue.pool == "max2"
    span = 2 if pool else 1
    po, qlim = spec.p_pad // span, spec.q // span * span
    choices = dw_tq_choices(spec)
    yp = spec.inputs[0].array_shape[3]
    if geom.tq not in choices:
        rep.add("dw.shape", loc,
                f"a strip of {geom.tq} outputs, but the kernel has "
                f"{choices or 'no strip'} for this launch (pool {pool}, "
                f"{qlim} columns a row)")
        if geom.tq < 1:
            return rep
    if not (1 <= geom.threads <= DW_THREADS and 1 <= geom.rows <= po
            and 1 <= geom.chans <= min(spec.c, DW_MAX_CHANS)
            and geom.grid[1] <= 65535 and geom.grid[2] <= 65535):
        rep.add("dw.cta-threads", loc,
                f"{geom.chans} channels x {geom.rows} rows x {geom.strips} "
                f"strips = {geom.threads} threads a CTA (at most "
                f"{DW_THREADS}, {DW_MAX_CHANS} channels; the launch has "
                f"{po} rows, {spec.c} channels), grid {geom.grid}")
        return rep
    # one CTA's threads: each (channel, row, strip) slot decoded by exactly
    # one of them
    owned = {(t // (geom.strips * geom.rows), t // geom.strips % geom.rows,
              t % geom.strips) for t in range(geom.threads)}
    missed = geom.chans * geom.rows * geom.strips - len(owned)
    if missed:
        rep.add("dw.coverage", loc,
                f"{missed} (channel, row, strip) slots of a CTA owned by no "
                f"thread ({geom.threads} threads)")
    # the grid: every image, row and channel in exactly one CTA, every
    # column in exactly one strip
    for what, ranges, extent in (
            ("images", [(z, z + 1) for z in range(geom.grid[2])], n),
            ("rows", [(b * geom.rows, (b + 1) * geom.rows)
                      for b in range(geom.grid[0])], po),
            ("channels", [(b * geom.chans, (b + 1) * geom.chans)
                          for b in range(geom.grid[1])], spec.c),
            ("columns", [(k * geom.tq, (k + 1) * geom.tq)
                         for k in range(geom.strips)], qlim)):
        lost, twice = _ranges_cover(ranges, extent)
        if lost or twice:
            rep.add("dw.coverage", loc,
                    f"{len(ranges)} blocks of the launch's {extent} "
                    f"{what}: {lost} covered by no thread, {twice} by two")
    if pool and (geom.tq % 2 or qlim % 2):
        rep.add("dw.pool-split", loc,
                f"strips of {geom.tq} columns over {qlim}: a 2x2 window's "
                f"two columns fall in two threads")
    # what the kernel derives from the strip, rows and channels it is given
    want = (-(-qlim // geom.tq), geom.chans * geom.rows * geom.strips,
            (-(-po // geom.rows), -(-spec.c // geom.chans), n), yp % 2 == 0)
    got = (geom.strips, geom.threads, tuple(geom.grid), geom.pairs)
    if got != want:
        rep.add("dw.shape", loc,
                f"(strips, threads, grid, pairs) = {got}, but strips of "
                f"{geom.tq} over {qlim} columns, {geom.chans} x {geom.rows} "
                f"strip rows a CTA and rows of {yp} elements give {want}")
    return rep


def check_launch_tile(spec: FoldKernelSpec, n: int, sm_count: int,
                      where: str = "kernel",
                      tile: Optional[FoldTile] = None,
                      dtype: torch.dtype = torch.float32) -> Report:
    """Prove the CTA tile of one WS / OS / psum launch on ``dtype``
    operands (``fold_tile``'s choice at ``sm_count`` SMs, or ``tile``):
    it is a tile of the core that type runs on (the tensor-core tiles for
    bf16) that the launch's dataflow may run (``tile_count``: OS's
    small-M tensor-core tiles have no WS or psum kernel), its dataflow,
    shape, depth fold and shared memory (a resident depth fold of the
    filter tile for WS and psum, the weight ring for OS) are its tile
    set's entry at this launch, it fits the shared memory of a CTA
    (``plan_check.check_tile_residency``; no tile that fits is the same
    finding), every output pixel and every filter of the launch falls in
    exactly one CTA tile, no filter tile straddles a group, and psum's
    depth folds cover the depth exactly.  A depthwise launch has no CTA
    tile: its thread geometry (``dw_geometry``'s pick, or ``tile``, a
    ``DwGeometry``) is proven by ``check_dw_geometry``."""
    rep = Report()
    if spec.dataflow == "depthwise":
        if tile is None:
            try:
                tile = dw_geometry(spec, n, sm_count, dtype)
            except ValueError as e:
                rep.add("dw.shape", f"{where}:dw", str(e))
                return rep
        return check_dw_geometry(spec, n, tile, where)
    if tile is None:
        try:
            tile = fold_tile(spec, n, sm_count, dtype=dtype)
        except ValueError as e:
            rep.add("plan.smem-overflow", where, str(e))
            return rep
    rep.extend(check_tile_residency(tile, where))
    loc = f"{where}:tile"
    core = tile_core(spec.dataflow, dtype)
    count = tile_count(core, spec.dataflow)
    if tile.core != core or not 0 <= tile.index < count:
        rep.add("tile.shape", loc,
                f"tile {tile.index} of the {tile.core} core, but a "
                f"{spec.dataflow} launch on {dtype} runs one of the first "
                f"{count} tiles of the {core} core")
        return rep
    pool = spec.epilogue.pool == "max2"
    po, qo = (spec.p_pad // 2, spec.q // 2) if pool else (spec.p_pad, spec.q)
    m = (4 if pool else 1) * n * po * qo
    nfg = spec.nf_pad // spec.groups
    kf = spec.plan.c_block * spec.r * spec.s
    k_total = spec.c_pad // spec.groups * spec.r * spec.s
    tm, tn, bm, bn, threads = tile_shape(core, tile.index)
    want = (spec.dataflow, tm, tn, bm, bn, threads, m, kf,
            tile_smem(core, spec.dataflow != "output_stationary", bm, bn,
                      kf, k_total, threads))
    got = (tile.dataflow, tile.tm, tile.tn, tile.bm, tile.bn, tile.threads,
           tile.m, tile.kf, tile.smem)
    if got != want:
        rep.add("tile.shape", loc,
                f"{core} tile {tile.index} reads (dataflow, tm, tn, bm, bn, "
                f"threads, M, Kf, smem) = {got}, but its tile set and the "
                f"launch give {want}")
        return rep

    # M: a WS / psum CTA walks m_per_cta consecutive M tiles, an OS CTA
    # owns one; the kernel clips the last CTA's walk at the M-tile count
    m_tiles = -(-m // tile.bm)
    per = 1 if spec.dataflow == "output_stationary" else tile.m_per_cta
    if per < 1 or tile.m_tiles != m_tiles:
        rep.add("tile.m-coverage", loc,
                f"{tile.m_tiles} M tiles of {tile.bm} pixels with "
                f"{per} a CTA, but the launch has {m} pixels "
                f"({m_tiles} tiles)")
    else:
        ctas = [(bx * per * tile.bm, min(m_tiles, (bx + 1) * per)
                 * tile.bm) for bx in range(tile.grid[0])]
        missed, twice = _ranges_cover(ctas, m)
        if missed or twice:
            rep.add("tile.m-coverage", loc,
                    f"{tile.grid[0]} CTAs x {per} M tiles of {tile.bm} "
                    f"cover the {m} output pixels with {missed} missed "
                    f"and {twice} written twice")

    # filters: CTA y is filter tile y % tpg of group y // tpg, its real
    # filters clipped at the tile's group width (``filter_tile``)
    tpg = tile.n_tiles // max(tile.groups, 1)
    if tile.groups < 1 or tile.n_tiles % tile.groups or tile.nfg < 1:
        rep.add("tile.n-coverage", loc,
                f"{tile.n_tiles} filter tiles over {tile.groups} groups "
                f"of {tile.nfg} filters")
        return rep
    ranges = []
    for y in range(tile.n_tiles):
        grp, t = divmod(y, tpg)
        f0 = grp * tile.nfg + t * tile.bn
        ranges.append((f0, f0 + max(0, min(tile.bn, tile.nfg - t * tile.bn))))
    missed, twice = _ranges_cover(ranges, spec.nf_pad)
    past = max((hi for _, hi in ranges), default=0) > spec.nf_pad
    if missed or twice or past:
        rep.add("tile.n-coverage", loc,
                f"{tile.n_tiles} filter tiles of {tile.bn} cover the "
                f"{spec.nf_pad} filters with {missed} missed, {twice} "
                f"computed twice{' and filters past the last' if past else ''}")
    straddle = [(lo, hi) for lo, hi in ranges
                if hi > lo and lo // nfg != (hi - 1) // nfg]
    if straddle:
        lo, hi = straddle[0]
        rep.add("tile.group-straddle", loc,
                f"filter tile [{lo}, {hi}) spans groups {lo // nfg} and "
                f"{(hi - 1) // nfg} (N_F/G = {nfg}): its sums would read "
                f"two groups' channels")

    # depth: psum sums one depth fold a CTA, WS / OS the whole depth
    cg = spec.c_pad // spec.groups
    k_total = cg * spec.r * spec.s
    folds = spec.cg_folds if spec.dataflow == "weight_stationary_psum" \
        else 1
    if tile.folds != folds or tile.folds * tile.k_len != k_total:
        rep.add("tile.fold-coverage", loc,
                f"{tile.folds} depth folds of {tile.k_len} taps, but the "
                f"launch sums {k_total} taps a group over {folds} folds")
    return rep
