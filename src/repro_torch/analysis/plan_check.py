"""ConvBlockPlan invariant verifier (the JAX package's
``analysis/plan_check.py``).

A ``ConvBlockPlan`` is the solved fold geometry for one loop nest: the
Filter Fold (``nf_block``), the depth fold (``c_block``), and the image
fold (``p_block``), plus the grid that walks them.  The planner
(``core/mapping.py:plan_conv_blocks``) *constructs* plans satisfying these
invariants; this module *proves* an arbitrary plan satisfies them, so a
hand-edited, cache-corrupted, or future-planner plan is caught before it
reaches a kernel.  Every rule that reads only the plan and the loop nest
gives the JAX package's finding, code for code:

  plan.groups-mismatch  the plan was solved for a different group
                        structure than the nest (G differs)
  plan.degenerate       a block or grid extent is < 1
  plan.group-straddle   ``nf_block`` does not divide N_F/G or ``c_block``
                        does not divide C/G — a fold would mix channels
                        from two independent group reductions
  plan.depthwise-shape  depthwise (G == C == N_F) plans must ride the
                        channel block (nf_block == c_block, one nf fold)
  plan.mxu-align        the filter fold is not lane aligned (dense layers
                        with N_F >= 8 want nf_block % 8 == 0; the plan is
                        the JAX package's, so is its alignment)
  plan.grid-coverage    grid x block does not cover each (N_F, C, P)
                        extent exactly once (under- or over-coverage)
  plan.not-clamped      ``clamped()`` is not idempotent at the nest's own
                        dims — the plan does not describe this layer
  quant.acc-overflow    (int8 only) the worst-case per-output reduction
                        127 * 127 * C_g * R * S exceeds the int32
                        accumulator range — a depth fold could wrap

The JAX package's residency rule prices a TPU's 64 MiB of VMEM
(``plan.vmem-overflow`` / ``plan.vmem-pressure``), which means nothing on
the card.  Here residency is the launch's CTA tile
(``kernels/conv2d_ws.py:fold_tile``), under a code of its own
(``check_tile_residency``):

  plan.smem-overflow    the tile's shared memory exceeds what one CTA may
                        take (``SMEM_LIMIT``), or no tile fits at all; a
                        tensor-core tile's bytes are recomputed from its
                        shape and depth fold (its resident bf16 filter
                        tile, the input ring that also stages the fp32
                        sums, the k offset table)

A tile that leaves room for one CTA per SM is no finding: the tile model
picks such tiles on purpose for the deepest WS layers.
"""
from __future__ import annotations

import math

from repro_torch.analysis.report import Report
from repro_torch.core.loopnest import ConvLoopNest
from repro_torch.core.mapping import ConvBlockPlan
from repro_torch.kernels.conv2d_ws import SMEM_LIMIT, FoldTile, tile_smem

__all__ = ["check_plan", "check_tile_residency"]


def _covers_exactly(grid: int, block: int, extent: int) -> bool:
    """grid x block tiles ``extent`` exactly once: enough blocks to cover
    it, and the last block is not entirely out of range."""
    return grid * block >= extent and (grid - 1) * block < extent


def check_tile_residency(tile: FoldTile, where: str = "plan") -> Report:
    """Prove one launch's CTA tile fits the shared memory a CTA may
    take: its recorded bytes and, for a tensor-core tile, the bytes its
    shape and dataflow need (WS, psum: a resident depth fold of the filter
    tile; OS: the ring of its chunks, whatever the depth)."""
    rep = Report()
    need = tile.smem
    if tile.core == "tc":
        need = max(need, tile_smem(
            "tc", tile.dataflow != "output_stationary", tile.bm, tile.bn,
            tile.kf, tile.k_len * tile.folds, tile.threads))
    if need > SMEM_LIMIT:
        rep.add("plan.smem-overflow", where,
                f"{tile.core} CTA tile {tile.index} ({tile.bm} pixels x "
                f"{tile.bn} filters) takes {need} bytes of shared memory, "
                f"over the {SMEM_LIMIT} one CTA may use: the launch fails")
    return rep


def check_plan(conv: ConvLoopNest, plan: ConvBlockPlan,
               where: str = "plan", precision: str = "fp32") -> Report:
    """Prove ``plan`` is a legal fold geometry for ``conv``.

    With ``precision="int8"`` the int32 accumulator is additionally
    proven safe: the per-output reduction depth (C_g * R * S) at the
    worst-case int8 magnitude (127 * 127 per product) must fit int32.
    Residency is the launch's CTA tile (``check_tile_residency``).
    """
    rep = Report()
    if precision == "int8":
        from repro_torch.core.quant import (INT32_ACC_MAX,
                                            int32_accumulator_bound)
        bound = int32_accumulator_bound(conv.cg, conv.r, conv.s)
        if bound > INT32_ACC_MAX:
            rep.add("quant.acc-overflow", where,
                    f"worst-case int8 reduction 127^2 * C_g*R*S = "
                    f"127^2 * {conv.cg * conv.r * conv.s} = {bound} "
                    f"exceeds int32 max {INT32_ACC_MAX}: a depth fold "
                    f"could wrap the accumulator")
    nf_b, c_b, p_b = plan.nf_block, plan.c_block, plan.p_block
    g_nf, g_c, g_p = plan.grid

    if plan.groups != conv.groups:
        rep.add("plan.groups-mismatch", where,
                f"plan solved for G={plan.groups} but the nest has "
                f"G={conv.groups}; group divisibility invariants differ")
        return rep      # nothing below is meaningful across group structures

    if min(nf_b, c_b, p_b, g_nf, g_c, g_p) < 1:
        rep.add("plan.degenerate", where,
                f"non-positive block/grid extent: blocks=({nf_b}, {c_b}, "
                f"{p_b}), grid={plan.grid}")
        return rep

    dw = conv.depthwise
    if dw:
        if nf_b != c_b:
            rep.add("plan.depthwise-shape", where,
                    f"depthwise filters ride the channel block but "
                    f"nf_block={nf_b} != c_block={c_b}")
        if g_nf != 1:
            rep.add("plan.depthwise-shape", where,
                    f"depthwise has no filter folds (one filter per "
                    f"channel) but grid has {g_nf} nf folds")
    else:
        if conv.groups > 1 and conv.nfg % nf_b:
            rep.add("plan.group-straddle", where,
                    f"nf_block={nf_b} does not divide N_F/G={conv.nfg}: a "
                    f"filter fold would straddle a group boundary")
        if conv.groups > 1 and conv.cg % c_b:
            rep.add("plan.group-straddle", where,
                    f"c_block={c_b} does not divide C/G={conv.cg}: a depth "
                    f"fold would mix channels from two group reductions")
        if (conv.groups == 1 and conv.nf >= 8 and nf_b % 8
                and nf_b != conv.nf):
            # nf_b == nf is the clamped-to-extent case: a ragged N_F
            # (e.g. 10 filters) legally clamps the fold to the extent
            rep.add("plan.mxu-align", where,
                    f"nf_block={nf_b} is not lane aligned (want a multiple "
                    f"of 8 when N_F={conv.nf} >= 8): the filter fold is "
                    f"not the planner's")

    # grid/fold coverage arithmetic: every (N_F, C, P) element is owned by
    # exactly one fold.  The nf grid axis spans all G groups' filter folds.
    if dw:
        axes = (("C", g_c, c_b, conv.c), ("P", g_p, p_b, conv.p))
    elif conv.groups > 1:
        # per-group folds: g_nf spans G groups' nf folds exactly
        if conv.nfg % nf_b == 0 and g_nf != conv.groups * (conv.nfg // nf_b):
            rep.add("plan.grid-coverage", where,
                    f"nf grid axis has {g_nf} folds but G * (N_F/G / "
                    f"nf_block) = {conv.groups * (conv.nfg // nf_b)}")
        axes = (("C/G", g_c, c_b, conv.cg), ("P", g_p, p_b, conv.p))
    else:
        axes = (("N_F", g_nf, nf_b, conv.nf), ("C", g_c, c_b, conv.c),
                ("P", g_p, p_b, conv.p))
    for name, g, b, extent in axes:
        if not _covers_exactly(g, b, extent):
            want = math.ceil(extent / b)
            rep.add("plan.grid-coverage", where,
                    f"{name} axis: {g} folds x {b}-block covers "
                    f"[{(g - 1) * b}, {g * b}) but the extent is {extent} "
                    f"(want {want} folds): elements would be "
                    f"{'missed' if g * b < extent else 'computed twice'}")

    # clamp idempotence: a plan describing *this* layer must be a fixed
    # point of clamped() at the layer's own dims (cache reuse clamps a
    # larger-geometry plan down; an unclamped plan reaching the kernel
    # means the engine skipped that step)
    clamped = plan.clamped(conv.nf, conv.c, conv.p)
    if (clamped.nf_block, clamped.c_block, clamped.p_block, clamped.grid) \
            != (nf_b, c_b, p_b, plan.grid):
        rep.add("plan.not-clamped", where,
                f"plan is not clamped to the nest's dims: blocks "
                f"({nf_b}, {c_b}, {p_b}) grid {plan.grid} != clamped "
                f"({clamped.nf_block}, {clamped.c_block}, "
                f"{clamped.p_block}) grid {clamped.grid}")
    return rep
