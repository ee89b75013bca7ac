"""The port's op-cost walker and H100 roofline (``repro_torch.op_cost``,
``repro_torch.roofline``) against the JAX package's HLO walker and
roofline (``repro/hlo_cost.py``, ``repro/roofline.py``): the same ring
factors, the same report arithmetic on H100 constants, and on the same
small functions counts inside the same band as the JAX walker's on the
compiled JAX version."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import roofline as j_roofline  # noqa: E402
from repro.hlo_cost import analyze_hlo  # noqa: E402
from repro_torch import op_cost, roofline  # noqa: E402


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_h100_constants_are_the_datasheet_figures():
    hw = roofline.H100_SXM
    assert (hw.peak_flops, hw.hbm_bw, hw.ici_bw) == (989e12, 3.35e12, 450e9)
    assert [f.name for f in dataclasses.fields(roofline.HW)] == \
        [f.name for f in dataclasses.fields(j_roofline.HW)]
    assert not hasattr(roofline, "TPU_V5E")


def test_ring_factors_via_collective_stats_match_the_hlo_parse():
    hlo = """
  %ar = f32[1024]{0} all-reduce(%x), replica_groups=[2,8]<=[16], to_apply=%s
  %ag = f32[2048]{0} all-gather(%y), replica_groups=[2,8]<=[16], dimensions={0}
  %cp = f32[512]{0} collective-permute(%z), source_target_pairs={{0,1}}
"""
    want = j_roofline.parse_collectives(hlo)
    got = roofline.collective_stats([
        op_cost.CollectiveRecord("all-reduce", 4096, 8),
        op_cost.CollectiveRecord("all-gather", 8192, 8),
        op_cost.CollectiveRecord("collective-permute", 2048, 2)])
    assert got.count == want.count
    for op in want.wire_bytes:
        assert got.wire_bytes[op] == pytest.approx(want.wire_bytes[op])
        assert got.result_bytes[op] == pytest.approx(want.result_bytes[op])
    assert got.wire_bytes["all-reduce"] == pytest.approx(4096 * 2 * 7 / 8)
    assert got.total_wire_bytes == pytest.approx(want.total_wire_bytes)


@pytest.mark.parametrize("op,g", [("all-reduce", 16), ("all-gather", 16),
                                  ("reduce-scatter", 16), ("all-to-all", 4),
                                  ("collective-permute", 2)])
def test_ring_factor_table_is_the_hlo_walkers(op, g):
    from repro.hlo_cost import _RING_FACTOR
    assert op_cost.RING_FACTOR[op](g) == _RING_FACTOR[op](g)


def test_roofline_dominant_and_fraction_on_h100_constants():
    hw = roofline.H100_SXM
    rep = roofline.RooflineReport(
        flops_per_dev=hw.peak_flops,          # exactly 1 s of compute
        bytes_per_dev=hw.hbm_bw * 2,          # 2 s of memory
        coll_wire_bytes=hw.ici_bw * 0.5,      # 0.5 s of collectives
        collectives=roofline.CollectiveStats({}, {}, {}),
        hw=hw, model_flops=hw.peak_flops * 256, chips=256)
    assert rep.t_compute == pytest.approx(1.0)
    assert rep.t_memory == pytest.approx(2.0)
    assert rep.t_collective == pytest.approx(0.5)
    assert rep.dominant == "memory"
    assert rep.bound_time == pytest.approx(2.0)
    assert rep.useful_flops_ratio == pytest.approx(1.0)
    assert rep.roofline_fraction == pytest.approx(0.5)
    j_rep = j_roofline.RooflineReport(
        flops_per_dev=1.0, bytes_per_dev=1.0, coll_wire_bytes=0.0,
        collectives=j_roofline.CollectiveStats({}, {}, {}),
        hw=j_roofline.TPU_V5E)
    assert set(rep.as_dict()) == set(j_rep.as_dict())


def test_tanh_matmul_sum_counts_within_the_jax_walkers_band():
    want = 2 * 64 * 128 * 256

    def f(x, w):
        return torch.tanh(x @ w).sum()
    cost = op_cost.analyze_step(f, _meta(64, 128), _meta(128, 256))
    rep = roofline.roofline_terms(cost, chips=1, model_flops=want)
    assert want <= rep.flops_per_dev <= 1.2 * want
    assert rep.bytes_per_dev > 0
    assert 0.8 <= rep.useful_flops_ratio <= 1.0
    # the JAX walker on the compiled JAX version lands in the same band
    c = jax.jit(lambda x, w: jnp.sum(jnp.tanh(x @ w))).lower(
        jax.ShapeDtypeStruct((64, 128), jnp.float32),
        jax.ShapeDtypeStruct((128, 256), jnp.float32)).compile()
    j_rep = j_roofline.roofline_terms(c, chips=1, model_flops=want)
    assert want <= j_rep.flops_per_dev <= 1.2 * want
    # the dot's operands and result at their boundaries, tanh fused
    assert cost.bytes_hbm == (64 * 128 + 128 * 256 + 64 * 256) * 4 + \
        4 * 1 + 64 * 256 * 4


def test_a_loop_of_twelve_matmuls_counts_twelve_times():
    want = 12 * 2 * 32 * 64 * 64

    def f(x, ws):
        for i in range(ws.shape[0]):
            x = torch.tanh(x @ ws[i])
        return x.sum()
    cost = op_cost.analyze_step(f, _meta(32, 64), _meta(12, 64, 64))
    assert want <= cost.flops <= 1.2 * want

    def g(x, ws):
        def body(c, w):
            return jnp.tanh(c @ w), None
        y, _ = jax.lax.scan(body, x, ws)
        return y.sum()
    c = jax.jit(g).lower(jax.ShapeDtypeStruct((32, 64), jnp.float32),
                         jax.ShapeDtypeStruct((12, 64, 64), jnp.float32)
                         ).compile()
    hc = analyze_hlo(c.as_text())
    assert want <= hc.flops <= 1.2 * want
    assert list(hc.trip_counts.values()) == [12]


def test_walker_counts_real_cpu_tensors_like_meta_ones():
    gen = np.random.default_rng(0)
    x = torch.from_numpy(gen.standard_normal((16, 32)).astype(np.float32))
    w = torch.from_numpy(gen.standard_normal((32, 8)).astype(np.float32))

    def f(x, w):
        return torch.softmax(x @ w, dim=-1).float()
    real = op_cost.analyze_step(f, x, w)
    meta = op_cost.analyze_step(f, x.to("meta"), w.to("meta"))
    assert (real.flops, real.bytes_hbm, real.bytes_all) == \
        (meta.flops, meta.bytes_hbm, meta.bytes_all)
    assert real.flops == 2 * 16 * 8 * 32 + 16 * 8


def test_a_converted_operand_is_read_at_its_source_bytes():
    """A dtype conversion is fused into its reader: the fp32 copy of a
    bf16 weight is read at bf16's bytes."""
    def f(x, w):
        return x.float() @ w.float()
    cost = op_cost.analyze_step(f, _meta(8, 64, dtype=torch.bfloat16),
                                _meta(64, 32, dtype=torch.bfloat16))
    assert cost.bytes_hbm == (8 * 64 + 64 * 32) * 2 + 8 * 32 * 4
    assert cost.bytes_all > cost.bytes_hbm


def test_peak_live_bytes_and_argument_bytes():
    def f(x):
        y = x * 2.0                     # y: 4 KiB live
        z = y + 1.0                     # y, z: 8 KiB
        del y
        return (z * 3.0).sum()          # z, z * 3 and the 4-byte sum
    cost = op_cost.analyze_step(f, _meta(32, 32), donate_argnums=(0,))
    assert cost.arg_bytes == cost.alias_bytes == 32 * 32 * 4
    assert cost.peak_bytes == 2 * 32 * 32 * 4 + 4
    assert cost.out_bytes == 4


def test_opcost_scaled_and_add_follow_hlocost():
    from repro.hlo_cost import HloCost
    a = op_cost.OpCost(1.0, 2.0, 3.0, 4.0, 5.0, {"all-reduce": 1},
                       {"blocks": 3}, [op_cost.CollectiveRecord(
                           "all-reduce", 5.0, 4)])
    b = a.scaled(3)
    assert (b.flops, b.bytes_hbm, b.bytes_all, b.coll_wire_bytes,
            b.coll_result_bytes) == (3.0, 6.0, 9.0, 12.0, 15.0)
    assert b.coll_counts == {"all-reduce": 3}
    assert b.records[0].count == 3
    a.add(b)
    assert (a.flops, a.coll_counts) == (4.0, {"all-reduce": 4})
    h = HloCost(1.0, 2.0, 3.0, 4.0, 5.0, {"all-reduce": 1}, {"blocks": 3})
    h.add(h.scaled(3))
    assert (h.flops, h.bytes_hbm, h.bytes_all, h.coll_wire_bytes,
            h.coll_result_bytes, h.coll_counts) == \
        (a.flops, a.bytes_hbm, a.bytes_all, a.coll_wire_bytes,
         a.coll_result_bytes, a.coll_counts)


def test_a_row_parallel_matmul_on_a_fake_mesh_counts_one_all_reduce():
    from torch.distributed.tensor import Replicate
    from repro_torch.core.mapping import PartitionSpec
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import end_fake_group, make_fake_mesh
    mesh = make_fake_mesh((4,), ("model",))
    try:
        x = shd.NamedSharding(mesh, PartitionSpec(None, "model")).distribute(
            _meta(8, 64))
        w = shd.NamedSharding(mesh, PartitionSpec("model", None)).distribute(
            _meta(64, 32))

        def f(x, w):
            return (x @ w).redistribute(mesh.device_mesh, [Replicate()])
        cost = op_cost.analyze_step(f, x, w)
    finally:
        end_fake_group()
    assert cost.coll_counts == {"all-reduce": 1}
    assert cost.flops == 2 * 8 * 32 * 16          # the rank's K slice
    rec = cost.records[0]
    assert (rec.result_bytes, rec.group_size) == (8 * 32 * 4, 4)
    assert cost.coll_wire_bytes == pytest.approx(8 * 32 * 4 * 2 * 3 / 4)
    assert cost.arg_bytes == (8 * 16 + 16 * 32) * 4
