"""The port's dry-run (``repro_torch.launch.dryrun``) against the JAX
package's (``repro/launch/dryrun.py``): the analytic MODEL_FLOPS of every
cell, the per-device argument bytes of all 80 arch x shape x mesh cells
against JAX's ``NamedSharding`` shard shapes, the traced sharded step on
fake 2x2 and 2x1x2 meshes (reduced configs), the JSON records, the memory
term of gemma3-12b's decode against its weight read, and the traced
program on real tensors: reduced qwen3-4b's and zamba2-1.2b's loss on
DTensors over two gloo ranks against the one-rank loss.

The JAX dry-run module is not imported here: it sets 512 fake host
devices when imported.  Its ``model_flops_for`` is read from its source."""
import ast
import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import NamedSharding as JNamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs.base import SHAPES as J_SHAPES  # noqa: E402
from repro.configs.registry import ARCHS as J_ARCHS  # noqa: E402
from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.distributed import sharding as j_shd  # noqa: E402
from repro.launch import specs as j_specs  # noqa: E402
from repro.models import api as j_api  # noqa: E402
from repro.optim.adamw import abstract_opt_state as j_abstract_opt  # noqa

from repro_torch.configs.base import SHAPES, ShapeSpec  # noqa: E402
from repro_torch.configs.registry import ARCHS, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_DRYRUN = ROOT / "src" / "repro" / "launch" / "dryrun.py"
CELLS = [(a, s, mp) for a in ARCHS for s in SHAPES for mp in (False, True)]
TRACED_ARCHS = ("llama3-8b", "zamba2-1.2b", "rwkv6-1.6b", "qwen2-moe-a2.7b")
# JAX's record keys (repro/launch/dryrun.py:133-162)
JAX_META_KEYS = {"arch", "shape", "mesh", "chips", "kind", "remat",
                 "attn_impl", "seq_shard_kv", "shard_batch", "compile_s"}
JAX_MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
                   "alias_bytes", "total_per_device"}


def _jax_model_flops_for():
    """``model_flops_for`` of the JAX dry-run, compiled from its source
    alone."""
    tree = ast.parse(JAX_DRYRUN.read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "model_flops_for")
    ns = {}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(JAX_DRYRUN),
                 "exec"), ns)
    return ns["model_flops_for"]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_model_flops_for_equals_jax(arch):
    j_flops = _jax_model_flops_for()
    for sname in SHAPES:
        assert dryrun.model_flops_for(get_config(arch), SHAPES[sname]) == \
            j_flops(j_get_config(arch), J_SHAPES[sname])


def _jax_bytes(tree, shardings) -> int:
    return sum(math.prod(s.shard_shape(a.shape)) * a.dtype.itemsize
               for a, s in zip(jax.tree.leaves(tree),
                               jax.tree.leaves(shardings)))


def _jax_argument_bytes(arch, sname, multi_pod) -> int:
    """The JAX dry-run's per-device step arguments (its ``in_shardings``,
    ``repro/launch/dryrun.py:58-131``) on an ``AbstractMesh``."""
    cfg, shape = j_get_config(arch), J_SHAPES[sname]
    mesh = (AbstractMesh((2, 16, 16), ("pod", "data", "model")) if multi_pod
            else AbstractMesh((16, 16), ("data", "model")))
    dp = mesh.shape.get("pod", 1) * mesh.shape["data"]
    shard_batch = shape.global_batch % dp == 0
    rules = j_shd.make_rules(cfg, mesh, shard_batch=shard_batch,
                             seq_shard_kv=shape.kind == "decode"
                             and not shard_batch)
    params = j_api.init_params(cfg, abstract=True)
    axes = j_api.param_axes(cfg)
    total = _jax_bytes(params, j_shd.tree_shardings(axes, rules, mesh))
    repl = JNamedSharding(mesh, JP())

    def batch_bytes(abs_, axes_):
        sh = jax.tree.map(lambda a: JNamedSharding(mesh,
                                                   j_shd.spec_for(a, rules)),
                          axes_, is_leaf=lambda x: isinstance(x, tuple))
        return _jax_bytes(abs_, sh)
    if shape.kind == "train":
        opt = j_abstract_opt(params)
        z1 = j_shd.zero1_shardings(axes, params, rules, mesh)
        total += 3 * _jax_bytes(opt["mu"], z1) + 4
        return total + batch_bytes(j_specs.train_batch_specs(cfg, shape),
                                   j_specs.train_batch_axes(cfg))
    max_len = shape.seq_len + (cfg.frontend_len
                               if cfg.frontend == "vlm" else 0)
    cache = j_api.init_cache(cfg, shape.global_batch, max_len,
                             src_len=j_specs.src_len_for(cfg, shape),
                             abstract=True)
    total += _jax_bytes(cache, j_shd.tree_shardings(j_api.cache_axes(cfg),
                                                    rules, mesh))
    if shape.kind == "prefill":
        return total + batch_bytes(j_specs.prefill_batch_specs(cfg, shape),
                                   j_specs.prefill_batch_axes(cfg))
    token, pos = j_specs.decode_input_specs(cfg, shape)
    tok_sh = JNamedSharding(mesh, j_shd.spec_for(("batch",), rules))
    return total + _jax_bytes(token, tok_sh) + _jax_bytes(pos, repl)


@pytest.mark.parametrize("arch,sname,multi_pod", CELLS,
                         ids=[f"{a}-{s}-{'2x16x16' if m else '16x16'}"
                              for a, s, m in CELLS])
def test_per_device_argument_bytes_equal_jax(arch, sname, multi_pod):
    assert dryrun.argument_bytes(arch, sname, multi_pod) == \
        _jax_argument_bytes(arch, sname, multi_pod)


def _small(kind, batch=4):
    return ShapeSpec(f"{kind}_cpu", 64 if kind == "decode" else 16, batch,
                     kind)


TRACED = [(a, m, k) for a in TRACED_ARCHS for m in ((2, 2), (2, 1, 2))
          for k in ("train", "prefill", "decode")]


@pytest.mark.parametrize("arch,mesh_shape,kind", TRACED,
                         ids=[f"{a}-{'x'.join(map(str, m))}-{k}"
                              for a, m, k in TRACED])
def test_build_cell_traces_the_sharded_step(arch, mesh_shape, kind):
    shape = _small(kind)
    cfg = get_config(arch, reduced=True)
    cost, meta = dryrun.build_cell(arch + "-smoke", shape, False,
                                   mesh_shape=mesh_shape)
    rec = dryrun.analyze(cost, meta, cfg, shape)
    rec["ok"] = True
    json.dumps(rec)
    assert JAX_META_KEYS <= set(rec) and JAX_MEMORY_KEYS <= set(rec["memory"])
    assert meta["chips"] == 4 and meta["kind"] == kind
    assert meta["mesh"] == "x".join(map(str, mesh_shape))
    # every count is a sum over the layers: none goes below zero
    assert cost.flops > 0 and cost.bytes_hbm > 0 and cost.n_ops > 0
    assert all(v >= 0 for v in cost.coll_counts.values())
    # the model axis splits the heads, the MLP and the vocab
    counts = rec["roofline"]["collectives"]["count"]
    assert counts.get("all-reduce", 0) + counts.get("all-gather", 0) >= 1
    # the traced step's arguments: the exact per-rank bytes of the rules
    mesh = Mesh(dict(zip(dryrun._mesh_axes(mesh_shape), mesh_shape)))
    rules, _, _ = dryrun._rules_for(cfg, shape, mesh)
    _, args, shardings, donate = dryrun.cell_inputs(cfg, shape, mesh, rules)
    assert rec["memory"]["argument_bytes"] == pytest.approx(
        dryrun._sharded_bytes(args, shardings), rel=1e-12)
    assert rec["memory"]["alias_bytes"] == pytest.approx(sum(
        dryrun._sharded_bytes(args[i], shardings[i]) for i in donate),
        rel=1e-12)


def test_build_cell_with_one_head_a_rank():
    """Two heads over the two model ranks (one a rank, no GQA: qwen2-moe's
    and seamless's 16 heads over 16 ranks at full size)."""
    cost, meta = dryrun.build_cell(
        "llama3-8b-smoke", _small("train"), False, mesh_shape=(2, 2),
        extra={"n_heads": 2, "kv_heads": 2})
    assert cost.flops > 0 and meta["kind"] == "train"


def test_shard_local_einsum_places_its_result():
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.core.mapping import PartitionSpec as P
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import end_fake_group, make_fake_mesh
    from repro_torch.distributed.dtensor import einsum
    x, w = torch.randn(4, 3, 8), torch.randn(8, 2, 5)
    assert torch.equal(einsum("btd,dhk->bthk", x, w),
                       torch.einsum("btd,dhk->bthk", x, w))
    mesh = make_fake_mesh((2, 2), ("data", "model"))
    try:
        xs = shd.NamedSharding(mesh, P("data", None, None)).distribute(
            torch.empty((4, 6, 8), device="meta"))
        wq = shd.NamedSharding(mesh, P(None, "model", None)).distribute(
            torch.empty((8, 4, 16), device="meta"))
        q = einsum("btd,dhk->bthk", xs, wq)
        assert q.placements == (Shard(0), Shard(2))
        assert q.to_local().shape == (2, 6, 2, 16)
        wo = shd.NamedSharding(mesh, P("model", None, None)).distribute(
            torch.empty((4, 16, 8), device="meta"))
        o = einsum("bthk,hkd->btd", q, wo)
        assert o.placements == (Shard(0), Partial())
        assert o.redistribute(mesh.device_mesh, [Shard(0), Replicate()]
                              ).to_local().shape == (2, 6, 8)
    finally:
        end_fake_group()


EXTRAPOLATED = [(a, k, m) for a, k in (("llama3-8b", "train"),
                                       ("llama3-8b", "decode"),
                                       ("qwen2-moe-a2.7b", "train"),
                                       ("rwkv6-1.6b", "train"),
                                       ("rwkv6-1.6b", "decode"))
                for m in ((1, 2), (4, 2))]


@pytest.mark.parametrize("arch,kind,mesh_shape", EXTRAPOLATED,
                         ids=[f"{a}-{k}-{'x'.join(map(str, m))}"
                              for a, k, m in EXTRAPOLATED])
def test_depth_extrapolation_equals_the_whole_trace(arch, kind, mesh_shape):
    """Two cut depths (two and three layers) taken linearly to four count
    what the whole four-layer stack counts.  On the 4x2 mesh the data
    axis divides the four layers and neither cut depth, so ZeRO-1 folds
    it onto the layers dim of the whole stack's optimizer state and onto
    another dim at the cut depths: the update traced at the full depth
    and the memory from the abstract trees keep the counts exact.
    rwkv6's train step lays out the gradients of a one-layer stack
    otherwise than those of more (no cut at one layer), and its decode
    step each layer's new state (laid out as its cache layer)."""
    from repro_torch.models import api
    from repro_torch.tree import leaves
    cfg = get_config(arch, reduced=True)
    assert dryrun.depth_plan(cfg) == (1, 0, 4, 2)
    shape = _small(kind)
    cost, meta = dryrun.build_cell(arch + "-smoke", shape, False,
                                   mesh_shape=mesh_shape)
    assert meta["traced_depths"] == [2, 3]
    mesh = dryrun.make_fake_mesh(mesh_shape, ("data", "model"))
    try:
        rules, _, _ = dryrun._rules_for(cfg, shape, mesh)
        dryrun.shd.set_context(mesh, rules)
        whole, _ = dryrun._trace(cfg, shape, mesh, rules, "dots", "naive",
                                 False)
        if kind == "train" and mesh_shape == (4, 2):
            z1 = dryrun.shd.zero1_shardings(
                api.param_axes(cfg), api.init_params(cfg, abstract=True),
                rules, mesh)
            # the stacked leaves fold the data axis onto the layers dim
            assert all(sh.spec[0] == "data"
                       for sh in leaves(z1["blocks"]))
    finally:
        dryrun.shd.clear_context()
        dryrun.end_fake_group()
    for f in ("flops", "bytes_hbm", "bytes_all", "coll_wire_bytes",
              "coll_result_bytes", "arg_bytes", "out_bytes", "alias_bytes"):
        assert getattr(cost, f) == pytest.approx(getattr(whole, f),
                                                 rel=1e-9), f
    assert cost.coll_counts == pytest.approx(whole.coll_counts)
    # the peak of live bytes is the port's estimate of temp memory: the
    # update's peak is taken on top of the gradients and the loss
    assert cost.peak_bytes == pytest.approx(whole.peak_bytes, rel=1e-4)
    assert cost.trip_counts == {"blocks": 4}


def test_a_full_attention_long_cell_skips_with_jax_reason(tmp_path):
    src = JAX_DRYRUN.read_text()
    assert ('"reason": f"{arch} is full-attention; {shape_name} "\n'
            '                                "requires sub-quadratic '
            '(DESIGN.md §6)"') in src
    r = dryrun.run_cell("llama3-8b", "long_500k", True, tmp_path)
    want = ("llama3-8b is full-attention; long_500k requires "
            "sub-quadratic (DESIGN.md §6)")
    assert r == {"skipped": True, "reason": want, "arch": "llama3-8b",
                 "shape": "long_500k", "mesh": "2x16x16", "ok": True}
    assert json.loads((tmp_path / "llama3-8b__long_500k__2x16x16.json")
                      .read_text()) == r
    for arch, cfg in ARCHS.items():
        assert cfg.runs_shape(SHAPES["long_500k"]) == \
            J_ARCHS[arch].runs_shape(J_SHAPES["long_500k"])


def test_run_cell_records_a_failure(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise ValueError("no such layout")
    monkeypatch.setattr(dryrun, "build_cell", boom)
    r = dryrun.run_cell("qwen3-4b", "train_4k", False, tmp_path)
    assert r["ok"] is False and r["error"] == "ValueError: no such layout"
    assert "boom" in r["traceback"]
    assert json.loads((tmp_path / "qwen3-4b__train_4k__16x16.json")
                      .read_text())["ok"] is False


def test_main_writes_one_json_per_cell(tmp_path, capsys):
    rc = dryrun.main(["--arch", "llama3-8b,qwen3-4b", "--shape",
                      "long_500k", "--mesh", "both", "--out",
                      str(tmp_path)])
    assert rc == 0
    assert sorted(p.name for p in tmp_path.glob("*.json")) == sorted(
        f"{a}__long_500k__{m}.json" for a in ("llama3-8b", "qwen3-4b")
        for m in ("16x16", "2x16x16"))
    assert capsys.readouterr().out.count("SKIP(") == 4
    assert dryrun.RESULTS == ROOT / "build" / "dryrun"


def test_gemma3_decode_memory_term_against_its_weight_read():
    """gemma3-12b's B=4 decode at its published config on ``meta``: the
    memory term reads every weight once (21.91 GiB at 3.35 TB/s), within
    1.0-1.5x of that read."""
    from repro_torch.models import api
    from repro_torch.op_cost import analyze_step
    from repro_torch.roofline import H100_SXM, roofline_terms
    from repro_torch.serve.steps import make_decode_step
    from repro_torch.tree import leaves
    cfg = get_config("gemma3-12b")
    params = api.init_params(cfg, abstract=True)
    weights = sum(t.numel() * t.element_size() for t in leaves(params))
    assert weights / 2**30 == pytest.approx(21.91, abs=0.01)
    cache = api.init_cache(cfg, 4, 64, abstract=True)
    token = torch.empty(4, dtype=torch.long, device="meta")
    cost = analyze_step(make_decode_step(cfg, donate=True), params, token,
                        cache, 16)
    rep = roofline_terms(cost, chips=1,
                         model_flops=dryrun.model_flops_for(
                             cfg, ShapeSpec("d", 64, 4, "decode")))
    read = weights / H100_SXM.hbm_bw
    assert 1.0 * read <= rep.t_memory <= 1.5 * read
    assert rep.dominant == "memory"


def test_fake_mesh_refuses_a_running_process_group():
    import torch.distributed as dist
    from repro_torch.launch.mesh import (free_port, make_fake_mesh,
                                         start_process_group)
    start_process_group(0, 1, free_port(), device="cpu")
    try:
        with pytest.raises(RuntimeError, match="gloo"):
            make_fake_mesh((2, 2), ("data", "model"))
    finally:
        dist.destroy_process_group()


def test_distribute_tree_and_constrain_on_a_fake_mesh():
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.core.mapping import PartitionSpec
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import end_fake_group, make_production_mesh
    mesh = make_production_mesh(multi_pod=True, fake=True)
    try:
        assert mesh.size == 512 and mesh.dm_axes == (("pod", "data"),
                                                     ("model",))
        sh = shd.NamedSharding(mesh, PartitionSpec(("pod", "data"),
                                                   "model"))
        x = torch.empty((64, 32), device="meta")
        tree = shd.distribute_tree({"a": x, "b": x[:, :16]},
                                   {"a": sh, "b": sh})
        assert tree["a"].placements == (Shard(0), Shard(1))
        assert tree["a"].to_local().shape == (2, 2)
        assert tree["a"].shape == x.shape
        assert tree["b"].to_local().shape == (2, 1)
        cfg = get_config("qwen3-4b")
        shd.set_context(mesh, shd.make_rules(cfg, mesh))
        y = shd.constrain(tree["a"], ("batch", None))
        assert y.placements == (Shard(0), Replicate())
        with pytest.raises(NotImplementedError, match="4f.3"):
            shd.constrain(torch.ones(64, 32), ("batch", None))
    finally:
        shd.clear_context()
        end_fake_group()


def test_two_gloo_ranks_give_the_one_rank_loss(tmp_path):
    """The reduced LM families in fp32 on DTensors (``distribute_tree``)
    over a data 1 x model 2 and a data 2 x model 1 mesh of two gloo
    ranks, against one rank: ``lm_loss`` within 1e-5·|loss| (the
    vocab-parallel embedding and loss, the attention, SSD, WKV and MoE
    cores, the token split over the data axis); a greedy decode step from
    a prefilled cache whose sequence the data axis splits (the
    split-key combine, the sharded cache writes) with its logits within
    1e-5·max|logits| and the same next token; and one train step with
    the optimizer state in the ZeRO-1 layout (the gradients handed to it,
    the master handed back): its first moments (the clipped gradients)
    within 1e-4·max|mu| a leaf (the largest seen is 1.7e-5, rwkv6's WKV
    recurrence on 1x2), its new parameters within
    1e-6 + 1e-5·|p| plus what that gradient error can move them (Adam's
    first step moves a weight by lr·g/(|g| + eps), so an error dg in g
    moves it by up to 2·lr·dg/(|g| + eps)).  The program the dry-run
    traces is the program."""
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_mesh_ranks as ranks
    from repro_torch.models import api
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.serve.steps import make_decode_step
    from repro_torch.tree import leaves_with_path
    out = subprocess.run([sys.executable, str(ROOT / "tests"
                                              / "torch_mesh_ranks.py"),
                          "2", str(tmp_path), "lm"],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr[-3000:]
    got = [np.load(tmp_path / f"rank{r}.npz") for r in (0, 1)]
    for arch in ranks.LM_ARCHS:
        cfg = get_config(arch, reduced=True)
        params = ranks.lm_params(cfg)
        batch = ranks.lm_batch(cfg)
        loss = float(api.lm_loss(params, cfg, batch)[0])
        new, opt, _ = ranks.lm_train_step(cfg)(params,
                                               init_opt_state(params), batch)
        cache, token, pos = ranks.lm_prefill(cfg, params)
        nxt, logits, _ = make_decode_step(cfg)(params, token, cache, pos)
        for data, model in ranks.LM_MESHES:
            tag = f"{data}x{model}_{arch}"
            for g in got:
                assert abs(float(g[f"loss_{tag}"]) - loss) <= \
                    1e-5 * abs(loss), (tag, float(g[f"loss_{tag}"]), loss)
                err = np.abs(g[f"decode_{tag}"] - logits.numpy()).max()
                assert err <= 1e-5 * logits.abs().max().item(), (tag, err)
                assert np.array_equal(g[f"next_{tag}"], nxt.numpy()), tag
                adam = AdamWConfig()
                for (path, leaf), (_, mu) in zip(leaves_with_path(new),
                                                 leaves_with_path(opt["mu"])):
                    key = f"{tag}_{'.'.join(map(str, path))}"
                    mu = mu.numpy()
                    dmu = 1e-4 * np.abs(mu).max()
                    assert np.abs(g[f"mu_{key}"] - mu).max() <= dmu, key
                    gs, dg = mu / (1 - adam.b1), dmu / (1 - adam.b1)
                    want = leaf.numpy()
                    tol = (1e-6 + 1e-5 * np.abs(want)
                           + 2 * adam.lr * dg / (np.abs(gs) + adam.eps))
                    assert np.all(np.abs(g[f"train_{key}"] - want) <= tol), key
