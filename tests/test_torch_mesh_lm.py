"""The port's LM steps on real ranks through its entry points, on the CPU.

Two gloo ranks in spawned processes (``tests/torch_mesh_ranks.py``'s
``lm_entry`` case, one run for the file, under a timeout) take reduced
qwen3-4b, zamba2-1.2b, rwkv6-1.6b and qwen2-moe-a2.7b in fp32 from the
JAX package's weights (its step-0 checkpoint, written here) through, on
a 1x2 and a 2x1 mesh:

* ``Trainer(mesh=)`` for three steps, checkpointing every step: the
  losses within 1e-5·|loss| and the new parameters within 2·lr of the
  JAX package's jitted ``make_train_step`` on the same weights and
  batches; a restart from the step-2 checkpoint bitwise the uninterrupted
  run; the step-3 checkpoint restored bitwise by one rank and by the JAX
  package, its files byte for byte a one-rank save of the gathered tree;
* the survivor's restart (here, in the test's process): the step-2
  checkpoint restored on one rank by ``examples/torch_elastic_restart.py``'s
  ``restart_trainer`` under the plan for one survivor (a 1x1 mesh, two
  microbatches of 1), its step-3 loss within 1e-5·|loss| of the mesh
  run's and its parameters within the fp32 step's bound of the mesh
  run's;
* ``BatchEngine(mesh=)``: the JAX package's engine's tokens on the same
  weights and prompts (a token may part only at a near-tie of the one-rank
  logits), each decode call's logits within 1e-5·max|logits| of the
  port's one-rank engine's;
* ``make_prefill_step`` on ``DTensor``s: its logits within
  1e-5·max|logits| of one rank's;
* both launchers with ``--mesh``, a checkpoint of a ``DTensor`` that rank
  0 alone writes, a SIGTERM to one rank (every rank stops after the same
  step), and a plain tensor's step under the two-rank context, which
  raises;
* every collective of ``distributed/hostgloo.py``'s group (what ranks
  that share a card join) on host tensors; a test marked ``cuda`` runs
  them on a card's tensors, through its CUDA IPC buffers.

Here, in the test's own process: ``mesh=None`` and a one-rank mesh give
the mesh-less ``Trainer`` and ``BatchEngine`` bitwise, the step layouts
(``launch/specs.step_layout``) pick the batch or the cache's sequence,
and ``torchrun`` starts the training launcher on two ranks through the
``env://`` variables."""
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax import tree_util as jtu  # noqa: E402

from repro.ckpt import checkpoint as j_ckpt  # noqa: E402
from repro.configs import registry as j_registry  # noqa: E402
from repro.data.pipeline import DataConfig as JData  # noqa: E402
from repro.data.pipeline import TokenPipeline as JPipeline  # noqa: E402
from repro.models import api as j_api  # noqa: E402
from repro.models.common import DTypePolicy as JPolicy  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro.serve import engine as j_engine  # noqa: E402
from repro.train.steps import make_train_step as j_make_step  # noqa: E402
from repro_torch.ckpt import checkpoint as t_ckpt  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import api as t_api  # noqa: E402
from repro_torch.optim import adamw as t_adamw  # noqa: E402
from repro_torch.serve import engine as t_engine  # noqa: E402
from repro_torch.serve.steps import make_prefill_step  # noqa: E402
from repro_torch.tree import leaves, leaves_with_path  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
sys.path.insert(0, str(ROOT / "examples"))
import torch_elastic_restart as elastic  # noqa: E402
import torch_mesh_ranks as ranks  # noqa: E402

MESHES = ["1x2", "2x1"]
ARCHS = list(ranks.LM_ARCHS)
REL = 1e-5              # the mesh contract: loss, logits, the tie gap
# rwkv6's WKV state carries each call's rounding into the next (a batch
# row split over two ranks runs its matmuls at other shapes): after the
# first call its served logits part from one rank's by up to 1.7e-5 of
# max|logits| (its two-rank gradients part by as much)
REL_CARRIED = {"rwkv6-1.6b": 1e-4}
LR = t_adamw.AdamWConfig().lr
RANK_TIMEOUT_S = 420


def _j_by_key(tree):
    """{key path joined by "__": numpy} of a JAX tree."""
    return {"__".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path): np.asarray(v)
            for path, v in jtu.tree_flatten_with_path(tree)[0]}


def _t_by_key(tree):
    return {"__".join(map(str, path)): v.numpy()
            for path, v in leaves_with_path(tree)}


def _jax_refs(arch, params):
    """The JAX package's three train steps (jitted) on the ``lm_entry``
    batches and its engine over the ``lm_entry`` requests (every call's
    logits), and the port's one-rank engine and prefill logits, all on
    ``params``."""
    cfg = j_registry.get_config(arch, reduced=True)
    tcfg = t_registry.get_config(arch, reduced=True)
    d = ranks.entry_data(tcfg)
    pipe = JPipeline(JData(vocab=d.vocab, seq_len=d.seq_len,
                           global_batch=d.global_batch, seed=d.seed))
    step = jax.jit(j_make_step(cfg, j_adamw.AdamWConfig()))
    p, opt, losses = params, j_adamw.init_opt_state(params), []
    for _ in range(ranks.ENTRY_STEPS):
        p, opt, m = step(p, opt, {k: jnp.asarray(v) for k, v in
                                  pipe.next_batch().items()})
        losses.append(float(m["loss"]))
    out = {"losses": losses, "params": _j_by_key(p)}
    j_eng = j_engine.BatchEngine(cfg, params, batch=ranks.ENTRY_BATCH,
                                 max_len=ranks.ENTRY_MAX_LEN,
                                 cache_dtype=jnp.float32)
    j_calls, j_step = [], j_eng.decode

    def decode(*args):
        res = j_step(*args)
        j_calls.append(np.asarray(res[1]))
        return res
    j_eng.decode = decode
    reqs = [j_engine.Request(rid=i, prompt=pr, max_new_tokens=n)
            for i, (pr, (_, n)) in enumerate(zip(ranks.entry_prompts(tcfg),
                                                 ranks.ENTRY_SPECS))]
    for r in reqs:
        j_eng.submit(r)
    j_eng.run()
    out["served"], out["served_logits"] = [r.output for r in reqs], j_calls
    tparams = params_from_jax(params, "cpu")
    t_calls = []
    eng = ranks._recorded(t_engine.BatchEngine(
        tcfg, tparams, batch=ranks.ENTRY_BATCH, max_len=ranks.ENTRY_MAX_LEN,
        cache_dtype=torch.float32, device="cpu"), t_calls)
    ranks.serve_entry(eng, tcfg)
    out["one_rank_logits"] = t_calls
    cache = t_api.init_cache(tcfg, ranks.ENTRY_BATCH, ranks.ENTRY_MAX_LEN,
                             dtype=torch.float32, device="cpu")
    toks = ranks.lm_batch(tcfg)["tokens"][:, :ranks.ENTRY_PREFILL]
    out["prefill"] = make_prefill_step(tcfg)(tparams, {"tokens": toks},
                                             cache)[1].numpy()
    return out


@pytest.fixture(scope="module")
def entry(tmp_path_factory):
    """(the run's directory, the JAX weights, the references, each rank's
    results).  The ranks run while the references are computed here."""
    d = tmp_path_factory.mktemp("mesh_lm")
    weights = {}
    for arch in ARCHS:
        cfg = j_registry.get_config(arch, reduced=True)
        p = j_api.init_params(cfg, jax.random.PRNGKey(0),
                              dtype_policy=JPolicy.fp32())
        j_ckpt.save_checkpoint(str(d / f"jax0_{arch}"), 0,
                               {"params": p, "opt": j_adamw.init_opt_state(p)},
                               extra={"data": {"step": 0}})
        weights[arch] = p
    with open(d / "ranks.log", "w") as log:
        proc = subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "torch_mesh_ranks.py"),
             "2", str(d), "collectives,lm_entry"], stdout=log,
            stderr=subprocess.STDOUT,
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        try:
            refs = {arch: _jax_refs(arch, weights[arch]) for arch in ARCHS}
            rc = proc.wait(timeout=RANK_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert rc == 0, (d / "ranks.log").read_text()[-3000:]
    got = [dict(np.load(d / f"rank{r}.npz")) for r in (0, 1)]
    return d, weights, refs, got


# -- Trainer(mesh=) -----------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_trainer_matches_the_jax_train_step(entry, mesh, arch):
    _, _, refs, got = entry
    tag = f"{mesh}_{arch}"
    want = refs[arch]
    losses = got[0][f"losses_{tag}"]
    assert len(losses) == ranks.ENTRY_STEPS
    for a, b in zip(losses, want["losses"]):
        assert abs(a - b) <= REL * abs(b), (tag, a, b)
    prefix = f"final_{tag}/params__"
    new = {k[len(prefix):]: v for k, v in got[0].items()
           if k.startswith(prefix)}
    assert sorted(new) == sorted(want["params"])
    for k, w in want["params"].items():
        err = np.abs(new[k] - w).max()
        assert err <= 2 * LR, (tag, k, err)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_restart_is_bitwise_the_uninterrupted_run(entry, mesh, arch):
    _, _, _, got = entry
    tag = f"{mesh}_{arch}"
    assert all(bool(g[f"restart_{tag}"]) for g in got)
    assert got[0][f"restart_losses_{tag}"].tolist() == \
        got[0][f"losses_{tag}"][-1:].tolist()


def test_rank_zero_alone_keeps_the_history(entry):
    _, _, _, got = entry
    for mesh in MESHES:
        for arch in ARCHS:
            assert len(got[0][f"losses_{mesh}_{arch}"]) == ranks.ENTRY_STEPS
            assert len(got[1][f"losses_{mesh}_{arch}"]) == 0


# -- the survivor's restart on a re-planned mesh -----------------------------

SURVIVOR_FROM = ranks.ENTRY_STEPS - 1   # the mesh run's step-2 checkpoint
# the dense, hybrid-SSM and RWKV families (qwen2-moe's restore and step
# alone took 8-10 s a case in the tier-1 run)
SURVIVOR_ARCHS = ["qwen3-4b", "zamba2-1.2b", "rwkv6-1.6b"]
TOL_MU = 1e-4           # the first moment's error, of each leaf's max|mu|


@pytest.mark.parametrize("arch", SURVIVOR_ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_survivor_restores_the_mesh_checkpoint_on_a_replanned_mesh(
        entry, mesh, arch, tmp_path):
    """One rank survives the two: ``examples/torch_elastic_restart.py``'s
    plan for it (a 1x1 mesh, the batch of 2 as two microbatches of 1) and
    its ``restart_trainer`` on that mesh restore the two-rank run's step-2
    checkpoint and run step 3.  The loss within 1e-5·|loss| of the mesh
    run's step 3, every new parameter within ``1e-6 + 1e-5·|p| +
    2·lr·dg/(|g| + eps)`` of the mesh run's (g the mesh run's clipped
    gradient, |mu| / (1 - b1), dg 1e-4 of its leaf's max), the step
    counter 3."""
    import torch.distributed as dist
    from repro_torch.tree import leaves_with_path as paths
    d, _, _, got = entry
    tag = f"{mesh}_{arch}"
    cfg = t_registry.get_config(arch, reduced=True)
    data = ranks.entry_data(cfg)
    plan = elastic.replan(available=1, model_parallel=1,
                     global_batch=data.global_batch, max_per_device_batch=1)
    assert (plan.mesh_shape, plan.grad_accum) == ((1, 1), 2)
    step_dir = f"step_{SURVIVOR_FROM:09d}"
    shutil.copytree(d / f"whole_{tag}" / step_dir, tmp_path / step_dir)
    adam = t_adamw.AdamWConfig()
    try:
        tr = elastic.restart_trainer(plan, cfg, data, adam, str(tmp_path),
                                     "cpu", total_steps=ranks.ENTRY_STEPS,
                                     ckpt_every=1, log_every=1, mesh=True)
        assert tr.mesh.shape == {"data": 1, "model": 1}
        p, o = tr.run()
    finally:
        dist.destroy_process_group()
    assert [h["step"] for h in tr.history] == [ranks.ENTRY_STEPS]
    want = float(got[0][f"losses_{tag}"][-1])
    assert abs(tr.history[0]["loss"] - want) <= REL * abs(want), \
        (tag, tr.history[0]["loss"], want)
    assert int(o["step"]) == ranks.ENTRY_STEPS
    final = f"final_{tag}/"
    for path, leaf in paths({"params": p}):
        key = "__".join(map(str, path))
        ref = got[0][final + key]
        mu = np.abs(got[0][final + "opt__mu__" + key.split("__", 1)[1]])
        g = mu / (1 - adam.b1)
        dg = TOL_MU * max(float(mu.max()), 1e-30) / (1 - adam.b1)
        tol = 1e-6 + 1e-5 * np.abs(ref) + 2 * adam.lr * dg / (g + adam.eps)
        err = np.abs(leaf.numpy() - ref)
        assert leaf.dtype == torch.float32 and (err <= tol).all(), \
            (tag, key, float((err / tol).max()))


# -- checkpoints of DTensor trees ---------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_checkpoint_restores_on_one_rank_and_in_jax(entry, mesh, arch,
                                                         tmp_path):
    """The mesh run's step-3 checkpoint: restored by one rank (no mesh)
    and by the JAX package bitwise the tree the ranks gathered, and its
    files byte for byte those of a one-rank save of that tree."""
    d, weights, _, got = entry
    tag = f"{mesh}_{arch}"
    ckpt = d / f"whole_{tag}"
    assert t_ckpt.latest_step(str(ckpt)) == ranks.ENTRY_STEPS
    final = {k.split("/", 1)[1]: v for k, v in got[0].items()
             if k.startswith(f"final_{tag}/")}
    tparams = params_from_jax(weights[arch], "cpu")
    like = {"params": tparams, "opt": t_adamw.init_opt_state(tparams)}
    tree, step, extra = t_ckpt.restore_checkpoint(str(ckpt), like)
    assert step == ranks.ENTRY_STEPS
    restored = _t_by_key(tree)
    assert sorted(restored) == sorted(final)
    for k, v in final.items():
        assert restored[k].dtype == v.dtype and np.array_equal(
            restored[k], v), k
    jlike = {"params": weights[arch],
             "opt": j_adamw.init_opt_state(weights[arch])}
    jtree, jstep, jextra = j_ckpt.restore_checkpoint(str(ckpt), jlike)
    assert jstep == step and jextra == extra
    for k, v in _j_by_key(jtree).items():
        assert np.array_equal(v, final[k]), k
    t_ckpt.save_checkpoint(str(tmp_path), step, tree, extra=extra)
    mine = ckpt / f"step_{step:09d}"
    one = tmp_path / f"step_{step:09d}"
    files = sorted(p.relative_to(one) for p in one.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(mine) for p in mine.rglob("*")
                           if p.is_file())
    for f in files:
        assert (one / f).read_bytes() == (mine / f).read_bytes(), f


@pytest.mark.parametrize("mesh", MESHES)
def test_rank_zero_alone_writes_a_mesh_checkpoint(entry, mesh):
    """Each rank saved a DTensor to a directory of its own: only rank 0's
    exists."""
    d, _, _, got = entry
    assert bool(got[0][f"solo_{mesh}"]) and not bool(got[1][f"solo_{mesh}"])
    assert (d / f"solo_{mesh}_r0").exists()
    assert not (d / f"solo_{mesh}_r1").exists()
    x, step, _ = t_ckpt.restore_checkpoint(str(d / f"solo_{mesh}_r0"),
                                           {"x": torch.zeros(8)})
    assert step == 7 and torch.equal(x["x"], torch.arange(8.0))


# -- BatchEngine(mesh=) and the prefill step ---------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_engine_serves_the_jax_engines_tokens(entry, mesh, arch):
    """Every decode call's logits within REL·max|logits| of the port's
    one-rank engine's (``REL_CARRIED`` after the first call for a family
    whose recurrent state carries rounding), and the served tokens the
    JAX engine's: a token may differ only where the JAX engine's top-2
    logits at that call are within 2·REL·max|logits| (a near-tie), and
    no call is compared after it."""
    _, _, refs, got = entry
    tag = f"{mesh}_{arch}"
    want = refs[arch]
    calls = got[0][f"served_logits_{tag}"]
    assert np.array_equal(calls, got[1][f"served_logits_{tag}"])
    assert str(got[0][f"decode_mode_{tag}"]) == "eager"
    served = [got[0][f"served_{tag}_{i}"].tolist()
              for i in range(len(ranks.ENTRY_SPECS))]
    assert [len(s) for s in served] == [n for _, n in ranks.ENTRY_SPECS]
    assert len(calls) == len(want["one_rank_logits"]) == \
        len(want["served_logits"])
    for i, (a, b, j) in enumerate(zip(calls, want["one_rank_logits"],
                                      want["served_logits"])):
        parted = np.nonzero(a.argmax(-1) != j.argmax(-1))[0]
        for r in parted:
            top2 = np.sort(j[r])[-2:]
            assert top2[1] - top2[0] <= 2 * REL * np.abs(j).max(), \
                (tag, i, r, top2)
        if len(parted):
            return
        rel = REL if i == 0 else REL_CARRIED.get(arch, REL)
        assert np.abs(a - b).max() <= rel * np.abs(b).max(), (tag, i)
    assert served == want["served"], tag


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_prefill_step_matches_one_rank(entry, mesh, arch):
    _, _, refs, got = entry
    tag = f"{mesh}_{arch}"
    want = refs[arch]["prefill"]
    for g in got:
        assert g[f"prefill_{tag}"].shape == want.shape
        assert np.abs(g[f"prefill_{tag}"] - want).max() <= \
            REL * np.abs(want).max(), tag


# -- the staged process group for ranks that share a card ---------------------

def _collectives_want(rank):
    """What each collective of the ``collectives`` case gives rank
    ``rank``: from the two ranks' operands, in numpy."""
    x = [ranks.collective_input(r).numpy() for r in (0, 1)]
    total = x[0] + x[1]
    return {"sum": total, "avg": total / 2, "max": np.maximum(*x),
            "sum_bf16": total, "gather": np.concatenate(x),
            "scatter": total[4 * rank:4 * rank + 4], "bcast": x[1],
            "a2a": np.concatenate([x[0][4 * rank:4 * rank + 4],
                                   x[1][4 * rank:4 * rank + 4]])}


@pytest.mark.parametrize("rank", [0, 1])
def test_staged_group_collectives_on_host_tensors(entry, rank):
    """``distributed/hostgloo.py``'s group (the one ranks that share a
    card join) on host tensors: every collective the sharded steps and
    the checkpoints run, exact."""
    _, _, _, got = entry
    for name, want in _collectives_want(rank).items():
        np.testing.assert_array_equal(got[rank][f"coll_{name}"], want,
                                      err_msg=name)


@pytest.mark.parametrize("rank", [0, 1])
def test_staged_group_counts_a_collective_once(entry, rank):
    """``HostGlooGroup.stats``: a collective that runs another inside (the
    list form of reduce-scatter runs the tensor form) counts once, under
    its own name, and gives the tensor form's result."""
    _, _, _, got = entry
    np.testing.assert_array_equal(got[rank]["coll_counted"], [1, 1, 0])
    np.testing.assert_array_equal(got[rank]["coll_scatter_list"],
                                  _collectives_want(rank)["scatter"])


@pytest.mark.cuda
def test_staged_group_collectives_on_the_card(tmp_path):
    """The same collectives on two ranks of one card, through the CUDA
    IPC buffers (the first under inference mode, so the buffers it makes
    must take the later writes outside it), each counted once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the operands cross through CUDA "
                    "IPC buffers on the card")
    out = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_mesh_ranks.py"), "2",
         str(tmp_path), "card_collectives"], capture_output=True, text=True,
        timeout=RANK_TIMEOUT_S, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr[-3000:]
    for rank in (0, 1):
        got = np.load(tmp_path / f"rank{rank}.npz")
        for name, want in _collectives_want(rank).items():
            np.testing.assert_array_equal(got[f"coll_{name}"], want,
                                          err_msg=name)
        np.testing.assert_array_equal(got["coll_counted"], [1, 1, 0])


# -- the launchers, the plain tensor ------------------------------------------

@pytest.mark.parametrize("mesh", MESHES)
def test_both_launchers_run_on_the_mesh(entry, mesh):
    _, _, _, got = entry
    assert np.isfinite(got[0][f"train_launcher_{mesh}"])
    assert np.isnan(got[1][f"train_launcher_{mesh}"])   # no history there
    for g in got:
        assert g[f"serve_launcher_{mesh}"].tolist() == [3, 0, 9, 1]


@pytest.mark.parametrize("mesh", MESHES)
def test_a_sigterm_on_one_rank_stops_every_rank_after_the_same_step(
        entry, mesh):
    """Rank 1 alone got SIGTERM before its first step: both ranks stop
    after step 1 (the guard's flag is reduced over the ranks), and the
    checkpoint of that step is the newest."""
    _, _, _, got = entry
    assert got[0][f"preempt_{mesh}"].tolist() == [1, 1]
    assert got[1][f"preempt_{mesh}"].tolist() == [1, 0]


@pytest.mark.parametrize("mesh", MESHES)
def test_a_plain_tensor_under_two_ranks_raises(entry, mesh):
    _, _, _, got = entry
    assert all(bool(g[f"plain_raises_{mesh}"]) for g in got)


def test_train_launcher_under_torchrun():
    """``torchrun`` starts two ranks; ``--mesh 2x1`` joins its group
    through the ``env://`` variables and rank 0 alone prints the
    summary."""
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", "qwen3-4b", "--device", "cpu", "--steps", "2",
         "--batch", "2", "--seq", "16", "--mesh", "2x1"],
        capture_output=True, text=True, timeout=240, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(ln) for ln in out.stdout.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1
    assert lines[0]["mesh"] == {"data": 2, "model": 1}
    assert lines[0]["steps_logged"] == [1]       # the first, then every 10th
    assert np.isfinite(lines[0]["last_loss"])


# -- in this process: no mesh, one rank, the layouts --------------------------

@pytest.fixture
def one_rank_mesh():
    """A 1x1 mesh over a one-rank gloo group of this process, ended
    after the test."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(1, 1, device="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def _trainer(mesh):
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = t_registry.get_config("zamba2-1.2b", reduced=True)
    return Trainer(cfg, TrainerConfig(total_steps=2, log_every=1),
                   data_cfg=ranks.entry_data(cfg), device="cpu", mesh=mesh)


def test_trainer_on_one_rank_is_bitwise_the_mesh_less_one(one_rank_mesh):
    plain = _trainer(None)
    want = plain.run()
    one = _trainer(one_rank_mesh)
    got = one.run()
    assert [h["loss"] for h in one.history] == \
        [h["loss"] for h in plain.history]
    for a, b in zip(leaves(got), leaves(want)):
        assert type(a) is torch.Tensor and a.dtype == b.dtype
        assert torch.equal(a, b)


def test_engine_on_one_rank_is_bitwise_the_mesh_less_one(one_rank_mesh):
    cfg = t_registry.get_config("zamba2-1.2b", reduced=True)
    params = t_api.init_params(cfg, torch.Generator().manual_seed(3),
                               device="cpu")
    outs, calls = {}, {}
    for name, mesh in (("none", None), ("1x1", one_rank_mesh)):
        calls[name] = []
        eng = t_engine.BatchEngine(cfg, params, batch=2, max_len=16,
                                   device="cpu", mesh=mesh)
        assert not eng.sharded and eng.decode_mode == "eager"
        assert isinstance(eng.decode, t_engine.CapturedDecode)
        outs[name] = ranks.serve_entry(ranks._recorded(eng, calls[name]),
                                       cfg)
    assert outs["1x1"] == outs["none"]
    assert len(calls["1x1"]) == len(calls["none"])
    for a, b in zip(calls["1x1"], calls["none"]):
        assert np.array_equal(a, b)


def test_token_serving_summary_names_the_mesh_and_the_decode_mode():
    d = t_engine.token_serving_summary("qwen3-4b", batch=2, max_len=16,
                                       prompt_len=3, new_tokens=3,
                                       requests=3, device="cpu", fp32=True,
                                       record_logits=True)
    assert d["mesh"] is None and d["decode"] == "eager"
    assert d["requests_done"] == 3 and d["requests_lost"] == 0
    assert len(d["step_logits"]) == d["prefill_calls"] + d["decode_steps"]
    assert all(a.dtype == np.float32 for a in d["step_logits"])


@pytest.mark.parametrize("batch,seq_kv,shard_batch", [(4, False, True),
                                                      (3, True, False)])
def test_step_layout_picks_the_batch_or_the_cache_sequence(batch, seq_kv,
                                                           shard_batch):
    """A decode step splits its batch over the data axis where the batch
    divides by it, else its cache's sequence; the train step never splits
    a sequence, and donates its parameters and optimizer state."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.specs import step_layout
    cfg = t_registry.get_config("qwen3-4b", reduced=True)
    mesh = Mesh({"data": 2, "model": 2})
    lay = step_layout(cfg, "decode", mesh, batch)
    assert (lay.seq_shard_kv, lay.shard_batch) == (seq_kv, shard_batch)
    assert lay.donate == (2,) and len(lay.shardings) == 4
    k = tuple(lay.shardings[2]["k"].spec)
    assert (k[1] is not None, k[2] is not None) == (shard_batch, seq_kv)
    assert tuple(lay.shardings[1].spec) == (k[1],)     # the token
    train = step_layout(cfg, "train", mesh, batch)
    assert not train.seq_shard_kv and train.donate == (0, 1)
    assert set(train.shardings[1]) == {"step", "mu", "nu", "master"}
    with pytest.raises(ValueError, match="step kind"):
        step_layout(cfg, "eval", mesh, batch)
