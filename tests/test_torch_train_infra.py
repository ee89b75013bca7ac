"""The port's training infrastructure against the JAX package's: the
counterparts of ``tests/test_infra.py:18-130`` (AdamW math, clipping, the
warm-up cosine, checkpoint round trip / torn / keep, data determinism,
resume, ranks, labels); checkpoints crossing between the packages both
ways bit for bit; ``TokenPipeline`` batches bitwise the JAX package's
(synthetic, memmap, the VLM and audio stubs, ranks, a restored cursor);
the schedules, the int8 gradient round trip and error feedback, and
``evaluate`` against the JAX package's; ``Trainer``'s restart bitwise an
uninterrupted run on the CPU; the launcher and the example."""
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro_torch.ckpt.checkpoint import (latest_step,  # noqa: E402
                                         restore_checkpoint, save_checkpoint)
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.optim.adamw import (AdamWConfig, adamw_update,  # noqa: E402
                                     global_norm, init_opt_state)
from repro_torch.tree import leaves  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's small CPU ops while a test runs:
    under ``-n 6`` every worker's default thread pool would oversubscribe
    the cores (the thread count is put back after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# optimizer
# --------------------------------------------------------------------------

def test_adamw_matches_reference_math():
    cfg = AdamWConfig(lr=0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0,
                      grad_clip=0.0)
    p = {"w": torch.tensor([1.0, -2.0])}
    g = {"w": torch.tensor([0.5, 0.25])}
    newp, news, m = adamw_update(p, g, init_opt_state(p), cfg)
    mu = 0.1 * np.asarray([0.5, 0.25])
    nu = 0.01 * np.asarray([0.25, 0.0625])
    want = np.asarray([1.0, -2.0]) - 0.1 * (mu / (1 - 0.9)) / (
        np.sqrt(nu / (1 - 0.99)) + 1e-8)
    np.testing.assert_allclose(newp["w"].numpy(), want, rtol=1e-6)
    assert int(news["step"]) == 1 and news["step"].dtype == torch.int32
    assert float(m["grad_norm"]) == pytest.approx(float(np.hypot(0.5, 0.25)))


def test_grad_clip_caps_update():
    p = {"w": torch.ones(4)}
    g = {"w": torch.full((4,), 100.0)}
    _, news, m = adamw_update(p, g, init_opt_state(p),
                              AdamWConfig(grad_clip=1.0, weight_decay=0.0))
    assert float(m["grad_norm"]) == pytest.approx(200.0)
    assert float(global_norm(g)) == pytest.approx(200.0)
    # clipped first moment: |mu| <= (1-b1) * the clipped grad
    assert float(news["mu"]["w"].abs().max()) <= 0.1 * 0.5 + 1e-6


def test_opt_state_layout():
    p = {"a": torch.ones(3, dtype=torch.bfloat16), "b": {"c": torch.ones(2)}}
    s = init_opt_state(p)
    assert sorted(s) == ["master", "mu", "nu", "step"]
    assert s["step"].shape == () and s["step"].dtype == torch.int32
    for tree in (s["mu"], s["nu"], s["master"]):
        assert all(t.dtype == torch.float32 for t in leaves(tree))
    new, _, _ = adamw_update(p, {"a": torch.ones(3, dtype=torch.bfloat16),
                                 "b": {"c": torch.ones(2)}}, s,
                             AdamWConfig())
    assert new["a"].dtype == torch.bfloat16
    assert not new["a"].requires_grad


def test_warmup_cosine_shape():
    from repro_torch.optim.schedules import warmup_cosine
    f = warmup_cosine(1.0, 10, 100)
    assert float(f(torch.tensor(0))) == 0.0
    assert float(f(torch.tensor(10))) == pytest.approx(1.0)
    assert float(f(torch.tensor(100))) == pytest.approx(0.1, abs=1e-3)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 57, 100, 140])
def test_schedules_match_reference(step):
    from repro.optim import schedules as j_sched
    from repro_torch.optim import schedules as t_sched
    for tf, jf in ((t_sched.warmup_cosine(3e-4, 10, 100),
                    j_sched.warmup_cosine(3e-4, 10, 100)),
                   (t_sched.warmup_cosine(1.0, 0, 50, 0.0),
                    j_sched.warmup_cosine(1.0, 0, 50, 0.0)),
                   (t_sched.constant(0.5), j_sched.constant(0.5))):
        got = tf(torch.tensor(step, dtype=torch.int32))
        want = jf(jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(float(want), rel=1e-6, abs=1e-12)


# --------------------------------------------------------------------------
# gradient compression
# --------------------------------------------------------------------------

def test_int8_roundtrip_and_error_feedback_match_reference():
    from repro.distributed import compression as jc
    from repro_torch.distributed import compression as tc
    rng = np.random.default_rng(3)
    g = {"a": rng.standard_normal((5, 7)).astype(np.float32),
         "b": (rng.standard_normal(9) * 1e-3).astype(np.float32)}
    jg = jax.tree.map(jnp.asarray, g)
    tg = params_from_jax(g, "cpu")
    got, want = tc.int8_roundtrip(tg), jc.int8_roundtrip(jg)
    for k in g:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    te, je = tc.ErrorFeedback.init(tg), jc.ErrorFeedback.init(jg)
    for _ in range(2):
        tgh, te = tc.ErrorFeedback.apply(tg, te)
        jgh, je = jc.ErrorFeedback.apply(jg, je)
        for k in g:
            np.testing.assert_allclose(tgh[k].numpy(), np.asarray(jgh[k]),
                                       rtol=0, atol=1e-7)
            np.testing.assert_allclose(te[k].numpy(), np.asarray(je[k]),
                                       rtol=0, atol=1e-7)


# --------------------------------------------------------------------------
# checkpoint
# --------------------------------------------------------------------------

def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": (torch.arange(3) * 0.37).to(torch.bfloat16),
                  "d": torch.tensor(7, dtype=torch.int32)},
            "e": [torch.ones(2), torch.full((1,), -3.5)]}


def test_checkpoint_roundtrip_bitwise(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 5, tree, extra={"data": {"step": 5}})
    got, step, extra = restore_checkpoint(str(tmp_path), tree)
    assert step == 5 and extra == {"data": {"step": 5}}
    for a, b in zip(leaves(tree), leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    meta = json.loads((tmp_path / "step_000000005" / "meta.json")
                      .read_text())
    assert meta["bf16_keys"] == ["b__c"]
    names = sorted(p.name for p in (tmp_path / "step_000000005" / "arrays")
                   .iterdir())
    assert names == ["a.npy", "b__c.npy", "b__d.npy", "e__0.npy",
                     "e__1.npy"]


def test_torn_checkpoint_ignored(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"a": torch.ones(2)})
    torn = tmp_path / "step_000000002"
    (torn / "arrays").mkdir(parents=True)
    (torn / "meta.json").write_text(json.dumps({"step": 2}))
    assert latest_step(str(tmp_path)) == 1
    with pytest.raises(FileNotFoundError, match="torn"):
        restore_checkpoint(str(tmp_path), {"a": torch.ones(2)}, step=2)


def test_checkpoint_keep_policy(tmp_path):
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(str(tmp_path), s, {"a": torch.ones(2)}, keep=2)
    steps = sorted(p.name for p in tmp_path.glob("step_*"))
    assert len(steps) == 2 and latest_step(str(tmp_path)) == 5


def _model_state():
    """A reduced zamba2 parameter tree (bf16) and its optimizer state, as
    the JAX package makes them."""
    from repro.configs.registry import get_config
    from repro.models import api
    from repro.optim.adamw import init_opt_state as j_init
    cfg = get_config("zamba2-1.2b", reduced=True)
    params = api.init_params(cfg, jax.random.PRNGKey(0))
    return {"params": params, "opt": j_init(params)}


def test_checkpoint_from_reference_restores_bitwise(tmp_path):
    from repro.ckpt.checkpoint import save_checkpoint as j_save
    jtree = _model_state()
    j_save(str(tmp_path), 3, jtree, extra={"data": {"step": 3}})
    like = params_from_jax(jtree, "cpu")
    got, step, extra = restore_checkpoint(str(tmp_path), like)
    assert step == 3 and extra == {"data": {"step": 3}}
    jl = jax.tree.leaves(jtree)
    tl = leaves(got)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
            else t.numpy(),
            np.asarray(j).view(np.int16) if j.dtype == jnp.bfloat16
            else np.asarray(j))


def test_checkpoint_to_reference_restores_bitwise(tmp_path):
    from repro.ckpt.checkpoint import restore_checkpoint as j_restore
    jtree = _model_state()
    tree = params_from_jax(jtree, "cpu")
    save_checkpoint(str(tmp_path), 4, tree, extra={"data": {"step": 4}})
    got, step, extra = j_restore(str(tmp_path), jtree)
    assert step == 4 and extra == {"data": {"step": 4}}
    for j, t in zip(jax.tree.leaves(got), leaves(tree)):
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
        np.testing.assert_array_equal(
            np.asarray(j).view(np.int16) if j.dtype == jnp.bfloat16
            else np.asarray(j),
            t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
            else t.numpy())


# --------------------------------------------------------------------------
# data pipeline
# --------------------------------------------------------------------------

def test_data_determinism_and_resume():
    cfg = DataConfig(vocab=101, seq_len=16, global_batch=4, seed=7)
    p1 = TokenPipeline(cfg)
    seq = [p1.next_batch() for _ in range(3)]
    p2 = TokenPipeline(cfg)
    p2.restore({"step": 2})
    b2 = p2.next_batch()
    np.testing.assert_array_equal(seq[2]["tokens"], b2["tokens"])
    np.testing.assert_array_equal(seq[2]["labels"], b2["labels"])
    assert p2.state() == {"step": 3}


def test_data_dp_ranks_differ():
    a = TokenPipeline(DataConfig(vocab=50, seq_len=8, global_batch=8,
                                 dp_rank=0, dp_size=2)).next_batch()
    b = TokenPipeline(DataConfig(vocab=50, seq_len=8, global_batch=8,
                                 dp_rank=1, dp_size=2)).next_batch()
    assert a["tokens"].shape == (4, 8)
    assert not np.array_equal(a["tokens"], b["tokens"])


def test_labels_are_next_tokens():
    b = TokenPipeline(DataConfig(vocab=64, seq_len=12, global_batch=2)
                      ).next_batch()
    match = (b["labels"] == (b["tokens"] * 31 + 7) % 64).mean()
    assert match > 0.7


@pytest.mark.parametrize("kw", [
    dict(vocab=101, seq_len=16, global_batch=4, seed=7),
    dict(vocab=50, seq_len=8, global_batch=8, dp_rank=1, dp_size=2),
    dict(vocab=64, seq_len=12, global_batch=2, frontend="vlm",
         frontend_len=5, d_model=8),
    dict(vocab=64, seq_len=12, global_batch=2, frontend="audio",
         d_model=8),
    dict(vocab=500, seq_len=9, global_batch=3, source="memmap")],
    ids=["synthetic", "rank1", "vlm", "audio", "memmap"])
def test_pipeline_batches_are_the_reference_bitwise(kw, tmp_path):
    from repro.data.pipeline import DataConfig as JConfig
    from repro.data.pipeline import TokenPipeline as JPipe
    if kw.get("source") == "memmap":
        path = tmp_path / "tokens.bin"
        np.random.default_rng(1).integers(0, 500, 1000).astype(
            np.uint16).tofile(path)
        kw = dict(kw, memmap_path=str(path))
    got, want = TokenPipeline(DataConfig(**kw)), JPipe(JConfig(**kw))
    want.restore({"step": 2})
    got.restore({"step": 2})
    for _ in range(3):
        g, w = got.next_batch(), want.next_batch()
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    assert got.state() == want.state()


# --------------------------------------------------------------------------
# evaluation
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-4b", "internvl2-26b",
                                  "seamless-m4t-medium"])
def test_evaluate_matches_reference(arch):
    from repro.configs.registry import get_config
    from repro.models import api
    from repro.models.common import DTypePolicy
    from repro.train.evaluate import evaluate as j_eval
    from repro_torch.configs.registry import get_config as t_get
    from repro_torch.train.evaluate import evaluate as t_eval
    cfg = get_config(arch, reduced=True)
    params = api.init_params(cfg, jax.random.PRNGKey(0),
                             dtype_policy=DTypePolicy.fp32())
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=8, global_batch=2, seed=11,
                      frontend=cfg.frontend, frontend_len=cfg.frontend_len,
                      d_model=cfg.d_model)
    batches = []
    for b in [TokenPipeline(dcfg).next_batch() for _ in range(2)]:
        b["labels"][1, -2:] = -1
        if cfg.is_encdec:
            b["src_embeds"] = np.ones((2, 8, cfg.d_model), np.float32)
        batches.append(b)
    got = t_eval(params_from_jax(params, "cpu"), t_get(arch, reduced=True),
                 iter(batches))
    want = j_eval(params, cfg, iter(batches))
    assert got["tokens"] == want["tokens"] == 28.0     # 32 less 4 masked
    assert got["token_acc"] == pytest.approx(want["token_acc"], abs=1e-9)
    for k in ("nll", "ppl"):
        assert got[k] == pytest.approx(want[k], rel=1e-5)


# --------------------------------------------------------------------------
# the trainer, the launcher, the example
# --------------------------------------------------------------------------

def _trainer(total, ckpt_dir=None, ckpt_every=50):
    from repro_torch.configs.registry import get_config
    from repro_torch.optim.schedules import warmup_cosine
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = get_config("zamba2-1.2b", reduced=True)
    data = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2, seed=3)
    opt = AdamWConfig(lr=1e-3, schedule=warmup_cosine(1e-3, 2, 6))
    return Trainer(cfg, TrainerConfig(total_steps=total, ckpt_dir=ckpt_dir,
                                      ckpt_every=ckpt_every, log_every=1),
                   opt_cfg=opt, data_cfg=data, device="cpu")


def test_trainer_restart_is_bitwise_an_uninterrupted_run(tmp_path):
    """Save at step 3, a new Trainer restores and runs to step 6: the
    parameters, the optimizer state and every logged loss equal one
    uninterrupted 6-step run bitwise (bf16 parameters, fp32 state)."""
    whole = _trainer(6)
    p_ref, opt_ref = whole.run()
    first = _trainer(3, str(tmp_path), ckpt_every=3)
    first.run()
    assert latest_step(str(tmp_path)) == 3
    second = _trainer(6, str(tmp_path), ckpt_every=3)
    p, opt = second.run()
    assert latest_step(str(tmp_path)) == 6
    assert [h["loss"] for h in first.history + second.history] == \
        [h["loss"] for h in whole.history]
    for a, b in zip(leaves({"p": p, "o": opt}),
                    leaves({"p": p_ref, "o": opt_ref})):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(opt["step"]) == 6
    assert leaves(p)[0].dtype == torch.bfloat16


def test_train_launcher_on_the_cpu(capsys):
    from repro_torch.launch.train import main
    out = main(["--arch", "qwen3-4b", "--device", "cpu", "--steps", "11",
                "--batch", "2", "--seq", "16"])
    assert out["steps_logged"] == [1, 10]
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == out


def test_example_trains_and_survives_the_restart():
    res = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_train_lm.py"),
         "--arch", "qwen3-4b", "--device", "cpu", "--steps", "40",
         "--batch", "4", "--seq", "32"],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr[-2000:]
    assert "OK: loss fell and training survived the restart" in res.stdout
