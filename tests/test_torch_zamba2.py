"""The port's zamba2 LM slice against the JAX package's, on
``get_config("zamba2-1.2b", reduced=True)`` (4 Mamba2 layers, d 64, the
shared attention block twice) with the fp32 policy and the JAX weights
carried across: forward, prefill and decode logits, the prefill step's
token, the served tokens of ``BatchEngine``, the config registry and the
weight bridge; and the port on its own: the chunked Mamba2 mixer against
its step-by-step decode, decode against forward."""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import api as t_api  # noqa: E402
from repro_torch.models import ssm as t_ssm  # noqa: E402
from repro_torch.models import transformer as t_tr  # noqa: E402
from repro_torch.models.common import DTypePolicy, TreeMaker  # noqa: E402
from repro_torch.serve import engine as t_engine  # noqa: E402
from repro_torch.serve.steps import make_prefill_step  # noqa: E402

REL = 1e-5      # port vs JAX, fp32: the same math, sums in other orders
CFG = t_registry.get_config("zamba2-1.2b", reduced=True)


@pytest.fixture(scope="module")
def jx():
    """The JAX package and one set of fp32 weights for reduced zamba2,
    with the port's copy of them."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import registry
    from repro.models import api, transformer
    from repro.models.common import DTypePolicy as JPolicy
    from repro.serve import engine, steps
    cfg = registry.get_config("zamba2-1.2b", reduced=True)
    params = api.init_params(cfg, jax.random.PRNGKey(0),
                             dtype_policy=JPolicy.fp32())
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, registry=registry, api=api,
        transformer=transformer, engine=engine, steps=steps, JPolicy=JPolicy,
        cfg=cfg, params=params, tparams=params_from_jax(params, "cpu"))


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= REL * np.abs(want).max(), (what, err)


def _tokens(b, s, seed=1):
    return np.random.default_rng(seed).integers(0, CFG.vocab, (b, s),
                                                dtype=np.int32)


# --------------------------------------------------------------------------
# the registry and the weight bridge
# --------------------------------------------------------------------------

def test_registry_is_the_reference_registry(jx):
    assert t_registry.arch_names() == jx.registry.arch_names()
    for name in jx.registry.arch_names():
        for reduced in (False, True):
            want = jx.registry.get_config(name, reduced=reduced)
            got = t_registry.get_config(name, reduced=reduced)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert got.param_count() == want.param_count()
    full = t_registry.get_config("zamba2-1.2b")
    assert (full.padded_vocab, full.padded_heads, full.cache_kv_heads,
            full.param_count()) == (32768, 32, 32, 1_170_229_376)


@pytest.mark.parametrize("policy", ["bf16", "fp32"])
def test_bridge_carries_bf16_and_fp32_trees(jx, policy):
    dp = jx.JPolicy() if policy == "bf16" else jx.JPolicy.fp32()
    tree = jx.api.init_params(jx.cfg, jx.jax.random.PRNGKey(3),
                              dtype_policy=dp)
    got = params_from_jax(tree, "cpu")
    flat = jx.jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat) == len(jx.jax.tree_util.tree_leaves(got))
    for path, leaf in flat:
        t = got
        for key in path:
            t = t[key.key]
        want_dtype = (torch.bfloat16 if leaf.dtype == jx.jnp.bfloat16
                      else torch.float32)
        assert t.dtype == want_dtype and tuple(t.shape) == leaf.shape
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(leaf, np.float32))


# --------------------------------------------------------------------------
# forward, prefill and decode against the JAX package
# --------------------------------------------------------------------------

def test_forward_prefill_decode_match_reference(jx):
    b, s, k = 2, 10, 6
    tokens = _tokens(b, s)
    tt = torch.from_numpy(tokens).long()
    _close(t_tr.forward(jx.tparams, CFG, tt),
           jx.transformer.forward(jx.params, jx.cfg,
                                  jx.jnp.asarray(tokens))[0], "forward")
    j_cache = jx.api.init_cache(jx.cfg, b, s, dtype=jx.jnp.float32)
    t_cache = t_api.init_cache(CFG, b, s, dtype=torch.float32, device="cpu")
    j_tok, j_lp, j_cache = jx.steps.make_prefill_step(jx.cfg)(
        jx.params, {"tokens": jx.jnp.asarray(tokens[:, :k])}, j_cache)
    t_tok, t_lp, t_cache = make_prefill_step(CFG)(
        jx.tparams, {"tokens": tt[:, :k]}, t_cache)
    _close(t_lp, j_lp, "prefill logits")
    assert t_tok.tolist() == np.asarray(j_tok).tolist()
    for i in range(k, k + 4):
        j_lg, j_cache = jx.api.decode_step(jx.params, jx.cfg,
                                           jx.jnp.asarray(tokens[:, i]),
                                           j_cache, jx.jnp.int32(i))
        t_lg, t_cache = t_api.decode_step(jx.tparams, CFG, tt[:, i],
                                          t_cache, i)
        _close(t_lg, j_lg, f"decode step {i}")
    for part in ("mamba", "attn"):
        for name, leaf in j_cache[part].items():
            _close(t_cache[part][name], leaf, f"cache {part}/{name}")


# (arch, T new tokens, cache position or None for no cache, window):
# zamba2's GQA (4 heads, 2 kv) in the grouped-decode and expand branches,
# qwen3's qk-norm, qwen2.5's QKV bias, and a sliding window
ATTN_CASES = [("zamba2-1.2b", 8, None, 0), ("zamba2-1.2b", 6, 0, 0),
              ("zamba2-1.2b", 1, 5, 0), ("qwen3-4b", 6, 0, 0),
              ("qwen3-4b", 1, 7, 0), ("qwen2.5-14b", 8, None, 3),
              ("qwen2.5-14b", 1, 4, 3)]


@pytest.mark.parametrize("impl", ["naive", "blockwise"])
@pytest.mark.parametrize("arch,t,pos,window", ATTN_CASES)
def test_attention_matches_reference(jx, arch, t, pos, window, impl):
    from repro.models import attention as j_attn
    from repro.models.common import TreeMaker as JTreeMaker
    from repro.models.layers import rope_freqs
    from repro.models.settings import attn_impl as j_impl
    from repro_torch.models import attention as t_attn
    from repro_torch.models.layers import rope_freqs as t_rope
    from repro_torch.models.settings import attn_impl as t_impl
    cfg = jx.registry.get_config(arch, reduced=True)
    tcfg = t_registry.get_config(arch, reduced=True)
    p = j_attn.attn_params(JTreeMaker("init", key=jx.jax.random.PRNGKey(7),
                                      dtype_policy=jx.JPolicy.fp32()), cfg)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, t, cfg.d_model)).astype(np.float32)
    start = 0 if pos is None else pos
    positions = np.arange(start, start + t)
    kw, tkw = {}, {}
    if pos is not None:
        shape = (2, 12, cfg.cache_kv_heads, cfg.head_dim_)
        cache = {n: rng.standard_normal(shape).astype(np.float32)
                 for n in ("k", "v")}
        kw = dict(cache={n: jx.jnp.asarray(a) for n, a in cache.items()},
                  cache_pos=jx.jnp.int32(pos))
        tkw = dict(cache={n: torch.from_numpy(a) for n, a in cache.items()},
                   cache_pos=pos)
    with j_impl(impl):
        want, want_cache = j_attn.attention(
            p, cfg, jx.jnp.asarray(x), positions=jx.jnp.asarray(positions),
            inv_freq=rope_freqs(cfg.head_dim_, cfg.rope_theta),
            window=window, **kw)
    with t_impl(impl):
        got, got_cache = t_attn.attention(
            params_from_jax(p, "cpu"), tcfg, torch.from_numpy(x),
            positions=torch.from_numpy(positions),
            inv_freq=t_rope(tcfg.head_dim_, tcfg.rope_theta),
            window=window, **tkw)
    _close(got, want, "attention")
    if pos is not None:
        for n in ("k", "v"):
            _close(got_cache[n], want_cache[n], f"cache {n}")


def test_unported_families_raise():
    for name in ("rwkv6-1.6b", "granite-moe-1b-a400m", "internvl2-26b",
                 "seamless-m4t-medium"):
        cfg = t_registry.get_config(name, reduced=True)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            t_api.init_params(cfg, device="cpu")


# --------------------------------------------------------------------------
# the port on its own
# --------------------------------------------------------------------------

def test_mamba_chunked_equals_stepwise():
    """The chunked SSD mixer against its step-by-step decode
    (tests/test_moe_ssm.py's check, its tolerance)."""
    cfg = dataclasses.replace(CFG, d_model=32, ssm_state=8, ssm_head_dim=16)
    tm = TreeMaker(torch.Generator().manual_seed(0), "cpu",
                   DTypePolicy.fp32())
    p = t_ssm.mamba_params(tm, cfg)
    b, t = 2, 12
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (b, t, cfg.d_model)).astype(np.float32))
    y_full, hf, tail = t_ssm.mamba_block(p, cfg, x, chunk=4)
    cache = t_ssm.init_mamba_cache(cfg, b, dtype=torch.float32,
                                   device="cpu")
    outs = []
    for i in range(t):
        o, cache = t_ssm.mamba_decode(p, cfg, x[:, i:i + 1], cache)
        outs.append(o)
    np.testing.assert_allclose(y_full.numpy(), torch.cat(outs, 1).numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(hf.numpy(), cache["h"].numpy(), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(tail.numpy(), cache["conv"].numpy(),
                               rtol=2e-3, atol=2e-3)


def test_decode_matches_forward():
    """Prefill 6 tokens, then decode 6 more one at a time: the logits
    against the teacher-forced forward within 2e-3·max|logits|
    (tests/test_decode_consistency.py's bound)."""
    params = t_api.init_params(CFG, torch.Generator().manual_seed(0),
                               dtype_policy=DTypePolicy.fp32(), device="cpu")
    b, s, k = 2, 12, 6
    tokens = torch.from_numpy(_tokens(b, s)).long()
    logits_f = t_tr.forward(params, CFG, tokens)
    cache = t_api.init_cache(CFG, b, s, dtype=torch.float32, device="cpu")
    lp, cache = t_api.prefill(params, CFG, {"tokens": tokens[:, :k]}, cache)
    scale = logits_f.abs().max().item() + 1e-6
    errs = [(lp - logits_f[:, k - 1]).abs().max().item() / scale]
    for i in range(k, s):
        lg, cache = t_api.decode_step(params, CFG, tokens[:, i], cache, i)
        errs.append((lg - logits_f[:, i]).abs().max().item() / scale)
    assert max(errs) < 2e-3, errs


# --------------------------------------------------------------------------
# served tokens against the JAX BatchEngine
# --------------------------------------------------------------------------

def _recording(engine, to_np):
    """Wrap the engine instance's decode step to record every call's
    logits."""
    calls, step = [], engine.decode

    def decode(*args, **kwargs):
        out = step(*args, **kwargs)
        calls.append(to_np(out[1]))
        return out
    engine.decode = decode
    return calls


def test_batch_engine_serves_the_reference_tokens(jx):
    """Batch 2, 3 requests: the third refills a slot (keeping the previous
    request's recurrent state) while the other slot decodes on, and every
    prompt token is stepped through decode over the whole batch.  fp32
    weights and cache on both sides.  Any token that differs must sit on a
    near-tie of the reference's logits at that call, and every call before
    it must agree within REL·max|logits|."""
    rng = np.random.default_rng(5)
    specs = [(5, 4), (3, 6), (4, 3)]          # (prompt length, new tokens)
    prompts = [rng.integers(0, CFG.vocab, n, dtype=np.int32)
               for n, _ in specs]
    j_eng = jx.engine.BatchEngine(jx.cfg, jx.params, batch=2, max_len=16,
                                  cache_dtype=jx.jnp.float32)
    t_eng = t_engine.BatchEngine(CFG, jx.tparams, batch=2, max_len=16,
                                 cache_dtype=torch.float32, device="cpu")
    j_calls = _recording(j_eng, lambda a: np.asarray(a))
    t_calls = _recording(t_eng, lambda a: a.numpy())
    outs = {}
    for name, eng, mod in (("jax", j_eng, jx.engine),
                           ("port", t_eng, t_engine)):
        reqs = [mod.Request(rid=i, prompt=p, max_new_tokens=n)
                for i, (p, (_, n)) in enumerate(zip(prompts, specs))]
        for r in reqs:
            eng.submit(r)
        eng.run()
        assert all(r.done for r in reqs), name
        outs[name] = [r.output for r in reqs]
    if outs["port"] == outs["jax"]:
        assert len(t_calls) == len(j_calls)
        for i, (got, want) in enumerate(zip(t_calls, j_calls)):
            _close(got, want, f"decode call {i}")
        return
    # a token differs: find the first call whose argmax differs
    for i, (got, want) in enumerate(zip(t_calls, j_calls)):
        rows = np.nonzero(got.argmax(-1) != want.argmax(-1))[0]
        if len(rows) == 0:
            _close(got, want, f"decode call {i}")
            continue
        tol = REL * np.abs(want).max()
        for r in rows:
            top2 = np.sort(want[r])[-2:]
            assert top2[1] - top2[0] <= 2 * tol, (i, r, top2)
        return
    raise AssertionError("served tokens differ, yet every call's argmax "
                         "agrees")
