"""The port's dense attention LM family (llama3-8b, qwen3-4b, qwen2.5-14b,
gemma3-12b) against the JAX package's, on the reduced configs with the JAX
weights carried across: the weight bridge, forward / prefill / decode in
fp32 and bf16, gemma3's ring-buffer window cache, head and vocab padding,
and ``BatchEngine``'s served tokens; and the port on its own: decode
against forward, the ring past its wrap, the donated ring step."""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import api as t_api  # noqa: E402
from repro_torch.models import transformer as t_tr  # noqa: E402
from repro_torch.models.common import DTypePolicy  # noqa: E402
from repro_torch.serve import engine as t_engine  # noqa: E402

DENSE = ["llama3-8b", "qwen3-4b", "qwen2.5-14b", "gemma3-12b"]
REL = {"float32": 1e-5,     # port vs JAX: the same math, other sum orders
       "bfloat16": 3e-2}    # bf16 operands: the repo's bf16 logits rule
TOL_DECODE = 2e-3           # decode vs forward (test_decode_consistency.py)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import registry
    from repro.models import api, transformer
    from repro.models.common import DTypePolicy as JPolicy
    from repro.serve import engine
    return types.SimpleNamespace(jax=jax, jnp=jnp, registry=registry,
                                 api=api, transformer=transformer,
                                 engine=engine, JPolicy=JPolicy)


def _pair(jx, arch, dtype="float32", **replace):
    """(JAX cfg, port cfg, JAX params, port params) for a reduced arch."""
    cfg = dataclasses.replace(jx.registry.get_config(arch, reduced=True),
                              **replace)
    tcfg = dataclasses.replace(t_registry.get_config(arch, reduced=True),
                               **replace)
    dp = jx.JPolicy.fp32() if dtype == "float32" else jx.JPolicy()
    params = jx.api.init_params(cfg, jx.jax.random.PRNGKey(0),
                                dtype_policy=dp)
    return cfg, tcfg, params, params_from_jax(params, "cpu")


def _close(got, want, rel, what, scale=None):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    ref = np.abs(want).max() if scale is None else scale
    assert err <= rel * max(1.0, ref), (what, err, ref)


def _tokens(vocab, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


# --------------------------------------------------------------------------
# the weight bridge and the family gate
# --------------------------------------------------------------------------

PADDED = dict(n_heads=5, kv_heads=1, head_pad_multiple=8,
              vocab_pad_multiple=64, vocab=100)


@pytest.mark.parametrize("arch,replace", [(a, {}) for a in DENSE]
                         + [("qwen2.5-14b", PADDED)],
                         ids=DENSE + ["qwen2.5-14b-padded"])
def test_bridge_carries_the_attention_tree(jx, arch, replace):
    """Leaf for leaf: the QKV biases, qk norms, a tied head (no lm_head)
    and the padded head / vocab leaves, in the port's own layout."""
    cfg, tcfg, params, tparams = _pair(jx, arch, **replace)
    own = t_api.init_params(tcfg, torch.Generator().manual_seed(0),
                            dtype_policy=DTypePolicy.fp32(), device="cpu")
    flat = jx.jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == len(jx.jax.tree_util.tree_leaves(own))
    for path, leaf in flat:
        got, mine = tparams, own
        for key in path:
            got, mine = got[key.key], mine[key.key]
        assert got.dtype == mine.dtype == torch.float32
        assert tuple(got.shape) == tuple(mine.shape) == leaf.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))
    attn = tparams["blocks"]["attn"]
    assert ("bq" in attn) == cfg.qkv_bias
    assert ("q_norm" in attn) == cfg.qk_norm
    assert ("lm_head" in tparams) != cfg.tie_embeddings
    assert attn["wq"].shape[2] == cfg.padded_heads
    assert tparams["embed"].shape[0] == cfg.padded_vocab


def test_layer_windows_equal_reference(jx):
    for arch in DENSE:
        for reduced in (False, True):
            cfg = jx.registry.get_config(arch, reduced=reduced)
            want = np.asarray(jx.transformer._layer_windows(cfg)).tolist()
            assert t_tr._layer_windows(
                t_registry.get_config(arch, reduced=reduced)) == want
    full = t_tr._layer_windows(t_registry.get_config("gemma3-12b"))
    assert full.count(0) == 8 and full.count(1024) == 40


# --------------------------------------------------------------------------
# forward, prefill and decode against the JAX package
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_forward_prefill_decode_match_reference(jx, arch, dtype):
    cfg, tcfg, params, tparams = _pair(jx, arch, dtype)
    b, s, k = 2, 12, 6
    tokens = _tokens(cfg.vocab, b, s)
    tt = torch.from_numpy(tokens).long()
    want_f = np.asarray(jx.transformer.forward(params, cfg,
                                               jx.jnp.asarray(tokens))[0],
                        np.float32)
    scale = np.abs(want_f).max()
    got_f = t_tr.forward(tparams, tcfg, tt)
    assert got_f.dtype == torch.float32
    _close(got_f, want_f, REL[dtype], "forward")
    cdt = jx.jnp.float32 if dtype == "float32" else jx.jnp.bfloat16
    j_cache = jx.api.init_cache(cfg, b, s, dtype=cdt)
    t_cache = t_api.init_cache(tcfg, b, s, dtype=getattr(torch, dtype),
                               device="cpu")
    j_lp, j_cache = jx.api.prefill(
        params, cfg, {"tokens": jx.jnp.asarray(tokens[:, :k])}, j_cache)
    t_lp, t_cache = t_api.prefill(tparams, tcfg, {"tokens": tt[:, :k]},
                                  t_cache)
    _close(t_lp, np.asarray(j_lp, np.float32), REL[dtype], "prefill",
           scale)
    for i in range(k, s):
        j_lg, j_cache = jx.api.decode_step(params, cfg,
                                           jx.jnp.asarray(tokens[:, i]),
                                           j_cache, jx.jnp.int32(i))
        t_lg, t_cache = t_api.decode_step(tparams, tcfg, tt[:, i], t_cache,
                                          i)
        _close(t_lg, np.asarray(j_lg, np.float32), REL[dtype],
               f"decode step {i}", scale)
    for name in ("k", "v"):
        _close(t_cache[name].float(), np.asarray(j_cache[name], np.float32),
               REL[dtype], f"cache {name}")


@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma3-12b"])
def test_decode_matches_forward(arch):
    """tests/test_decode_consistency.py on the port alone: prefill 6, then
    decode 6 one at a time, against the teacher-forced forward."""
    cfg = t_registry.get_config(arch, reduced=True)
    params = t_api.init_params(cfg, torch.Generator().manual_seed(0),
                               dtype_policy=DTypePolicy.fp32(), device="cpu")
    b, s, k = 2, 12, 6
    tokens = torch.from_numpy(_tokens(cfg.vocab, b, s)).long()
    logits_f = t_tr.forward(params, cfg, tokens)
    cache = t_api.init_cache(cfg, b, s, dtype=torch.float32, device="cpu")
    lp, cache = t_api.prefill(params, cfg, {"tokens": tokens[:, :k]}, cache)
    scale = logits_f.abs().max().item() + 1e-6
    errs = [(lp - logits_f[:, k - 1]).abs().max().item() / scale]
    for i in range(k, s):
        lg, cache = t_api.decode_step(params, cfg, tokens[:, i], cache, i)
        errs.append((lg - logits_f[:, i]).abs().max().item() / scale)
    assert max(errs) < TOL_DECODE, errs


# --------------------------------------------------------------------------
# gemma3's ring-buffer window cache
# --------------------------------------------------------------------------

def test_ring_cache_decode_matches_forward():
    """tests/test_perf_features.py's check: ring-buffer local caches
    reproduce the full-attention forward past the wrap (3 windows)."""
    cfg0 = t_registry.get_config("gemma3-12b", reduced=True)
    cfg = dataclasses.replace(cfg0, window_cache=True)
    assert t_tr.uses_window_cache(cfg)
    params = t_tr.init_params(cfg0, torch.Generator().manual_seed(0),
                              dtype_policy=DTypePolicy.fp32(), device="cpu")
    b, s = 2, 3 * cfg0.sliding_window
    tokens = torch.from_numpy(_tokens(cfg0.vocab, b, s)).long()
    logits_f = t_tr.forward(params, cfg0, tokens)
    cache = t_tr.init_cache(cfg, b, s, dtype=torch.float32, device="cpu")
    scale = logits_f.abs().max().item() + 1e-6
    errs = []
    for i in range(s):
        lg, cache = t_tr.decode_step(params, cfg, tokens[:, i], cache, i)
        errs.append((lg - logits_f[:, i]).abs().max().item() / scale)
    assert max(errs) < TOL_DECODE, errs


def test_ring_cache_memory_is_window_sized():
    cfg = dataclasses.replace(t_registry.get_config("gemma3-12b",
                                                    reduced=True),
                              window_cache=True)
    cache = t_tr.init_cache(cfg, batch=2, max_len=4096, dtype=torch.float32,
                            device="cpu")
    w = cfg.sliding_window
    ng, ge = cfg.n_layers // cfg.global_every, cfg.global_every
    assert tuple(cache["local"]["k"].shape[:4]) == (ng, ge - 1, 2, w)
    assert tuple(cache["global"]["k"].shape[:3]) == (ng, 2, 4096)
    assert cache["local"]["k"].numel() < cache["global"]["k"].numel() / 10


def test_ring_decode_matches_reference(jx):
    """The window-cache decode step by step against the JAX package's on
    the same fp32 weights, past the wrap, with the rings equal."""
    cfg, tcfg, params, tparams = _pair(jx, "gemma3-12b", window_cache=True)
    b, s = 2, 3 * cfg.sliding_window
    tokens = _tokens(cfg.vocab, b, s, seed=2)
    j_cache = jx.transformer.init_cache(cfg, b, s, dtype=jx.jnp.float32)
    t_cache = t_tr.init_cache(tcfg, b, s, dtype=torch.float32,
                              device="cpu")
    j_step = jx.jax.jit(jx.transformer.decode_step, static_argnums=1)
    for i in range(s):
        j_lg, j_cache = j_step(params, cfg, jx.jnp.asarray(tokens[:, i]),
                               j_cache, jx.jnp.int32(i))
        t_lg, t_cache = t_tr.decode_step(
            tparams, tcfg, torch.from_numpy(tokens[:, i]).long(), t_cache,
            i)
        _close(t_lg, np.asarray(j_lg), REL["float32"], f"step {i}")
    for part in ("local", "global"):
        for name in ("k", "v"):
            _close(t_cache[part][name], np.asarray(j_cache[part][name]),
                   REL["float32"], f"{part}/{name}")


def test_donated_ring_step_writes_in_place_from_a_device_position():
    """The donated step with the position as a 0-d tensor (what a CUDA
    graph replays): bitwise the functional step, the ring written into
    the very tensors passed in."""
    cfg = dataclasses.replace(t_registry.get_config("gemma3-12b",
                                                    reduced=True),
                              window_cache=True)
    params = t_tr.init_params(cfg, torch.Generator().manual_seed(1),
                              dtype_policy=DTypePolicy.fp32(), device="cpu")
    cache = t_tr.init_cache(cfg, 2, 32, dtype=torch.float32, device="cpu")
    donated = t_tr.init_cache(cfg, 2, 32, dtype=torch.float32, device="cpu")
    ptrs = [t.data_ptr() for part in donated.values() for t in part.values()]
    tokens = torch.from_numpy(_tokens(cfg.vocab, 2, 20, seed=3)).long()
    for i in range(20):
        want, cache = t_tr.decode_step(params, cfg, tokens[:, i], cache, i)
        got, out = t_tr.decode_step(params, cfg, tokens[:, i], donated,
                                    torch.tensor(i), donate=True)
        assert out is donated and torch.equal(got, want), i
    assert [t.data_ptr() for part in donated.values()
            for t in part.values()] == ptrs
    for part in ("local", "global"):
        for name in ("k", "v"):
            assert torch.equal(donated[part][name], cache[part][name])


def test_prefill_refuses_a_window_cache():
    cfg = dataclasses.replace(t_registry.get_config("gemma3-12b",
                                                    reduced=True),
                              window_cache=True)
    params = t_tr.init_params(cfg, device="cpu")
    cache = t_tr.init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="decode_step"):
        t_tr.prefill(params, cfg, torch.zeros((1, 4), dtype=torch.long),
                     cache)


# --------------------------------------------------------------------------
# head and vocab padding
# --------------------------------------------------------------------------

def test_vocab_and_head_padding_exactness(jx):
    """tests/test_models_smoke.py's check on logits: a padded qwen2.5
    (5 heads padded to 8, vocab 100 padded to 128) with its unpadded twin's
    weights in the real slices gives the twin's real-vocab logits, in
    forward and decode, and the padded rows lose every argmax; and it
    matches the JAX package's padded forward."""
    cfg, tcfg, params, tparams = _pair(jx, "qwen2.5-14b", **PADDED)
    assert (cfg.padded_heads, cfg.padded_vocab) == (8, 128)
    tcfg0 = dataclasses.replace(tcfg, head_pad_multiple=1,
                                vocab_pad_multiple=1)
    ref = t_api.init_params(tcfg0, torch.Generator().manual_seed(1),
                            dtype_policy=DTypePolicy.fp32(), device="cpu")

    def copy_into(dst, src):
        if isinstance(dst, dict):
            return {k: copy_into(dst[k], src[k]) for k in dst}
        out = dst.clone()
        out[tuple(slice(0, n) for n in src.shape)] = src
        return out
    padded = copy_into(tparams, ref)
    tokens = torch.from_numpy(_tokens(100, 2, 8, seed=2)).long()
    l_pad = t_tr.forward(padded, tcfg, tokens)
    l_ref = t_tr.forward(ref, tcfg0, tokens)
    _close(l_pad[..., :100], l_ref, REL["float32"], "padded forward")
    assert bool((l_pad[..., 100:] < -1e29).all())
    cache = t_api.init_cache(tcfg, 2, 8, dtype=torch.float32, device="cpu")
    assert cache["k"].shape[3] == tcfg.cache_kv_heads == 8
    cache0 = t_api.init_cache(tcfg0, 2, 8, dtype=torch.float32, device="cpu")
    for i in range(8):
        lg, cache = t_api.decode_step(padded, tcfg, tokens[:, i], cache, i)
        lg0, cache0 = t_api.decode_step(ref, tcfg0, tokens[:, i], cache0, i)
        _close(lg[:, :100], lg0, REL["float32"], f"padded decode {i}")
        assert int(lg.argmax(-1).max()) < 100
    want = jx.transformer.forward(params, cfg, jx.jnp.asarray(
        tokens.numpy().astype(np.int32)))[0]
    _close(t_tr.forward(tparams, tcfg, tokens)[..., :100],
           np.asarray(want)[..., :100], REL["float32"],
           "padded forward vs JAX")


# --------------------------------------------------------------------------
# served tokens against the JAX BatchEngine
# --------------------------------------------------------------------------

def _recording(engine, to_np):
    calls, step = [], engine.decode

    def decode(*args, **kwargs):
        out = step(*args, **kwargs)
        calls.append(to_np(out[1]))
        return out
    engine.decode = decode
    return calls


@pytest.mark.parametrize("arch,window_cache",
                         [("qwen3-4b", False), ("gemma3-12b", False),
                          ("gemma3-12b", True)])
def test_batch_engine_serves_the_reference_tokens(jx, arch, window_cache):
    """Batch 2, 3 requests (the third refills a slot while the other
    decodes on, every prompt token stepped through decode over the whole
    batch), fp32 weights and caches on both sides, 24 positions so the
    gemma3 rings wrap.  Any token that differs must sit on a near-tie of
    the reference's logits at that call, and every call before it must
    agree within REL·max|logits|."""
    cfg, tcfg, params, tparams = _pair(jx, arch, window_cache=window_cache)
    rng = np.random.default_rng(5)
    specs = [(5, 7), (3, 9), (4, 6)]          # (prompt length, new tokens)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32)
               for n, _ in specs]
    j_eng = jx.engine.BatchEngine(cfg, params, batch=2, max_len=24,
                                  cache_dtype=jx.jnp.float32)
    t_eng = t_engine.BatchEngine(tcfg, tparams, batch=2, max_len=24,
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
    rel = REL["float32"]
    if outs["port"] == outs["jax"]:
        assert len(t_calls) == len(j_calls)
        for i, (got, want) in enumerate(zip(t_calls, j_calls)):
            _close(got, want, rel, f"decode call {i}")
        return
    for i, (got, want) in enumerate(zip(t_calls, j_calls)):
        rows = np.nonzero(got.argmax(-1) != want.argmax(-1))[0]
        if len(rows) == 0:
            _close(got, want, rel, f"decode call {i}")
            continue
        tol = rel * np.abs(want).max()
        for r in rows:
            top2 = np.sort(want[r])[-2:]
            assert top2[1] - top2[0] <= 2 * tol, (i, r, top2)
        return
    raise AssertionError("served tokens differ, yet every call's argmax "
                         "agrees")


@pytest.mark.parametrize("arch", DENSE)
def test_token_serving_summary(arch):
    """What the token launcher runs, for each dense arch (reduced)."""
    d = t_engine.token_serving_summary(arch, batch=2, max_len=24,
                                       prompt_len=6, new_tokens=10,
                                       requests=3, device="cpu")
    assert d["requests_done"] == 3 and d["requests_lost"] == 0
    assert d["tokens"] == 30 and d["arch"] == f"{arch}-smoke"
