"""The port's RWKV-6 and MoE families (rwkv6-1.6b, granite-moe-1b-a400m,
qwen2-moe-a2.7b) against the JAX package's, on the reduced configs with
the JAX weights carried across, fp32 and bf16: the WKV recurrence (and a
naive numpy loop), the time and channel mixes with their states, the MoE
FFN with and without dropped tokens, in GShard's fp32 dispatch and the
bf16 one, forward / prefill / decode with the caches, and
``BatchEngine``'s served tokens; and the port on its own: a sequence split
in two equal to the whole, decode against forward, the donated step.
Inputs come from numpy with a seed."""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import api as t_api  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models import rwkv as t_rwkv  # noqa: E402
from repro_torch.models import transformer as t_tr  # noqa: E402
from repro_torch.models.common import DTypePolicy  # noqa: E402
from repro_torch.serve import engine as t_engine  # noqa: E402
from repro_torch.serve.steps import make_decode_step  # noqa: E402

RWKV = "rwkv6-1.6b"
MOE = ["granite-moe-1b-a400m", "qwen2-moe-a2.7b"]
ARCHS = [RWKV] + MOE
REL = {"float32": 1e-5,     # port vs JAX: the same math, other sum orders
       "bfloat16": 3e-2}    # bf16 operands: the repo's bf16 logits rule
TOL_DECODE = 2e-3           # decode vs forward (test_decode_consistency.py)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import registry
    from repro.models import api, moe, rwkv, transformer
    from repro.models.common import DTypePolicy as JPolicy
    from repro.models.common import TreeMaker as JTreeMaker
    from repro.serve import engine
    return types.SimpleNamespace(jax=jax, jnp=jnp, registry=registry,
                                 api=api, moe=moe, rwkv=rwkv,
                                 transformer=transformer, engine=engine,
                                 JPolicy=JPolicy, JTreeMaker=JTreeMaker)


def _policy(jx, dtype):
    return jx.JPolicy.fp32() if dtype == "float32" else jx.JPolicy()


def _pair(jx, arch, dtype="float32", **replace):
    """(JAX cfg, port cfg, JAX params, port params) for a reduced arch."""
    cfg = dataclasses.replace(jx.registry.get_config(arch, reduced=True),
                              **replace)
    tcfg = dataclasses.replace(t_registry.get_config(arch, reduced=True),
                               **replace)
    params = jx.api.init_params(cfg, jx.jax.random.PRNGKey(0),
                                dtype_policy=_policy(jx, dtype))
    return cfg, tcfg, params, params_from_jax(params, "cpu")


def _close(got, want, rel, what, scale=None):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    ref = np.abs(want).max() if scale is None else scale
    assert err <= rel * max(1.0, ref), (what, err, ref)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _tokens(vocab, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


# --------------------------------------------------------------------------
# the WKV recurrence and the RWKV-6 mixes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("t", [10, 32])
def test_wkv_scan_matches_reference_and_naive_loop(jx, t):
    """T = 10 takes the JAX scan's one-step path, T = 32 its 16-step
    chunks: the port's loop against both and against numpy's loop."""
    rng = np.random.default_rng(0)
    b, h, hd = 2, 2, 8
    r, k, v = (rng.standard_normal((b, t, h, hd)).astype(np.float32)
               for _ in range(3))
    w = (1 / (1 + np.exp(-rng.standard_normal((b, t, h, hd)))) * 0.5
         + 0.4).astype(np.float32)
    u = rng.standard_normal((h, hd)).astype(np.float32)
    s0 = rng.standard_normal((b, h, hd, hd)).astype(np.float32)
    got, got_s = t_rwkv._wkv_scan(*(torch.from_numpy(a)
                                    for a in (r, k, v, w, u, s0)))
    want, want_s = jx.rwkv._wkv_scan(*(jx.jnp.asarray(a)
                                       for a in (r, k, v, w, u, s0)))
    _close(got, want, REL["float32"], "out")
    _close(got_s, want_s, REL["float32"], "state")
    s, outs = s0.astype(np.float64), np.zeros((b, t, h, hd))
    for i in range(t):
        kv = np.einsum("bhc,bhd->bhcd", k[:, i], v[:, i])
        outs[:, i] = np.einsum("bhc,bhcd->bhd", r[:, i],
                               s + u[None, :, :, None] * kv)
        s = s * w[:, i][..., None] + kv
    _close(got, outs, REL["float32"], "out vs naive")
    _close(got_s, s, REL["float32"], "state vs naive")


def _rwkv_layer(jx, dtype, seed=0):
    """One RWKV-6 layer's JAX params (reduced rwkv6), every zero- or
    one-initialized leaf (mixes, decay base, bonus, ln_x) drawn at random
    so that each term moves the result, and the port's copy."""
    cfg = jx.registry.get_config(RWKV, reduced=True)
    tm = jx.JTreeMaker("init", key=jx.jax.random.PRNGKey(seed),
                       dtype_policy=_policy(jx, dtype))
    p = jx.rwkv.rwkv_params(tm, cfg)
    rng = np.random.default_rng(seed + 1)
    for name in ("mu_x", "mu", "decay_base", "u", "ln_x", "cmu_k",
                 "cmu_r"):
        base = 1.0 if name == "ln_x" else 0.0
        vals = base + 0.5 * rng.standard_normal(p[name].shape)
        p[name] = jx.jnp.asarray(vals.astype(np.float32)).astype(
            p[name].dtype)
    return cfg, t_registry.get_config(RWKV, reduced=True), p, \
        params_from_jax(p, "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_time_and_channel_mix_match_reference(jx, dtype):
    """The mixes from a carried state and last x: outputs, the final WKV
    state and the last x of each."""
    cfg, tcfg, p, tp = _rwkv_layer(jx, dtype)
    rng = np.random.default_rng(2)
    b, t, d = 2, 9, cfg.d_model
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    last = rng.standard_normal((b, d)).astype(np.float32)
    s0 = 0.1 * rng.standard_normal((b, cfg.n_heads, cfg.head_dim_,
                                    cfg.head_dim_)).astype(np.float32)
    tdt = getattr(torch, dtype)
    jdt = getattr(jx.jnp, dtype)
    jxx, jlast = jx.jnp.asarray(x).astype(jdt), jx.jnp.asarray(last)
    txx, tlast = torch.from_numpy(x).to(tdt), torch.from_numpy(last)
    want = jx.rwkv.rwkv_time_mix(p, cfg, jxx, last_x=jlast,
                                 s0=jx.jnp.asarray(s0))
    got = t_rwkv.rwkv_time_mix(tp, tcfg, txx, last_x=tlast,
                               s0=torch.from_numpy(s0))
    assert got[0].dtype == tdt and got[1].dtype == torch.float32
    for g, w, what in zip(got, want, ("out", "state", "last x")):
        _close(_np(g), _np(w), REL[dtype], f"time mix {what}")
    want = jx.rwkv.rwkv_channel_mix(p, cfg, jxx, last_x=jlast)
    got = t_rwkv.rwkv_channel_mix(tp, tcfg, txx, last_x=tlast)
    for g, w, what in zip(got, want, ("out", "last x")):
        _close(_np(g), _np(w), REL[dtype], f"channel mix {what}")


def test_time_mix_two_halves_equal_the_whole(jx):
    """tests/test_moe_ssm.py's continuity check on the port: a sequence
    split at 5, the state and last x carried, equals the unsplit run."""
    _, tcfg, _, tp = _rwkv_layer(jx, "float32")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 12, tcfg.d_model)).astype(np.float32))
    full, sf, xl = t_rwkv.rwkv_time_mix(tp, tcfg, x)
    o1, s1, x1 = t_rwkv.rwkv_time_mix(tp, tcfg, x[:, :5])
    o2, s2, x2 = t_rwkv.rwkv_time_mix(tp, tcfg, x[:, 5:], last_x=x1, s0=s1)
    _close(torch.cat([o1, o2], 1), full, REL["float32"], "out")
    _close(s2, sf, REL["float32"], "state")
    assert torch.equal(x2, xl)


# --------------------------------------------------------------------------
# the MoE FFN
# --------------------------------------------------------------------------

def _moe_case(jx, e, k, shared, cf):
    """tests/test_moe_ssm.py's configs: d 32, d_ff 16, ``e`` experts
    (padded to 16), top-``k``, ``shared`` shared experts; fp32 weights
    and x (2, 32, 32) from a seed."""
    replace = dict(d_model=32, d_ff=16, n_experts=e, top_k=k,
                   shared_experts=shared, moe_capacity_factor=cf)
    cfg = dataclasses.replace(
        jx.registry.get_config(MOE[0], reduced=True), **replace)
    tcfg = dataclasses.replace(
        t_registry.get_config(MOE[0], reduced=True), **replace)
    tm = jx.JTreeMaker("init", key=jx.jax.random.PRNGKey(0),
                       dtype_policy=jx.JPolicy.fp32())
    p = jx.moe.moe_params(tm, cfg)
    x = np.random.default_rng(1).standard_normal(
        (2, 32, 32)).astype(np.float32)
    return cfg, tcfg, p, params_from_jax(p, "cpu"), x


MOE_CASES = [(8, 2, 0, 8.0), (8, 2, 1, 8.0), (4, 1, 0, 4.0),  # lossless
             (8, 2, 0, 1.0), (8, 2, 1, 1.0)]                  # drops


@pytest.mark.parametrize("dispatch", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,k,shared,cf", MOE_CASES,
                         ids=[f"e{e}k{k}s{s}cf{cf:g}"
                              for e, k, s, cf in MOE_CASES])
def test_moe_ffn_matches_reference(jx, e, k, shared, cf, dispatch):
    """``out`` and ``aux`` against the JAX function in groups of 16, the
    dead padded experts included; at capacity 1.0 tokens are dropped
    (the output differs from the lossless one)."""
    cfg, tcfg, p, tp, x = _moe_case(jx, e, k, shared, cf)
    kw = dict(group_size=16, capacity_factor=cf, renorm_topk=shared == 0)
    want, want_aux = jx.moe.moe_ffn(
        p, cfg, jx.jnp.asarray(x), dispatch_dtype=getattr(jx.jnp, dispatch),
        **kw)
    got, got_aux = t_moe.moe_ffn(tp, tcfg, torch.from_numpy(x),
                                 dispatch_dtype=getattr(torch, dispatch),
                                 **kw)
    assert tp["router"].shape[1] == t_moe.padded_experts(tcfg) == 16
    _close(got, want, REL["float32"], "out")
    _close(got_aux, want_aux, REL["float32"], "aux")
    assert float(got_aux) > 0
    if cf < e / k:
        lossless, _ = t_moe.moe_ffn(tp, tcfg, torch.from_numpy(x),
                                    **dict(kw, capacity_factor=e / k))
        assert (got - lossless).abs().max() > 1e-3, "no token dropped"


# --------------------------------------------------------------------------
# the families' trees and models against the JAX package
# --------------------------------------------------------------------------

def _cache_leaves(tree, prefix=""):
    """(path, leaf) of a nested dict, in its key order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _cache_leaves(v, f"{prefix}{k}/")]
    return [(prefix.rstrip("/"), tree)]


def _leaf(tree, path):
    for key in path.split("/"):
        tree = tree[key]
    return tree


@pytest.mark.parametrize("arch,dtype",
                         [(a, "float32") for a in ARCHS]
                         + [(a, "bfloat16") for a in MOE])
def test_forward_prefill_decode_match_reference(jx, arch, dtype):
    """Forward over 12 tokens, prefill 6 (the MoE at the default capacity
    1.25: a group of 6 keeps one token an expert), decode 6, and the
    caches (WKV states and token shifts, or K / V).  rwkv6 in bf16 is
    held layer by layer below."""
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
    cdt = getattr(jx.jnp, dtype)
    j_cache = jx.api.init_cache(cfg, b, s, dtype=cdt)
    t_cache = t_api.init_cache(tcfg, b, s, dtype=getattr(torch, dtype),
                               device="cpu")
    j_lp, j_cache = jx.api.prefill(
        params, cfg, {"tokens": jx.jnp.asarray(tokens[:, :k])}, j_cache)
    t_lp, t_cache = t_api.prefill(tparams, tcfg, {"tokens": tt[:, :k]},
                                  t_cache)
    _close(t_lp, _np(j_lp), REL[dtype], "prefill", scale)
    assert len(_cache_leaves(t_cache)) == len(_cache_leaves(j_cache))
    for name, got in _cache_leaves(t_cache):
        want = _leaf(j_cache, name)
        assert got.dtype == getattr(torch, str(want.dtype)), name
        _close(_np(got), _np(want), REL[dtype], f"prefill cache {name}")
    for i in range(k, s):
        j_lg, j_cache = jx.api.decode_step(params, cfg,
                                           jx.jnp.asarray(tokens[:, i]),
                                           j_cache, jx.jnp.int32(i))
        t_lg, t_cache = t_api.decode_step(tparams, tcfg, tt[:, i], t_cache,
                                          i)
        _close(t_lg, _np(j_lg), REL[dtype], f"decode step {i}", scale)
    for name, got in _cache_leaves(t_cache):
        _close(_np(got), _np(_leaf(j_cache, name)), REL[dtype],
               f"cache {name}")


def test_rwkv6_bf16_matches_reference_layer_by_layer(jx):
    """rwkv6 with bf16 weights and activations.  Each layer, fed the JAX
    stack's own bf16 input, gives the JAX layer's output, WKV state and
    last x's within REL (bf16); so does the step of each layer in a
    decode after a 6-token prefill.  Through the 4 layers the bf16
    roundings of r, k, v are amplified (a head's WKV output sums
    products that cancel, and the group norm rescales what is left), so
    the whole forward's logits are held to the JAX package's own bf16
    error, measured here: no further from the JAX bf16 forward than that
    is from the JAX forward on the same weights in fp32."""
    cfg, tcfg, params, tparams = _pair(jx, RWKV, "bfloat16")
    tokens = _tokens(cfg.vocab, 2, 12)
    jt = jx.jnp.asarray(tokens)
    x = jx.jnp.take(params["embed"], jt, axis=0)
    c = jx.api.init_cache(cfg, 2, 12)
    for i in range(cfg.n_layers):
        lp = jx.jax.tree_util.tree_map(lambda a: a[i], params["blocks"])
        ci = jx.jax.tree_util.tree_map(lambda a: a[i], c)
        want = jx.transformer._rwkv_block(lp, cfg, x, state=ci["s"],
                                          x_tm=ci["x_tm"], x_cm=ci["x_cm"])
        tci = params_from_jax(ci, "cpu")
        got = t_tr._rwkv_block(t_tr._layer(tparams["blocks"], i), tcfg,
                               params_from_jax(x, "cpu"), state=tci["s"],
                               x_tm=tci["x_tm"], x_cm=tci["x_cm"])
        for g, w, what in zip(got, want, ("x", "s", "x_tm", "x_cm")):
            _close(_np(g), _np(w), REL["bfloat16"], f"layer {i} {what}")
        x = want[0]
    _, j_cache = jx.api.prefill(params, cfg, {"tokens": jt[:, :6]}, c)
    h = jx.jnp.take(params["embed"], jt[:, 6], axis=0)[:, None]
    for i in range(cfg.n_layers):
        lp = jx.jax.tree_util.tree_map(lambda a: a[i], params["blocks"])
        ci = jx.jax.tree_util.tree_map(lambda a: a[i], j_cache)
        want = jx.transformer._rwkv_block(lp, cfg, h, state=ci["s"],
                                          x_tm=ci["x_tm"], x_cm=ci["x_cm"])
        tci = params_from_jax(ci, "cpu")
        got = t_tr._rwkv_block(t_tr._layer(tparams["blocks"], i), tcfg,
                               params_from_jax(h, "cpu"), state=tci["s"],
                               x_tm=tci["x_tm"], x_cm=tci["x_cm"])
        for g, w, what in zip(got, want, ("x", "s", "x_tm", "x_cm")):
            _close(_np(g), _np(w), REL["bfloat16"], f"decode layer {i} "
                   f"{what}")
        h = want[0]
    want16 = _np(jx.transformer.forward(params, cfg, jt)[0])
    p32 = jx.jax.tree_util.tree_map(lambda a: a.astype(jx.jnp.float32),
                                    params)
    want32 = _np(jx.transformer.forward(p32, cfg, jt)[0])
    got = t_tr.forward(tparams, tcfg, torch.from_numpy(tokens).long())
    own = np.abs(want16 - want32).max()
    assert np.abs(got.numpy() - want16).max() <= own, own


def test_moe_bf16_dispatch_matches_reference(jx):
    """``cfg.moe_dispatch_dtype = "bf16"``, the named mode (gates rounded
    to bf16 in the combine), through the whole qwen2-moe forward."""
    cfg, tcfg, params, tparams = _pair(jx, MOE[1],
                                       moe_dispatch_dtype="bf16")
    tokens = _tokens(cfg.vocab, 2, 12, seed=4)
    want = jx.transformer.forward(params, cfg, jx.jnp.asarray(tokens))[0]
    got = t_tr.forward(tparams, tcfg, torch.from_numpy(tokens).long())
    _close(got, _np(want), REL["float32"], "forward")
    fp32 = t_tr.forward(tparams, dataclasses.replace(
        tcfg, moe_dispatch_dtype="fp32"), torch.from_numpy(tokens).long())
    assert not torch.equal(got, fp32)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The port alone: prefill 6, decode 6 against the teacher-forced
    forward within 2e-3·max|logits| (the MoE lossless, capacity factor
    n_experts / top_k: a prefill group and a one-token decode group then
    route alike)."""
    cfg = t_registry.get_config(arch, reduced=True)
    if cfg.is_moe:
        cfg = dataclasses.replace(
            cfg, moe_capacity_factor=cfg.n_experts / cfg.top_k)
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


@pytest.mark.parametrize("arch", [RWKV, MOE[1]])
def test_donated_step_is_bitwise_the_functional_step(arch):
    """The donated decode step with a device position: the functional
    step's logits and cache bitwise, written into the very tensors passed
    in."""
    cfg = t_registry.get_config(arch, reduced=True)
    params = t_api.init_params(cfg, torch.Generator().manual_seed(1),
                               dtype_policy=DTypePolicy.fp32(), device="cpu")
    cache = t_api.init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
    donated = t_api.init_cache(cfg, 2, 16, dtype=torch.float32,
                               device="cpu")
    ptrs = [t.data_ptr() for _, t in _cache_leaves(donated)]
    tokens = torch.from_numpy(_tokens(cfg.vocab, 2, 10, seed=3)).long()
    for i in range(10):
        want, cache = t_api.decode_step(params, cfg, tokens[:, i], cache, i)
        got, out = t_api.decode_step(params, cfg, tokens[:, i], donated,
                                     torch.tensor(i), donate=True)
        assert out is donated and torch.equal(got, want), i
    assert [t.data_ptr() for _, t in _cache_leaves(donated)] == ptrs
    for name, got in _cache_leaves(donated):
        assert torch.equal(got, _leaf(cache, name)), name


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


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_engine_serves_the_reference_tokens(jx, arch):
    """Batch 2, 3 requests (the third refills a slot, which keeps the
    previous request's recurrent state, while the other row decodes on),
    fp32 weights and caches on both sides.  Every decode call's logits
    agree within REL·max|logits| until a served token differs, and the
    first that differs sits on a near-tie of the reference's logits: a
    routing decision that differs moves a row's logits, so it fails the
    first rule unless it sits on such a tie."""
    cfg, tcfg, params, tparams = _pair(jx, arch)
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
    assert outs["port"] == outs["jax"]
    assert len(t_calls) == len(j_calls)


@pytest.mark.parametrize("arch", ARCHS)
def test_token_serving_summary(arch):
    """What the token launcher runs, for each family (reduced)."""
    d = t_engine.token_serving_summary(arch, batch=2, max_len=24,
                                       prompt_len=6, new_tokens=10,
                                       requests=3, device="cpu")
    assert d["requests_done"] == 3 and d["requests_lost"] == 0
    assert d["tokens"] == 30 and d["arch"] == f"{arch}-smoke"


# --------------------------------------------------------------------------
# on a card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the decode step is captured as a "
                    "CUDA graph")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_captured_engine_is_bitwise_the_eager_engine(cuda_device, arch):
    """The captured decode step (one CUDA graph: the MoE's capacity a
    Python int, its one-hots by comparison, nothing synced) serves the
    eager step's tokens and logits bitwise, with one capture."""
    cfg = t_registry.get_config(arch, reduced=True)
    params = t_api.init_params(
        cfg, torch.Generator(device=cuda_device).manual_seed(0),
        dtype_policy=DTypePolicy.fp32(), device=cuda_device)
    functional = make_decode_step(cfg)
    runs = []
    for captured in (True, False):
        eng = t_engine.BatchEngine(cfg, params, batch=2, max_len=24,
                                   cache_dtype=torch.float32,
                                   device=cuda_device)
        step = eng.decode
        if not captured:
            eng.decode = lambda p, tok, cache, pos: functional(
                p, tok.to(cuda_device), cache, pos)
        calls = _recording(eng, lambda a: a.clone())
        rng = np.random.default_rng(5)
        reqs = [t_engine.Request(rid=i, prompt=rng.integers(
            0, cfg.vocab, n, dtype=np.int32), max_new_tokens=m)
            for i, (n, m) in enumerate([(5, 7), (3, 9), (4, 6)])]
        for r in reqs:
            eng.submit(r)
        eng.run()
        runs.append(([r.output for r in reqs], calls, step))
    (got, got_lg, step), (want, want_lg, _) = runs
    assert got == want and step.captures == 1
    assert len(got_lg) == len(want_lg)
    for i, (a, b) in enumerate(zip(got_lg, want_lg)):
        assert torch.equal(a, b), f"decode call {i}"
