"""The port's enc-dec family (seamless-m4t-medium) and VLM frontend
(internvl2-26b) against the JAX package's, on the reduced configs with the
JAX weights carried across, fp32 and bf16: ``layer_norm``, cross-attention
(``attention(kv_x=)``), ``encode`` / ``forward`` / ``prefill`` (the self
and the cross caches) / ``decode_step``, the VLM's forward and prefill
with patch embeddings and the decode after them, and ``BatchEngine``'s
served tokens; and the port on its own: decode against forward.  Inputs
come from numpy with a seed."""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import api as t_api  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import encdec as t_ed  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import transformer as t_tr  # noqa: E402
from repro_torch.models.common import DTypePolicy  # noqa: E402
from repro_torch.serve import engine as t_engine  # noqa: E402
from repro_torch.serve.steps import make_decode_step  # noqa: E402

ENCDEC = "seamless-m4t-medium"
VLM = "internvl2-26b"
REL = {"float32": 1e-5,     # port vs JAX: the same math, other sum orders
       "bfloat16": 3e-2}    # bf16 operands: the repo's bf16 logits rule
TOL_DECODE = 2e-3           # decode vs forward (test_decode_consistency.py)
B, SRC, S, K = 2, 10, 12, 6   # batch, source frames, tokens, prompt


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import registry
    from repro.models import api, attention, encdec, layers, transformer
    from repro.models.common import DTypePolicy as JPolicy
    from repro.models.common import TreeMaker as JTreeMaker
    from repro.serve import engine
    return types.SimpleNamespace(jax=jax, jnp=jnp, registry=registry,
                                 api=api, attention=attention, encdec=encdec,
                                 layers=layers, transformer=transformer,
                                 engine=engine, JPolicy=JPolicy,
                                 JTreeMaker=JTreeMaker)


def _pair(jx, arch, dtype="float32"):
    """(JAX cfg, port cfg, JAX params, port params) for a reduced arch."""
    cfg = jx.registry.get_config(arch, reduced=True)
    tcfg = t_registry.get_config(arch, reduced=True)
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


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _tokens(vocab, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


def _embeds(b, n, d, seed=2):
    return np.random.default_rng(seed).standard_normal(
        (b, n, d)).astype(np.float32)


def _leaves(tree, prefix=""):
    """(path, leaf) of a nested dict, in its key order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _leaves(v, f"{prefix}{k}/")]
    return [(prefix.rstrip("/"), tree)]


def _leaf(tree, path):
    for key in path.split("/"):
        tree = tree[key]
    return tree


# --------------------------------------------------------------------------
# layer_norm and cross-attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(jx, dtype):
    rng = np.random.default_rng(0)
    x = (3.0 + 2.0 * rng.standard_normal((2, 5, 48))).astype(np.float32)
    w, b = (rng.standard_normal(48).astype(np.float32) for _ in range(2))
    want = jx.layers.layer_norm(jx.jnp.asarray(x).astype(
        getattr(jx.jnp, dtype)), jx.jnp.asarray(w), jx.jnp.asarray(b))
    got = t_layers.layer_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                              torch.from_numpy(w), torch.from_numpy(b))
    assert got.dtype == getattr(torch, dtype)
    _close(_np(got), _np(want), REL[dtype], "layer_norm")


CROSS = [dict(), dict(qkv_bias=True, qk_norm=True, kv_heads=2)]


@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("replace", CROSS, ids=["mha", "gqa-bias-qknorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_matches_reference(jx, dtype, replace, rope):
    """``attention(kv_x=)``: q over 7 decoder rows, K / V projected from
    10 encoder rows, no mask, RoPE on q only with ``inv_freq``, no
    cache."""
    cfg = dataclasses.replace(jx.registry.get_config(ENCDEC, reduced=True),
                              **replace)
    tcfg = dataclasses.replace(t_registry.get_config(ENCDEC, reduced=True),
                               **replace)
    dp = jx.JPolicy.fp32() if dtype == "float32" else jx.JPolicy()
    tm = jx.JTreeMaker("init", key=jx.jax.random.PRNGKey(0),
                       dtype_policy=dp)
    p = jx.attention.attn_params(tm, cfg)
    if cfg.qkv_bias:       # the biases start at 0: give them a value
        rng = np.random.default_rng(4)
        for name in ("bq", "bk", "bv"):
            p[name] = jx.jnp.asarray(rng.standard_normal(
                p[name].shape).astype(np.float32)).astype(p[name].dtype)
    x = _embeds(B, 7, cfg.d_model, seed=5)
    enc = _embeds(B, SRC, cfg.d_model, seed=6)
    jdt, tdt = getattr(jx.jnp, dtype), getattr(torch, dtype)
    inv = jx.layers.rope_freqs(cfg.head_dim_, cfg.rope_theta) if rope \
        else None
    want, want_cache = jx.attention.attention(
        p, cfg, jx.jnp.asarray(x).astype(jdt),
        positions=jx.jnp.arange(7) + 3, inv_freq=inv,
        kv_x=jx.jnp.asarray(enc).astype(jdt))
    got, got_cache = t_attn.attention(
        params_from_jax(p, "cpu"), tcfg, torch.from_numpy(x).to(tdt),
        positions=torch.arange(7) + 3,
        inv_freq=(t_layers.rope_freqs(tcfg.head_dim_, tcfg.rope_theta)
                  if rope else None),
        kv_x=torch.from_numpy(enc).to(tdt))
    assert want_cache is None and got_cache is None
    _close(_np(got), _np(want), REL[dtype], "cross attention")


# --------------------------------------------------------------------------
# seamless-m4t-medium: the enc-dec against the JAX package
# --------------------------------------------------------------------------

def _batches(jx, tokens, src):
    return ({"tokens": jx.jnp.asarray(tokens),
             "src_embeds": jx.jnp.asarray(src)},
            {"tokens": torch.from_numpy(tokens).long(),
             "src_embeds": torch.from_numpy(src)})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encdec_matches_reference(jx, dtype):
    """``encode``, the teacher-forced ``forward``, ``prefill`` of 6
    tokens over 10 source frames (its self cache and its cross cache,
    sized by the source: 10 rows, not init_cache's 12), then 6
    ``decode_step``s, and the caches after them."""
    cfg, tcfg, params, tparams = _pair(jx, ENCDEC, dtype)
    tokens = _tokens(cfg.vocab, B, S)
    src = _embeds(B, SRC, cfg.d_model)
    jb, tb = _batches(jx, tokens, src)
    _close(_np(t_ed.encode(tparams, tcfg, tb["src_embeds"])),
           _np(jx.encdec.encode(params, cfg, jb["src_embeds"])),
           REL[dtype], "encode")
    want_f = _np(jx.encdec.forward(params, cfg, jb)[0])
    scale = np.abs(want_f).max()
    got_f = t_ed.forward(tparams, tcfg, tb)
    assert got_f.dtype == torch.float32
    _close(got_f, want_f, REL[dtype], "forward")
    cdt, tdt = getattr(jx.jnp, dtype), getattr(torch, dtype)
    j_cache = jx.api.init_cache(cfg, B, S, src_len=S, dtype=cdt)
    t_cache = t_api.init_cache(tcfg, B, S, src_len=S, dtype=tdt,
                               device="cpu")
    j_lp, j_cache = jx.api.prefill(
        params, cfg, {"tokens": jb["tokens"][:, :K],
                      "src_embeds": jb["src_embeds"]}, j_cache)
    t_lp, t_cache = t_api.prefill(
        tparams, tcfg, {"tokens": tb["tokens"][:, :K],
                        "src_embeds": tb["src_embeds"]}, t_cache)
    _close(t_lp, _np(j_lp), REL[dtype], "prefill", scale)
    assert tuple(t_cache["cross"]["k"].shape[:3]) == (cfg.n_layers, B, SRC)
    for name, got in _leaves(t_cache):
        want = _leaf(j_cache, name)
        assert got.dtype == getattr(torch, str(want.dtype)), name
        _close(_np(got), _np(want), REL[dtype], f"prefill cache {name}")
    for i in range(K, S):
        j_lg, j_cache = jx.api.decode_step(params, cfg, jb["tokens"][:, i],
                                           j_cache, jx.jnp.int32(i))
        t_lg, t_cache = t_api.decode_step(tparams, tcfg, tb["tokens"][:, i],
                                          t_cache, i)
        _close(t_lg, _np(j_lg), REL[dtype], f"decode step {i}", scale)
    for name, got in _leaves(t_cache):
        _close(_np(got), _np(_leaf(j_cache, name)), REL[dtype],
               f"cache {name}")


def test_init_cache_sizes_match_reference(jx):
    """``src_len=0`` gives the cross K/V ``max_len`` rows, as
    ``repro.models.api.init_cache`` does; a given ``src_len`` its own."""
    cfg = jx.registry.get_config(ENCDEC, reduced=True)
    tcfg = t_registry.get_config(ENCDEC, reduced=True)
    for src_len in (0, 5):
        want = jx.api.init_cache(cfg, 3, 16, src_len=src_len)
        got = t_api.init_cache(tcfg, 3, 16, src_len=src_len, device="cpu")
        assert len(_leaves(got)) == len(_leaves(want))
        for name, t in _leaves(got):
            w = _leaf(want, name)
            assert tuple(t.shape) == w.shape, (src_len, name)
            assert t.dtype == torch.bfloat16 and not t.any()


# --------------------------------------------------------------------------
# internvl2-26b: the VLM frontend against the JAX package
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_matches_reference(jx, dtype):
    """``forward`` with 8 patch embeddings in front of 12 tokens (20
    positions), ``prefill`` of the patches and 6 tokens through
    ``api.prefill(batch["patches"])``, the 6 decode steps after it at
    positions 14-19, and the cache."""
    cfg, tcfg, params, tparams = _pair(jx, VLM, dtype)
    assert "frontend_proj" in tparams
    tokens = _tokens(cfg.vocab, B, S)
    patches = _embeds(B, cfg.frontend_len, cfg.d_model)
    tt = torch.from_numpy(tokens).long()
    want_f = _np(jx.transformer.forward(
        params, cfg, jx.jnp.asarray(tokens),
        extra_embeds=jx.jnp.asarray(patches))[0])
    scale = np.abs(want_f).max()
    got_f = t_tr.forward(tparams, tcfg, tt,
                         extra_embeds=torch.from_numpy(patches))
    assert got_f.shape[1] == cfg.frontend_len + S
    _close(got_f, want_f, REL[dtype], "forward")
    n = cfg.frontend_len + S
    cdt, tdt = getattr(jx.jnp, dtype), getattr(torch, dtype)
    j_cache = jx.api.init_cache(cfg, B, n, dtype=cdt)
    t_cache = t_api.init_cache(tcfg, B, n, dtype=tdt, device="cpu")
    j_lp, j_cache = jx.api.prefill(
        params, cfg, {"tokens": jx.jnp.asarray(tokens[:, :K]),
                      "patches": jx.jnp.asarray(patches)}, j_cache)
    t_lp, t_cache = t_api.prefill(
        tparams, tcfg, {"tokens": tt[:, :K],
                        "patches": torch.from_numpy(patches)}, t_cache)
    _close(t_lp, _np(j_lp), REL[dtype], "prefill", scale)
    for i in range(K, S):
        pos = cfg.frontend_len + i
        j_lg, j_cache = jx.api.decode_step(
            params, cfg, jx.jnp.asarray(tokens[:, i]), j_cache,
            jx.jnp.int32(pos))
        t_lg, t_cache = t_api.decode_step(tparams, tcfg, tt[:, i], t_cache,
                                          pos)
        _close(t_lg, _np(j_lg), REL[dtype], f"decode step {i}", scale)
    for name in ("k", "v"):
        _close(_np(t_cache[name]), _np(j_cache[name]), REL[dtype],
               f"cache {name}")


# --------------------------------------------------------------------------
# the port alone: decode against forward
# --------------------------------------------------------------------------

def _fp32_params(arch, seed=0):
    cfg = t_registry.get_config(arch, reduced=True)
    return cfg, t_api.init_params(cfg, torch.Generator().manual_seed(seed),
                                  dtype_policy=DTypePolicy.fp32(),
                                  device="cpu")


def test_encdec_decode_matches_forward():
    """Prefill 6 tokens over the source, decode 6 on the cached cross
    K/V, against the teacher-forced forward within 2e-3·max|logits|."""
    cfg, params = _fp32_params(ENCDEC)
    tokens = torch.from_numpy(_tokens(cfg.vocab, B, S)).long()
    src = torch.from_numpy(_embeds(B, SRC, cfg.d_model))
    logits_f = t_ed.forward(params, cfg, {"tokens": tokens,
                                          "src_embeds": src})
    cache = t_api.init_cache(cfg, B, S, dtype=torch.float32, device="cpu")
    lp, cache = t_api.prefill(params, cfg, {"tokens": tokens[:, :K],
                                            "src_embeds": src}, cache)
    scale = logits_f.abs().max().item()
    errs = [(lp - logits_f[:, K - 1]).abs().max().item() / scale]
    for i in range(K, S):
        lg, cache = t_api.decode_step(params, cfg, tokens[:, i], cache, i)
        errs.append((lg - logits_f[:, i]).abs().max().item() / scale)
    assert max(errs) < TOL_DECODE, errs


def test_vlm_decode_matches_forward():
    """Prefill the patches and 6 tokens, decode 6, against the forward
    with the patches within 2e-3·max|logits|."""
    cfg, params = _fp32_params(VLM)
    tokens = torch.from_numpy(_tokens(cfg.vocab, B, S)).long()
    patches = torch.from_numpy(_embeds(B, cfg.frontend_len, cfg.d_model))
    logits_f = t_tr.forward(params, cfg, tokens, extra_embeds=patches)
    f = cfg.frontend_len
    cache = t_api.init_cache(cfg, B, f + S, dtype=torch.float32,
                             device="cpu")
    lp, cache = t_api.prefill(params, cfg, {"tokens": tokens[:, :K],
                                            "patches": patches}, cache)
    scale = logits_f.abs().max().item()
    errs = [(lp - logits_f[:, f + K - 1]).abs().max().item() / scale]
    for i in range(K, S):
        lg, cache = t_api.decode_step(params, cfg, tokens[:, i], cache,
                                      f + i)
        errs.append((lg - logits_f[:, f + i]).abs().max().item() / scale)
    assert max(errs) < TOL_DECODE, errs


def test_encdec_donated_step_is_bitwise_the_functional_step():
    """The donated enc-dec step writes the self caches in place and gives
    the functional step's logits and caches bitwise; the cross K/V are
    read, not written."""
    cfg, params = _fp32_params(ENCDEC, seed=1)
    src = torch.from_numpy(_embeds(B, SRC, cfg.d_model))
    tokens = torch.from_numpy(_tokens(cfg.vocab, B, 10, seed=3)).long()
    cache = t_api.init_cache(cfg, B, 16, dtype=torch.float32, device="cpu")
    _, cache = t_api.prefill(params, cfg, {"tokens": tokens[:, :4],
                                           "src_embeds": src}, cache)
    donated = {k: {n: t.clone() for n, t in v.items()}
               for k, v in cache.items()}
    ptrs = [t.data_ptr() for _, t in _leaves(donated)]
    cross = donated["cross"]["k"].clone()
    for i in range(4, 10):
        want, cache = t_api.decode_step(params, cfg, tokens[:, i], cache, i)
        got, out = t_api.decode_step(params, cfg, tokens[:, i], donated,
                                     torch.tensor(i), donate=True)
        assert out is donated and torch.equal(got, want), i
    assert [t.data_ptr() for _, t in _leaves(donated)] == ptrs
    assert torch.equal(donated["cross"]["k"], cross)
    for name, t in _leaves(donated):
        assert torch.equal(t, _leaf(cache, name)), name


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


@pytest.mark.parametrize("arch", [ENCDEC, VLM])
def test_batch_engine_serves_the_reference_tokens(jx, arch):
    """Batch 2, 3 requests, fp32 weights and caches on both sides; the
    enc-dec decodes over the zero cross K/V of ``max_len`` rows (the
    engine never prefills, so no source is encoded), the VLM over tokens
    alone.  Every decode call's logits agree within REL·max|logits| until
    a served token differs, and the first that differs sits on a
    near-tie of the reference's logits."""
    cfg, tcfg, params, tparams = _pair(jx, arch)
    rng = np.random.default_rng(5)
    specs = [(5, 7), (3, 9), (4, 6)]          # (prompt length, new tokens)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32)
               for n, _ in specs]
    j_eng = jx.engine.BatchEngine(cfg, params, batch=2, max_len=24,
                                  cache_dtype=jx.jnp.float32)
    t_eng = t_engine.BatchEngine(tcfg, tparams, batch=2, max_len=24,
                                 cache_dtype=torch.float32, device="cpu")
    if cfg.is_encdec:
        assert tuple(t_eng.cache["cross"]["k"].shape[:3]) == (
            cfg.n_layers, 2, 24)
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


@pytest.mark.parametrize("arch", [ENCDEC, VLM])
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
@pytest.mark.parametrize("arch", [ENCDEC, VLM])
def test_cuda_captured_engine_is_bitwise_the_eager_engine(cuda_device, arch):
    """The captured decode step serves the eager step's tokens and
    logits bitwise, with one capture."""
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
