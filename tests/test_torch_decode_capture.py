"""The donated decode step and its capture as one CUDA graph (the port's
counterpart of the JAX engine's ``jax.jit(make_decode_step(cfg),
donate_argnums=(2,))``), on ``get_config("zamba2-1.2b", reduced=True)``.

On the CPU, with the JAX package's fp32 weights carried across: the
donated step's logits and cache are bitwise the functional step's at
every step (a position at ``max_len - 1`` and one past it included, where
the cache write clamps and the mask's ``kv_len`` does not), the
functional step leaves its input cache unchanged, ``pos`` as an int and
as a 0-d tensor agree, and ``BatchEngine`` keeps its cache tensors at
fixed addresses and serves the functional engine's tokens.  On a card
(marked ``cuda``): the captured engine serves the eager engine's tokens
and logits bitwise, two engines capture a graph each, and a replay after
a slot refill goes on with the same sequence."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import api as t_api  # noqa: E402
from repro_torch.models.common import DTypePolicy  # noqa: E402
from repro_torch.serve import engine as t_engine  # noqa: E402
from repro_torch.serve.steps import make_decode_step  # noqa: E402

CFG = t_registry.get_config("zamba2-1.2b", reduced=True)
BATCH, MAX_LEN = 2, 8
# (prompt length, new tokens): the third request refills a slot
SPECS = [(5, 4), (3, 6), (4, 3)]


REL = 1e-5      # port vs JAX, fp32: the same math, sums in other orders


@pytest.fixture(scope="module")
def jx():
    """The JAX package and its fp32 weights for reduced zamba2."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import registry
    from repro.models import api
    from repro.models.common import DTypePolicy as JPolicy
    cfg = registry.get_config("zamba2-1.2b", reduced=True)
    tree = api.init_params(cfg, jax.random.PRNGKey(0),
                           dtype_policy=JPolicy.fp32())
    return types.SimpleNamespace(jnp=jnp, api=api, cfg=cfg, params=tree)


@pytest.fixture(scope="module")
def params(jx):
    """The JAX weights carried to the port on the CPU."""
    return params_from_jax(jx.params, "cpu")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += _leaves(v, f"{prefix}/{k}")
        return out
    return [(prefix, tree)]


def _assert_trees_equal(got, want, what):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys(), what
    for k in want:
        assert torch.equal(got[k], want[k]), f"{what}: {k}"


def _cache(device="cpu", dtype=torch.float32):
    return t_api.init_cache(CFG, BATCH, MAX_LEN, dtype=dtype, device=device)


def _token_seq(n, seed=3):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, CFG.vocab, (n, BATCH))).long()


# --------------------------------------------------------------------------
# the donated step on the CPU
# --------------------------------------------------------------------------

def test_donated_step_is_bitwise_the_functional_step(jx, params):
    """Positions 0 .. max_len: the last two write at the clamped index
    max_len - 1 while the mask's kv_len runs on unclamped.  Both steps'
    logits are the JAX package's too, within REL·max|logits|."""
    toks = _token_seq(MAX_LEN + 1)
    functional, donated = _cache(), _cache()
    j_cache = jx.api.init_cache(jx.cfg, BATCH, MAX_LEN,
                                dtype=jx.jnp.float32)
    for pos in range(MAX_LEN + 1):
        j_lg, j_cache = jx.api.decode_step(
            jx.params, jx.cfg, jx.jnp.asarray(toks[pos].numpy()), j_cache,
            jx.jnp.int32(pos))
        lg_f, functional = t_api.decode_step(params, CFG, toks[pos],
                                             functional, pos)
        lg_d, back = t_api.decode_step(params, CFG, toks[pos], donated,
                                       torch.tensor(pos), donate=True)
        assert back is donated
        assert torch.equal(lg_d, lg_f), f"logits at pos {pos}"
        _assert_trees_equal(donated, functional, f"cache at pos {pos}")
        want = np.asarray(j_lg, np.float64)
        err = np.abs(lg_d.double().numpy() - want).max()
        assert err <= REL * np.abs(want).max(), (pos, err)
    assert bool(donated["attn"]["k"][:, :, MAX_LEN - 1].ne(0).any())


def test_functional_step_leaves_its_input_cache_unchanged(params):
    toks = _token_seq(3)
    cache = _cache()
    for pos in range(2):
        _, cache = t_api.decode_step(params, CFG, toks[pos], cache, pos)
    before = {k: v.clone() for k, v in _leaves(cache)}
    _, new = t_api.decode_step(params, CFG, toks[2], cache, 2)
    for k, v in _leaves(cache):
        assert torch.equal(v, before[k]), k
    assert not torch.equal(new["attn"]["k"], cache["attn"]["k"])


@pytest.mark.parametrize("donate", [False, True])
def test_pos_as_int_and_as_tensor_agree(params, donate):
    toks = _token_seq(1)
    out = []
    for pos in (5, torch.tensor(5), torch.tensor(5, dtype=torch.int32)):
        cache = _cache()
        lg, cache = t_api.decode_step(params, CFG, toks[0], cache, pos,
                                      donate=donate)
        out.append((lg, cache))
    for lg, cache in out[1:]:
        assert torch.equal(lg, out[0][0])
        _assert_trees_equal(cache, out[0][1], "cache")


def test_make_decode_step_donates_on_request(params):
    toks = _token_seq(1)
    cache = _cache()
    nxt_f, lg_f, new = make_decode_step(CFG)(params, toks[0], cache, 0)
    assert new is not cache
    nxt_d, lg_d, back = make_decode_step(CFG, donate=True)(
        params, toks[0], cache, 0)
    assert back is cache
    assert torch.equal(nxt_d, nxt_f) and torch.equal(lg_d, lg_f)
    _assert_trees_equal(cache, new, "cache")


# --------------------------------------------------------------------------
# BatchEngine on the CPU
# --------------------------------------------------------------------------

def _requests(seed=5):
    rng = np.random.default_rng(seed)
    return [t_engine.Request(rid=i, prompt=rng.integers(0, CFG.vocab, n,
                                                        dtype=np.int32),
                             max_new_tokens=m)
            for i, (n, m) in enumerate(SPECS)]


def _serve(engine, reqs, record=None):
    """Serve ``reqs``; with ``record`` every decode call's logits land
    there (cloned)."""
    if record is not None:
        step = engine.decode

        def decode(*args):
            out = step(*args)
            record.append(out[1].clone())
            return out
        engine.decode = decode
    for r in reqs:
        engine.submit(r)
    engine.run()
    assert all(r.done for r in reqs)
    return [r.output for r in reqs]


def _eager(engine, device):
    """Give ``engine`` the functional decode step, tokens moved to the
    device (the engine before its step was captured)."""
    functional = make_decode_step(CFG)
    engine.decode = lambda p, tok, cache, pos: functional(
        p, tok.to(device), cache, pos)
    return engine


def test_batch_engine_keeps_its_cache_in_place(params):
    eng = t_engine.BatchEngine(CFG, params, batch=BATCH, max_len=16,
                               cache_dtype=torch.float32, device="cpu")
    cache = eng.cache
    ptrs = [(k, v.data_ptr()) for k, v in _leaves(cache)]
    _serve(eng, _requests())
    assert eng.cache is cache
    assert [(k, v.data_ptr()) for k, v in _leaves(eng.cache)] == ptrs
    assert isinstance(eng.decode, t_engine.CapturedDecode)
    assert eng.decode.captures == 0          # no graph on the CPU


def test_batch_engine_serves_the_functional_engines_tokens(params):
    got_lg, want_lg = [], []
    got = _serve(t_engine.BatchEngine(CFG, params, batch=BATCH, max_len=16,
                                      cache_dtype=torch.float32,
                                      device="cpu"), _requests(), got_lg)
    ref = _eager(t_engine.BatchEngine(CFG, params, batch=BATCH, max_len=16,
                                      cache_dtype=torch.float32,
                                      device="cpu"), "cpu")
    want = _serve(ref, _requests(), want_lg)
    assert got == want
    assert len(got_lg) == len(want_lg)
    for i, (a, b) in enumerate(zip(got_lg, want_lg)):
        assert torch.equal(a, b), f"decode call {i}"


# --------------------------------------------------------------------------
# the capture on a card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the decode step is captured as a "
                    "CUDA graph")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _cuda_params(device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return t_api.init_params(CFG, gen, dtype_policy=DTypePolicy.fp32(),
                             device=device)


def _engine(p, device):
    return t_engine.BatchEngine(CFG, p, batch=BATCH, max_len=16,
                                cache_dtype=torch.float32, device=device)


def _pair(device, seed=0):
    p = _cuda_params(device, seed)
    return p, _engine(p, device), _eager(_engine(p, device), device)


@pytest.mark.cuda
def test_cuda_captured_engine_is_bitwise_the_eager_engine(cuda_device):
    _, captured, eager = _pair(cuda_device)
    cache, step = captured.cache, captured.decode
    ptrs = [v.data_ptr() for _, v in _leaves(cache)]
    got_lg, want_lg = [], []
    got = _serve(captured, _requests(), got_lg)
    want = _serve(eager, _requests(), want_lg)
    assert got == want
    assert len(got_lg) == len(want_lg)
    for i, (a, b) in enumerate(zip(got_lg, want_lg)):
        assert torch.equal(a, b), f"decode call {i}"
    assert captured.cache is cache
    assert [v.data_ptr() for _, v in _leaves(captured.cache)] == ptrs
    assert step.captures == 1


@pytest.mark.cuda
def test_cuda_two_engines_capture_a_graph_each(cuda_device):
    """Two engines over other weights, stepped in turns: each replays its
    own graph and serves what its eager engine serves."""
    runs = [_pair(cuda_device, seed) for seed in (0, 1)]
    outs = []
    for _, captured, _ in runs:
        reqs = _requests()
        for r in reqs:
            captured.submit(r)
        outs.append(reqs)
    while any(c.queue or any(s is not None for s in c.slots)
              for _, c, _ in runs):
        for _, captured, _ in runs:
            captured.step()
    for (_, captured, eager), reqs in zip(runs, outs):
        assert captured.decode.captures == 1
        assert [r.output for r in reqs] == _serve(eager, _requests())
    assert runs[0][1].decode._graph is not runs[1][1].decode._graph


@pytest.mark.cuda
def test_cuda_replay_after_a_refill_goes_on_with_the_sequence(cuda_device):
    """Batch 2, three requests: the third refills a slot and is prompt-
    stepped through the same graph while the other slot's state moves
    on; a second round of requests after the queue ran dry as well."""
    _, captured, eager = _pair(cuda_device)
    first = _serve(captured, _requests(5))
    again = _serve(captured, _requests(6))
    assert first == _serve(eager, _requests(5))
    assert again == _serve(eager, _requests(6))
    assert captured.decode.captures == 1
