"""The port's collectives against the JAX package's, on the CPU: the GPipe
schedule and stage split, the sequential emulation against JAX's
``make_pipelined_stack(mesh=None)`` for 1-4 stages (1e-6, as
``tests/test_pipeline.py`` holds JAX's against its scan), and on gloo
ranks in spawned processes (``tests/torch_mesh_ranks.py``, under a
timeout): the pipeline over 4 and 2 stage ranks bitwise the port's
sequential emulation, and ``compressed_psum`` on 2 and 4 ranks — over the
world and over each axis of a 2x1, a 1x2 and a 2x2 mesh — bitwise the
numpy formula built from JAX's ``quantize_int8`` of each rank's operand:
the int8 values summed as int32, times the largest scale."""
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core.quant import quantize_int8 as j_quantize  # noqa: E402
from repro.distributed import pipeline as j_pipe  # noqa: E402
from repro_torch.distributed import pipeline as t_pipe  # noqa: E402

from test_torch_mesh_serving import run_ranks  # noqa: E402
from torch_mesh_ranks import psum_input  # noqa: E402

L, D = 8, 16


def _stack_inputs():
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((L, D, D)) * 0.1).astype(np.float32)
    xm = rng.standard_normal((4, 2, 6, D)).astype(np.float32)
    return ws, xm


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    ws, xm = _stack_inputs()
    return run_ranks(4, tmp_path_factory.mktemp("pipe4"), "pipeline,psum",
                     {"pipe_ws": ws, "pipe_x": xm})


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    ws, xm = _stack_inputs()
    return run_ranks(2, tmp_path_factory.mktemp("pipe2"), "pipeline,psum",
                     {"pipe_ws": ws, "pipe_x": xm})


@pytest.mark.parametrize("n_micro,n_stages", [(4, 2), (1, 1), (3, 4),
                                              (8, 3), (2, 5)])
def test_gpipe_schedule_matches_jax(n_micro, n_stages):
    assert t_pipe.gpipe_schedule(n_micro, n_stages) == \
        j_pipe.gpipe_schedule(n_micro, n_stages)


@pytest.mark.parametrize("n_stages", [1, 2, 3, 6])
def test_split_stages_matches_jax(n_stages):
    ws = np.arange(6 * 2 * 3, dtype=np.float32).reshape(6, 2, 3)
    tree = {"a": ws, "b": {"c": ws[:, :1] * 2}}
    got = t_pipe.split_stages(
        {"a": torch.from_numpy(ws), "b": {"c": torch.from_numpy(
            tree["b"]["c"])}}, n_stages)
    want = j_pipe.split_stages(tree, n_stages)
    np.testing.assert_array_equal(got["a"].numpy(), np.asarray(want["a"]))
    np.testing.assert_array_equal(got["b"]["c"].numpy(),
                                  np.asarray(want["b"]["c"]))


def test_split_stages_refuses_an_uneven_split():
    with pytest.raises(ValueError):
        t_pipe.split_stages(torch.zeros(6, 2), 4)


@pytest.mark.parametrize("n_stages", [1, 2, 3, 4])
def test_sequential_emulation_matches_jax(n_stages):
    if L % n_stages:
        ws, xm = _stack_inputs()
        ws = ws[:6]
    else:
        ws, xm = _stack_inputs()
    want = j_pipe.make_pipelined_stack(
        None, lambda lp, x: x + jnp.tanh(x @ lp), n_stages=n_stages,
        mesh=None)(jnp.asarray(ws), jnp.asarray(xm))
    got = t_pipe.make_pipelined_stack(
        None, lambda lp, x: x + torch.tanh(x @ lp), n_stages=n_stages)(
        torch.from_numpy(ws), torch.from_numpy(xm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_pipeline_on_four_ranks_equals_the_emulation(four_ranks, rank):
    r = four_ranks[rank]
    assert r["pipeline_mesh"].shape == (4, 2, 6, D)
    np.testing.assert_array_equal(r["pipeline_mesh"], r["pipeline_seq"])


@pytest.mark.parametrize("rank", [0, 1])
def test_pipeline_on_two_ranks_equals_the_emulation(two_ranks, rank):
    np.testing.assert_array_equal(two_ranks[rank]["pipeline_mesh"],
                                  two_ranks[rank]["pipeline_seq"])


def _want(seed, ranks):
    """JAX's quantize per rank, int32 sum, times the largest scale."""
    qs = [j_quantize(jnp.asarray(psum_input(seed, r))) for r in ranks]
    acc = sum(np.asarray(q).astype(np.int32) for q, _ in qs)
    smax = max(np.float32(s) for _, s in qs)
    return (acc.astype(np.float32) * smax).astype(np.float32)


# name -> (seed, the group of each rank in mesh order)
GROUPS2 = {"world": (0, lambda r: [0, 1]),
           "2x1_data": (1, lambda r: [0, 1]),
           "2x1_model": (2, lambda r: [r]),
           "1x2_data": (1, lambda r: [r]),
           "1x2_model": (2, lambda r: [0, 1])}
GROUPS4 = {"world": (0, lambda r: [0, 1, 2, 3]),
           "2x2_data": (1, lambda r: [r % 2, r % 2 + 2]),
           "2x2_model": (2, lambda r: [r - r % 2, r - r % 2 + 1])}


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("name", sorted(GROUPS2))
def test_compressed_psum_on_two_ranks(two_ranks, name, rank):
    seed, group = GROUPS2[name]
    np.testing.assert_array_equal(two_ranks[rank][f"psum_{name}"],
                                  _want(seed, group(rank)))


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
@pytest.mark.parametrize("name", sorted(GROUPS4))
def test_compressed_psum_on_four_ranks(four_ranks, name, rank):
    seed, group = GROUPS4[name]
    np.testing.assert_array_equal(four_ranks[rank][f"psum_{name}"],
                                  _want(seed, group(rank)))


def test_compressed_psum_on_one_rank_is_int8_roundtrip(tmp_path):
    """A one-rank group (started here in a subprocess: the test process
    keeps no process group) gives ``int8_roundtrip`` bitwise."""
    import subprocess
    code = (
        "import sys, torch\n"
        "sys.path.insert(0, 'src')\n"
        "from repro_torch.launch.mesh import make_local_mesh\n"
        "from repro_torch.distributed.compression import (\n"
        "    compressed_psum, int8_roundtrip)\n"
        "from repro_torch.distributed.sharding import (make_rules,\n"
        "    set_context)\n"
        "from repro_torch.configs.registry import get_config\n"
        "mesh = make_local_mesh(1, 1, device='cpu')\n"
        "x = torch.randn(64, 33, generator=torch.Generator().manual_seed(3))\n"
        "a = compressed_psum(x, mesh.group('data'))\n"
        "set_context(mesh, make_rules(get_config('qwen3-4b'), mesh))\n"
        "b = compressed_psum(x.bfloat16(), 'model')\n"
        "assert torch.equal(a, int8_roundtrip(x)), 'fp32'\n"
        "assert torch.equal(b, int8_roundtrip(x.bfloat16())), 'bf16'\n"
        "print('ok')\n")
    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok"
