"""Rank processes for the port's mesh tests on the CPU (not a test module).

    python tests/torch_mesh_ranks.py WORLD DIR CASE[,CASE...]

spawns WORLD processes, one rank each, joined over gloo on a free
localhost port, and runs in every rank the CASEs on the inputs in DIR
(``inputs.npz`` and ``params_<model>.npz``, written by the tests),
writing each rank's results to ``DIR/rank<r>.npz``.  A rank that raises
fails the run: ``torch.multiprocessing.spawn`` raises and the exit code
is not 0.

``serve``: ``VisionEngine`` on 2x1 and 1x2 meshes (two ranks) or 2x2
(four), VGG-16 in fp32 and bf16 and MobileNetV2, beside the mesh-less
engine of the same process.  ``psum``: ``compressed_psum`` over the world
and over each axis of a 2x1 and a 1x2 mesh (two ranks) or of a 2x2 mesh
(four).  ``pipeline``: the GPipe pipeline over WORLD stages against the
sequential emulation.
"""
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

IMG = 32
BUCKETS = (2, 4)


def _params(d, model, dtype):
    from repro_torch.convert import params_from_jax
    from repro_torch.models.common import cast
    flat = np.load(d / f"params_{model}.npz")
    tree = {}
    for key in flat.files:
        layer, leaf = key.split("/")
        tree.setdefault(layer, {})[leaf] = flat[key]
    return cast(params_from_jax(tree, "cpu"), dtype)


def _serve(params, model, mesh, images):
    from repro_torch.models import zoo
    from repro_torch.serve.vision import VisionEngine
    eng = VisionEngine(params, zoo.get_conv_model(model).to_graph(),
                       img=IMG, buckets=BUCKETS, device="cpu", mesh=mesh)
    eng.warmup()
    reqs = [eng.submit(im) for im in images]
    eng.run()
    assert all(r.served_by == "primary" for r in reqs)
    d = eng.metrics_dict()
    split = eng.compiler.shard.names if eng.compiler.shard else ()
    return (np.concatenate([r.logits for r in reqs]), d["mesh"],
            d["buckets"], len(split))


def psum_input(seed, rank):
    """Rank ``rank``'s operand of the ``seed``-th reduction."""
    return np.random.default_rng([seed, rank]).standard_normal(
        (3, 5, 7)).astype(np.float32)


def _psum(out, name, group, seed):
    import torch.distributed as dist
    from repro_torch.distributed.compression import compressed_psum
    x = torch.from_numpy(psum_input(seed, dist.get_rank()))
    out[f"psum_{name}"] = compressed_psum(x, group).numpy()


def _serving_cases(out, d, shapes):
    from repro_torch.launch.mesh import make_local_mesh
    inputs = np.load(d / "inputs.npz")
    images = [inputs[k] for k in sorted(inputs.files)
              if k.startswith("img")]
    for model, dtype in (("vgg16", torch.float32),
                         ("vgg16", torch.bfloat16),
                         ("mobilenetv2", torch.float32)):
        tag = f"{model}_{str(dtype).split('.')[-1]}"
        params = _params(d, model, dtype)
        out[f"{tag}_alone"] = _serve(params, model, None, images)[0]
        for data, mdl in shapes:
            mesh = make_local_mesh(data, mdl, device="cpu")
            logits, shape, buckets, n_split = _serve(params, model, mesh,
                                                     images)
            key = f"{tag}_{data}x{mdl}"
            out[key] = logits
            out[f"{key}_mesh"] = np.array([shape["data"], shape["model"]])
            out[f"{key}_buckets"] = np.array(buckets)
            out[f"{key}_split"] = np.array(n_split)


def _psum_cases(out, shapes):
    from repro_torch.launch.mesh import make_local_mesh
    _psum(out, "world", None, 0)
    for data, mdl in shapes:
        mesh = make_local_mesh(data, mdl, device="cpu")
        _psum(out, f"{data}x{mdl}_data", mesh.group("data"), 1)
        _psum(out, f"{data}x{mdl}_model", mesh.group("model"), 2)


def _pipeline_case(out, d, world):
    from repro_torch.distributed.pipeline import make_pipelined_stack
    from repro_torch.launch.mesh import make_mesh
    inputs = np.load(d / "inputs.npz")
    ws = torch.from_numpy(inputs["pipe_ws"])
    xm = torch.from_numpy(inputs["pipe_x"])

    def layer_fn(lp, x):
        return x + torch.tanh(x @ lp)
    mesh = make_mesh((world,), ("pod",), device="cpu")
    run = make_pipelined_stack(None, layer_fn, n_stages=world, mesh=mesh)
    out["pipeline_mesh"] = run(ws, xm).numpy()
    out["pipeline_seq"] = make_pipelined_stack(
        None, layer_fn, n_stages=world)(ws, xm).numpy()


def rank_main(rank, world, port, d, cases):
    import torch.distributed as dist
    from repro_torch.launch.mesh import start_process_group
    torch.set_num_threads(1)
    d = pathlib.Path(d)
    start_process_group(rank, world, port, device="cpu")
    out = {}
    shapes = [(2, 1), (1, 2)] if world == 2 else [(2, 2)]
    if "serve" in cases:
        _serving_cases(out, d, shapes)
    if "psum" in cases:
        _psum_cases(out, shapes)
    if "pipeline" in cases:
        _pipeline_case(out, d, world)
    np.savez(d / f"rank{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    import torch.multiprocessing as mp
    from repro_torch.launch.mesh import free_port
    world, d, cases = int(sys.argv[1]), sys.argv[2], sys.argv[3].split(",")
    mp.spawn(rank_main, args=(world, free_port(), d, cases), nprocs=world)
