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
sequential emulation.  ``lm``: the reduced LM families of ``LM_ARCHS`` in
fp32 on DTensors (``distribute_tree``) over a 1x2 and a 2x1 mesh: the
``lm_loss`` of ``lm_batch``, a greedy decode step from the cache of
``lm_prefill`` with the cache's sequence split over the data axis
(``seq_shard_kv``), and one train step (``make_train_step``) with its
optimizer state in the ZeRO-1 layout.  ``collectives``: every
collective of ``distributed/hostgloo.py``'s group on host tensors
(``card_collectives``: on the card's, over the world group, which is
that group where ranks share a card).
``lm_entry``: the same families
through the port's entry points on a 1x2 and a 2x1 mesh, fp32, from the
JAX package's weights (the step-0 checkpoint ``jax0_<arch>`` in DIR):
``Trainer(mesh=)`` for ``ENTRY_STEPS`` steps checkpointing every step,
a restart from its step-2 checkpoint, ``BatchEngine(mesh=)`` over
``entry_requests``, ``make_prefill_step`` on ``DTensor``s, both
launchers with ``--mesh``, a checkpoint that rank 0 alone writes, a
SIGTERM to rank 1 alone, and a plain tensor's step under the two-rank
context.
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


LM_ARCHS = ("qwen3-4b", "zamba2-1.2b", "rwkv6-1.6b", "qwen2-moe-a2.7b")
LM_MESHES = ((1, 2), (2, 1))
LM_CACHE = 16


def lm_batch(cfg):
    """The ``lm`` case's batch: 2 x 16 tokens, labels the next ones."""
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 17))
    return {"tokens": torch.from_numpy(toks[:, :-1]).int(),
            "labels": torch.from_numpy(toks[:, 1:]).int()}


def lm_params(cfg):
    """The ``lm`` case's weights: seeded, fp32, on the CPU."""
    from repro_torch.models import api
    from repro_torch.models.common import DTypePolicy
    return api.init_params(cfg, torch.Generator().manual_seed(0),
                           dtype_policy=DTypePolicy.fp32(), device="cpu")


def lm_prefill(cfg, params):
    """(the fp32 cache of ``LM_CACHE`` rows after the batch's first 8
    tokens, the 9th token, its position 8), on one rank."""
    from repro_torch.models import api
    toks = lm_batch(cfg)["tokens"]
    cache = api.init_cache(cfg, 2, LM_CACHE, dtype=torch.float32,
                           device="cpu")
    _, cache = api.prefill(params, cfg, {"tokens": toks[:, :8]}, cache)
    return cache, toks[:, 8], 8


def lm_train_step(cfg):
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.steps import make_train_step
    return make_train_step(cfg, AdamWConfig())


def _lm_case(out):
    from repro_torch.configs.registry import get_config
    from repro_torch.core.mapping import PartitionSpec
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import api
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.serve.steps import make_decode_step
    from repro_torch.tree import leaves_with_path

    def lay(tree, rules, mesh, axes):
        return shd.distribute_tree(tree, shd.tree_shardings(axes, rules,
                                                            mesh))

    for data, model in LM_MESHES:
        mesh = make_local_mesh(data, model, device="cpu")
        for arch in LM_ARCHS:
            cfg = get_config(arch, reduced=True)
            tag = f"{data}x{model}_{arch}"
            plain = lm_params(cfg)
            rules = shd.make_rules(cfg, mesh)
            p_axes = api.param_axes(cfg)
            params = lay(plain, rules, mesh, p_axes)
            batch = lay(lm_batch(cfg), rules, mesh,
                        specs.train_batch_axes(cfg))
            shd.set_context(mesh, rules)
            try:
                loss = api.lm_loss(params, cfg, batch)[0]
                z1 = shd.zero1_shardings(p_axes, plain, rules, mesh)
                opt = init_opt_state(plain)
                opt = {"step": shd.NamedSharding(mesh, PartitionSpec())
                       .distribute(opt["step"]),
                       **{k: shd.distribute_tree(opt[k], z1)
                          for k in ("mu", "nu", "master")}}
                new_params, new_opt, _ = lm_train_step(cfg)(params, opt,
                                                            batch)
            finally:
                shd.clear_context()
            out[f"loss_{tag}"] = loss.full_tensor().numpy()
            for what, tree in (("train", new_params),
                               ("mu", new_opt["mu"])):
                for path, leaf in leaves_with_path(tree):
                    out[f"{what}_{tag}_{'.'.join(map(str, path))}"] = \
                        leaf.full_tensor().numpy()
            # a decode step over the cache's sequence split on the data
            # axis (the batch whole on every rank)
            rules = shd.make_rules(cfg, mesh, seq_shard_kv=True,
                                   shard_batch=False)
            cache, token, pos = lm_prefill(cfg, plain)
            shd.set_context(mesh, rules)
            try:
                nxt, logits, _ = make_decode_step(cfg)(
                    lay(plain, rules, mesh, p_axes),
                    lay(token, rules, mesh, ("batch",)),
                    lay(cache, rules, mesh, api.cache_axes(cfg)), pos)
            finally:
                shd.clear_context()
            out[f"decode_{tag}"] = logits.full_tensor().numpy()
            out[f"next_{tag}"] = nxt.full_tensor().numpy()


ENTRY_STEPS = 3
ENTRY_BATCH, ENTRY_SEQ, ENTRY_DATA_SEED = 2, 16, 7
ENTRY_MAX_LEN = 16
ENTRY_SPECS = ((5, 4), (3, 5), (4, 3))   # (prompt length, new tokens)
ENTRY_PREFILL = 8                        # prompt tokens of the prefill step


def entry_data(cfg):
    """The ``lm_entry`` trainer's pipeline: 2 x 16 tokens a step."""
    from repro_torch.data.pipeline import DataConfig
    return DataConfig(vocab=cfg.vocab, seq_len=ENTRY_SEQ,
                      global_batch=ENTRY_BATCH, seed=ENTRY_DATA_SEED)


def entry_prompts(cfg):
    rng = np.random.default_rng(9)
    return [rng.integers(0, cfg.vocab, n, dtype=np.int32)
            for n, _ in ENTRY_SPECS]


def entry_params(cfg, d, arch):
    """The JAX package's fp32 weights, from its step-0 checkpoint."""
    from repro_torch.ckpt.checkpoint import restore_checkpoint
    from repro_torch.models import api
    from repro_torch.models.common import DTypePolicy
    like = {"params": api.init_params(cfg, dtype_policy=DTypePolicy.fp32(),
                                      device="cpu")}
    return restore_checkpoint(str(d / f"jax0_{arch}"), like)[0]["params"]


def entry_trainer(cfg, mesh, directory, total):
    from repro_torch.train.trainer import Trainer, TrainerConfig
    return Trainer(cfg, TrainerConfig(total_steps=total,
                                      ckpt_dir=str(directory), ckpt_every=1,
                                      log_every=1),
                   data_cfg=entry_data(cfg), device="cpu", mesh=mesh)


def serve_entry(engine, cfg):
    """The ``ENTRY_SPECS`` requests over ``entry_prompts`` through
    ``engine``: the served tokens of each."""
    from repro_torch.serve.engine import Request
    reqs = [Request(rid=i, prompt=p, max_new_tokens=n)
            for i, (p, (_, n)) in enumerate(zip(entry_prompts(cfg),
                                                ENTRY_SPECS))]
    for r in reqs:
        engine.submit(r)
    engine.run()
    assert all(r.done for r in reqs)
    return [r.output for r in reqs]


def _recorded(engine, calls):
    """``engine`` with every decode call's logits (gathered whole on a
    mesh) appended to ``calls``."""
    step = engine.decode

    def decode(*args):
        out = step(*args)
        lg = out[1]
        calls.append((lg.full_tensor() if engine.sharded else lg).numpy())
        return out
    engine.decode = decode
    return engine


def collective_input(rank):
    """Rank ``rank``'s operand of the ``collectives`` case."""
    return torch.arange(8.0) + 10 * rank


def _collectives_case(out, rank, device):
    """Each collective of ``distributed/hostgloo.py``'s group on ``device``
    tensors: on the CPU over a group of that backend made beside the
    world's, on a card over the world group (the staged one there)."""
    import torch.distributed as dist
    from repro_torch.distributed.hostgloo import register
    group = dist.new_group(backend=register()) if device == "cpu" else None
    x = collective_input(rank).to(device)

    def keep(name, t):
        out[f"coll_{name}"] = t.float().cpu().numpy()
    for name, op in (("sum", dist.ReduceOp.SUM), ("avg", dist.ReduceOp.AVG),
                     ("max", dist.ReduceOp.MAX)):
        y = x.clone()
        # the first collective under inference mode, the rest outside:
        # the staging buffers it makes serve both
        with torch.inference_mode(name == "sum"):
            dist.all_reduce(y, op=op, group=group)
        keep(name, y)
    y = x.to(torch.bfloat16)
    dist.all_reduce(y, group=group)
    keep("sum_bf16", y)
    o = torch.empty(16, device=device)
    dist.all_gather_into_tensor(o, x, group=group)
    keep("gather", o)
    o = torch.empty(4, device=device)
    dist.reduce_scatter_tensor(o, x, group=group)
    keep("scatter", o)
    y = x.clone()
    dist.broadcast(y, 1, group=group)
    keep("bcast", y)
    o = torch.empty(8, device=device)
    dist.all_to_all_single(o, x, group=group)
    keep("a2a", o)
    # the list form runs the tensor form inside: counted once, as itself
    stats = (group if group is not None else dist.group.WORLD).stats
    before = dict(stats["by_op"]), stats["calls"]
    o = torch.empty(4, device=device)
    dist.reduce_scatter(o, list(x.split(4)), group=group)
    keep("scatter_list", o)
    out["coll_counted"] = np.array(
        [stats["calls"] - before[1]]
        + [stats["by_op"].get(k, 0) - before[0].get(k, 0)
           for k in ("reduce_scatter", "reduce_scatter_single")])
    if group is not None:
        dist.destroy_process_group(group)


def _lm_entry_case(out, d, rank):
    import os
    import shutil
    import signal
    import torch.distributed as dist
    from repro_torch.ckpt.checkpoint import latest_step, save_checkpoint
    from repro_torch.configs.registry import get_config
    from repro_torch.core.mapping import PartitionSpec
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.dtensor import is_dtensor
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch import train as train_launcher
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.specs import step_layout
    from repro_torch.models import api
    from repro_torch.serve.engine import BatchEngine
    from repro_torch.serve.steps import make_prefill_step
    from repro_torch.tree import leaves, leaves_with_path

    def key(path):
        return "__".join(map(str, path))

    for data, model in LM_MESHES:
        mesh = make_local_mesh(data, model, device="cpu")
        shape = f"{data}x{model}"
        # a DTensor tree's checkpoint: rank 0 alone writes
        solo = d / f"solo_{shape}_r{rank}"
        x = shd.NamedSharding(mesh, PartitionSpec(
            "data" if data > 1 else "model")).distribute(torch.arange(8.0))
        save_checkpoint(str(solo), 7, {"x": x})
        out[f"solo_{shape}"] = np.array(solo.exists())
        # both launchers on the mesh (the group is already running)
        # (rank 0 alone keeps the history: the other rank's loss is None)
        loss = train_launcher.main(
            ["--arch", "qwen3-4b", "--device", "cpu", "--steps", "2",
             "--batch", "2", "--seq", "16", "--mesh", shape])["last_loss"]
        out[f"train_launcher_{shape}"] = np.array(
            np.nan if loss is None else loss)
        summary = serve_launcher.main(
            ["--arch", "zamba2-1.2b", "--device", "cpu", "--batch", "2",
             "--max-len", "16", "--prompt-len", "3", "--new-tokens", "3",
             "--requests", "3", "--mesh", shape])
        out[f"serve_launcher_{shape}"] = np.array(
            [summary["requests_done"], summary["requests_lost"],
             summary["tokens"], summary["decode"] == "eager"])
        for arch in LM_ARCHS:
            cfg = get_config(arch, reduced=True)
            tag = f"{shape}_{arch}"
            whole, again = d / f"whole_{tag}", d / f"again_{tag}"
            if rank == 0:
                shutil.copytree(d / f"jax0_{arch}", whole)
            dist.barrier()
            tr = entry_trainer(cfg, mesh, whole, ENTRY_STEPS)
            p, o = tr.run()
            out[f"losses_{tag}"] = np.array([h["loss"] for h in tr.history])
            for path, leaf in leaves_with_path({"params": p, "opt": o}):
                out[f"final_{tag}/{key(path)}"] = leaf.full_tensor().numpy()
            # a restart from the step-2 checkpoint
            if rank == 0:
                again.mkdir()
                shutil.copytree(whole / "step_000000002",
                                again / "step_000000002")
            dist.barrier()
            tr2 = entry_trainer(cfg, mesh, again, ENTRY_STEPS)
            p2, o2 = tr2.run()
            out[f"restart_{tag}"] = np.array(all(
                is_dtensor(a) and torch.equal(a.to_local(), b.to_local())
                for a, b in zip(leaves((p2, o2)), leaves((p, o)))))
            out[f"restart_losses_{tag}"] = np.array(
                [h["loss"] for h in tr2.history])
            # serving and the prefill step from the JAX weights
            params = entry_params(cfg, d, arch)
            calls = []
            eng = _recorded(BatchEngine(cfg, params, batch=ENTRY_BATCH,
                                        max_len=ENTRY_MAX_LEN,
                                        cache_dtype=torch.float32,
                                        device="cpu", mesh=mesh), calls)
            for i, toks in enumerate(serve_entry(eng, cfg)):
                out[f"served_{tag}_{i}"] = np.array(toks)
            out[f"served_logits_{tag}"] = np.stack(calls)
            out[f"decode_mode_{tag}"] = np.array(eng.decode_mode)
            lay = step_layout(cfg, "prefill", mesh, ENTRY_BATCH)
            p_sh, b_sh, c_sh = lay.shardings
            toks = lm_batch(cfg)["tokens"][:, :ENTRY_PREFILL]
            cache = api.init_cache(cfg, ENTRY_BATCH, ENTRY_MAX_LEN,
                                   dtype=torch.float32, device="cpu")
            shd.set_context(mesh, lay.rules)
            try:
                _, logits, _ = make_prefill_step(cfg)(
                    shd.distribute_tree(params, p_sh),
                    shd.distribute_tree({"tokens": toks}, b_sh),
                    shd.distribute_tree(cache, c_sh))
            finally:
                shd.clear_context()
            out[f"prefill_{tag}"] = logits.full_tensor().numpy()
        # a SIGTERM to rank 1 alone stops both ranks after the same step
        cfg = get_config("qwen3-4b", reduced=True)
        stop_dir = d / f"preempt_{shape}"
        if rank == 0:
            shutil.copytree(d / "jax0_qwen3-4b", stop_dir)
        dist.barrier()
        tr = entry_trainer(cfg, mesh, stop_dir, ENTRY_STEPS)
        if rank == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        tr.run()
        out[f"preempt_{shape}"] = np.array(
            [latest_step(str(stop_dir)), len(tr.history)])
        # a plain tensor's step under the two-rank context raises
        shd.set_context(mesh, shd.make_rules(cfg, mesh))
        try:
            api.lm_loss(lm_params(cfg), cfg, lm_batch(cfg))
            raised = False
        except NotImplementedError:
            raised = True
        finally:
            shd.clear_context()
        out[f"plain_raises_{shape}"] = np.array(raised)


def rank_main(rank, world, port, d, cases):
    import torch.distributed as dist
    from repro_torch.launch.mesh import start_process_group
    torch.set_num_threads(1)
    d = pathlib.Path(d)
    device = "cuda" if "card_collectives" in cases else "cpu"
    start_process_group(rank, world, port, device=device)
    out = {}
    if "collectives" in cases or "card_collectives" in cases:
        _collectives_case(out, rank, device)
    shapes = [(2, 1), (1, 2)] if world == 2 else [(2, 2)]
    if "serve" in cases:
        _serving_cases(out, d, shapes)
    if "psum" in cases:
        _psum_cases(out, shapes)
    if "pipeline" in cases:
        _pipeline_case(out, d, world)
    if "lm" in cases:
        _lm_case(out)
    if "lm_entry" in cases:
        _lm_entry_case(out, d, rank)
    np.savez(d / f"rank{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    import torch.multiprocessing as mp
    from repro_torch.launch.mesh import free_port
    world, d, cases = int(sys.argv[1]), sys.argv[2], sys.argv[3].split(",")
    mp.spawn(rank_main, args=(world, free_port(), d, cases), nprocs=world)
