"""The port stands alone: no file of it (nor ``chip_smoke.py``,
``fold_tiles.py``, ``serve_ab.py``, ``kernel_ab.py``, ``dw_variants.py``
and the port's examples) imports jax or the JAX package, it imports in a
process where jax cannot load, and asking for a GPU that is not there raises instead of falling back."""
import ast
import dataclasses
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "fold_tiles.py", ROOT / "serve_ab.py",
     ROOT / "kernel_ab.py", ROOT / "dw_variants.py"] + \
    sorted((ROOT / "examples").glob("torch_*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_and_no_reference_package(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_where_jax_cannot_load():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch\n"
        "from repro_torch.models import mobilenet, resnet, vgg, zoo\n"
        "from repro_torch.models import (api, attention, common, encdec,\n"
        "                                layers, mlp, moe, rwkv, settings,\n"
        "                                ssm, transformer)\n"
        "from repro_torch.configs import base, registry\n"
        "from repro_torch.serve import (admission, batcher, chaos, engine,\n"
        "                               steps, vision)\n"
        "from repro_torch.obs import folds, metrics, report, trace\n"
        "from repro_torch.ft import fault_tolerance\n"
        "from repro_torch.launch import serve, train\n"
        "from repro_torch.optim import adamw, schedules\n"
        "from repro_torch.ckpt import checkpoint\n"
        "from repro_torch.data import pipeline\n"
        "from repro_torch.distributed import (comm, compression,\n"
        "                                     pipeline, sharding)\n"
        "from repro_torch.launch import mesh, specs\n"
        "from repro_torch.train import evaluate, steps, trainer\n"
        "from repro_torch import tree\n"
        "from repro_torch.kernels import (attention_fold, build,\n"
        "                                 conv1d_causal, conv2d_ws, ops, ref)\n"
        "from repro_torch.kernels import (conv1d_causal, conv2d,\n"
        "                                 flash_attention_folded)\n"
        "assert build._build.cache_info().currsize == 0  # nothing built\n"
        "from repro_torch.core import (engine, mapping, quant,\n"
        "                              simulator, streaming)\n"
        "from repro_torch.analysis import (foldlint, graph_check,\n"
        "                                  index_check, launch_audit,\n"
        "                                  plan_check, report)\n"
        "from repro_torch import convert\n"
        "from repro_torch import op_cost, roofline\n"
        "from repro_torch.distributed import dtensor, hostgloo\n"
        "from repro_torch.launch import dryrun\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()  # no process group started\n"
        "assert build._build.cache_info().currsize == 0  # nothing built\n"
        "assert not [m for m in sys.modules\n"
        "            if m.split('.')[0] in ('jax', 'jaxlib', 'repro')\n"
        "            and sys.modules[m] is not None]\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("entry", ["compile_forward", "vision_engine",
                                   "bucket_compiler", "resnet18",
                                   "mobilenetv2", "serving_summary",
                                   "launcher", "lm_init_params",
                                   "lm_init_cache", "dense_lm_init_params",
                                   "dense_lm_init_cache", "rwkv_init_cache",
                                   "moe_init_params", "encdec_init_params",
                                   "encdec_init_cache", "batch_engine",
                                   "token_serving_summary",
                                   "token_launcher", "foldlint",
                                   "chaos_summary", "chaos_launcher",
                                   "obs_report", "autotune", "trainer",
                                   "train_launcher", "elastic_example"])
def test_cuda_without_a_gpu_raises(entry):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: nothing to refuse")
    from repro_torch.analysis import foldlint
    from repro_torch.configs.registry import get_config
    from repro_torch.core.engine import autotune_schedule
    from repro_torch.core.loopnest import ConvLoopNest
    from repro_torch.obs import report
    from repro_torch.serve.chaos import chaos_summary
    from repro_torch.launch.serve import main
    from repro_torch.launch.train import main as train_main
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.models import api, mobilenet, resnet, vgg
    from repro_torch.serve.engine import BatchEngine, token_serving_summary
    from repro_torch.serve.vision import VisionEngine, serving_summary
    sys.path.insert(0, str(ROOT / "examples"))
    import torch_elastic_restart as elastic
    params = vgg.init_params(torch.Generator(), width_mult=0.0625, img=32,
                             classes=10, device="cpu")
    lm = get_config("zamba2-1.2b", reduced=True)
    dense = get_config("gemma3-12b", reduced=True)

    def zoo_model(module):
        p = module.init_params(torch.Generator(), width_mult=0.0625,
                               img=32, device="cpu")
        return module.compile_forward(p, img=32)

    calls = {
        "compile_forward": lambda: vgg.compile_forward(params, img=32),
        "vision_engine": lambda: VisionEngine(params, vgg.to_graph(),
                                              img=32),
        "bucket_compiler": lambda: vgg.bucket_compiler(
            params, img=32).network_for(1),
        "resnet18": lambda: zoo_model(resnet),
        "mobilenetv2": lambda: zoo_model(mobilenet),
        "serving_summary": lambda: serving_summary("mobilenetv2"),
        "launcher": lambda: main(["--vision", "--model", "resnet18"]),
        # the prefill step's caller makes its weights and cache first
        "lm_init_params": lambda: api.init_params(lm),
        "lm_init_cache": lambda: api.init_cache(lm, 1, 8),
        "dense_lm_init_params": lambda: api.init_params(dense),
        "dense_lm_init_cache": lambda: api.init_cache(
            dataclasses.replace(dense, window_cache=True), 1, 8),
        "rwkv_init_cache": lambda: api.init_cache(
            get_config("rwkv6-1.6b", reduced=True), 1, 8),
        "moe_init_params": lambda: api.init_params(
            get_config("qwen2-moe-a2.7b", reduced=True)),
        "encdec_init_params": lambda: api.init_params(
            get_config("seamless-m4t-medium", reduced=True)),
        "encdec_init_cache": lambda: api.init_cache(
            get_config("seamless-m4t-medium", reduced=True), 1, 8),
        "batch_engine": lambda: BatchEngine(
            lm, api.init_params(lm, device="cpu"), batch=1, max_len=8),
        "token_serving_summary": lambda: token_serving_summary(),
        "token_launcher": lambda: main(["--arch", "zamba2-1.2b"]),
        "foldlint": lambda: foldlint.main(["--model", "vgg16"]),
        "chaos_summary": lambda: chaos_summary("vgg16", profile="mixed",
                                               seed=0),
        "chaos_launcher": lambda: main(["--vision", "--chaos", "0"]),
        "obs_report": lambda: report.main(["--model", "vgg16"]),
        "autotune": lambda: autotune_schedule(ConvLoopNest(
            n=1, nf=8, c=4, r=3, s=3, x=8, y=8, stride=1, pad=1)),
        "trainer": lambda: Trainer(lm, TrainerConfig(total_steps=1)),
        "train_launcher": lambda: train_main(["--arch", "zamba2-1.2b",
                                              "--steps", "1"]),
        "elastic_example": lambda: elastic.main([]),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


@pytest.mark.parametrize("mesh", ["1x1", "2x1", "production"])
def test_make_local_mesh_without_a_gpu_raises_and_starts_nothing(mesh):
    """A mesh on the card without a card raises before any process group
    starts: nothing falls back to gloo on the CPU (a planning mesh needs
    no device and builds)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: nothing to refuse")
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
    if mesh == "production":
        assert make_production_mesh().device_mesh is None
    else:
        data, model = (int(t) for t in mesh.split("x"))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_local_mesh(data, model)
    assert not dist.is_initialized()


def test_chip_smoke_refuses_to_run_without_a_gpu(tmp_path):
    """Without a card the script exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_fold_tiles_refuses_to_run_without_a_gpu(tmp_path):
    """The per-layer timing script exits non-zero without a card and
    prints no summary."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    out = subprocess.run([sys.executable, str(ROOT / "fold_tiles.py")],
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert out.returncode != 0
    assert '"card"' not in out.stdout


def test_kernel_ab_refuses_to_run_without_a_gpu(tmp_path):
    """The same-card A/B script exits non-zero without a card and prints
    no time."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    out = subprocess.run([sys.executable, str(ROOT / "kernel_ab.py"),
                          str(ROOT), "change"], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert "KAB" not in out.stdout
