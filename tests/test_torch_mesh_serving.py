"""The port's ``VisionEngine`` on a mesh, on the CPU: two gloo ranks in
spawned processes (``tests/torch_mesh_ranks.py``, one run for the file,
under a timeout) serve one request stream on 2x1 and 1x2 meshes, and
four serve it on 2x2.  Each rank's logits against the single-rank engine
of its own process: bitwise for VGG-16 (fp32 and bf16: the plain fold
loop sums each output in one order whatever the batch rows and the
filter slice), within 1e-6 of max|ref| for MobileNetV2, whose 1x1 convs'
plain einsums on a filter slice may sum in another order on the CPU.
The logits also within 1e-4·max of the JAX package's ``policy=
"reference"`` engine on the same weights (the JAX package's own mesh
test does not run under this jax, so it is not the oracle).  Also the
bucket widths rounded to the data axis (``BucketPolicy.aligned``, the
JAX package's, on the mesh widths), ``metrics_dict()["mesh"]``, and the
filter split: every conv of VGG-16 on the model axis, MobileNetV2's
convs that keep two groups a rank."""
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.models import zoo as j_zoo  # noqa: E402
from repro.serve import batcher as j_batcher  # noqa: E402
from repro.serve import vision as j_vision  # noqa: E402
from repro_torch.serve import batcher as t_batcher  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
IMG, WIDTH = 32, 0.0625
SIZES = (1, 3, 2, 4, 1, 2)        # requests of a stream over buckets (2, 4)
REL_MOBILENET = 1e-6               # sliced plain einsums on the CPU
REL_JAX = 1e-4                     # port vs the JAX reference engine
MODELS = ("vgg16_float32", "vgg16_bfloat16", "mobilenetv2_float32")
RANK_TIMEOUT_S = 240


def _images():
    rng = np.random.default_rng(5)
    return [rng.standard_normal((n, 3, IMG, IMG)).astype(np.float32)
            for n in SIZES]


def _jax_params(model):
    return j_zoo.get_conv_model(model).init_params(
        jax.random.PRNGKey(3), width_mult=WIDTH, img=IMG, classes=10)


def run_ranks(world: int, d: pathlib.Path, cases: str, arrays=None):
    """Write the inputs, run ``world`` gloo ranks on ``cases``
    (``tests/torch_mesh_ranks.py``), return their results."""
    arrays = dict(arrays or {})
    arrays.update({f"img{i:02d}": im for i, im in enumerate(_images())})
    np.savez(d / "inputs.npz", **arrays)
    for model in ("vgg16", "mobilenetv2"):
        flat = {f"{k}/{leaf}": np.asarray(v) for k, entry in
                _jax_params(model).items() for leaf, v in entry.items()}
        np.savez(d / f"params_{model}.npz", **flat)
    out = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_mesh_ranks.py"),
         str(world), str(d), cases], capture_output=True, text=True,
        timeout=RANK_TIMEOUT_S, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return run_ranks(2, tmp_path_factory.mktemp("mesh2"), "serve")


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return run_ranks(4, tmp_path_factory.mktemp("mesh4"), "serve")


@pytest.fixture(scope="module")
def jax_logits():
    """The JAX package's reference engine over the same stream, per
    model (fp32 weights; the bf16 case is held to the fp32 reference
    with bf16's tolerance)."""
    out = {}
    for model in ("vgg16", "mobilenetv2"):
        spec = j_zoo.get_conv_model(model)
        eng = j_vision.VisionEngine(_jax_params(model), spec.to_graph(),
                                    img=IMG, policy="reference",
                                    buckets=(2, 4))
        reqs = [eng.submit(im) for im in _images()]
        eng.run()
        out[model] = np.concatenate([np.asarray(r.logits) for r in reqs])
    return out


def _check(got, want, model):
    if model.startswith("vgg16"):
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= \
            REL_MOBILENET * np.abs(want).max()


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("shape", ["2x1", "1x2"])
@pytest.mark.parametrize("model", MODELS)
def test_two_rank_mesh_equals_the_single_rank_engine(two_ranks, model,
                                                    shape, rank):
    r = two_ranks[rank]
    got, want = r[f"{model}_{shape}"], r[f"{model}_alone"]
    assert got.shape == (sum(SIZES), 10)
    _check(got, want, model)
    assert tuple(r[f"{model}_{shape}_mesh"]) == tuple(
        int(t) for t in shape.split("x"))


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
@pytest.mark.parametrize("model", MODELS)
def test_two_by_two_mesh_equals_the_single_rank_engine(four_ranks, model,
                                                      rank):
    r = four_ranks[rank]
    _check(r[f"{model}_2x2"], r[f"{model}_alone"], model)


@pytest.mark.parametrize("shape", ["2x1", "1x2"])
@pytest.mark.parametrize("model", MODELS)
def test_mesh_logits_match_the_jax_reference_engine(two_ranks, jax_logits,
                                                    model, shape):
    got = two_ranks[0][f"{model}_{shape}"]
    want = jax_logits[model.split("_")[0]]
    # bf16 weights and activations against the fp32 reference: bf16's
    # rounding over the network, the tolerance of tests/test_torch_bf16.py
    rel = 3e-2 if model.endswith("bfloat16") else REL_JAX
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


@pytest.mark.parametrize("shape,widths", [("2x1", [2, 4]),
                                          ("1x2", [2, 4])])
def test_buckets_round_to_the_data_axis(two_ranks, shape, widths):
    assert list(two_ranks[0][f"vgg16_float32_{shape}_buckets"]) == widths


@pytest.mark.parametrize("multiple", [1, 2, 3, 4, 16])
@pytest.mark.parametrize("widths", [(1, 2, 4, 8), (1, 3, 5), (2, 4), (7,)])
def test_bucket_policy_aligned_matches_jax(widths, multiple):
    got = t_batcher.BucketPolicy(widths).aligned(multiple).widths
    want = j_batcher.BucketPolicy(widths).aligned(multiple).widths
    assert tuple(got) == tuple(want)


def test_vgg16_splits_every_conv_on_the_model_axis(two_ranks):
    assert int(two_ranks[0]["vgg16_float32_1x2_split"]) == 13
    assert int(two_ranks[0]["vgg16_float32_2x1_split"]) == 0


def test_mobilenet_splits_the_convs_that_keep_two_groups(two_ranks):
    from repro_torch.core.graph import DEPTHWISE
    from repro_torch.models import mobilenet
    params = mobilenet.init_params(torch.Generator(), width_mult=WIDTH,
                                   img=IMG, device="meta")
    want = 0
    for nd in mobilenet.to_graph().nodes:
        if nd.op != "conv":
            continue
        nf = params[nd.param]["w"].shape[0]
        groups = nf if nd.groups == DEPTHWISE else nd.groups
        want += nf % 2 == 0 and (groups == 1 or groups // 2 >= 2)
    assert int(two_ranks[0]["mobilenetv2_float32_1x2_split"]) == want > 0
