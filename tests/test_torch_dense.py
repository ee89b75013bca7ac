"""The port's dense head against the JAX package's: the plain version
against ``x @ w + b`` in jax.numpy, and the invariant the head exists for —
row ``i`` gives the same bits at every batch width — on the CPU; on a card,
the CUDA kernel against its plain version, bitwise across batch widths."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import dense as t_dense  # noqa: E402

# (K, N): VGG-16's fc layers at width 0.0625 and 32x32, the zoo's heads
# at that width (ResNet-18 and MobileNetV2, 10 classes), a ragged N
SHAPES = [(32, 256), (256, 256), (256, 10), (32, 10), (80, 10), (300, 13)]
# VGG-16's fc shapes at full width and 224x224, and the zoo heads at full
# width and 32x32; a single-chunk layer (one group: its CTA stores the
# outputs with no ticket taken)
CARD_SHAPES = [(25088, 4096), (4096, 4096), (4096, 1000), (512, 4096),
               (512, 10), (1280, 10), (300, 13), (32, 256)]


def _operands(b, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((b, k)) / np.sqrt(k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


@pytest.mark.parametrize("k,n", SHAPES)
def test_plain_dense_matches_reference_package(k, n):
    """``dense_plain`` against the JAX package's dense (``x @ w + b`` in
    jax.numpy, what its compiled forward runs): within 1e-6 of max|ref|
    (fp32, two sum orders)."""
    jnp = pytest.importorskip("jax.numpy")
    x, w, b = _operands(5, k, n)
    want = np.asarray(jnp.asarray(x) @ jnp.asarray(w) + jnp.asarray(b))
    got = t_dense.dense(*(torch.from_numpy(a) for a in (x, w, b))).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("k,n", SHAPES)
def test_plain_dense_rows_bitwise_across_batch_widths(k, n):
    """Row i of a batch of 8 equals row i of every narrower batch, bit for
    bit: the bucket a request is padded to changes none of its logits."""
    x, w, b = (torch.from_numpy(a) for a in _operands(8, k, n, seed=1))
    full = t_dense.dense(x, w, b)
    for rows in range(1, 8):
        assert torch.equal(t_dense.dense(x[:rows], w, b), full[:rows])


def test_k_chunk_depends_on_the_layer_alone():
    """The kernel's K chunk (its sum order) is a function of (K, N): a
    multiple of 8 taps within the kernel's limits, and the chunks cover K
    in at most 128 chunks (16 group sums for the last CTA to add)."""
    for k, n in SHAPES + CARD_SHAPES:
        kc = t_dense.k_chunk(k, n)
        assert kc % 8 == 0 and 32 <= kc <= 448
        assert -(-k // kc) * kc >= k
        assert -(-k // kc) <= 128
    # fc1 at 224 (K 25088) runs about 64 chunks: about 2048 warps share
    # its 411 MB of weights
    kc = t_dense.k_chunk(25088, 4096)
    assert 450 <= 8 * -(-25088 // kc) <= 560


@pytest.mark.parametrize("model", ["vgg16", "resnet18", "mobilenetv2"])
def test_no_recipe_scale_comes_from_a_dense_output(model):
    """The int8 calibration keeps ``torch.matmul`` for dense layers: no
    activation scale is read downstream of a dense output (scales are
    read at conv inputs, and no conv follows a dense layer), so the head's
    sum order cannot move a recipe."""
    from repro_torch.core.quant import default_recipe
    from repro_torch.models import zoo
    spec = zoo.get_conv_model(model)
    graph = spec.to_graph()
    after_dense = set()
    for nd in graph.nodes:
        srcs = set(nd.all_inputs())
        if nd.op == "dense" or srcs & after_dense:
            after_dense.add(nd.name)
    convs = {nd.name for nd in graph.nodes if nd.op == "conv"}
    assert after_dense and not convs & after_dense
    params = spec.init_params(torch.Generator().manual_seed(0),
                              width_mult=0.0625, img=32, classes=10,
                              device="cpu")
    recipe = default_recipe(graph, params, (2, 3, 32, 32), device="cpu")
    assert set(recipe.act_scales) == convs


def test_dense_refuses_a_mismatched_shape():
    x, w, b = (torch.from_numpy(a) for a in _operands(2, 16, 4))
    with pytest.raises(ValueError, match="dense takes"):
        t_dense.dense(x, w[:8], b)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the head kernel is CUDA-only")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", CARD_SHAPES)
def test_cuda_dense_kernel_matches_plain_version(cuda_device, k, n):
    """The head kernel against its plain version within 1e-5·max|plain|
    (fp32, chunked against unchunked sums), and row i bitwise equal at
    batch widths 1 to 11 (more than one 8-row tile)."""
    x, w, b = (torch.from_numpy(a).to(cuda_device)
               for a in _operands(11, k, n, seed=2))
    before = t_dense.launch_counts()[t_dense.KERNEL]
    full = t_dense.dense(x, w, b)
    torch.cuda.synchronize()
    assert t_dense.launch_counts()[t_dense.KERNEL] == before + 1
    want = t_dense.dense_plain(x, w, b)
    assert full.shape == want.shape
    assert (full - want).abs().max().item() <= \
        1e-5 * want.abs().max().item()
    for rows in range(1, 11):
        assert torch.equal(t_dense.dense(x[:rows], w, b), full[:rows])


def test_bf16_k_chunk_is_a_function_of_the_layer_alone():
    """The bf16 instance's K chunk (its sum order) depends on (K, N) alone:
    its launches at batch 1 to 8 run one chunking (the same K chunk, the
    same groups of chunks, the fp32 instance's), a multiple of 8 taps
    within the kernel's limits, while its CTAs' columns (256 bf16, 16
    bytes a lane) and the rows a CTA keeps follow the instance (1, 2, 4,
    4, 8, 8, 8, 8 rows at batch 1 to 8; a ninth row takes a second row
    tile)."""
    bf16 = torch.bfloat16
    for k, n in SHAPES + CARD_SHAPES:
        kc = t_dense.k_chunk(k, n)
        assert kc % 8 == 0 and 32 <= kc <= 448
        assert -(-k // kc) <= 128
        grids = [t_dense.launch_grid(rows, k, n, bf16) for rows in range(1, 9)]
        assert {g[:2] for g in grids} == {grids[0][:2]}
        assert grids[0][1] == -(-(-(-k // kc)) // 8)
        assert [g[2] for g in grids] == [1] * 8
        assert t_dense.launch_grid(9, k, n, bf16)[2] == 2
    assert [t_dense.rows_per_cta(r, bf16) for r in range(1, 12)] == \
        [1, 2, 4, 4, 8, 8, 8, 8, 8, 8, 8]
    assert {t_dense.rows_per_cta(r) for r in range(1, 12)} == {8}
    # fc1 at 224: 16 column tiles of 256 bf16 columns (32 of 128 fp32
    # ones) over its 64 chunks of 392 taps
    assert t_dense.k_chunk(25088, 4096) == 392
    assert t_dense.launch_grid(1, 25088, 4096, bf16) == (16, 8, 1)
    assert t_dense.launch_grid(1, 25088, 4096) == (32, 8, 1)
    assert t_dense.launch_grid(8, 300, 13, bf16)[0] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", CARD_SHAPES)
def test_cuda_bf16_head_at_every_row_instance(cuda_device, k, n):
    """The bf16 head kernel at batch 1, 2, 4 and 8 (its instances of 1, 2,
    4 and 8 rows a CTA) against ``dense_plain``, and row i bitwise equal at
    every width.  Both round the product to bf16 before the bias is added:
    where their fp32 sums (chunked, unchunked) fall on two sides of a
    rounding boundary of the product, the outputs differ by a bf16 step of
    the product, not of the output.  So each element is held within one
    bf16 step of the product and one of the output, plus
    1e-4·max(1, max|plain|)."""
    bf16 = torch.bfloat16
    x, w, b = (torch.from_numpy(a).to(cuda_device, bf16)
               for a in _operands(8, k, n, seed=3))
    prod = (x.float() @ w.float()).abs()
    full = t_dense.dense(x, w, b)
    for rows in (1, 2, 4, 8):
        before = t_dense.launch_counts()[t_dense.KERNEL_BF16]
        got = t_dense.dense(x[:rows], w, b)
        torch.cuda.synchronize()
        assert t_dense.launch_counts()[t_dense.KERNEL_BF16] == before + 1
        want = t_dense.dense_plain(x[:rows], w, b).float()
        assert got.dtype == bf16 and got.shape == want.shape
        assert ((got.float() - want).abs() <= 2.0 ** -7 * (
            want.abs() + prod[:rows])
            + 1e-4 * max(1.0, want.abs().max().item())).all()
        assert torch.equal(got, full[:rows])
