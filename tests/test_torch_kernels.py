"""The plain versions of the port's CUDA kernels vs the Pallas
kernels they replace (interpret mode, as the JAX package's own tests run
them on the CPU), the wrappers' input checks, and (on a machine with a GPU
only) each CUDA kernel vs its plain version.

JAX is imported inside the tests that compare with it, so the GPU tests
also run where JAX is absent:
``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``."""

import numpy as np
import pytest
import torch

from tdnet_torch.ops.block import fused_bottleneck_chain, fused_bottleneck_chain_plain
from tdnet_torch.ops.ingest import normalize_uint8_rows, normalize_uint8_rows_plain
from tdnet_torch.ops.nms_kernel import nms_keep, nms_keep_plain
from tdnet_torch.ops.soft_nms import soft_nms_rescore_batched, soft_nms_rescore_plain
from tdnet_torch.ops.stem import fused_stem_packed, fused_stem_plain

torch.set_num_threads(1)  # tier-1 runs several xdist workers


def _np(x):
    """jax or torch array -> float32 numpy (bf16 widens exactly)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype("float32"))


def _bf16_ulp(v):
    """Spacing of the bf16 grid at |v| (8 significant bits)."""
    a = np.maximum(np.abs(v), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(a)) - 7).astype(np.float32)


def _assert_within_one_bf16_ulp(got, want):
    """|got - want| <= 1 bf16 ulp of the larger magnitude, or <= 1e-5: the
    f32 conv sums (147 products of O(1) terms) differ in order by ~1e-6, so
    a value that BN leaves near zero, where a bf16 ulp is finer than that,
    can move by more than its own ulp."""
    d = np.abs(got - want)
    ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    assert np.all((d <= ulp) | (d <= 1e-5)), float(d.max())


def _stem_params(seed):
    r = np.random.RandomState(seed)
    k7 = r.normal(0, 0.1, (7, 7, 3, 64)).astype(np.float32)
    scale = r.uniform(0.5, 1.5, 64).astype(np.float32)
    bias = r.normal(0, 0.1, 64).astype(np.float32)
    mean = r.normal(0, 0.5, 64).astype(np.float32)
    var = r.uniform(0.5, 2.0, 64).astype(np.float32)
    inv = (1.0 / np.sqrt(var + np.float32(1e-5)) * scale).astype(np.float32)
    off = (bias - mean * inv).astype(np.float32)
    return k7, inv, off


def _clustered_boxes(rng, rows, k, span=40.0):
    """Score-sorted rows of heavily overlapping boxes: suppression chains
    cross the 128-box tile edge."""
    b = rng.uniform(0, span, (rows, k, 4)).astype(np.float32)
    b[..., 2:] = b[..., :2] + rng.uniform(3, 25, (rows, k, 2)).astype(np.float32)
    return b


# ---------------------------------------------------------------- ingest


@pytest.mark.parametrize("mode", ["caffe", "tf"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", [3072, 192 * 3])
def test_plain_ingest_equals_pallas_interpret(mode, dtype, width):
    """Exact: one subtract and one multiply in f32, then one rounding."""
    jnp = pytest.importorskip("jax.numpy")
    from tdnet.ops.pallas_ingest import normalize_uint8_rows as ref

    x = np.random.RandomState(0).randint(0, 256, (300, width)).astype(np.uint8)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = ref(jnp.asarray(x), mode=mode, out_dtype=jdt, interpret=True)
    got = normalize_uint8_rows_plain(torch.from_numpy(x), mode, tdt)
    assert got.dtype == tdt
    np.testing.assert_array_equal(_np(got), _np(want))
    # the wrapper on a CPU tensor is the plain version
    assert torch.equal(normalize_uint8_rows(torch.from_numpy(x), mode, tdt), got)


# ---------------------------------------------------------------- stem


@pytest.mark.parametrize("mode,hw,b", [("caffe", (32, 64), 2), ("tf", (40, 48), 1)])
def test_plain_stem_f32_matches_pallas_interpret(mode, hw, b):
    """f32: rtol 2e-5, atol 2e-3 (tests/ops/test_pallas_stem.py's bound:
    the conv sums 147 products in another order)."""
    jnp = pytest.importorskip("jax.numpy")
    from tdnet.ops.pallas_stem import fused_stem_packed as ref

    h, w = hw
    k7, inv, off = _stem_params(1)
    x8 = np.random.RandomState(2).randint(0, 256, (b, h, w * 3)).astype(np.uint8)
    want = ref(jnp.asarray(x8), jnp.asarray(k7), jnp.asarray(inv),
               jnp.asarray(off), normalize=mode, out_dtype=jnp.float32,
               interpret=True)
    got = fused_stem_plain(torch.from_numpy(x8), torch.from_numpy(k7),
                           torch.from_numpy(inv), torch.from_numpy(off),
                           normalize=mode, out_dtype=torch.float32)
    assert tuple(got.shape) == (b, h // 4, w // 4, 64) == want.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-3)


@pytest.mark.parametrize("mode", ["caffe", "tf"])
def test_plain_stem_bf16_within_one_ulp(mode):
    """bf16: the f32 conv sums differ in order, so a value near a rounding
    boundary may round to the neighbouring bf16 (see the helper)."""
    jnp = pytest.importorskip("jax.numpy")
    from tdnet.ops.pallas_stem import fused_stem_packed as ref

    k7, inv, off = _stem_params(3)
    x8 = np.random.RandomState(4).randint(0, 256, (2, 32, 64 * 3)).astype(np.uint8)
    want = _np(ref(jnp.asarray(x8), jnp.asarray(k7), jnp.asarray(inv),
                   jnp.asarray(off), normalize=mode, out_dtype=jnp.bfloat16,
                   interpret=True))
    got = fused_stem_plain(torch.from_numpy(x8), torch.from_numpy(k7),
                           torch.from_numpy(inv), torch.from_numpy(off),
                           normalize=mode, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = _np(got)
    _assert_within_one_bf16_ulp(got, want)
    assert np.mean(got == want) > 0.99


# ---------------------------------------------------------------- nms


@pytest.mark.parametrize("kernel", ["pallas_nms_keep", "pallas_nms_keep_rows"])
def test_plain_nms_equals_pallas_interpret(kernel):
    """K=256 (two TPU tiles, cross-tile suppression) with invalid slots
    scattered through the rows: the keep masks are equal."""
    jnp = pytest.importorskip("jax.numpy")
    import tdnet.ops.pallas_nms as pn

    rng = np.random.RandomState(5)
    boxes = _clustered_boxes(rng, 3, 256)
    valid = rng.uniform(size=(3, 256)) > 0.2
    valid[2, 200:] = False  # a ragged tail of invalid slots
    want = np.asarray(getattr(pn, kernel)(jnp.asarray(boxes), jnp.asarray(valid),
                                          iou_threshold=0.5, interpret=True))
    got = nms_keep_plain(torch.from_numpy(boxes), torch.from_numpy(valid), 0.5)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < valid.sum()  # something kept, something suppressed
    assert torch.equal(nms_keep(torch.from_numpy(boxes),
                                torch.from_numpy(valid), 0.5), got)


# ---------------------------------------------------------------- checks


def test_wrappers_reject_bad_inputs():
    u8 = torch.zeros((4, 3072), dtype=torch.uint8)
    with pytest.raises(TypeError, match="uint8"):
        normalize_uint8_rows(u8.float())
    with pytest.raises(ValueError, match="W3 % 3"):
        normalize_uint8_rows(torch.zeros((4, 100), dtype=torch.uint8))
    with pytest.raises(ValueError, match="contiguous"):
        normalize_uint8_rows(torch.zeros((6, 8), dtype=torch.uint8).t())
    with pytest.raises(TypeError, match="out_dtype"):
        normalize_uint8_rows(u8, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="mode"):
        normalize_uint8_rows(u8, mode="torch")

    k7, inv, off = (torch.from_numpy(a) for a in _stem_params(0))
    packed = torch.zeros((1, 32, 64 * 3), dtype=torch.uint8)
    with pytest.raises(TypeError, match="uint8"):
        fused_stem_packed(packed.float(), k7, inv, off)
    with pytest.raises(ValueError, match="unsupported packed stem shape"):
        fused_stem_packed(torch.zeros((1, 36, 64 * 3), dtype=torch.uint8),
                          k7, inv, off)
    with pytest.raises(ValueError, match="contiguous"):
        fused_stem_packed(packed, k7.transpose(0, 1), inv, off)
    with pytest.raises(ValueError, match="kernel7"):
        fused_stem_packed(packed, k7[..., :32], inv, off)
    with pytest.raises(TypeError, match="out_dtype"):
        fused_stem_packed(packed, k7, inv, off, out_dtype=torch.float16)

    boxes = torch.zeros((2, 8, 4))
    valid = torch.ones((2, 8), dtype=torch.bool)
    with pytest.raises(TypeError, match="float32"):
        nms_keep(boxes.double(), valid)
    with pytest.raises(TypeError, match="bool"):
        nms_keep(boxes, valid.int())
    with pytest.raises(ValueError, match="does not match"):
        nms_keep(boxes, valid[:, :4])
    with pytest.raises(ValueError, match="contiguous"):
        nms_keep(boxes.transpose(0, 1), valid.t())


# ---------------------------------------------------------------- on a GPU


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["caffe", "tf"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ingest_equals_plain(cuda, mode, dtype):
    """Bit for bit, including a ragged tail."""
    x = torch.from_numpy(np.random.RandomState(6).randint(
        0, 256, (37, 3072 + 3 * 5)).astype(np.uint8)).to(cuda)
    got = normalize_uint8_rows(x, mode, dtype)
    want = normalize_uint8_rows_plain(x, mode, dtype)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw", [(64, 128), (40, 200)])
def test_cuda_stem_equals_plain(cuda, dtype, hw):
    """f32: rtol 2e-5, atol 2e-3; bf16: within 1 bf16 ulp (or 1e-5)."""
    h, w = hw
    k7, inv, off = (torch.from_numpy(a).to(cuda) for a in _stem_params(7))
    x = torch.from_numpy(np.random.RandomState(8).randint(
        0, 256, (3, h, w * 3)).astype(np.uint8)).to(cuda)
    got = fused_stem_packed(x, k7, inv, off, "caffe", dtype).float().cpu().numpy()
    want = fused_stem_plain(x, k7, inv, off, "caffe", dtype).float().cpu().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-3)
    else:
        _assert_within_one_bf16_ulp(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1024, 1000, 200, 64, 2112])
def test_cuda_nms_equals_plain(cuda, k):
    """K of whole and ragged 64-box words, and above 2048 (two removed
    words a lane in the scan)."""
    rng = np.random.RandomState(9)
    boxes = torch.from_numpy(_clustered_boxes(rng, 5, k, span=200.0)).to(cuda)
    valid = torch.from_numpy(rng.uniform(size=(5, k)) > 0.1).to(cuda)
    assert torch.equal(nms_keep(boxes, valid, 0.5),
                       nms_keep_plain(boxes, valid, 0.5))


@pytest.mark.cuda
def test_cuda_nms_and_soft_nms_limit_k(cuda):
    boxes = torch.zeros((1, 14337, 4), device=cuda)
    with pytest.raises(ValueError, match="limit"):
        nms_keep(boxes, torch.ones((1, 14337), dtype=torch.bool, device=cuda))
    boxes = torch.zeros((1, 14497, 4), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        soft_nms_rescore_batched(boxes, torch.ones((1, 14497), device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["gaussian", "linear"])
@pytest.mark.parametrize("k", [1024, 2000])
def test_cuda_soft_nms_equals_plain(cuda, method, k):
    """rtol 1e-5, atol 1e-6 (the reference's bound); the same boxes are
    selected in every row; a row of exact duplicates stays finite. K 2000
    takes two candidates a thread."""
    rng = np.random.RandomState(10)
    boxes = _clustered_boxes(rng, 6, k, span=200.0)
    boxes[5, k // 2:] = boxes[5, :k // 2]  # exact duplicates (IoU 1)
    scores = rng.uniform(0, 1, (6, k)).astype(np.float32)
    scores[5, k // 2:] = scores[5, :k // 2]
    scores[:, -100:] = 0.0  # the below-threshold tail
    b, s = torch.from_numpy(boxes).to(cuda), torch.from_numpy(scores).to(cuda)
    kw = dict(method=method, sigma=0.5, iou_threshold=0.3, max_selections=300)
    got = soft_nms_rescore_batched(b, s, **kw).cpu().numpy()
    want = soft_nms_rescore_plain(b, s, **kw).cpu().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got > 0, want > 0)


def _block_inputs(cuda, dtype, depth, h, w, c, m):
    rng = np.random.RandomState(11)
    f = lambda *shape, s=1.0: torch.from_numpy(
        (rng.standard_normal(shape) * s).astype(np.float32)).to(cuda)
    u = lambda *shape: torch.from_numpy(
        rng.uniform(0.5, 1.5, shape).astype(np.float32)).to(cuda)
    x = f(2, h, w, c).to(dtype)
    args = (f(depth, c, m, s=c ** -0.5), f(depth, 3, 3, m, m, s=(9 * m) ** -0.5),
            f(depth, m, c, s=0.5 * m ** -0.5), u(depth, m), f(depth, m, s=0.1),
            u(depth, m), f(depth, m, s=0.1), u(depth, c), f(depth, c, s=0.1))
    return x, args


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,depth,h,w,c,m", [
    (torch.float32, 2, 20, 24, 64, 8), (torch.float32, 1, 13, 16, 256, 64),
    (torch.float32, 2, 8, 16, 512, 128), (torch.bfloat16, 1, 20, 24, 128, 32),
    (torch.bfloat16, 1, 13, 16, 256, 64), (torch.bfloat16, 1, 8, 16, 512, 128)])
def test_cuda_block_chain_equals_plain(cuda, dtype, depth, h, w, c, m):
    """f32 (TF32 off, the CUDA-core body): a chain within rtol = atol =
    3e-5. bf16 (the tensor-core body): one block, held to chip_smoke.py's
    BLOCK_BF16_LIMITS: >= 99% of the outputs within 1 bf16 ulp (a t1 or t2
    rounding on the other side of a bf16 boundary moves the rest of its
    pixel), none beyond 2 ulp of max(|v|, 1), relative Frobenius <= 1e-3."""
    x, args = _block_inputs(cuda, dtype, depth, h, w, c, m)
    torch.backends.cuda.matmul.allow_tf32 = False
    got = fused_bottleneck_chain(x, *args).float().cpu().numpy()
    want = fused_bottleneck_chain_plain(x, *args).float().cpu().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5)
        return
    _assert_bf16_block_limits(got, want)


def _assert_bf16_block_limits(got, want):
    d = np.abs(got - want)
    big = np.maximum(np.abs(got), np.abs(want))
    within = (d <= _bf16_ulp(big)) | (d <= 1e-5)
    assert within.mean() >= 0.99, within.mean()
    assert (d / _bf16_ulp(np.maximum(big, 1.0))).max() <= 2.0
    assert np.linalg.norm(got - want) <= 1e-3 * np.linalg.norm(want)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c,m,tile_h,pass_n", [
    (1, 20, 24, 128, 32, 16, 32), (3, 13, 16, 256, 64, 16, 64),
    (2, 9, 16, 2048, 512, 8, 128), (16, 32, 32, 2048, 512, 8, 128)])
def test_cuda_block_bf16_tiles_and_reruns(cuda, b, h, w, c, m, tile_h, pass_n):
    """The bf16 kernel's launch (tile height, pass width, one block an SM,
    a persistent grid no larger than the tiles) at ragged heights and at
    config 4's stage 5 (256 tiles: the grid wraps), two runs on the same
    input bit-equal (tiles in a fixed order), the same output from weights
    laid out by the caller (``kmajor``), and BLOCK_BF16_LIMITS against the
    plain version."""
    from tdnet_torch.ops.block import kmajor_weights, launch_info

    info = launch_info(b, h, w, c, m)
    assert (info["tile_h"], info["pass_n"]) == (tile_h, pass_n), info
    assert info["tiles"] == b * (w // 8) * -(-h // tile_h)
    assert 1 <= info["grid"] <= info["tiles"] and info["smem_bytes"] <= 232448
    x, args = _block_inputs(cuda, torch.bfloat16, 1, h, w, c, m)
    x = x[:1].expand(b, h, w, c).contiguous()
    first = fused_bottleneck_chain(x, *args)
    assert torch.equal(first, fused_bottleneck_chain(x, *args))
    assert torch.equal(first, fused_bottleneck_chain(x, *args, kmajor=kmajor_weights(*args[:3])))
    assert torch.equal(first[0], first[-1])  # each image alone, whatever its tiles' blocks
    want = fused_bottleneck_chain_plain(x[:1], *args).float().cpu().numpy()
    _assert_bf16_block_limits(first[:1].float().cpu().numpy(), want)


@pytest.mark.cuda
def test_cuda_block_bf16_kmajor_layout_checked(cuda):
    """Weights passed as ``kmajor`` in another layout raise."""
    from tdnet_torch.ops.block import kmajor_weights

    x, args = _block_inputs(cuda, torch.bfloat16, 1, 16, 16, 128, 32)
    k1, k2, k3 = kmajor_weights(*args[:3])
    for bad in ((k1.transpose(1, 2), k2, k3), (k1, k2.float(), k3), (k1, k2, k3.cpu())):
        with pytest.raises(ValueError, match="kmajor"):
            fused_bottleneck_chain(x, *args, kmajor=bad)


@pytest.mark.cuda
def test_cuda_block_bf16_needs_m_multiple_of_32(cuda):
    """The bf16 kernel runs on the tensor cores only: M 8 raises on CUDA
    (the plain version on the CPU takes it)."""
    x, args = _block_inputs(cuda, torch.bfloat16, 1, 16, 16, 64, 8)
    with pytest.raises(ValueError, match="M % 32"):
        fused_bottleneck_chain(x, *args)


@pytest.mark.cuda
def test_cuda_predictor_block_opt_in(cuda, monkeypatch):
    """TDNET_BLOCK_KERNEL=1: a CUDA Predictor's calls launch the block
    kernel, and the caller's model keeps block_kernel off."""
    from tdnet_torch.models.retinanet import RetinaNet
    from tdnet_torch.ops import block
    from tdnet_torch.train.predictor import Predictor
    from tdnet_torch.weights import random_variables

    monkeypatch.setenv("TDNET_BLOCK_KERNEL", "1")
    model = RetinaNet(1)
    pred = Predictor(model, random_variables(1, "resnet50", seed=0), device=cuda,
                     min_side=128, max_side=128)
    page = np.random.RandomState(0).randint(0, 256, (120, 128, 3)).astype(np.uint8)
    block.LAUNCHES.reset()
    pred.predict_batch([page])
    assert block.LAUNCHES.count > 0
    assert model.backbone.block_kernel is False
