"""The whole slice on the CPU: tdnet_torch's Predictor (uint8 pages ->
fused stem (plain version) -> ResNet-50 RetinaNet -> deferred tail with the
plain NMS -> host rescale) vs tdnet's Predictor on the same pages and
variables, plus the port Predictor's routes, padding and counters."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdnet_torch.data.image import compute_resize_scale
from tdnet_torch.models.retinanet import RetinaNet
from tdnet_torch.train.predictor import Predictor
from tdnet_torch.weights import random_variables

torch.set_num_threads(1)  # tier-1 runs several xdist workers

BUCKETS = [(64, 128), (128, 64)]
KW = dict(min_side=64, max_side=96, buckets=BUCKETS, score_threshold=0.05)


@pytest.fixture(scope="module")
def variables():
    """Random ResNet-50 variables whose class head spreads the logits over
    O(1) (kernel x30, bias -2), so most anchors pass the 0.05 threshold,
    NMS suppresses, and scores are far apart compared with the float noise
    between the two frameworks."""
    v = random_variables(1, "resnet50", seed=0)
    v["params"]["classification_submodel"]["head"]["kernel"] *= 30.0
    v["params"]["classification_submodel"]["head"]["bias"][:] = -2.0
    return v


@pytest.fixture(scope="module", autouse=True)
def _drop_compiled_executables():
    """The ResNet-50 executables compiled here are not reused elsewhere; the
    tier-1 workers run hundreds of tests each and their memory adds up."""
    yield
    import jax

    jax.clear_caches()


def _pages(n, seed, scale_one=True):
    """Float32 BGR pages; with scale_one their resize scale is exactly 1.0
    (min side 64, max side 96), so the device path is what is compared."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        if scale_one:
            h, w = (64, 96) if i % 3 else (96, 64)
        else:
            h, w = (70, 100) if i % 3 else (100, 70)
        out.append(rng.uniform(0, 255, (h, w, 3)).astype(np.float32))
    return out


def test_slice_matches_jax_predictor(variables):
    """Port Predictor (CPU, f32, uint8 pages through the fused stem) vs
    tdnet's Predictor(fused_stem=True, use_pallas=False,
    device_preprocess=True), whose stem runs the Pallas kernel in interpret
    mode. Tolerances are those of tests/train/test_predictor_batch.py's
    fused-stem test: scores rtol/atol 1e-3, boxes rtol 1e-3 + atol 0.5 px,
    labels exact, on detections clear of the threshold."""
    import jax

    from tdnet.models.retinanet import RetinaNet as FlaxRetinaNet
    from tdnet.train.predictor import Predictor as JaxPredictor

    pages = _pages(4, seed=11)
    ref = JaxPredictor(FlaxRetinaNet(num_classes=1, dtype=jnp.float32),
                       jax.tree.map(jnp.asarray, variables), fused_stem=True,
                       use_pallas=False, device_preprocess=True, batch_size=4,
                       **KW)
    port = Predictor(RetinaNet(1), variables, device="cpu",
                     device_preprocess=True, fused_stem=True, **KW)
    assert port.fused_stem
    want = ref.predict_batch(pages)
    got = port.predict_batch(pages)
    n_compared = 0
    for (rb, rs, rl), (gb, gs, gl) in zip(want, got):
        clear = rs > 0.06  # clear of the 0.05 threshold
        n_compared += int(clear.sum())
        np.testing.assert_array_equal(gl[clear], rl[clear])
        np.testing.assert_allclose(gs[clear], rs[clear], rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(gb[clear], rb[clear], rtol=1e-3, atol=0.5)
    assert n_compared > 100


def test_routes_agree_and_counters(variables):
    """The fused-stem, flat-normalize and host-float routes give the same
    detections (f32, CPU); sub-batches are padded to a power of two; the
    host/dispatch counters advance; boxes come back in page coordinates."""
    pages = _pages(5, seed=3, scale_one=False)  # resized on the host
    stem = Predictor(RetinaNet(1), variables, device="cpu",
                     device_preprocess=True, fused_stem=True, **KW)
    flat = Predictor(RetinaNet(1), variables, device="cpu",
                     device_preprocess=True, fused_stem=False, **KW)
    seen = {}
    for name, pred in (("stem", stem), ("flat", flat)):
        run = pred._run
        pred._run = (lambda images, bucket, run=run, log=seen.setdefault(name, []):
                     log.append(tuple(images.shape)) or run(images, bucket))
    out_stem = stem.predict_batch(pages)
    out_flat = flat.predict_batch(pages)
    # 3 landscape pages padded to 4 (64x128), 2 portrait: packed (B, H, W*3)
    # rows for the stem, flat 3072-byte rows for the normalize kernel
    assert sorted(seen["stem"]) == sorted([(4, 64, 128 * 3), (2, 128, 64 * 3)])
    assert sorted(seen["flat"]) == sorted([(4 * 64 * 128 * 3 // 3072, 3072),
                                           (2 * 128 * 64 * 3 // 3072, 3072)])
    for (sb, ss, sl), (fb, fs, fl) in zip(out_stem, out_flat):
        clear = fs > 0.06
        np.testing.assert_array_equal(sl[clear], fl[clear])
        np.testing.assert_allclose(ss[clear], fs[clear], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(sb[clear], fb[clear], rtol=1e-4, atol=1e-2)
    assert flat.dispatch_count == 2 and flat.dispatch_images == 5
    assert flat.host_prep_s > 0 and flat.dispatch_s > 0
    for (b, s, _), page in zip(out_flat, pages):
        ok = s > -1
        scale = compute_resize_scale(page.shape, 64, 96)
        bucket = BUCKETS[0] if page.shape[1] > page.shape[0] else BUCKETS[1]
        assert ok.sum() > 0
        assert b[ok].min() >= 0  # clipped to the canvas, then / scale
        assert b[ok][:, [0, 2]].max() <= bucket[1] / scale + 1e-6
        assert b[ok][:, [1, 3]].max() <= bucket[0] / scale + 1e-6

    host = Predictor(RetinaNet(1), variables, device="cpu", **KW)
    assert not host.fused_stem
    out_host = host.predict_batch(pages[:1])
    assert out_host[0][0].shape == (300, 4)


def test_odd_bucket_rows_take_the_normalize_route(variables):
    """A bucket whose canvas does not divide into 3072-byte rows goes to the
    normalize kernel as (B*H, W*3) rows, and gives the host-float route's
    detections exactly: integer pages at scale 1.0 fill the canvas, so both
    normalize the same values with the same f32 subtract."""
    kw = dict(KW, min_side=40, max_side=56, buckets=[(40, 56)])
    rng = np.random.RandomState(12)
    pages = [rng.randint(0, 256, (40, 56, 3)).astype(np.float32) for _ in range(3)]
    flat = Predictor(RetinaNet(1), variables, device="cpu",
                     device_preprocess=True, fused_stem=False, **kw)
    seen = []
    run = flat._run
    flat._run = lambda images, bucket: seen.append(tuple(images.shape)) or run(images, bucket)
    out_flat = flat.predict_batch(pages)
    out_host = Predictor(RetinaNet(1), variables, device="cpu", **kw).predict_batch(pages)
    assert seen == [(4 * 40, 56 * 3)]  # 3 pages padded to 4
    for got, want in zip(out_flat, out_host):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert (out_flat[0][1] > -1).sum() > 0


def test_fused_stem_defaults_off_on_cpu_and_cuda_requires_gpu(variables):
    pred = Predictor(RetinaNet(1), variables, device="cpu",
                     device_preprocess=True, **KW)
    assert pred.fused_stem is False  # auto: on only for CUDA devices
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        Predictor(RetinaNet(1), device="cuda")



def test_call_is_predict_batch_of_one(variables):
    """__call__ is predict_batch of one image, as in the reference
    (tdnet/train/predictor.py:234-237; tdnet/bin/predict.py calls it)."""
    page = _pages(1, seed=5)[0]
    pred = Predictor(RetinaNet(1), variables, device="cpu", **KW)
    for got, want in zip(pred(page), pred.predict_batch([page])[0]):
        np.testing.assert_array_equal(got, want)


def test_batch_size_defaults_and_eval_chunks(variables):
    """batch_size defaults to 1 on the CPU (16 on CUDA, the counterpart of
    the reference's TPU default) and is the chunk utils/eval.py hands to
    predict_batch."""
    from tdnet_torch.utils.eval import _get_detections

    assert Predictor(RetinaNet(1), variables, device="cpu", **KW).batch_size == 1
    pred = Predictor(RetinaNet(1), variables, device="cpu", batch_size=3, **KW)
    assert pred.batch_size == 3

    class Pages:  # 4 pages through predict_batch in chunks of 3
        def size(self):
            return 4

        def num_classes(self):
            return 1

        def has_label(self, label):
            return label == 0

        def load_image(self, i):
            return _pages(4, seed=5)[i]

    calls = []
    run = pred.predict_batch
    pred.predict_batch = lambda images: calls.append(len(images)) or run(images)
    _get_detections(Pages(), pred, 0.05, 100)
    assert calls == [3, 1]


def test_use_pallas_false_raises_for_cuda_only(variables):
    """use_pallas=False asks for the plain route: it raises for CUDA (the
    port has no plain route there; None means CUDA) and changes nothing on
    the CPU, where the plain versions run anyway."""
    page = _pages(1, seed=5)[0]
    plain = Predictor(RetinaNet(1), variables, device="cpu", use_pallas=False, **KW)
    pred = Predictor(RetinaNet(1), variables, device="cpu", **KW)
    assert plain.use_pallas is False and pred.use_pallas is None
    for got, want in zip(plain(page), pred(page)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="use_pallas=False"):
        Predictor(RetinaNet(1), device="cuda", use_pallas=False)
    with pytest.raises(ValueError, match="use_pallas=False"):
        Predictor(RetinaNet(1), use_pallas=False)


def test_fused_stem_fallback_is_always_none(variables):
    """The reference records a switch to the flat route in
    fused_stem_fallback (serve's /stats reports it); the port has no
    fallback route, so it is None on every route."""
    for kw in (dict(), dict(device_preprocess=True, fused_stem=True)):
        pred = Predictor(RetinaNet(1), variables, device="cpu", **kw, **KW)
        pred.predict_batch(_pages(1, seed=5))
        assert pred.fused_stem_fallback is None
