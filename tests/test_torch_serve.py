"""tdnet_torch.bin.serve: the cases of tests/bin/test_serve.py on the port
(``device="cpu"``), PNG, JPEG, BMP and refused bodies, and served
detections against tdnet's server on the same bridged weights."""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tdnet_torch.data import png
from tdnet_torch.models.retinanet import RetinaNet
from tdnet_torch.train.predictor import Predictor
from tdnet_torch.weights import random_variables

torch.set_num_threads(1)  # tier-1 runs several xdist workers


@pytest.fixture(scope="module", autouse=True)
def _release_memory():
    """The tier-1 workers run hundreds of tests each and their memory adds
    up: drop this module's JAX executables and trim the C heap that its
    ResNet-50 weights and bundles leave behind."""
    yield
    import ctypes
    import gc

    import jax

    jax.clear_caches()
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except OSError:  # not glibc: nothing to trim
        pass


KW = dict(min_side=64, max_side=64, buckets=[(64, 64)], score_threshold=0.01,
          pre_nms_top_k=64, max_detections=10, batch_size=4)


@pytest.fixture(scope="module")
def variables():
    """Random 2-class ResNet-50 variables, the class head spread over O(1)
    (kernel x30, bias -2) as in tests/test_torch_predictor.py."""
    v = random_variables(2, "resnet50", seed=0)
    v["params"]["classification_submodel"]["head"]["kernel"] *= 30.0
    v["params"]["classification_submodel"]["head"]["bias"][:] = -2.0
    return v


def _start(predictor, **kw):
    from tdnet_torch.bin.serve import build_server

    httpd, batcher = build_server(predictor, port=0, **kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{httpd.server_address[1]}", httpd, batcher


@pytest.fixture(scope="module")
def served(variables):
    predictor = Predictor(RetinaNet(2), variables, device="cpu", **KW)
    base, httpd, batcher = _start(predictor, max_batch=4, max_delay_ms=150.0,
                                  label_names={0: "table", 1: "figure"},
                                  default_threshold=0.01)
    yield base, predictor, batcher
    httpd.shutdown()
    batcher.close()


def _post(base, body, ctype, path="/v1/detect"):
    req = urllib.request.Request(base + path, data=body, headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _post_npy(base, image, path="/v1/detect"):
    buf = io.BytesIO()
    np.save(buf, image)
    return _post(base, buf.getvalue(), "application/x-npy", path)


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as r:
        return json.loads(r.read())


def _assert_response_matches(resp, result, threshold=0.01):
    boxes, scores, labels = result
    kept = np.where(scores > threshold)[0]
    assert len(resp["detections"]) == len(kept)
    for det, i in zip(resp["detections"], kept):
        np.testing.assert_allclose(det["box"], boxes[i], atol=0.01)
        assert det["score"] == pytest.approx(float(scores[i]), abs=1e-3)
        assert det["label"] == int(labels[i])


def test_healthz_and_stats(served):
    base, _, _ = served
    h = _get(base, "/healthz")
    assert h["status"] == "ok" and h["device"] == "cpu"
    assert {"requests", "batches", "images", "latency_ms"} <= set(_get(base, "/stats"))


def test_detect_matches_direct_predictor(served):
    base, predictor, _ = served
    image = np.random.RandomState(0).uniform(0, 255, (64, 64, 3)).astype(np.float32)
    resp = _post_npy(base, image)
    assert resp["image_hw"] == [64, 64] and len(resp["detections"]) > 0
    _assert_response_matches(resp, predictor(image))
    assert all(d["name"] in ("table", "figure") for d in resp["detections"])


def test_png_body_equals_npy_body(served):
    """A PNG body decodes (BGR, as cv2.imdecode gives it) to the pixels of
    the same page sent as .npy."""
    base, predictor, _ = served
    page = np.random.RandomState(7).randint(0, 256, (64, 64, 3)).astype(np.uint8)
    via_png = _post(base, png.encode_png(page[:, :, ::-1]), "image/png")
    via_npy = _post_npy(base, page.astype(np.float32))
    assert via_png["detections"] == via_npy["detections"]
    _assert_response_matches(via_png, predictor(page.astype(np.float32)))


def _exif6() -> bytes:
    """An EXIF block whose IFD0 holds orientation 6 (turn 90 degrees
    clockwise to display)."""
    import struct

    ifd = struct.pack("<HHHIHHI", 1, 0x0112, 3, 1, 6, 0, 0)
    return b"Exif\x00\x00II" + struct.pack("<HI", 42, 8) + ifd


@pytest.mark.parametrize("kind", ["jpeg", "bmp", "jpeg_exif6"])
def test_jpeg_and_bmp_bodies(served, kind):
    """JPEG and BMP bodies decode as cv2.imdecode(IMREAD_COLOR) does (the
    reference's route): each 200 answer equals the predictor's on that
    decode, and the EXIF-6 page arrives turned upright (64x48 stored as
    48x64)."""
    import cv2
    from PIL import Image

    base, predictor, _ = served
    page = np.random.RandomState(11).randint(0, 256, (48, 64, 3)).astype(np.uint8)
    page = cv2.GaussianBlur(page, (5, 5), 0)
    buf = io.BytesIO()
    if kind == "bmp":
        Image.fromarray(page).save(buf, format="BMP")
    else:
        Image.fromarray(page).save(buf, format="JPEG", quality=90,
                                   **({"exif": _exif6()} if kind == "jpeg_exif6" else {}))
    body = buf.getvalue()
    want = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
    resp = _post(base, body, f"image/{kind[:4]}")
    assert resp["image_hw"] == list(want.shape[:2]) == ([64, 48] if kind == "jpeg_exif6"
                                                          else [48, 64])
    assert len(resp["detections"]) > 0
    _assert_response_matches(resp, predictor(want.astype(np.float32)))


def test_threshold_query_param(served):
    base, _, _ = served
    image = np.random.RandomState(1).uniform(0, 255, (64, 64, 3)).astype(np.float32)
    all_dets = _post_npy(base, image, "/v1/detect?threshold=0.01")
    high = _post_npy(base, image, "/v1/detect?threshold=0.9")
    assert len(high["detections"]) <= len(all_dets["detections"])
    assert all(d["score"] > 0.9 for d in high["detections"])


def test_concurrent_requests_are_batched(served):
    base, predictor, batcher = served
    rng = np.random.RandomState(2)
    images = [rng.uniform(0, 255, (64, 64, 3)).astype(np.float32) for _ in range(8)]
    direct = predictor.predict_batch(images)
    b0 = batcher.batches
    results = [None] * len(images)

    def worker(i):
        results[i] = _post_npy(base, images[i])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(images))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert all(r is not None for r in results)
    assert 2 <= batcher.batches - b0 < 8  # coalesced
    for resp, result in zip(results, direct):
        _assert_response_matches(resp, result)


def test_bad_requests(served):
    """Bodies that do not decode (garbage; a truncated JPEG, which
    cv2.imdecode refuses too) get 400, as the reference answers when
    cv2.imdecode fails; unknown paths 404."""
    import cv2
    from PIL import Image

    base, _, _ = served
    jpeg = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(jpeg, format="JPEG")
    truncated = jpeg.getvalue()[:-40]
    assert cv2.imdecode(np.frombuffer(truncated, np.uint8), cv2.IMREAD_COLOR) is None
    for body, ctype in ((b"not an image", "image/png"), (truncated, "image/jpeg")):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, body, ctype)
        assert e.value.code == 400
    buf = io.BytesIO()
    np.save(buf, np.zeros((8, 8), np.float32))
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, buf.getvalue(), "application/x-npy")
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, b"", "text/plain", "/nope")
    assert e.value.code == 404


def test_stats_exposes_fused_stem_state(served):
    base, predictor, _ = served
    s = _get(base, "/stats")
    assert s["fused_stem"] == bool(predictor.fused_stem) is False
    assert "fused_stem_fallback" in s and s["fused_stem_fallback"] is None


def test_close_never_strands_a_waiter():
    """Every submit racing close() returns a result or raises 'batcher is
    closed'; none hangs."""
    from tdnet_torch.bin.serve import MicroBatcher

    class SlowPredictor:
        def predict_batch(self, images):
            import time

            time.sleep(0.02)
            return [(np.zeros((1, 4)), np.zeros(1), np.zeros(1, np.int64)) for _ in images]

    for trial in range(8):
        batcher = MicroBatcher(SlowPredictor(), max_batch=4, max_delay_ms=1.0)
        outcomes = [None] * 12
        start = threading.Barrier(13)

        def worker(i):
            start.wait()
            try:
                batcher.submit(np.zeros((8, 8, 3), np.float32))
                outcomes[i] = "ok"
            except RuntimeError:
                outcomes[i] = "closed"

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(12)]
        for t in threads:
            t.start()
        start.wait()
        batcher.close()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads), f"trial {trial}: {outcomes}"
        assert all(o in ("ok", "closed") for o in outcomes), outcomes


def test_predictor_error_propagates_to_waiter():
    from tdnet_torch.bin.serve import MicroBatcher

    class ExplodingPredictor:
        def predict_batch(self, images):
            raise MemoryError("boom")

    batcher = MicroBatcher(ExplodingPredictor(), max_batch=2, max_delay_ms=1.0)
    with pytest.raises(MemoryError):
        batcher.submit(np.zeros((8, 8, 3), np.float32))
    assert batcher.stats()["errors"] == 1
    batcher.close()


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_worker_death_fails_inflight_and_queued(monkeypatch):
    """A worker killed mid-dispatch by a non-Exception fails the batch in
    flight and every later submit."""
    from tdnet_torch.bin.serve import MicroBatcher

    class DyingPredictor:
        def predict_batch(self, images):
            raise KeyboardInterrupt

    seen = []
    monkeypatch.setattr(threading, "excepthook", lambda args: seen.append(args.exc_type))
    batcher = MicroBatcher(DyingPredictor(), max_batch=1, max_delay_ms=1.0)
    with pytest.raises(RuntimeError, match="closed"):
        batcher.submit(np.zeros((8, 8, 3), np.float32))
    with pytest.raises(RuntimeError, match="closed"):
        batcher.submit(np.zeros((8, 8, 3), np.float32))
    batcher._thread.join(timeout=10)
    assert not batcher._thread.is_alive()
    assert seen == [KeyboardInterrupt]


def test_uint8_device_normalize_serving_and_cli_args(variables):
    """A device-normalize predictor (uint8 canvases, the fused stem's plain
    version on the CPU) gets uint8 .npy bodies as uint8, answers like the
    direct predictor, and reports the host/dispatch split; --no-pallas on
    CUDA is an argparse error."""
    from tdnet_torch.bin.serve import parse_args

    predictor = Predictor(RetinaNet(2), variables, device="cpu", device_preprocess=True,
                          fused_stem=True, **KW)
    base, httpd, batcher = _start(predictor, max_batch=4, max_delay_ms=5.0,
                                  default_threshold=0.01)
    seen = []
    orig = predictor.predict_batch
    predictor.predict_batch = lambda images: seen.extend(im.dtype for im in images) or orig(images)
    try:
        u8 = np.random.RandomState(3).randint(0, 256, (64, 64, 3)).astype(np.uint8)
        resp = _post_npy(base, u8)
        assert seen == [np.uint8]
        _assert_response_matches(resp, orig([u8])[0])
        dev = _get(base, "/stats")["device"]
        assert dev["dispatches"] >= 1 and dev["images"] >= 1 and "host_prep_s" in dev
        assert _get(base, "/stats")["fused_stem"] is True
    finally:
        httpd.shutdown()
        batcher.close()
    assert parse_args(["m.tdn"]).device == "cuda"
    assert parse_args(["m.tdn", "--no-pallas", "--device", "cpu"]).use_pallas is False
    with pytest.raises(SystemExit):
        parse_args(["m.tdn", "--no-pallas"])


def test_served_detections_equal_jax_server(variables):
    """The port's server (CPU, f32) and tdnet's (use_pallas=False) on the
    same bridged weights answer the same pages alike: labels exact, scores
    within 1e-3 and boxes within 0.5 px (test_torch_predictor.py's
    tolerance) on detections clear of the threshold."""
    import jax
    import jax.numpy as jnp

    from tdnet.bin.serve import build_server as jax_build_server
    from tdnet.models.retinanet import RetinaNet as FlaxRetinaNet
    from tdnet.train.predictor import Predictor as JaxPredictor

    kw = dict(KW, score_threshold=0.05)
    ref = JaxPredictor(FlaxRetinaNet(num_classes=2, dtype=jnp.float32),
                       jax.tree.map(jnp.asarray, variables), use_pallas=False, **kw)
    jax_httpd, jax_batcher = jax_build_server(ref, port=0, max_batch=4, max_delay_ms=5.0,
                                              default_threshold=0.05)
    threading.Thread(target=jax_httpd.serve_forever, daemon=True).start()
    jax_base = f"http://127.0.0.1:{jax_httpd.server_address[1]}"
    base, httpd, batcher = _start(Predictor(RetinaNet(2), variables, device="cpu", **kw),
                                  max_batch=4, max_delay_ms=5.0, default_threshold=0.05)
    try:
        rng = np.random.RandomState(4)
        n = 0
        for _ in range(2):
            page = rng.uniform(0, 255, (64, 64, 3)).astype(np.float32)
            got, want = _post_npy(base, page)["detections"], _post_npy(jax_base, page)["detections"]
            clear = [d for d in want if d["score"] > 0.06]
            assert len([d for d in got if d["score"] > 0.06]) == len(clear)
            for w in clear:
                assert any(g["label"] == w["label"]
                           and abs(g["score"] - w["score"]) <= 1e-3 + 1e-3 * w["score"]
                           and np.all(np.abs(np.subtract(g["box"], w["box"])) <= 0.5)
                           for g in got), w
                n += 1
        assert n > 5
    finally:
        for h, b in ((httpd, batcher), (jax_httpd, jax_batcher)):
            h.shutdown()
            b.close()
