"""Soft-NMS rescoring in tdnet_torch vs tdnet, on the CPU: the plain
version against the reference's vmapped ``soft_nms_rescore`` and its Pallas
``soft_nms_rescore_batched`` (interpret mode, as the JAX package's own tests
run it), exact ties, duplicate boxes under linear decay, the wrapper's
checks, and a 3-class soft-NMS Predictor against tdnet's. Inputs come from
numpy seeds; both sides get the same arrays."""

import ctypes
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdnet_torch.ops.soft_nms import soft_nms_rescore_batched, soft_nms_rescore_plain

torch.set_num_threads(1)  # tier-1 runs several xdist workers


@pytest.fixture(scope="module", autouse=True)
def _drop_compiled_executables():
    """The ResNet-50 executables of the Predictor test are not reused
    elsewhere; the freed model memory goes back to the system."""
    yield
    jax.clear_caches()
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except OSError:  # not glibc: nothing to trim
        pass


def _rows(seed, r, k, span=100.0):
    """Overlapping boxes and scores with a below-threshold share (as the
    reference's test_rescore_batched_matches_vmapped_rescore makes them)."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(0, span, (r, k, 2))
    sizes = rng.uniform(5, 30, (r, k, 2))
    boxes = np.concatenate([centers, centers + sizes], -1).astype(np.float32)
    scores = (rng.uniform(0, 1, (r, k)) * (rng.rand(r, k) > 0.3)).astype(np.float32)
    return boxes, scores


def _reference(boxes, scores, pallas, **kw):
    from tdnet.ops.soft_nms import soft_nms_rescore, soft_nms_rescore_batched as ref

    if pallas:
        return np.asarray(ref(jnp.asarray(boxes), jnp.asarray(scores),
                              interpret=True, **kw))
    return np.asarray(jax.vmap(lambda b, s: soft_nms_rescore(b, s, **kw))(
        jnp.asarray(boxes), jnp.asarray(scores)))


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("method", ["gaussian", "linear"])
@pytest.mark.parametrize("r,k", [(5, 130), (6, 256)])
def test_plain_matches_reference(r, k, method, pallas):
    """rtol 1e-5, atol 1e-6 (the reference's own bound between its two
    forms: exp comes from different libraries)."""
    boxes, scores = _rows(r * k, r, k)
    kw = dict(method=method, sigma=0.4, iou_threshold=0.3,
              score_threshold=0.001, max_selections=64)
    want = _reference(boxes, scores, pallas, **kw)
    got = soft_nms_rescore_plain(torch.from_numpy(boxes), torch.from_numpy(scores), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # the same boxes were selected, and some were decayed
    np.testing.assert_array_equal(got.numpy() > 0, want > 0)
    assert 0 < (want > 0).sum() < (scores > 0.001).sum()
    # the wrapper on a CPU tensor is the plain version
    assert torch.equal(soft_nms_rescore_batched(
        torch.from_numpy(boxes), torch.from_numpy(scores), **kw), got)


def test_exact_ties_pick_the_lowest_index_first():
    """Two identical boxes with identical scores: the lower index is picked
    first and keeps its score exactly, the other is decayed (the decayed
    values within 1e-6: exp comes from different libraries)."""
    boxes = np.array([[[0, 0, 10, 10], [50, 50, 60, 60], [0, 0, 10, 10],
                       [1, 1, 11, 11], [50, 50, 60, 60]]], np.float32)
    scores = np.array([[0.7, 0.9, 0.7, 0.6, 0.9]], np.float32)
    kw = dict(method="gaussian", sigma=0.5, max_selections=5)
    want = _reference(boxes, scores, False, **kw)
    got = soft_nms_rescore_plain(torch.from_numpy(boxes),
                                 torch.from_numpy(scores), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[0, 1] == want[0, 1] == np.float32(0.9)
    assert got[0, 0] == want[0, 0] == np.float32(0.7)
    assert got[0, 4] < got[0, 1] and got[0, 2] < got[0, 0]


def test_linear_duplicates_stay_finite():
    """Linear decay of an exact duplicate (IoU 1) is 0: the removed -inf
    sentinel is never multiplied, so nothing turns NaN."""
    boxes = np.tile(np.array([[[5, 5, 25, 25]]], np.float32), (2, 6, 1))
    boxes[1, 3:] += 40.0
    scores = np.array([[0.9, 0.8, 0.8, 0.3, 0.2, 0.1],
                       [0.5, 0.5, 0.4, 0.5, 0.5, 0.0]], np.float32)
    kw = dict(method="linear", iou_threshold=0.3, max_selections=6)
    want = _reference(boxes, scores, True, **kw)
    got = soft_nms_rescore_plain(torch.from_numpy(boxes),
                                 torch.from_numpy(scores), **kw).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.float32([[0.9, 0, 0, 0, 0, 0],
                                                   [0.5, 0, 0, 0.5, 0, 0]]))


def test_wrapper_rejects_bad_inputs():
    boxes = torch.zeros((2, 8, 4))
    scores = torch.zeros((2, 8))
    with pytest.raises(TypeError, match="float32"):
        soft_nms_rescore_batched(boxes.double(), scores)
    with pytest.raises(ValueError, match="does not match"):
        soft_nms_rescore_batched(boxes, scores[:, :4])
    with pytest.raises(ValueError, match="contiguous"):
        soft_nms_rescore_batched(boxes.transpose(0, 1), scores.t())
    with pytest.raises(ValueError, match="method"):
        soft_nms_rescore_batched(boxes, scores, method="hard")


def test_soft_nms_predictor_matches_jax_predictor(monkeypatch):
    """A 3-class soft-NMS Predictor (uint8 pages -> plain fused stem ->
    ResNet-50 RetinaNet, f32 -> deferred class-specific soft-NMS) vs tdnet's
    Predictor on the same pages and variables (use_pallas=False: its
    vmapped jnp rescore). The soft-NMS rescore ran and the hard NMS did not.
    Every detection clear of the threshold (> 0.07) matches one of the
    reference with the same label, a score within rtol 1e-3 and a box
    within 0.5 px (tests/train/test_predictor_batch.py's fused-stem
    bounds), and the counts of such detections are equal."""
    import tdnet_torch.ops.nms as port_nms
    from tdnet.models.retinanet import RetinaNet as FlaxRetinaNet
    from tdnet.train.predictor import Predictor as JaxPredictor
    from tdnet_torch.models.retinanet import RetinaNet
    from tdnet_torch.train.predictor import Predictor
    from tdnet_torch.weights import random_variables

    v = random_variables(3, "resnet50", seed=1)
    v["params"]["classification_submodel"]["head"]["kernel"] *= 30.0
    v["params"]["classification_submodel"]["head"]["bias"][:] = -2.0
    rng = np.random.RandomState(21)
    pages = [rng.uniform(0, 255, (64, 96, 3)).astype(np.float32) for _ in range(2)]
    kw = dict(min_side=64, max_side=96, buckets=[(64, 96)], soft_nms_sigma=0.5,
              pre_nms_top_k=100, max_detections=100)
    ref = JaxPredictor(FlaxRetinaNet(num_classes=3, dtype=jnp.float32),
                       jax.tree.map(jnp.asarray, v), fused_stem=True,
                       use_pallas=False, device_preprocess=True, batch_size=2,
                       **kw)
    calls = {"soft": 0, "nms": 0}
    soft, keep = port_nms.soft_nms_rescore_batched, port_nms.nms_keep

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(port_nms, "soft_nms_rescore_batched", counting("soft", soft))
    monkeypatch.setattr(port_nms, "nms_keep", counting("nms", keep))
    port = Predictor(RetinaNet(3), v, device="cpu", device_preprocess=True,
                     fused_stem=True, **kw)
    got = port.predict_batch(pages)
    want = ref.predict_batch(pages)
    assert calls == {"soft": 1, "nms": 0}
    n = 0
    for (gb, gs, gl), (wb, ws, wl) in zip(got, want):
        gv, wv = gs > 0.07, ws > 0.07
        assert gv.sum() == wv.sum()
        assert set(gl[gv]) <= {0, 1, 2}
        for b, s, lab in zip(gb[gv], gs[gv], gl[gv]):
            cand = (wl[wv] == lab) & (np.abs(ws[wv] - s) <= 1e-3 * s)
            assert cand.any(), s
            assert np.abs(wb[wv][cand] - b).max(axis=1).min() <= 0.5
        n += int(gv.sum())
    assert n > 50
    assert len({int(lab) for _, _, ls in got for lab in ls[ls >= 0]}) == 3
