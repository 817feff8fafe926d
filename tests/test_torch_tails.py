"""The inference tails of tdnet_torch vs tdnet, on the CPU: the deferred
tail with soft-NMS, the shared-NMS deferred tail, the legacy
decode-everything tail in every combination of ``class_specific_filter``,
``nms`` and soft-NMS, and ``detections_from_outputs``'s dispatch, each
against tdnet with ``use_pallas`` False and True (Pallas in interpret mode).
B 2, the 96x128 bucket (N 2313 anchors), C 3 random logits; both sides get
the same numpy arrays. Labels exact; scores rtol 1e-5; boxes atol 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tdnet_torch.models.detect as port_detect
from tdnet_torch.models.detect import decode_boxes, detections_from_outputs
from tdnet_torch.ops.anchors import anchors_for_shape
from tdnet_torch.ops.nms import (batched_detections_deferred,
                                 batched_detections_deferred_shared,
                                 batched_filter_detections, filter_detections)

torch.set_num_threads(1)  # tier-1 runs several xdist workers

BUCKET = (96, 128)
KW = dict(score_threshold=0.05, max_detections=100, nms_threshold=0.5,
          pre_nms_top_k=256)


def _outputs(seed, b=2, c=3):
    """Regression deltas and logits spread so that most anchors of a class
    pass 0.05 and many overlap (the candidates of a class are clustered)."""
    rng = np.random.RandomState(seed)
    n = anchors_for_shape(BUCKET).shape[0]
    reg = (rng.randn(b, n, 4) * 0.1).astype(np.float32)
    cls = (rng.randn(b, n, c) * 1.5 - 2.0).astype(np.float32)
    return reg, cls


def _assert_same(got, want):
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=0, atol=1e-4)
    assert (got.scores.numpy() > 0).sum() > 20  # a real set was kept


def _ref_anchors():
    return jnp.asarray(anchors_for_shape(BUCKET).astype(np.float32))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_deferred_soft_nms_matches_reference(use_pallas):
    from tdnet.ops.nms import batched_detections_deferred as ref

    reg, cls = _outputs(1)
    kw = dict(KW, soft_nms_sigma=0.5)
    want = ref(jnp.asarray(reg), jnp.asarray(cls), _ref_anchors(), BUCKET,
               use_pallas=use_pallas, pallas_interpret=True, **kw)
    got = batched_detections_deferred(
        torch.from_numpy(reg), torch.from_numpy(cls),
        torch.from_numpy(anchors_for_shape(BUCKET).astype(np.float32)), BUCKET, **kw)
    _assert_same(got, want)
    assert {0, 1, 2} <= set(got.labels.numpy().ravel().tolist())


@pytest.mark.parametrize("use_pallas", [False, True])
def test_deferred_shared_matches_reference(use_pallas):
    from tdnet.ops.nms import batched_detections_deferred_shared as ref

    reg, cls = _outputs(2)
    want = ref(jnp.asarray(reg), jnp.asarray(cls), _ref_anchors(), BUCKET,
               use_pallas=use_pallas, pallas_interpret=True, **KW)
    got = batched_detections_deferred_shared(
        torch.from_numpy(reg), torch.from_numpy(cls),
        torch.from_numpy(anchors_for_shape(BUCKET).astype(np.float32)), BUCKET, **KW)
    _assert_same(got, want)


def test_decode_boxes_matches_reference():
    from tdnet.models.detect import decode_boxes as ref

    reg, _ = _outputs(3)
    want = np.asarray(ref(jnp.asarray(reg), BUCKET))
    got = decode_boxes(torch.from_numpy(reg), BUCKET).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


# (class_specific_filter, nms, soft_nms_sigma); the shared branch ignores
# soft-NMS, as the reference's does
LEGACY = [(True, True, 0.0), (True, True, 0.5), (True, False, 0.0),
          (False, True, 0.0), (False, False, 0.0), (False, True, 0.5)]


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("class_specific,nms,sigma", LEGACY)
def test_legacy_tail_matches_reference(class_specific, nms, sigma, use_pallas):
    """batched_filter_detections on decoded boxes and sigmoid scores."""
    from tdnet.models.detect import decode_boxes as ref_decode
    from tdnet.ops.nms import batched_filter_detections as ref
    from tdnet.ops.nms import filter_detections as ref_one

    reg, cls = _outputs(4)
    boxes = np.array(ref_decode(jnp.asarray(reg), BUCKET))  # writable copy
    scores = 1.0 / (1.0 + np.exp(-cls.astype(np.float64)))
    scores = scores.astype(np.float32)
    kw = dict(KW, class_specific_filter=class_specific, nms=nms,
              soft_nms_sigma=sigma)
    want = ref(jnp.asarray(boxes), jnp.asarray(scores), use_pallas=use_pallas,
               pallas_interpret=True, **kw)
    got = batched_filter_detections(torch.from_numpy(boxes),
                                    torch.from_numpy(scores), **kw)
    _assert_same(got, want)
    # one image through filter_detections: the reference's per-image
    # filter, and that image's row of the batch
    one = filter_detections(torch.from_numpy(boxes[1]), torch.from_numpy(scores[1]), **kw)
    _assert_same(one, ref_one(jnp.asarray(boxes[1]), jnp.asarray(scores[1]),
                              use_pallas=use_pallas, pallas_interpret=True, **kw))
    for a, b in zip(one, got):
        np.testing.assert_allclose(a.numpy(), b[1].numpy(), rtol=1e-6, atol=1e-6)


# (nms, class_specific_filter, soft_nms_sigma, deferred) -> the port's tail
DISPATCH = [
    ((True, True, 0.0, None), "batched_detections_deferred"),
    ((True, True, 0.5, None), "batched_detections_deferred"),
    ((True, False, 0.0, None), "batched_detections_deferred_shared"),
    ((True, False, 0.5, None), "batched_filter_detections"),
    ((False, True, 0.0, None), "batched_filter_detections"),
    ((False, False, 0.0, None), "batched_filter_detections"),
    ((True, True, 0.0, False), "batched_filter_detections"),
    ((True, True, 0.5, False), "batched_filter_detections"),
    ((True, False, 0.0, True), "batched_detections_deferred_shared"),
]


@pytest.mark.parametrize("combo,route", DISPATCH)
def test_dispatch_matches_reference(combo, route, monkeypatch):
    """detections_from_outputs picks the reference's tail for every
    combination it accepts (the route is recorded, since the tails agree)
    and returns its detections (tdnet with use_pallas=False)."""
    from tdnet.models.detect import detections_from_outputs as ref

    nms, class_specific, sigma, deferred = combo
    reg, cls = _outputs(5)
    kw = dict(KW, nms=nms, class_specific_filter=class_specific,
              soft_nms_sigma=sigma, deferred=deferred)
    want = ref({"regression": jnp.asarray(reg), "classification": jnp.asarray(cls)},
               BUCKET, use_pallas=False, **kw)
    ran = []
    for name in ("batched_detections_deferred", "batched_detections_deferred_shared",
                 "batched_filter_detections"):
        fn = getattr(port_detect, name)
        monkeypatch.setattr(port_detect, name,
                            lambda *a, _n=name, _f=fn, **k: ran.append(_n) or _f(*a, **k))
    got = detections_from_outputs(
        {"regression": torch.from_numpy(reg), "classification": torch.from_numpy(cls)},
        BUCKET, **kw)
    assert ran == [route]
    _assert_same(got, want)


def test_dispatch_rejects_what_the_reference_rejects():
    reg, cls = _outputs(6, b=1, c=2)
    outputs = {"regression": torch.from_numpy(reg), "classification": torch.from_numpy(cls)}
    with pytest.raises(ValueError, match="requires nms=True"):
        detections_from_outputs(outputs, BUCKET, nms=False, deferred=True)
    with pytest.raises(ValueError, match="class-specific"):
        detections_from_outputs(outputs, BUCKET, class_specific_filter=False,
                                soft_nms_sigma=0.5, deferred=True)
