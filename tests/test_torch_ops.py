"""tdnet_torch ops vs the JAX/numpy reference, on the CPU: anchors, box
decode/clip/IoU, image resize and buckets, stable top-k, the deferred
detection tail, and the port's import isolation. Inputs come from numpy
seeds; both sides get the same arrays."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # tier-1 runs several xdist workers


@pytest.mark.parametrize("hw", [(64, 128), (96, 160), (800, 1344), (1344, 800)])
def test_anchors_equal_reference(hw):
    from tdnet.ops.anchors import anchors_for_shape as ref
    from tdnet_torch.ops.anchors import anchors_for_shape

    np.testing.assert_array_equal(anchors_for_shape(hw), ref(hw))


def _boxes(rng, n, span=60.0):
    b = rng.uniform(0, span, (n, 4)).astype(np.float32)
    b[:, 2:] = b[:, :2] + rng.uniform(0.5, 25, (n, 2)).astype(np.float32)
    return b


def _ulp_close(got, want, ulps=1):
    """|got - want| <= ulps * spacing(want): within ulps float32 ulp."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_array_less(
        np.abs(got - want), ulps * np.spacing(np.abs(want)) + 1e-30)


def test_decode_and_clip_within_one_ulp():
    from tdnet.ops.boxes import bbox_transform_inv as ref_inv
    from tdnet.ops.boxes import clip_boxes as ref_clip
    from tdnet_torch.ops.boxes import bbox_transform_inv, clip_boxes

    rng = np.random.RandomState(0)
    anchors = _boxes(rng, 500, span=120.0)
    deltas = rng.normal(0, 1.0, (500, 4)).astype(np.float32)
    want = np.asarray(ref_clip(ref_inv(jnp.asarray(anchors), jnp.asarray(deltas)),
                               (64, 96)))
    got = clip_boxes(bbox_transform_inv(torch.from_numpy(anchors),
                                        torch.from_numpy(deltas)), (64, 96))
    _ulp_close(got.numpy(), want)


@pytest.mark.parametrize("mode", ["exact", "legacy"])
def test_box_iou_within_one_ulp(mode):
    from tdnet.ops.boxes import box_iou as ref
    from tdnet_torch.ops.boxes import box_iou

    rng = np.random.RandomState(1)
    a, b = _boxes(rng, 40), _boxes(rng, 50)
    b[:5] = a[:5]  # identical pairs (IoU 1) and touching edges
    b[5:8, 0] = a[5:8, 2]
    want = np.asarray(ref(jnp.asarray(a), jnp.asarray(b), mode=mode))
    got = box_iou(torch.from_numpy(a), torch.from_numpy(b), mode=mode).numpy()
    _ulp_close(got, want)


@pytest.mark.parametrize("shape,min_side,max_side", [
    ((850, 1400, 3), 800, 1333),   # landscape page -> 800 x 1318
    ((1100, 850, 3), 800, 1333),   # portrait page -> 1035 x 800
    ((70, 100, 3), 64, 96),        # the test canvases
    ((40, 30, 3), 64, 96),         # upscale
])
def test_resize_image_matches_cv2(shape, min_side, max_side):
    """numpy INTER_LINEAR mirror vs cv2 (the reference's resize) on 0..255
    float data: equal bit for bit (IPP's float path; more scales in
    tests/test_torch_resize.py)."""
    from tdnet.data.image import resize_image as ref
    from tdnet_torch.data.image import resize_image

    img = np.random.RandomState(2).uniform(0, 255, shape).astype(np.float32)
    want, want_scale = ref(img, min_side=min_side, max_side=max_side)
    got, scale = resize_image(img, min_side=min_side, max_side=max_side)
    assert scale == want_scale
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_resize_scale_and_buckets_match_reference():
    from tdnet.data.generator import default_buckets as ref_buckets
    from tdnet.data.generator import pick_bucket as ref_pick
    from tdnet.data.image import compute_resize_scale as ref_scale
    from tdnet_torch.data.generator import default_buckets, pick_bucket
    from tdnet_torch.data.image import compute_resize_scale

    for shape in [(850, 1400), (1100, 850), (800, 800), (70, 100), (3000, 500)]:
        assert compute_resize_scale(shape) == ref_scale(shape)
    for sides in [(800, 1333), (64, 96), (512, 512)]:
        assert default_buckets(*sides) == ref_buckets(*sides)
    buckets = default_buckets()
    for hw in [(800, 1318), (1035, 800), (800, 1344), (10, 10)]:
        assert pick_bucket(*hw, buckets) == ref_pick(*hw, buckets)
    with pytest.raises(ValueError):
        pick_bucket(2000, 2000, buckets)


@pytest.mark.parametrize("n,k", [(4096, 64), (1500, 100)])  # group / plain path
def test_exact_topk_ties_equal_reference(n, k):
    """Tied bf16 logits: values AND indices (lower index first) exact."""
    from tdnet.ops.nms import exact_topk_lastdim as ref
    from tdnet_torch.ops.nms import exact_topk_lastdim

    rng = np.random.RandomState(3)
    x = np.round(rng.normal(0, 2, (3, n)) * 4) / 4  # a coarse grid: many ties
    xj = jnp.asarray(x, jnp.bfloat16)
    want_v, want_i = ref(xj, k)
    got_v, got_i = exact_topk_lastdim(torch.tensor(x, dtype=torch.bfloat16), k)
    np.testing.assert_array_equal(got_v.float().numpy(),
                                  np.asarray(want_v.astype(jnp.float32)))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conservative_logit_threshold_matches(dtype):
    from tdnet.ops.nms import _conservative_logit_threshold as ref
    from tdnet_torch.ops.nms import _conservative_logit_threshold

    for t in (0.05, 0.01, 0.5, 0.0, 1.0):
        want = float(ref(t, getattr(jnp, dtype)).astype(jnp.float32))
        assert _conservative_logit_threshold(t, getattr(torch, dtype)) == want


def _outputs(rng, b, c, bucket, spread=1.5, bias=-3.0):
    from tdnet_torch.ops.anchors import anchors_for_shape

    n = anchors_for_shape(bucket).shape[0]
    reg = rng.randn(b, n, 4).astype(np.float32) * 0.1
    cls = (rng.randn(b, n, c) * spread + bias).astype(np.float32)
    return reg, cls


@pytest.mark.parametrize("classes,k,bf16", [(1, 256, False), (3, 512, False),
                                            (1, 1024, True)])
def test_deferred_tail_matches_reference(classes, k, bf16):
    """batched_detections_deferred vs the JAX tail (jnp NMS). Labels exact;
    scores rtol 1e-6 (sigmoid from different libraries, <= a few ulp);
    boxes atol 1e-3 (decode is exact to 1 ulp, coordinates are < 200)."""
    from tdnet.ops.anchors import anchors_for_shape
    from tdnet.ops.nms import batched_detections_deferred as ref
    from tdnet_torch.ops.nms import batched_detections_deferred

    bucket = (64, 96)
    reg, cls = _outputs(np.random.RandomState(7 + classes), 2, classes, bucket)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    anchors = anchors_for_shape(bucket).astype(np.float32)
    want = ref(jnp.asarray(reg, jdt), jnp.asarray(cls, jdt), jnp.asarray(anchors),
               bucket, pre_nms_top_k=k, use_pallas=False)
    got = batched_detections_deferred(
        torch.tensor(reg, dtype=tdt), torch.tensor(cls, dtype=tdt),
        torch.from_numpy(anchors), bucket, pre_nms_top_k=k)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=0, atol=1e-3)
    assert (got.scores.numpy() > 0).sum() > 10  # NMS really kept a set


def test_non_max_suppression_matches_reference():
    from tdnet.ops.nms import non_max_suppression as ref
    from tdnet_torch.ops.nms import non_max_suppression

    rng = np.random.RandomState(4)
    boxes = _boxes(rng, 200, span=40.0)
    scores = rng.uniform(0, 1, 200).astype(np.float32)
    scores[10:20] = scores[0]  # ties: stable order
    want = np.asarray(ref(jnp.asarray(boxes), jnp.asarray(scores), 0.5, 0.2))
    got = non_max_suppression(torch.from_numpy(boxes), torch.from_numpy(scores),
                              0.5, 0.2).numpy()
    np.testing.assert_array_equal(got, want)


def test_unported_tail_branches_raise():
    """The tails that raised NotImplementedError before slice 3 (soft-NMS,
    shared NMS, the legacy tail) now run and give padded detections; what
    still raises is what the reference rejects (tests/test_torch_tails.py
    holds their values against tdnet)."""
    from tdnet_torch.models.detect import detections_from_outputs

    reg, cls = _outputs(np.random.RandomState(1), 1, 1, (64, 96))
    outputs = {"regression": torch.from_numpy(reg),
               "classification": torch.from_numpy(cls)}
    for kw in (dict(soft_nms_sigma=0.5), dict(class_specific_filter=False),
               dict(deferred=False)):
        det = detections_from_outputs(outputs, (64, 96), **kw)
        assert tuple(det.boxes.shape) == (1, 300, 4)
        assert (det.scores > 0).sum() > 0
    with pytest.raises(ValueError, match="nms=True"):
        detections_from_outputs(outputs, (64, 96), nms=False, deferred=True)
    with pytest.raises(ValueError, match="class-specific"):
        detections_from_outputs(outputs, (64, 96), class_specific_filter=False,
                                soft_nms_sigma=0.5, deferred=True)


def test_port_imports_no_jax_pil_cv2_or_tdnet():
    """Every tdnet_torch module, the training and serving slices' included,
    and chip_smoke.py import in a fresh interpreter without pulling in jax,
    flax, optax, orbax, PIL, cv2, msgpack or the tdnet package."""
    code = """
import importlib, pkgutil, sys
import tdnet_torch
for m in pkgutil.walk_packages(tdnet_torch.__path__, "tdnet_torch."):
    importlib.import_module(m.name)
import chip_smoke
for name in ("ops.losses", "ops.targets", "ops.stem_vjp", "train.step",
             "train.loop", "train.checkpoint", "data.prefetch", "ops.soft_nms",
             "ops.block", "ops.conv1x1", "utils.msgpack", "models.io",
             "data.png", "data.csv_dataset", "utils.eval", "bin.predict",
             "bin.evaluate", "bin.serve"):
    assert "tdnet_torch." + name in sys.modules, name
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                    "PIL", "cv2", "msgpack", "tdnet"))
print(len([n for n in sys.modules if n.startswith("tdnet_torch")]))
assert not bad, bad
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 40  # the whole package was imported
