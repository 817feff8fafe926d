#!/usr/bin/env python3
"""Smoke run of tdnet_torch's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``tdnet_torch/csrc/`` (into
``build/tdnet_torch/``), holds each kernel against its plain PyTorch version
at the main paths' shapes and times both, and drives the port's main paths
with random weights made from a seed, RetinaNet at full width and depth
(ResNet-50, and ResNet-101 for config 4):

- batched page inference (``Predictor.predict_batch``, bf16, uint8 pages
  through the fused ingest+stem kernel, the NMS kernel in the deferred
  tail), then CUDA-vs-CPU f32 detections on the same pages;
- training (in-memory pages -> ``BatchLoader`` -> the prefetcher -> ``fit``
  -> ``make_train_step`` on the fused-stem route with its backward kernel,
  bf16, batch 8 at 800x1344, 20 steps on one batch), a checkpoint round
  trip, then one f32 step on CUDA against the same step on the CPU;
- multi-class soft-NMS inference (config 5: 3-class ResNet-50, bf16, the
  deferred tail's soft-NMS kernel in place of the NMS kernel), then
  CUDA-vs-CPU f32 detections;
- ResNet-101 at the 1024x1024 bucket (config 4: bf16, batch 16, every
  stage's identity run through the fused bottleneck kernel), then
  CUDA-vs-CPU f32 detections at 512x512 and the f32 model with the kernel
  on and off;
- serving: a ResNet-50 ``.tdn`` written and read back by the port, behind
  ``tdnet_torch.bin.serve`` (bf16, device normalize, 32 concurrent
  ``.npy`` and PNG requests), then an f32 server against
  ``Predictor.predict_batch``;
- the ``predict`` and ``evaluate`` CLIs on that bundle.

The fused 1x1 conv kernel (B7) is wired into no model, so only the kernel
check runs it.

The launch counters, set to 0 just before each path and read just after,
show that it went through its kernels.

Every phase prints one JSON line; then one line lists the kernels (route,
source, the TPU kernel each replaces, launches, error, times and bound);
the line before the last is the GPU's ``nvidia-smi`` name and power limit,
and the last line is ``{"ok": true, "device": {...}}``. Any failed phase
exits non-zero without that line, as does a machine with no CUDA GPU or a
directory without the ``tdnet_torch`` package. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

SEED = 0
MIN_SIDE, MAX_SIDE = 800, 1333        # the resize rule: buckets 800x1344, 1344x800
N_LANDSCAPE, N_PORTRAIT = 12, 4
PAGE_LANDSCAPE, PAGE_PORTRAIT = (850, 1400), (1100, 850)  # -> 800x1318, 1035x800
INGEST_ROWS = 16 * 1050               # 16 canvases of 800x1344 as 3072-byte rows
STEM_SHAPES = [(16, 800, 1344 * 3), (16, 1344, 800 * 3)]
# B2 (R, K): config 1's batch of 16 pages, then bench.py's batch of 128;
# one row class a page. Also checked: 4 rows of a ragged K (the last 64-box
# word is partial). Timed in bursts of 10 calls (device time, not host).
NMS_SHAPES = [(16, 1024), (128, 1024)]
NMS_RAGGED_K = 1000
NMS_BURST = 10
BF16_WITHIN_ULP_MIN = 0.999           # share of bf16 stem outputs within 1 ulp
# (the control, the plain version with the weights left in f32, must fall
# below it; the kernels phase reports its share)
STEM_BWD_SHAPE = (8, 800, 1344 * 3)   # the train phase's batch
TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR = 8, 20, 3e-4
TRAIN_PAGE = (800, 1300)              # resize scale 1.0 -> bucket 800x1344
PARITY_SIDES, PARITY_PAGE = (256, 384), (256, 384)
# B5 (R, K): config 5's 16 pages x 3 classes, then 128 pages x 3
SOFT_SHAPES = [(48, 1024), (384, 1024)]
SOFT_PICKS = 300
SOFT_SIGMA = 0.5
# config 4 at batch 4: (stage, H = W, C, M, chain depth)
BLOCK_STAGES = [(2, 256, 256, 64, 2), (3, 128, 512, 128, 3),
                (4, 64, 1024, 256, 3), (5, 32, 2048, 512, 2)]
BLOCK_BATCH = 4
BLOCK_TIMED_BATCH = 16               # config 4's dispatch: one launch a stage timed,
BLOCK_BURST = 10                     # in bursts of 10 calls (device time, not host)
# the bf16 (tensor-core) block at depth 1 vs its plain version: least share
# of outputs within 1 bf16 ulp, most ulps of max(|v|, 1) of any output, most
# relative Frobenius error. Set from the sound readings at the four stage
# shapes on an H100 (>= 0.9966, 1 ulp, <= 5.5e-4), below every control's
# (share <= 0.995, or >= 3 ulp, and rel-Frobenius >= 1.8e-3); PERF.md.
BLOCK_BF16_LIMITS = {"share_within_1ulp": 0.99, "max_ulps_floor1": 2.0,
                     "rel_fro": 1e-3}
# B7: conv3 of ResNet stages 2-5 at 800x1344, (stage, H, W, K, N)
# (tools/perf_fused_conv.py), checked at batch 4, timed at batch 16
CONV1X1_STAGES = [(2, 200, 336, 64, 256), (3, 100, 168, 128, 512),
                  (4, 50, 84, 256, 1024), (5, 25, 42, 512, 2048)]
CONV1X1_BATCH, CONV1X1_TIMED_BATCH, CONV1X1_TIMED = 4, 16, (2, 4)
# the bf16 kernel vs its plain version: least share of outputs equal, most
# ulps of the element's chain scale (the largest magnitude among the plain
# version's rounded intermediates y, y * inv, + off, + residual, and 1; the
# offset and residual may cancel the output into a lower binade). The two
# differ only where the f32 sums, run in another order, round the product y
# to the neighbouring bf16 value: one ulp of y times inv (< 1.5 here), and
# the three roundings after it can each add one ulp, so 4.5 ulps of the
# chain scale bound it. The contracted-FMA control must fail the share.
CONV1X1_BF16_LIMITS = {"share_equal": 0.999, "max_ulps_chain": 4.5}
R101_SIDE, R101_PAGE, R101_PAGES = 1024, (1100, 1000), 16  # -> 1024x931, bucket 1024^2
SERVE_REQUESTS, SERVE_MAX_BATCH, SERVE_MAX_DELAY_MS = 32, 16, 50.0
R101_PARITY_SIDE = 512
# identity blocks of ResNet-101 (3, 4, 23, 3 blocks a stage), one launch each
R101_BLOCK_LAUNCHES = 2 + 3 + 22 + 2
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 tensor-core
# and f32 (outside the tensor cores) operations/s
PEAK = {"bytes": 3.35e12, "bf16": 989e12, "f32": 67e12}
# operations of one exact IoU in the NMS kernel: 2 max, 2 min, 2 subtract,
# 2 clamps, a product, the union's add and subtract, a divide, a compare
IOU_OPS = 13
# operations of one soft-NMS decay step: the IoU, the gaussian's square,
# negate, divide and exp, the product with the score, and the argmax compare
SOFT_OPS = IOU_OPS + 4 + 1 + 1


class PhaseError(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond, msg) -> None:
    if not cond:
        raise PhaseError(msg)


def median_ms(fn, iters: int = 10, warmup: int = 2, burst: int = 1) -> float:
    """Median of per-call CUDA-event times, after warm-up calls; with
    `burst`, each time spans that many calls in a row and is divided by it
    (the host work of a call then overlaps the device work before it)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(burst):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / burst)
    times.sort()
    return times[len(times) // 2]


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bound(n_bytes: float, n_ops: float, rate: str):
    """(least ms on the card, what bounds it): bytes over the HBM rate vs
    operations over the peak rate of their type."""
    t_bytes = n_bytes / PEAK["bytes"] * 1e3
    t_ops = n_ops / PEAK[rate] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_profile(fn, match: str = "", steps: int = 1, top: int = 8):
    """Run fn `steps` times under torch.profiler: wall seconds, the
    device's busy milliseconds (the union of its kernel and copy intervals;
    a user annotation's device span covers the gaps between its kernels, so
    annotations are left out), the summed device milliseconds and count of
    the kernels whose name holds `match`, and the `top` kernels by summed
    device time as [name, ms]."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    spans, by_name, hit_us, hits = [], {}, 0.0, 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        by_name[e.name] = by_name.get(e.name, 0.0) + (b - a) / 1e3
        if match and match in e.name:
            hit_us += b - a
            hits += 1
    spans.sort()
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_s": wall, "device_busy_ms": busy_us / 1e3,
            "matched_ms": hit_us / 1e3, "matched_kernels": hits,
            "top_kernels_ms": [[n[:80], round(ms, 4)] for n, ms in ranked]}


def rel_fro(got, want) -> float:
    """||got - want|| / ||want|| in float64."""
    import torch

    got, want = got.double(), want.double()
    return (torch.linalg.vector_norm(got - want)
            / torch.linalg.vector_norm(want).clamp_min(1e-300)).item()


def bf16_ulp(t):
    """Spacing of the bf16 grid at |t| (float32 tensor)."""
    import torch

    a = t.abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def bf16_within_ulp(got, want) -> float:
    """Share of elements within one bf16 ulp of max(|got|, |want|), or
    within 1e-5 (float32 tensors)."""
    import torch

    d = (got - want).abs()
    ulp = bf16_ulp(torch.maximum(got.abs(), want.abs()))
    return ((d <= ulp) | (d <= 1e-5)).float().mean().item()


def stem_unrounded_weights(packed, k7, inv, off):
    """B1's control: the plain bf16 stem with the weights left in f32 (the
    contract rounds them to bf16), float32 NHWC."""
    import torch
    import torch.nn.functional as F

    from tdnet_torch.device import no_tf32
    from tdnet_torch.models.resnet import max_pool_same
    from tdnet_torch.ops import stem

    x, _ = stem._plain_operands(packed, k7, "caffe", torch.bfloat16)
    with no_tf32():
        y = F.conv2d(x, k7.permute(3, 2, 0, 1), stride=2)
    y = y * inv[None, :, None, None] + off[None, :, None, None]
    y = max_pool_same(torch.relu(y).to(torch.bfloat16).float())
    return y.permute(0, 2, 3, 1)


# ------------------------------------------------------------------ phases


def phase_device():
    import torch

    require(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    # f32 phases compare against full-f32 references: no TF32 anywhere
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit({"phase": "device", "ok": True, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi_line,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "tf32": "off (cudnn and matmul)"})
    return smi_line


def phase_build():
    from tdnet_torch import _build

    t0 = time.monotonic()
    path = _build.build(force=True)
    _build.library()
    emit({"phase": "build", "ok": True, "seconds": round(time.monotonic() - t0, 3),
          "library": str(path.relative_to(ROOT)), "flags": " ".join(_build.NVCC_FLAGS)})


def phase_kernels(dev):
    """Each kernel vs its plain version at main-path shapes, and times."""
    import numpy as np
    import torch

    from tdnet_torch.ops import ingest, stem
    from tdnet_torch.ops.stem_vjp import stem_reference_packed

    rng = np.random.RandomState(SEED)
    results = {}

    # ---- ingest: bit-exact, caffe/tf x f32/bf16
    x = torch.from_numpy(rng.randint(0, 256, (INGEST_ROWS, 3072)).astype(np.uint8)).to(dev)
    ingest_err = 0.0
    for mode in ("caffe", "tf"):
        for dt in (torch.float32, torch.bfloat16):
            got = ingest.normalize_uint8_rows(x, mode, dt)
            want = ingest.normalize_uint8_rows_plain(x, mode, dt)
            require(torch.equal(got, want), f"ingest {mode} {dt} differs from plain")
            ingest_err = max(ingest_err,
                             (got.float() - want.float()).abs().max().item())
    results["ingest"] = {
        "max_abs_err": ingest_err,
        "ms": median_ms(lambda: ingest.normalize_uint8_rows(x, "caffe", torch.bfloat16)),
        "plain_ms": median_ms(
            lambda: ingest.normalize_uint8_rows_plain(x, "caffe", torch.bfloat16)),
        "shape": [INGEST_ROWS, 3072],
        # reads 1 byte and writes 2 per element; a subtract and a multiply
        "bound": bound(x.numel() * 3, x.numel() * 2, "f32")}
    del x

    # ---- stem: f32 rtol 2e-5 / atol 2e-3; bf16 within 1 ulp (or 1e-5)
    k7 = torch.from_numpy(rng.normal(0, 0.08, (7, 7, 3, 64)).astype(np.float32)).to(dev)
    inv = torch.from_numpy(rng.uniform(0.5, 1.5, 64).astype(np.float32)).to(dev)
    off = torch.from_numpy(rng.normal(0, 0.5, 64).astype(np.float32)).to(dev)
    stem_err, stem_info = 0.0, []
    for shape in STEM_SHAPES:
        packed = torch.from_numpy(rng.randint(0, 256, shape).astype(np.uint8)).to(dev)
        for dt in (torch.bfloat16, torch.float32):
            got = stem.fused_stem_packed(packed, k7, inv, off, "caffe", dt).float()
            want = stem.fused_stem_plain(packed, k7, inv, off, "caffe", dt).float()
            require(torch.isfinite(got).all().item(), f"stem {shape} {dt}: non-finite")
            d = (got - want).abs()
            err = d.max().item()
            stem_err = max(stem_err, err)
            info = {"shape": list(shape), "dtype": str(dt).split(".")[-1],
                    "max_abs_err": err}
            if dt == torch.float32:
                ok = bool((d <= 2e-3 + 2e-5 * want.abs()).all().item())
                require(ok, f"stem f32 {shape}: beyond rtol 2e-5 atol 2e-3 "
                            f"(max {err})")
            else:
                within = bf16_within_ulp(got, want)
                info["share_within_1ulp"] = within
                info["share_exact"] = (d == 0).float().mean().item()
                require(within >= BF16_WITHIN_ULP_MIN,
                        f"stem bf16 {shape}: only {within} within 1 ulp")
                control = bf16_within_ulp(
                    stem_unrounded_weights(packed, k7, inv, off), want)
                info["control_unrounded_weights_share"] = control
                require(control < BF16_WITHIN_ULP_MIN,
                        f"stem bf16 {shape}: the unrounded-weights control "
                        f"passes the limit ({control})")
            stem_info.append(info)
        if shape == STEM_SHAPES[0]:
            b, h, w3 = shape
            results["stem"] = {
                "ms": median_ms(lambda: stem.fused_stem_packed(
                    packed, k7, inv, off, "caffe", torch.bfloat16)),
                "plain_ms": median_ms(lambda: stem.fused_stem_plain(
                    packed, k7, inv, off, "caffe", torch.bfloat16)),
                # the port's unfused path: the normalize kernel, then cuDNN
                # bf16 conv, BN, ReLU and pool as PyTorch ops
                "library_ms": median_ms(lambda: stem_reference_packed(
                    packed, k7, inv, off, "caffe", torch.bfloat16)),
                "shape": list(shape),
                # u8 in, bf16 pooled out; 147 bf16-rounded products a conv
                # output and channel
                "bound": bound(b * h * w3 + b * (h // 4) * (w3 // 12) * 64 * 2,
                               2 * 147 * 64 * b * (h // 2) * (w3 // 6), "bf16")}
        del packed, got, want, d
    results["stem"]["max_abs_err"] = stem_err
    results["stem"]["checks"] = stem_info

    results["nms"] = check_nms(dev, rng)
    results["stem_bwd"] = check_stem_bwd(dev, rng, k7, inv, off)
    results["soft_nms"] = check_soft_nms(dev, rng)
    results["block"] = check_block(dev, rng)
    results["conv1x1"] = check_conv1x1(dev, rng)
    emit({"phase": "kernels", "ok": True, "results": results})
    return results


def clustered_boxes(rng, r, k):
    """(r, k, 4) float32 candidates clustered around 12 centres a row on an
    800x1344 page, sizes 20-300 px."""
    import numpy as np

    centres = rng.uniform(0, 1344, (r, 12, 2))
    pick = rng.randint(0, 12, (r, k))
    c = np.take_along_axis(centres, pick[..., None], axis=1) \
        + rng.normal(0, 12, (r, k, 2))
    wh = rng.uniform(20, 300, (r, k, 2))
    return np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)


def nms_rows(rng, r, k):
    """Score-sorted rows of clustered candidates with 5% invalid slots and
    a 100-slot invalid tail (the below-threshold end of a top-k row): numpy
    boxes (r, k, 4) float32 and valid (r, k) bool."""
    boxes = clustered_boxes(rng, r, k)
    valid = rng.uniform(size=(r, k)) > 0.05
    valid[:, -100:] = False
    return boxes, valid


def nms_inputs(rng):
    """{(R, K): (boxes, valid)} for B2: NMS_SHAPES[0] from `rng`, the other
    shapes from seed SEED + 1, and 4 rows of NMS_RAGGED_K: clustered, all
    invalid, 8 boxes repeated exactly (all valid), clustered."""
    import numpy as np

    inputs = {NMS_SHAPES[0]: nms_rows(rng, *NMS_SHAPES[0])}
    other = np.random.RandomState(SEED + 1)
    for shape in NMS_SHAPES[1:]:
        inputs[shape] = nms_rows(other, *shape)
    boxes, valid = nms_rows(other, 4, NMS_RAGGED_K)
    valid[1] = False
    boxes[2] = np.tile(boxes[2, :8], (NMS_RAGGED_K // 8, 1))
    valid[2] = True
    inputs[(4, NMS_RAGGED_K)] = (boxes, valid)
    return inputs


def check_nms(dev, rng):
    """The NMS kernel vs its plain version on `nms_inputs`: keep masks
    exact (0 mismatched slots), and each input keeps something and
    suppresses something (0 < kept < valid). Timed at NMS_SHAPES in bursts
    of NMS_BURST calls; the bound counts this run's work, each kept box
    against every later box of its row (the greedy walk's pairs)."""
    import torch

    from tdnet_torch.ops import nms_kernel

    checks, timed, worst = [], [], 0.0
    for (r, k), (b_np, v_np) in nms_inputs(rng).items():
        boxes = torch.from_numpy(b_np).to(dev)
        valid = torch.from_numpy(v_np).to(dev)
        got = nms_kernel.nms_keep(boxes, valid, 0.5)
        want = nms_kernel.nms_keep_plain(boxes, valid, 0.5)
        mism = int((got != want).sum().item())
        kept, n_valid = int(want.sum().item()), int(valid.sum().item())
        worst = max(worst, (got.float() - want.float()).abs().max().item())
        checks.append({"shape": [r, k], "mismatched_slots": mism,
                       "kept": int(got.sum().item()), "valid": n_valid})
        require(mism == 0, f"nms {r}x{k}: keep masks differ in {mism} slots")
        require(0 < kept < n_valid,
                f"nms {r}x{k}: kept {kept} of {n_valid} valid: nothing kept "
                f"or nothing suppressed")
        if (r, k) in NMS_SHAPES:
            timed.append({
                "shape": [r, k],
                "ms": median_ms(lambda: nms_kernel.nms_keep(boxes, valid, 0.5),
                                burst=NMS_BURST),
                "plain_ms": median_ms(
                    lambda: nms_kernel.nms_keep_plain(boxes, valid, 0.5), iters=5),
                "bound": bound(boxes.numel() * 4 + 2 * valid.numel(),
                               IOU_OPS * nms_pairs(got), "f32")})
        del boxes, valid, got, want
    return {"max_abs_err": worst, **timed[0], "batch_128": timed[1],
            "checks": checks}


def soft_rows(rng, r, k):
    """Soft-NMS rows as the deferred tail hands them over: clustered
    candidates, scores sorted descending with a 100-slot tail at 0 (below
    the threshold), and the last row's second half an exact copy of its
    first (exact ties: the lowest index is picked first; linear decay
    reaches 0 at IoU 1). numpy boxes (r, k, 4) and scores (r, k), float32."""
    import numpy as np

    boxes = clustered_boxes(rng, r, k)
    scores = np.sort(rng.uniform(0.05, 1.0, (r, k)), axis=1)[:, ::-1].astype(np.float32)
    scores[:, -100:] = 0.0
    boxes[-1, k // 2:] = boxes[-1, :k // 2]
    scores[-1, k // 2:] = scores[-1, :k // 2]
    return boxes, np.ascontiguousarray(scores)


def soft_inputs(rng):
    """{(R, K): (boxes, scores)} for B5: SOFT_SHAPES[0] from `rng`, the
    others from seed SEED + 2."""
    import numpy as np

    inputs = {SOFT_SHAPES[0]: soft_rows(rng, *SOFT_SHAPES[0])}
    other = np.random.RandomState(SEED + 2)
    for shape in SOFT_SHAPES[1:]:
        inputs[shape] = soft_rows(other, *shape)
    return inputs


def check_soft_nms(dev, rng):
    """The soft-NMS kernel vs its plain version on `soft_inputs` (config
    5's 48 rows and 128 pages' 384), gaussian sigma 0.5 and linear at IoU
    0.3, 300 picks. Tolerance: rtol 1e-5, atol 1e-6 (the reference's,
    tests/ops/test_soft_nms.py); rows whose set of selected boxes differs:
    0; the duplicate row picks the lower index first. Gaussian timed at
    each shape in bursts of NMS_BURST calls."""
    import torch

    from tdnet_torch.ops import soft_nms

    checks, timed, worst = [], [], 0.0
    for (r, k), (b_np, s_np) in soft_inputs(rng).items():
        boxes = torch.from_numpy(b_np).to(dev)
        scores = torch.from_numpy(s_np).to(dev)
        for method in ("gaussian", "linear"):
            kw = dict(method=method, sigma=SOFT_SIGMA, iou_threshold=0.3,
                      max_selections=SOFT_PICKS)
            got = soft_nms.soft_nms_rescore_batched(boxes, scores, **kw)
            want = soft_nms.soft_nms_rescore_plain(boxes, scores, **kw)
            name = f"soft_nms {r}x{k} {method}"
            require(torch.isfinite(got).all().item(), f"{name}: non-finite")
            d = (got - want).abs()
            err = d.max().item()
            worst = max(worst, err)
            rows_differ = int(((got > 0) != (want > 0)).any(dim=1).sum().item())
            checks.append({"shape": [r, k], "method": method, "max_abs_err": err,
                           "rows_with_other_selections": rows_differ,
                           "selected": int((want > 0).sum().item()),
                           "decayed_before_pick":
                               int(((want > 0) & (want < scores)).sum().item())})
            require(bool((d <= 1e-6 + 1e-5 * want.abs()).all().item()),
                    f"{name}: beyond rtol 1e-5 / atol 1e-6 (max {err})")
            require(rows_differ == 0, f"{name}: {rows_differ} rows select other boxes")
            dup = got[-1].cpu().numpy()
            require(dup[0] > 0 and dup[k // 2] < dup[0],
                    f"{name}: the tie rule did not pick the lower index first")
            if method == "gaussian":
                picks_per_row = (want > 0).sum(dim=1)
                valid = (scores > 0.001).sum(dim=1)
                # each pick decays every remaining (finite) candidate of its row
                steps = sum(int(vr) * int(pr) - int(pr) * (int(pr) + 1) // 2
                            for vr, pr in zip(valid.tolist(), picks_per_row.tolist()))
                timed.append({
                    "shape": [r, k],
                    "ms": median_ms(lambda: soft_nms.soft_nms_rescore_batched(
                        boxes, scores, **kw), burst=NMS_BURST),
                    "plain_ms": median_ms(lambda: soft_nms.soft_nms_rescore_plain(
                        boxes, scores, **kw), iters=5),
                    "bound": bound(boxes.numel() * 4 + 2 * scores.numel() * 4,
                                   SOFT_OPS * steps, "f32")})
        del boxes, scores, got, want, d
    return {"max_abs_err": worst, **timed[0], "batch_128": timed[1],
            "picks": SOFT_PICKS, "checks": checks}


def _chain_inputs(rng, dev, depth, hw, c, m, batch):
    """x and a depth-D chain's weights, scaled so activations stay O(1)."""
    import numpy as np
    import torch

    def f(*shape, s=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * s).astype(np.float32)).to(dev)

    def u(*shape):
        return torch.from_numpy(rng.uniform(0.5, 1.5, shape).astype(np.float32)).to(dev)

    x = f(batch, hw, hw, c)
    weights = (f(depth, c, m, s=c ** -0.5), f(depth, 3, 3, m, m, s=(9 * m) ** -0.5),
               f(depth, m, c, s=0.5 * m ** -0.5), u(depth, m), f(depth, m, s=0.1),
               u(depth, m), f(depth, m, s=0.1), u(depth, c), f(depth, c, s=0.1))
    return x, weights


def bf16_readings(got, want):
    """How far a bf16 result lies from its reference: the share of elements
    within 1 bf16 ulp of the larger magnitude (or 1e-5), the largest error
    in ulps of max(|value|, 1) (a ReLU whose input lands near 0 switches
    between exact 0 and a small value, where a ulp of the value itself
    means nothing), and the relative Frobenius error."""
    import torch

    got, want = got.float(), want.float()
    d = (got - want).abs()
    big = torch.maximum(got.abs(), want.abs())
    ulp = bf16_ulp(big)
    return {"share_within_1ulp": ((d <= ulp) | (d <= 1e-5)).float().mean().item(),
            "share_exact": (d == 0).float().mean().item(),
            "max_ulps_floor1": (d / bf16_ulp(big.clamp_min(1.0))).max().item(),
            "rel_fro": rel_fro(got, want), "max_abs_err": d.max().item()}


def bf16_block_ok(r) -> bool:
    lim = BLOCK_BF16_LIMITS
    return (r["share_within_1ulp"] >= lim["share_within_1ulp"]
            and r["max_ulps_floor1"] <= lim["max_ulps_floor1"]
            and r["rel_fro"] <= lim["rel_fro"])


def _block_variant(x, weights, accumulate="f32", pad="t1"):
    """One bf16 identity block (depth 1) as the plain version computes it,
    with matrix products instead of convolutions, changed where asked:
    accumulate "f64" (products and BN in float64: the rounding points'
    exact values), "bf16" (every 32-deep partial product rounded to bf16
    and summed in bf16, as a kernel that kept its accumulator in bf16
    between k-chunks would) or "f32"; pad "x" zero-pads x instead of t1
    (conv2's SAME padding in the wrong place)."""
    import torch
    import torch.nn.functional as F

    w1, w2, w3, i1, o1, i2, o2, i3, o3 = (t[0] for t in weights)
    cd = x.dtype
    f = torch.float64 if accumulate == "f64" else torch.float32

    def mm(a, w):
        w = w.to(cd).to(f)
        if accumulate != "bf16":
            return a @ w
        acc = None
        for k0 in range(0, a.shape[-1], 32):
            part = (a[..., k0:k0 + 32] @ w[k0:k0 + 32]).to(torch.bfloat16)
            acc = part if acc is None else acc + part
        return acc.to(f)

    def bn_relu(t, inv, off):
        return torch.relu(t * inv.to(f) + off.to(f))

    b, h, w, c = x.shape
    m = w1.shape[1]
    xf = x.to(f)
    if pad == "x":
        t1p = bn_relu(mm(F.pad(xf, (0, 0, 1, 1, 1, 1)), w1), i1, o1).to(cd).to(f)
    else:
        t1p = F.pad(bn_relu(mm(xf, w1), i1, o1).to(cd).to(f), (0, 0, 1, 1, 1, 1))
    cols = torch.cat([t1p[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)],
                     dim=-1)
    t2 = bn_relu(mm(cols, w2.reshape(9 * m, m)), i2, o2).to(cd).to(f)
    return torch.relu(mm(t2, w3) * i3.to(f) + o3.to(f) + xf).to(cd)


def _cudnn_blocks(weights, dev, c, m, depth):
    """The port's unfused path for a chain's weights: one eval-mode
    ``Bottleneck`` module (cuDNN convolutions, channels_last) a block, its
    frozen BN folding to the chain's (inv, off) pairs."""
    import torch

    from tdnet_torch.models.resnet import Bottleneck

    blocks = []
    for d in range(depth):
        blk = Bottleneck(c, m).to(dev)
        with torch.no_grad():
            blk.conv1.weight.copy_(weights[0][d].t()[:, :, None, None])
            blk.conv2.weight.copy_(weights[1][d].permute(3, 2, 0, 1))
            blk.conv3.weight.copy_(weights[2][d].t()[:, :, None, None])
            for j, bn in enumerate((blk.bn1, blk.bn2, blk.bn3)):
                bn.scale.copy_(weights[3 + 2 * j][d])
                bn.bias.copy_(weights[4 + 2 * j][d])
                bn.var.fill_(1.0 - bn.epsilon)  # folds to inv = scale
        blocks.append(blk.to(memory_format=torch.channels_last).eval())

    def run(x):
        with torch.inference_mode():
            y = x.permute(0, 3, 1, 2)
            for blk in blocks:
                y = blk(y)
            return y

    return run


def block_bound(x, depth, c, m):
    """((ms, what bounds it), operations) of a bf16 chain of `depth` blocks
    on x: x read and the output written in bf16, bf16 weights and f32 BN
    vectors read once, 2 (2CM + 9M^2) operations a pixel and block on the
    tensor cores."""
    b, h, w, _ = x.shape
    flops = 2 * b * h * w * depth * (2 * c * m + 9 * m * m)
    wbytes = depth * (2 * c * m + 9 * m * m) * 2 + depth * (4 * m + 2 * c) * 4
    return bound(2 * x.numel() * 2 + wbytes, flops, "bf16"), flops


def check_block(dev, rng):
    """The fused bottleneck kernel vs its plain version on config 4's four
    stage shapes at batch 4, and again at config 4's batch 16.

    f32 (TF32 off, the CUDA-core body): the stage's chain, within rtol =
    atol = 3e-5 (tests/ops/test_pallas_block.py's chain bound).

    bf16 (the tensor-core body, config 4's path): one block at each stage,
    held to BLOCK_BF16_LIMITS. The tensor cores accumulate in f32 but do
    not round like the plain version's FMA chain, so a t1 or t2 value near a
    bf16 rounding boundary can round the other way, and moves the rest of
    its pixel by an ulp. Controls, judged by the same limits, must fail:
    the block with its products summed in bf16 between 32-deep chunks, with
    SAME padding on x instead of t1, and the kernel itself fed a 3x3 filter
    whose left and right taps are swapped, or its BN vectors rounded to
    bf16. Reported beside them: the kernel's and the plain version's
    distance from the float64 block. Two runs of the kernel on the same
    input must be bit-equal (the persistent grid walks its tiles in a fixed
    order). At batch 16 (config 4's dispatch), where the persistent grid
    wraps at every stage, one bf16 block a stage is held to the same limits
    and must be bit-equal too.

    Timed, at batch 16: that launch at each stage shape, with its bound and
    the port's unfused path on the same input (one cuDNN ``Bottleneck``) as
    the library yardstick, both in bursts of BLOCK_BURST calls so that the
    wrapper's host work does not count; stage 4 also against the plain
    version. The kernels line reports stage 4 at batch 16. Also timed, for
    the history of PERF.md: stage 4's 3-block chain at batch 4."""
    import torch

    from tdnet_torch.ops import block

    checks, worst, timed, per_stage = [], 0.0, None, []
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for stage, hw, c, m, depth in BLOCK_STAGES:
        x32, weights = _chain_inputs(rng, dev, depth, hw, c, m, BLOCK_BATCH)
        info = {"stage": stage, "shape": [BLOCK_BATCH, hw, hw, c], "cmid": m}
        # f32: the whole chain
        got = block.fused_bottleneck_chain(x32, *weights)
        want = block.fused_bottleneck_chain_plain(x32, *weights)
        require(torch.isfinite(got).all().item(), f"block stage {stage} f32: non-finite")
        d = (got - want).abs()
        err = d.max().item()
        worst = max(worst, err)
        require(bool((d <= 3e-5 + 3e-5 * want.abs()).all().item()),
                f"block stage {stage} f32: beyond rtol/atol 3e-5 (max {err})")
        info["f32"] = {"depth": depth, "max_abs_err": err,
                       "scale": want.abs().max().item()}
        del got, want, d
        # bf16: one block, its readings and the controls'
        x = x32.to(torch.bfloat16)
        one = tuple(t[:1] for t in weights)
        got = block.fused_bottleneck_chain(x, *one)
        want = block.fused_bottleneck_chain_plain(x, *one)
        require(torch.isfinite(got).all().item(), f"block stage {stage} bf16: non-finite")
        require(torch.equal(got, block.fused_bottleneck_chain(x, *one)),
                f"block stage {stage} bf16: two runs differ")
        sound = bf16_readings(got, want)
        worst = max(worst, sound["max_abs_err"])
        swapped = one[1].clone()
        swapped[:, 1, 0], swapped[:, 1, 2] = one[1][:, 1, 2], one[1][:, 1, 0]
        bn16 = tuple(t.to(torch.bfloat16).float() for t in one[3:])
        controls = {
            "accumulate_bf16": _block_variant(x, one, accumulate="bf16"),
            "pad_x_not_t1": _block_variant(x, one, pad="x"),
            "kernel_taps_swapped": block.fused_bottleneck_chain(
                x, one[0], swapped, *one[2:]),
            "kernel_bn_rounded_to_bf16": block.fused_bottleneck_chain(x, *one[:3], *bn16),
        }
        controls = {k: bf16_readings(v, want) for k, v in controls.items()}
        f64 = _block_variant(x, one, accumulate="f64")
        info["bf16"] = {
            "depth": 1, "scale": want.float().abs().max().item(), "kernel": sound,
            "runs_bit_equal": True, "controls": controls,
            "kernel_vs_f64": bf16_readings(got, f64),
            "plain_vs_f64": bf16_readings(want, f64)}
        require(bf16_block_ok(sound), f"block stage {stage} bf16: {sound} "
                                      f"beyond {BLOCK_BF16_LIMITS}")
        for name, r in controls.items():
            require(not bf16_block_ok(r),
                    f"block stage {stage} bf16: control {name} passes the limits: {r}")
        del got, want, f64, swapped
        if stage == 4:  # PERF.md's history: the 3-block chain at batch 4
            unfused = _cudnn_blocks(weights, dev, c, m, depth)
            (bnd, flops) = block_bound(x, depth, c, m)
            info["chain_b4"] = {
                "ms": median_ms(lambda: block.fused_bottleneck_chain(x, *weights)),
                "plain_ms": median_ms(lambda: block.fused_bottleneck_chain_plain(x, *weights),
                                      iters=5),
                "library_ms": median_ms(lambda: unfused(x)),
                "shape": [BLOCK_BATCH, hw, hw, c], "cmid": m, "depth": depth,
                "gflop": flops / 1e9, "bound": bnd}
            del unfused
        # batch 16: one launch at each stage, checked and timed
        x16 = torch.randn((BLOCK_TIMED_BATCH, hw, hw, c), generator=gen, device=dev,
                          dtype=torch.float32).to(torch.bfloat16)
        got = block.fused_bottleneck_chain(x16, *one)
        want = block.fused_bottleneck_chain_plain(x16, *one)
        require(torch.isfinite(got).all().item(),
                f"block stage {stage} bf16 batch 16: non-finite")
        require(torch.equal(got, block.fused_bottleneck_chain(x16, *one)),
                f"block stage {stage} bf16 batch 16: two runs differ")
        sound = bf16_readings(got, want)
        worst = max(worst, sound["max_abs_err"])
        require(bf16_block_ok(sound), f"block stage {stage} bf16 batch 16: {sound} "
                                      f"beyond {BLOCK_BF16_LIMITS}")
        del got, want
        unfused = _cudnn_blocks(one, dev, c, m, 1)
        (bnd, flops) = block_bound(x16, 1, c, m)
        row = {"stage": stage, "shape": list(x16.shape), "cmid": m, "depth": 1,
               "gflop": flops / 1e9, "bound": bnd, "kernel": sound,
               "runs_bit_equal": True,
               "ms": median_ms(lambda: block.fused_bottleneck_chain(x16, *one),
                               burst=BLOCK_BURST),
               "library_ms": median_ms(lambda: unfused(x16), burst=BLOCK_BURST)}
        if stage == 4:
            row["plain_ms"] = median_ms(
                lambda: block.fused_bottleneck_chain_plain(x16, *one), iters=5)
            timed = {k: row[k] for k in ("ms", "plain_ms", "library_ms", "bound")}
            timed.update(timed_shape=row["shape"], timed_cmid=m, timed_depth=1,
                         timed_dtype="bfloat16", timed_gflop=row["gflop"])
        per_stage.append(row)
        checks.append(info)
        del x, x32, x16, weights, unfused
    return {"max_abs_err": worst, **timed, "checks": checks, "batch16": per_stage,
            "bf16_limits": BLOCK_BF16_LIMITS,
            "library": "the port's unfused path: Bottleneck modules, cuDNN bf16 convs"}


def _conv1x1_inputs(rng, dev, batch, h, w, k, n):
    """conv3 of a bottleneck: x (B, H, W, K) and a residual (B, H, W, N)
    at 0.5 std, the (K, N) weight at 0.05 std, a BN pair
    (tools/perf_fused_conv.py's scales)."""
    import numpy as np
    import torch

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    return (t(rng.standard_normal((batch, h, w, k)) * 0.5),
            t(rng.standard_normal((k, n)) * 0.05), t(rng.uniform(0.5, 1.5, n)),
            t(rng.standard_normal(n) * 0.1),
            t(rng.standard_normal((batch, h, w, n)) * 0.5))


def _conv1x1_product(x, w):
    """The plain version's product y = bf16(x . w) as (M, N) (TF32 off)."""
    from tdnet_torch.device import no_tf32

    with no_tf32():
        return (x.reshape(-1, w.shape[0]).float() @ w.to(x.dtype).float()).to(x.dtype)


def _conv1x1_contracted(y, inv, off, res):
    """The control: the plain version's epilogue with y * inv + off
    contracted into one f32 FMA and rounded once (y * inv of two bf16
    values is exact in f32, so the f32 multiply-add is the FMA)."""
    import torch

    cd = y.dtype
    t = (y.float() * inv.to(cd).float() + off.to(cd).float()).to(cd)
    if res is not None:
        t = t + res.reshape(t.shape).to(cd)
    return torch.relu(t)


def conv1x1_chain_scale(y, inv, off, res):
    """The largest magnitude among the plain version's rounded
    intermediates of each output: y, y * inv, + off and + residual (each
    rounded to bf16)."""
    import torch

    cd = y.dtype
    steps = [y, y * inv.to(cd)]
    steps.append(steps[-1] + off.to(cd))
    if res is not None:
        steps.append(steps[-1] + res.reshape(y.shape).to(cd))
    return torch.stack([t.float().abs() for t in steps]).amax(dim=0)


def conv1x1_readings(got, want, scale):
    """Share of outputs equal to the reference, the largest error in ulps
    of max(|v|, 1) and of the chain scale max(|v|, scale, 1), relative
    Frobenius error."""
    import torch

    got, want = got.float(), want.float()
    d = (got - want).abs()
    big = torch.maximum(got.abs(), want.abs()).clamp_min(1.0)
    return {"share_equal": (d == 0).float().mean().item(),
            "max_ulps_floor1": (d / bf16_ulp(big)).max().item(),
            "max_ulps_chain": (d / bf16_ulp(torch.maximum(big, scale))).max().item(),
            "rel_fro": rel_fro(got, want), "max_abs_err": d.max().item()}


def conv1x1_ok(r) -> bool:
    return (r["share_equal"] >= CONV1X1_BF16_LIMITS["share_equal"]
            and r["max_ulps_chain"] <= CONV1X1_BF16_LIMITS["max_ulps_chain"])


def check_conv1x1(dev, rng):
    """The fused 1x1 conv kernel (B7) vs its plain version at the conv3
    shapes of ResNet stages 2-5 at 800x1344 (tools/perf_fused_conv.py), batch
    4, ReLU on, with and without the residual.

    bf16 (tensor cores): CONV1X1_BF16_LIMITS (>= 99.9% of outputs equal,
    <= 4.5 ulps of the chain scale); the control, the same epilogue
    contracted to one f32 FMA and rounded once, must fail them. f32 (CUDA cores, TF32
    off): relative Frobenius error <= 1e-5.

    Timed at batch 16 with the residual, stages 2 and 4: the kernel, the
    plain version, and the port's unfused tail on the same input as the
    library yardstick (torch.matmul in bf16, then PyTorch's elementwise
    ops)."""
    import torch

    from tdnet_torch.ops import conv1x1

    checks, worst = [], 0.0
    for stage, h, w, k, n in CONV1X1_STAGES:
        x32, wt, inv, off, res32 = _conv1x1_inputs(rng, dev, CONV1X1_BATCH, h, w, k, n)
        info = {"stage": stage, "shape": [CONV1X1_BATCH, h, w, k], "n": n}
        for with_res in (True, False):
            tag = f"conv1x1 stage {stage} {'res' if with_res else 'nores'}"
            r32 = res32 if with_res else None
            got = conv1x1.fused_conv1x1(x32, wt, inv, off, residual=r32)
            want = conv1x1.fused_conv1x1_plain(x32, wt, inv, off, residual=r32)
            require(torch.isfinite(got).all().item(), f"{tag} f32: non-finite")
            f32 = rel_fro(got, want)
            worst = max(worst, (got - want).abs().max().item())
            require(f32 <= 1e-5, f"{tag} f32: rel Frobenius {f32}")
            x, r16 = x32.to(torch.bfloat16), None if r32 is None else r32.to(torch.bfloat16)
            got = conv1x1.fused_conv1x1(x, wt, inv, off, residual=r16)
            want = conv1x1.fused_conv1x1_plain(x, wt, inv, off, residual=r16)
            require(torch.isfinite(got).all().item(), f"{tag} bf16: non-finite")
            y = _conv1x1_product(x, wt)
            scale = conv1x1_chain_scale(y, inv, off, r16).reshape(got.shape)
            sound = conv1x1_readings(got, want, scale)
            control = conv1x1_readings(
                _conv1x1_contracted(y, inv, off, r16).reshape(got.shape), want, scale)
            worst = max(worst, sound["max_abs_err"])
            info["res" if with_res else "nores"] = {
                "f32_rel_fro": f32, "bf16": sound, "control_contracted_fma": control}
            require(conv1x1_ok(sound), f"{tag} bf16: {sound} beyond {CONV1X1_BF16_LIMITS}")
            require(not conv1x1_ok(control),
                    f"{tag} bf16: the contracted-FMA control passes the limits: {control}")
            del got, want, x, r16, y, scale
        checks.append(info)
        del x32, wt, inv, off, res32

    timed = []
    for stage, h, w, k, n in CONV1X1_STAGES:
        if stage not in CONV1X1_TIMED:
            continue
        x32, wt, inv, off, res32 = _conv1x1_inputs(rng, dev, CONV1X1_TIMED_BATCH, h, w, k, n)
        x, res = x32.to(torch.bfloat16), res32.to(torch.bfloat16)
        del x32, res32
        w16, inv16, off16 = wt.to(torch.bfloat16), inv.to(torch.bfloat16), off.to(torch.bfloat16)

        def unfused():
            y = (x.reshape(-1, k) @ w16).reshape(res.shape)
            return torch.relu(y * inv16 + off16 + res)

        m = x.numel() // k
        timed.append({
            "stage": stage, "shape": [CONV1X1_TIMED_BATCH, h, w, k], "n": n,
            "ms": median_ms(lambda: conv1x1.fused_conv1x1(x, wt, inv, off, residual=res)),
            "plain_ms": median_ms(lambda: conv1x1.fused_conv1x1_plain(
                x, wt, inv, off, residual=res), iters=5),
            "library_ms": median_ms(unfused),
            # bf16 x, weight, residual in and out; f32 BN pair; the product
            # on the bf16 tensor cores
            "bound": bound(2 * (m * k + k * n + 2 * m * n) + 8 * n, 2 * m * k * n, "bf16")})
        del x, res, wt, w16
    first = timed[0]
    return {"max_abs_err": worst, "ms": first["ms"], "plain_ms": first["plain_ms"],
            "library_ms": first["library_ms"], "bound": first["bound"],
            "timed": timed, "checks": checks, "bf16_limits": CONV1X1_BF16_LIMITS,
            "library": "the unfused tail: torch.matmul bf16, then * inv + off + "
                       "residual and ReLU as PyTorch elementwise ops"}


def nms_pairs(keep) -> int:
    """IoUs the greedy walk computes: each kept box against every later
    box of its row."""
    import torch

    k = keep.shape[1]
    later = torch.arange(k - 1, -1, -1, device=keep.device)  # k - 1 - i
    return int((keep.to(torch.int64) * later).sum().item())


def check_stem_bwd(dev, rng, k7, inv, off):
    """The fused-stem backward kernel vs its plain version at the train
    phase's batch, on random pages and on constant-colour pages with ruled
    tables (wide exact ties: the first-max routing decides), in f32 and
    bf16; twice each (no atomics, so bit-equal); and fused_stem_train's
    "kernel" backward vs its "remat" backward in f32.

    Tolerances: f32 rtol 1e-4 with atol 1e-5 of the gradient's largest
    element (the 147-tap sums and the 2M-pixel reductions run in another
    order; gradients reach ~2.5e5); bf16: dkernel7 relative Frobenius error
    <= 5e-3 (the kernel rounds dz to bf16 per 4x8 tile, so a conv row or
    column shared by two tiles is rounded twice where the plain version
    rounds once; tests/test_torch_stem_bwd.py measures the same order,
    ~1e-3, against the Pallas kernel), dinv/doff as in f32; kernel vs
    remat in f32: relative Frobenius <= 1e-4. On both pages the bf16
    backward's recomputed activations, pooled, must equal the forward
    kernel's output bit for bit (the shared tensor-core conv tile)."""
    import numpy as np
    import torch

    from tdnet_torch.ops import stem
    from tdnet_torch.ops.stem_vjp import fused_stem_train, stem_reference_packed

    b, h, w3 = STEM_BWD_SHAPE
    w = w3 // 3
    pages = {"random": rng.randint(0, 256, STEM_BWD_SHAPE).astype(np.uint8)}
    tables = np.full((b, h, w, 3), 245, np.uint8)
    for i in range(b):
        y0, x0 = 100 + 20 * i, 200 + 30 * i
        tables[i, y0:y0 + 300, x0:x0 + 600] = 60
        tables[i, y0:y0 + 300:37, x0:x0 + 600] = 30
        tables[i, y0:y0 + 300, x0:x0 + 600:90] = 30
    pages["table"] = tables.reshape(STEM_BWD_SHAPE)
    dy32 = torch.from_numpy(rng.normal(0, 1, (b, h // 4, w // 4, 64))
                            .astype(np.float32)).to(dev)
    checks, worst, fwd_bwd = [], 0.0, {}
    for name, page in pages.items():
        packed = torch.from_numpy(page).to(dev)
        fwd = stem.fused_stem_packed(packed, k7, inv, off, "caffe", torch.bfloat16)
        routed = stem.fused_stem_bwd_pooled(packed, k7, inv, off, "caffe")
        same = (fwd.view(torch.int16) == routed.view(torch.int16))
        fwd_bwd[name] = {"equal": bool(same.all().item()),
                         "share_equal": same.float().mean().item()}
        require(fwd_bwd[name]["equal"],
                f"stem_bwd {name}: the backward's pooled activations differ "
                f"from the forward kernel's ({fwd_bwd[name]['share_equal']} equal)")
        del fwd, routed, same
        for dt in (torch.bfloat16, torch.float32):
            dy = dy32.to(dt)
            got = stem.fused_stem_bwd_packed(packed, k7, inv, off, dy, "caffe", dt)
            again = stem.fused_stem_bwd_packed(packed, k7, inv, off, dy, "caffe", dt)
            want = stem.fused_stem_bwd_plain(packed, k7, inv, off, dy, "caffe", dt)
            tag = f"stem_bwd {name} {str(dt).split('.')[-1]}"
            require(all(torch.equal(g, a) for g, a in zip(got, again)),
                    f"{tag}: two runs differ")
            info = {"page": name, "dtype": str(dt).split(".")[-1]}
            for part, g, wv in zip(("dkernel7", "dinv", "doff"), got, want):
                require(torch.isfinite(g).all().item(), f"{tag} {part}: non-finite")
                d = (g - wv).abs()
                info[part] = {"max_abs_err": d.max().item(),
                              "scale": wv.abs().max().item(),
                              "rel_fro": rel_fro(g, wv)}
                worst = max(worst, d.max().item())
                if part == "dkernel7" and dt == torch.bfloat16:
                    require(info[part]["rel_fro"] <= 5e-3,
                            f"{tag} {part}: rel Frobenius {info[part]['rel_fro']}")
                else:
                    ok = bool((d <= 1e-4 * wv.abs() + 1e-5 * wv.abs().max()).all().item())
                    require(ok, f"{tag} {part}: beyond rtol 1e-4 / atol 1e-5 x max")
            checks.append(info)
    packed = torch.from_numpy(pages["random"]).to(dev)
    dy = dy32.to(torch.bfloat16)

    def remat():  # fused_stem_train's "remat" backward: autograd of the unfused path
        leaves = [t.detach().requires_grad_() for t in (k7, inv, off)]
        with torch.enable_grad():
            y = stem_reference_packed(packed, *leaves, "caffe", torch.bfloat16)
            return torch.autograd.grad(y, leaves, dy)

    timed = {"ms": median_ms(lambda: stem.fused_stem_bwd_packed(
                 packed, k7, inv, off, dy, "caffe", torch.bfloat16)),
             "plain_ms": median_ms(lambda: stem.fused_stem_bwd_plain(
                 packed, k7, inv, off, dy, "caffe", torch.bfloat16), iters=5),
             "library_ms": median_ms(remat, iters=5)}
    grads = {}
    for mode in ("kernel", "remat"):
        k = k7.clone().requires_grad_()
        y = fused_stem_train(packed, k, inv, off, "caffe", torch.float32,
                             backward=mode)
        (y * dy32).sum().backward()
        grads[mode] = k.grad
    kernel_vs_remat = rel_fro(grads["kernel"], grads["remat"])
    require(kernel_vs_remat <= 1e-4,
            f"fused_stem_train kernel vs remat: rel Frobenius {kernel_vs_remat}")
    return {"max_abs_err": worst, **timed, "shape": list(STEM_BWD_SHAPE),
            "checks": checks, "f32_kernel_vs_remat_rel_fro": kernel_vs_remat,
            "bf16_fwd_bwd_activations": fwd_bwd,
            # u8 pages and bf16 dy in, 9536 f32 out; the conv recompute and
            # the filter gradient, 147 bf16-rounded products each
            "bound": bound(b * h * w3 + dy.numel() * 2 + 9536 * 4,
                           2 * 2 * 147 * 64 * b * (h // 2) * (w // 2), "bf16")}


def synthetic_pages(n_land: int, n_port: int, seed: int,
                    sizes=(PAGE_LANDSCAPE, PAGE_PORTRAIT), with_boxes=False):
    """Float32 BGR document pages: light noisy paper with dark ruled
    rectangles (tables) and text-like strokes. With ``with_boxes`` also the
    tables' (x1, y1, x2, y2) boxes, one (m, 4) float32 array per page."""
    import numpy as np

    rng = np.random.RandomState(seed)
    pages, boxes = [], []
    for i in range(n_land + n_port):
        h, w = sizes[0] if i < n_land else sizes[1]
        page = rng.normal(240, 6, (h, w, 3))
        tables = []
        for _ in range(rng.randint(2, 5)):
            y0, x0 = rng.randint(0, h - h // 7), rng.randint(0, w - w // 7)
            y1 = min(h, y0 + rng.randint(h // 10, h // 2))
            x1 = min(w, x0 + rng.randint(w // 9, w // 2))
            page[y0:y1:rng.randint(18, 40), x0:x1] = 30   # row rules
            page[y0:y1, x0:x1:rng.randint(60, 160)] = 30  # column rules
            page[y0:y1, [x0, x1 - 1]] = 30
            page[[y0, y1 - 1], x0:x1] = 30
            tables.append((x0, y0, x1, y1))
        for _ in range(40):
            y, x = rng.randint(0, h - 10), rng.randint(0, w - w // 10)
            page[y:y + 6, x:x + rng.randint(w // 60, w // 10)] -= 120
        pages.append(np.clip(page, 0, 255).astype(np.float32))
        boxes.append(np.asarray(tables, np.float32))
    return (pages, boxes) if with_boxes else pages


class PageDataset:
    """In-memory pages and table boxes behind the loader's Dataset
    protocol (one class)."""

    def __init__(self, pages, boxes):
        self.pages, self.boxes = pages, boxes

    def size(self):
        return len(self.pages)

    def load_image(self, i):
        return self.pages[i]

    def load_annotations(self, i):
        import numpy as np

        return {"bboxes": self.boxes[i], "labels": np.zeros(len(self.boxes[i]), np.int32)}

    def image_aspect_ratio(self, i):
        h, w = self.pages[i].shape[:2]
        return w / h

    def num_classes(self):
        return 1


def smoke_variables():
    """ResNet-50 RetinaNet, 1 class, random weights from the seed. The class
    head's bias moves from the prior (-4.6, below the 0.05 threshold) to -2,
    so most anchors are candidates and NMS has work to do; on these pages
    the random trunk spreads the logits by ~0.6 around it."""
    from tdnet_torch.weights import random_variables

    v = random_variables(1, "resnet50", seed=SEED)
    v["params"]["classification_submodel"]["head"]["bias"][:] = -2.0
    return v


def check_detections(out, pages, buckets, scales, num_classes=1):
    import numpy as np

    total = 0
    for (b, s, l), page, bucket, scale in zip(out, pages, buckets, scales):
        ok = s > -1
        total += int(ok.sum())
        require(np.isfinite(b).all() and np.isfinite(s).all(), "non-finite output")
        require(b.shape == (300, 4) and s.shape == (300,) and l.shape == (300,),
                "unexpected detection shapes")
        if ok.any():
            bb = b[ok]
            require(bb.min() >= 0, "box below 0")
            require(bb[:, [0, 2]].max() <= bucket[1] / scale + 1e-3, "box x beyond canvas")
            require(bb[:, [1, 3]].max() <= bucket[0] / scale + 1e-3, "box y beyond canvas")
            require((s[ok] > 0.05).all() and (l[ok] >= 0).all()
                    and (l[ok] < num_classes).all(), "bad scores/labels")
    return total


def phase_predict(dev, variables):
    """The main path: Predictor.predict_batch in bf16 on 16 pages, then one
    batch through the flat-normalize route; counters reset just before each
    run and read just after."""
    import numpy as np
    import torch

    import tdnet_torch.ops.nms as nms_mod
    from tdnet_torch.data.generator import default_buckets, pick_bucket
    from tdnet_torch.data.image import compute_resize_scale
    from tdnet_torch.models.retinanet import RetinaNet
    from tdnet_torch.ops import ingest, nms_kernel, stem
    from tdnet_torch.train.predictor import Predictor

    counters = {"ingest": ingest.LAUNCHES, "stem": stem.LAUNCHES,
                "nms": nms_kernel.LAUNCHES}
    pages = synthetic_pages(N_LANDSCAPE, N_PORTRAIT, SEED)
    scales = [compute_resize_scale(p.shape, MIN_SIDE, MAX_SIDE) for p in pages]
    buckets = [pick_bucket(round(p.shape[0] * s), round(p.shape[1] * s),
                           default_buckets(MIN_SIDE, MAX_SIDE))
               for p, s in zip(pages, scales)]
    sides = dict(min_side=MIN_SIDE, max_side=MAX_SIDE)

    pred = Predictor(RetinaNet(1, dtype=torch.bfloat16), variables,
                     device=dev, device_preprocess=True, **sides)
    require(pred.fused_stem, "fused_stem did not resolve on for CUDA")

    # warm-up run (cuDNN plans, allocator) that also records what the NMS
    # kernel was given: rows of valid candidates, and suppressions
    nms_rows = []
    orig = nms_mod.nms_keep

    def recording(boxes, valid, iou_threshold=0.5):
        keep = orig(boxes, valid, iou_threshold=iou_threshold)
        nms_rows.append((int(valid.sum(1).min().item()),
                         int((valid & ~keep).sum().item())))
        return keep

    nms_mod.nms_keep = recording
    try:
        pred.predict_batch(pages)
    finally:
        nms_mod.nms_keep = orig
    require(nms_rows, "the NMS kernel never ran")
    require(min(r[0] for r in nms_rows) >= 100,
            f"an NMS row held < 100 valid candidates: {nms_rows}")
    require(sum(r[1] for r in nms_rows) >= 1, "NMS suppressed nothing")

    for c in counters.values():
        c.reset()
    sync(dev)
    t0 = time.monotonic()
    out = pred.predict_batch(pages)
    elapsed = time.monotonic() - t0
    launches = {k: c.count for k, c in counters.items()}
    n_det = check_detections(out, pages, buckets, scales)
    require(launches["stem"] >= 1 and launches["nms"] >= 1,
            f"fused path skipped a kernel: {launches}")

    flat = Predictor(RetinaNet(1, dtype=torch.bfloat16), variables,
                     device=dev, device_preprocess=True, fused_stem=False,
                     **sides)
    flat_pages = pages[:N_LANDSCAPE]
    flat.predict_batch(flat_pages)  # warm-up
    for c in counters.values():
        c.reset()
    out_flat = flat.predict_batch(flat_pages)
    flat_launches = {k: c.count for k, c in counters.items()}
    check_detections(out_flat, flat_pages, buckets, scales)
    require(flat_launches["ingest"] >= 1 and flat_launches["nms"] >= 1,
            f"flat path skipped a kernel: {flat_launches}")
    total = {k: launches[k] + flat_launches[k] for k in counters}
    require(all(v >= 1 for v in total.values()), f"a kernel never launched: {total}")

    emit({"phase": "predict", "ok": True, "pages": len(pages),
          "dtype": "bfloat16", "buckets": sorted({str(b) for b in buckets}),
          "images_per_s": len(pages) / elapsed, "seconds": elapsed,
          "host_prep_s": pred.host_prep_s, "dispatch_s": pred.dispatch_s,
          "detections": n_det, "nms_rows_min_valid": min(r[0] for r in nms_rows),
          "nms_suppressed": sum(r[1] for r in nms_rows),
          "launches_fused_route": launches, "launches_flat_route": flat_launches,
          "peak_mem_gb": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                          if dev.type == "cuda" else None)})
    return total


def _match(got, want, rtol=1e-4, px=0.5):
    """Every detection of `got` has one in `want` with the same label, a
    score within rtol, and a box within px; the counts are equal. Robust to
    two nearly equal scores trading places."""
    import numpy as np

    (gb, gs, gl), (wb, ws, wl) = got, want
    gv, wv = gs > -1, ws > -1
    require(gv.sum() == wv.sum(), f"{gv.sum()} vs {wv.sum()} detections")
    worst = 0.0
    for b, s, l in zip(gb[gv], gs[gv], gl[gv]):
        cand = (wl[wv] == l) & (np.abs(ws[wv] - s) <= rtol * abs(s))
        require(cand.any(), f"no score match for {s}")
        dist = np.abs(wb[wv][cand] - b).max(axis=1).min()
        worst = max(worst, float(dist))
        require(dist <= px, f"box off by {dist} px")
    return worst


def _gap_threshold(probe):
    """A score threshold in the widest gap between the detections ranked
    30..120 of a probe run, and that gap: every detection is clear of it."""
    import numpy as np

    s = np.sort(np.concatenate([p[1][p[1] > -1] for p in probe]))[::-1]
    require(s.size > 120, f"only {s.size} detections to set a threshold from")
    gaps = s[30:120] - s[31:121]
    i = 30 + int(np.argmax(gaps))
    return float((s[i] + s[i + 1]) / 2), float(gaps.max())


def _device_parity(make_predictor, pages, dev):
    """The same pages through make_predictor(device, score_threshold) on
    CUDA (the kernels) and on the CPU (their plain versions), with the
    threshold set in the widest gap of a CUDA probe run; each page's
    detections matched by :func:`_match`."""
    import torch

    thr, gap = _gap_threshold(make_predictor(dev, 0.05).predict_batch(pages))
    runs = {name: make_predictor(d, thr).predict_batch(pages)
            for name, d in (("gpu", dev), ("cpu", torch.device("cpu")))}
    worst, n = 0.0, 0
    for got, want in zip(runs["gpu"], runs["cpu"]):
        worst = max(worst, _match(got, want))
        n += int((got[1] > -1).sum())
    require(n > 0, "parity compared no detections")
    return {"pages": len(pages), "score_threshold": thr, "threshold_gap": gap,
            "detections_compared": n, "max_box_diff_px": worst,
            "score_rtol": 1e-4, "box_tol_px": 0.5}


def phase_parity(dev, variables):
    """2 pages in f32 through the Predictor on CUDA (the kernels) and on the
    CPU (their plain versions). The score threshold is set inside the
    widest gap of the CUDA run's scores (ranks 30..120), so every
    detection is clear of it."""
    from tdnet_torch.models.retinanet import RetinaNet
    from tdnet_torch.train.predictor import Predictor

    sides = dict(min_side=MIN_SIDE, max_side=MAX_SIDE)
    res = _device_parity(
        lambda d, thr: Predictor(RetinaNet(1), variables, device=d,
                                 device_preprocess=True, score_threshold=thr,
                                 **sides),
        synthetic_pages(2, 0, SEED + 1), dev)
    emit({"phase": "parity", "ok": True, **res})


def _host_batch(pages, boxes, sides, batch_size):
    """One BatchLoader batch (uint8 canvases, device_normalize) of pages
    whose resize scale is 1.0."""
    from tdnet_torch.data.generator import BatchLoader, LoaderConfig

    loader = BatchLoader(PageDataset(pages, boxes), LoaderConfig(
        batch_size=batch_size, min_side=sides[0], max_side=sides[1],
        device_normalize=True, shuffle=False))
    require(loader.steps_per_epoch() == 1, "the pages span more than one batch")
    return loader


def _to_device(batch, dev):
    import torch

    from tdnet_torch.ops.ingest import pack_uint8_host

    batch = dict(batch, images=pack_uint8_host(batch["images"]))
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def _states_equal(a, b) -> bool:
    import torch

    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a.cpu(), b.cpu())
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_states_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_states_equal(x, y) for x, y in zip(a, b))
    return a == b


def phase_train(dev):
    """The training path: 8 synthetic table pages with their GT boxes ->
    BatchLoader(device_normalize) -> the prefetcher -> fit -> the train step
    on the fused-stem route with the backward kernel (TDNET_STEM_BWD unset),
    ResNet-50 RetinaNet bf16, 20 steps on the repeated batch at lr 3e-4
    (clipnorm 1e6, tests/train/test_step.py's overfit case). Counters are set
    to 0 just before fit and read just after. Then the device step time on
    one resident batch, and a checkpoint round trip."""
    import numpy as np
    import torch

    from tdnet_torch.data.prefetch import DevicePrefetcher
    from tdnet_torch.models.retinanet import RetinaNet
    from tdnet_torch.ops import ingest, nms_kernel, stem
    from tdnet_torch.train.checkpoint import Checkpointer
    from tdnet_torch.train.loop import fit
    from tdnet_torch.train.step import (create_optimizer, create_train_state,
                                        make_train_step)
    from tdnet_torch.weights import random_variables

    require("TDNET_STEM_BWD" not in os.environ,
            "TDNET_STEM_BWD is set: the train phase runs the default backward")
    counters = {"ingest": ingest.LAUNCHES, "stem": stem.LAUNCHES,
                "nms": nms_kernel.LAUNCHES, "stem_bwd": stem.BWD_LAUNCHES}
    pages, boxes = synthetic_pages(TRAIN_BATCH, 0, SEED + 2,
                                   sizes=(TRAIN_PAGE, None), with_boxes=True)
    loader = _host_batch(pages, boxes, (MIN_SIDE, MAX_SIDE), TRAIN_BATCH)
    variables = random_variables(1, "resnet50", seed=SEED)
    model = RetinaNet(1, dtype=torch.bfloat16)
    state = create_train_state(model, variables, device=dev,
                               optimizer=create_optimizer(TRAIN_LR, 1e6))
    step = make_train_step(model, num_classes=1)
    out_dir = ROOT / "build" / "chip_smoke"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    metrics_path = out_dir / "train_metrics.jsonl"
    batches = DevicePrefetcher(loader.forever(), device=dev)
    log = io.StringIO()
    try:
        for c in counters.values():
            c.reset()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        sync(dev)
        t0 = time.monotonic()
        with contextlib.redirect_stdout(log):  # fit's records go to the JSONL
            state = fit(state, step, batches, steps_per_epoch=1,
                        epochs=TRAIN_STEPS, metrics_path=str(metrics_path),
                        log_every=1)
        sync(dev)
        fit_s = time.monotonic() - t0
        launches = {k: c.count for k, c in counters.items()}
    finally:
        batches.close()
    peak_gb = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
               if dev.type == "cuda" else None)
    recs = [json.loads(line) for line in open(metrics_path)]
    steps = [r for r in recs if "step" in r]
    losses = [r["loss"] for r in steps]
    require(len(steps) == TRAIN_STEPS and state.step == TRAIN_STEPS,
            f"{len(steps)} step records, state.step {state.step}")
    require(np.isfinite(losses).all(), f"non-finite loss: {losses}")
    require(np.mean(losses[-3:]) < losses[0],
            f"loss did not fall: first {losses[0]}, last 3 {losses[-3:]}")
    require(min(r["num_positive"] for r in steps) > 0, "no positive anchors")
    require(all(np.isfinite(r["grad_norm"]) and r["grad_norm"] > 0 for r in steps),
            "grad_norm not finite and positive")
    require(launches["stem"] >= TRAIN_STEPS and launches["stem_bwd"] >= TRAIN_STEPS,
            f"the train path skipped a kernel: {launches}")

    # device step time on one resident batch (no loader, no prefetch)
    batch = _to_device(next(loader.epoch()), dev)
    step(state, batch)
    sync(dev)
    t0 = time.monotonic()
    for _ in range(5):
        step(state, batch)
    sync(dev)
    step_s = (time.monotonic() - t0) / 5

    # checkpoint round trip: a fresh state restored from disk equals the
    # live one, Adam moments and step count included
    ckpt = Checkpointer(str(out_dir / "ckpt"))
    ckpt.save(state.step, state)
    fresh = create_train_state(RetinaNet(1, dtype=torch.bfloat16),
                               random_variables(1, "resnet50", seed=SEED + 1),
                               device=dev, optimizer=create_optimizer(1e-5, 1e-3))
    ckpt.restore(fresh)
    require(fresh.step == state.step, "restored step differs")
    require(_states_equal(fresh.model.state_dict(), state.model.state_dict()),
            "restored weights differ")
    require(_states_equal(fresh.optimizer.state_dict(), state.optimizer.state_dict()),
            "restored optimizer state (Adam moments) differs")
    shutil.rmtree(out_dir / "ckpt")

    ips = [r["images_per_sec"] for r in steps[1:]]
    emit({"phase": "train", "ok": True, "model": "resnet50 retinanet, 1 class",
          "dtype": "bfloat16", "batch": TRAIN_BATCH,
          "bucket": [batch["images"].shape[1], batch["images"].shape[2] // 3],
          "steps": TRAIN_STEPS, "lr": TRAIN_LR, "stem_bwd": "kernel",
          "loss_first": losses[0], "loss_last3_mean": float(np.mean(losses[-3:])),
          "losses": losses, "num_positive": steps[-1]["num_positive"],
          "grad_norm_last": steps[-1]["grad_norm"],
          "step_s": step_s, "images_per_s": TRAIN_BATCH / step_s,
          "fit_s": fit_s, "fit_images_per_s_median": float(np.median(ips)),
          "peak_mem_gb": peak_gb, "launches": launches,
          "checkpoint_round_trip": "equal (weights, Adam moments, step)"})
    return launches


def phase_train_parity(dev):
    """One f32 train step of ResNet-50 RetinaNet on CUDA (the kernels, TF32
    off) and on the CPU (their plain versions), 2 synthetic table pages at
    the 256x384 bucket, packed uint8 through the fused stem. Metrics rtol
    1e-4, num_positive exact. Gradients: each tensor within a relative
    Frobenius error of 3e-2, floored at 1e-3 of the largest tensor's norm,
    and the whole gradient within 5e-3. A ReLU whose input is within float
    noise of 0 can flip between the two devices and move every gradient
    upstream of it by up to ~1%, at layers that depend on the summation
    order; P6/P7 get ~1e-6 of the other gradients, differences of much
    larger terms (tools/torch_grad_parity.py measures both against tdnet)."""
    import numpy as np
    import torch

    from tdnet_torch.models.retinanet import RetinaNet
    from tdnet_torch.train.step import (create_optimizer, create_train_state,
                                        make_train_step)
    from tdnet_torch.weights import random_variables

    pages, boxes = synthetic_pages(2, 0, SEED + 3, sizes=(PARITY_PAGE, None),
                                   with_boxes=True)
    host = next(_host_batch(pages, boxes, PARITY_SIDES, 2).epoch())
    variables = random_variables(1, "resnet50", seed=SEED)
    runs = {}
    for name, d in (("gpu", dev), ("cpu", torch.device("cpu"))):
        model = RetinaNet(1)
        state = create_train_state(model, variables, device=d,
                                   optimizer=create_optimizer(1e-4, 1e6))
        step = make_train_step(model, num_classes=1, fused_stem=True)
        _, metrics = step(state, _to_device(host, d))
        runs[name] = ({k: float(v) for k, v in metrics.items()},
                      {n: p.grad.detach().double().cpu()
                       for n, p in model.named_parameters() if p.grad is not None})
    (gm, gg), (cm, cg) = runs["gpu"], runs["cpu"]
    require(gm["num_positive"] == cm["num_positive"] > 0,
            f"num_positive {gm['num_positive']} vs {cm['num_positive']}")
    worst_metric = 0.0
    for k in ("loss", "classification_loss", "regression_loss", "grad_norm"):
        rel = abs(gm[k] - cm[k]) / abs(cm[k])
        worst_metric = max(worst_metric, rel)
        require(rel <= 1e-4, f"{k}: {gm[k]} vs {cm[k]}")
    require(gg.keys() == cg.keys(), "different parameters got gradients")
    norms = {n: float(torch.linalg.vector_norm(w)) for n, w in cg.items()}
    biggest = max(norms.values())
    worst, err2, ref2 = ("", 0.0), 0.0, 0.0
    for n, want in cg.items():
        err = float(torch.linalg.vector_norm(gg[n] - want))
        rel = err / max(norms[n], 1e-3 * biggest)
        worst = max(worst, (n, rel), key=lambda t: t[1])
        require(rel <= 3e-2, f"{n}: gradient error {err}, norm {norms[n]}")
        err2 += err ** 2
        ref2 += norms[n] ** 2
    total = float(np.sqrt(err2 / ref2))
    require(total <= 5e-3, f"whole gradient: rel Frobenius {total}")
    emit({"phase": "train_parity", "ok": True, "pages": 2,
          "bucket": list(PARITY_SIDES), "dtype": "float32",
          "num_positive": gm["num_positive"], "loss_gpu": gm["loss"],
          "loss_cpu": cm["loss"], "worst_metric_rel": worst_metric,
          "worst_tensor": worst[0], "worst_tensor_rel_fro": worst[1],
          "whole_grad_rel_fro": total, "tensors_compared": len(cg)})


def _timed_predict(pred, pages, counters, dev):
    """One predict_batch with the launch counters and the predictor's
    host/dispatch counters set to 0 just before it and read just after."""
    import torch

    for c in counters.values():
        c.reset()
    pred.host_prep_s = pred.dispatch_s = 0.0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sync(dev)
    t0 = time.monotonic()
    out = pred.predict_batch(pages)
    elapsed = time.monotonic() - t0
    return out, elapsed, {k: c.count for k, c in counters.items()}


def _all_counters():
    from tdnet_torch.ops import block, conv1x1, ingest, nms_kernel, soft_nms, stem

    return {"ingest": ingest.LAUNCHES, "stem": stem.LAUNCHES,
            "nms": nms_kernel.LAUNCHES, "soft_nms": soft_nms.LAUNCHES,
            "block": block.LAUNCHES, "conv1x1": conv1x1.LAUNCHES}


def phase_predict_soft(dev):
    """Config 5: 3-class page layout with soft-NMS. Predictor.predict_batch
    on RetinaNet(3, resnet50) in bf16, the 16 pages of the predict phase
    (both buckets), uint8 through the fused stem, the class-specific
    deferred tail with soft_nms_sigma 0.5: the soft-NMS kernel rescores
    B*3 rows of 1024 candidates and the NMS kernel does not run. Then 2
    pages in f32, CUDA vs the CPU (pre_nms_top_k 200 and 100 detections, so
    fewer near-equal candidates can trade places in the greedy order)."""
    import torch

    import tdnet_torch.ops.nms as nms_mod
    from tdnet_torch.data.generator import default_buckets, pick_bucket
    from tdnet_torch.data.image import compute_resize_scale
    from tdnet_torch.models.retinanet import RetinaNet
    from tdnet_torch.train.predictor import Predictor
    from tdnet_torch.weights import random_variables

    variables = random_variables(3, "resnet50", seed=SEED)
    variables["params"]["classification_submodel"]["head"]["bias"][:] = -2.0
    pages = synthetic_pages(N_LANDSCAPE, N_PORTRAIT, SEED)
    scales = [compute_resize_scale(p.shape, MIN_SIDE, MAX_SIDE) for p in pages]
    buckets = [pick_bucket(round(p.shape[0] * s), round(p.shape[1] * s),
                           default_buckets(MIN_SIDE, MAX_SIDE))
               for p, s in zip(pages, scales)]
    sides = dict(min_side=MIN_SIDE, max_side=MAX_SIDE, soft_nms_sigma=SOFT_SIGMA)
    pred = Predictor(RetinaNet(3, dtype=torch.bfloat16), variables, device=dev,
                     device_preprocess=True, **sides)
    require(pred.fused_stem, "fused_stem did not resolve on for CUDA")

    # warm-up run that records what the soft-NMS kernel was given and did
    rows = []
    orig = nms_mod.soft_nms_rescore_batched

    def recording(boxes, scores, **kw):
        out = orig(boxes, scores, **kw)
        rows.append({"rows": boxes.shape[0], "k": boxes.shape[1],
                     "selected": int((out > 0).sum().item()),
                     "changed": int(((out > 0) & (out < scores)).sum().item())})
        return out

    nms_mod.soft_nms_rescore_batched = recording
    try:
        pred.predict_batch(pages)
    finally:
        nms_mod.soft_nms_rescore_batched = orig
    require(rows and sum(r["changed"] for r in rows) >= 1,
            f"soft-NMS changed no score: {rows}")

    counters = _all_counters()
    out, elapsed, launches = _timed_predict(pred, pages, counters, dev)
    n_det = check_detections(out, pages, buckets, scales, num_classes=3)
    labels = {int(v) for _, s, lab in out for v in lab[s > -1]}
    require(launches["soft_nms"] >= 1 and launches["stem"] >= 1
            and launches["nms"] == 0, f"config 5 launches: {launches}")
    require(labels <= {0, 1, 2} and len(labels) > 1, f"labels {labels}")

    parity = _device_parity(
        lambda d, thr: Predictor(RetinaNet(3), variables, device=d,
                                 device_preprocess=True, score_threshold=thr,
                                 pre_nms_top_k=200, max_detections=100, **sides),
        synthetic_pages(2, 0, SEED + 1), dev)
    emit({"phase": "predict_soft", "ok": True, "config": 5,
          "model": "resnet50 retinanet, 3 classes", "dtype": "bfloat16",
          "pages": len(pages), "buckets": sorted({str(b) for b in buckets}),
          "soft_nms_sigma": SOFT_SIGMA, "images_per_s": len(pages) / elapsed,
          "seconds": elapsed, "host_prep_s": pred.host_prep_s,
          "dispatch_s": pred.dispatch_s, "detections": n_det,
          "labels": sorted(labels), "soft_nms_rows": rows,
          "launches": launches,
          "peak_mem_gb": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                          if dev.type == "cuda" else None),
          "parity_f32": parity})
    return launches


def phase_predict_r101(dev):
    """Config 4: ResNet-101 RetinaNet at the 1024x1024 bucket.
    Predictor.predict_batch in bf16 with block_kernel=True on 16 near-square
    pages (one dispatch of batch 16), uint8 through the fused stem, hard NMS:
    every stage's identity run goes through the fused bottleneck kernel,
    one launch per block (29 a dispatch). Then 2 pages in f32 at a 512x512
    bucket (every stage passes the gate there too), CUDA vs the CPU, and the
    f32 model with the kernel on and off on CUDA (rtol = atol = 2e-4,
    tests/ops/test_pallas_block.py's model bound)."""
    import numpy as np
    import torch

    from tdnet_torch.models.retinanet import RetinaNet
    from tdnet_torch.train.predictor import Predictor
    from tdnet_torch.weights import random_variables

    variables = random_variables(1, "resnet101", seed=SEED)
    variables["params"]["classification_submodel"]["head"]["bias"][:] = -2.0
    pages = synthetic_pages(R101_PAGES, 0, SEED + 4, sizes=(R101_PAGE, None))
    sides = dict(min_side=R101_SIDE, max_side=R101_SIDE)
    pred = Predictor(RetinaNet(1, "resnet101", dtype=torch.bfloat16, block_kernel=True),
                     variables, device=dev, device_preprocess=True, **sides)
    require(pred.buckets == [(R101_SIDE, R101_SIDE)], f"buckets {pred.buckets}")
    pred.predict_batch(pages)  # warm-up
    counters = _all_counters()
    out, elapsed, launches = _timed_predict(pred, pages, counters, dev)
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else None)
    scale = R101_SIDE / max(R101_PAGE)
    n_det = check_detections(out, pages, [(R101_SIDE, R101_SIDE)] * len(pages),
                             [scale] * len(pages))
    require(pred.dispatch_count >= 1, "no dispatch")
    require(launches["block"] == R101_BLOCK_LAUNCHES and launches["stem"] >= 1
            and launches["nms"] >= 1, f"config 4 launches: {launches}")
    host_prep_s, dispatch_s = pred.host_prep_s, pred.dispatch_s
    prof = None
    if dev.type == "cuda":  # one dispatch under the profiler: the block kernel's share
        prof = device_profile(lambda: pred.predict_batch(pages), match="bottleneck")
        require(prof["matched_kernels"] == R101_BLOCK_LAUNCHES,
                f"profiled dispatch: {prof['matched_kernels']} block kernels")
        prof["block_share_of_busy"] = prof["matched_ms"] / prof["device_busy_ms"]
        prof["block_share_of_dispatch"] = prof["matched_ms"] / 1e3 / dispatch_s

    small = dict(min_side=R101_PARITY_SIDE, max_side=R101_PARITY_SIDE)
    parity_pages = synthetic_pages(2, 0, SEED + 5, sizes=((550, 500), None))
    parity = _device_parity(
        lambda d, thr: Predictor(RetinaNet(1, "resnet101", block_kernel=True), variables,
                                 device=d, device_preprocess=True,
                                 score_threshold=thr, **small),
        parity_pages, dev)

    # the f32 model, kernel on and off, on the same normalized images
    model = Predictor(RetinaNet(1, "resnet101"), variables, device=dev, **small).model
    x = torch.from_numpy(np.random.RandomState(SEED).normal(
        0, 50, (2, R101_PARITY_SIDE, R101_PARITY_SIDE, 3)).astype(np.float32)).to(dev)
    block_before = counters["block"].count
    outs = {}
    with torch.inference_mode():
        for on in (False, True):
            outs[on] = model(x, block_kernel=on)
    require(counters["block"].count - block_before == R101_BLOCK_LAUNCHES,
            "the kernel-on model did not run the block kernel")
    on_off = 0.0
    for key in ("regression", "classification"):
        a, b = outs[True][key], outs[False][key]
        on_off = max(on_off, (a - b).abs().max().item())
        require(bool(((a - b).abs() <= 2e-4 + 2e-4 * b.abs()).all().item()),
                f"{key}: kernel on vs off beyond rtol/atol 2e-4")
    emit({"phase": "predict_r101", "ok": True, "config": 4,
          "model": "resnet101 retinanet, 1 class, block_kernel", "dtype": "bfloat16",
          "pages": len(pages), "bucket": [R101_SIDE, R101_SIDE],
          "images_per_s": len(pages) / elapsed, "seconds": elapsed,
          "host_prep_s": host_prep_s, "dispatch_s": dispatch_s,
          "detections": n_det, "launches": launches, "peak_mem_gb": peak,
          "profile": prof, "parity_f32_512": parity, "f32_kernel_on_vs_off_max_abs": on_off})
    return launches


def _served_match(resp_dets, want, threshold):
    """A server's (or the predict CLI's) JSON detections against a
    Predictor's (boxes, scores, labels) above the same threshold: the same
    count, and each detection matched by label, score (rtol 1e-4, plus the
    5e-5 of its 4-decimal rounding) and box (0.5 px, plus 0.005 of its
    2-decimal rounding)."""
    import numpy as np

    wb, ws, wl = want
    keep = ws > threshold
    require(len(resp_dets) == int(keep.sum()),
            f"{len(resp_dets)} vs {int(keep.sum())} detections")
    worst = 0.0
    for d in resp_dets:
        cand = (wl[keep] == d["label"]) & (
            np.abs(ws[keep] - d["score"]) <= 1e-4 * d["score"] + 5e-5)
        require(cand.any(), f"no score match for {d}")
        dist = float(np.abs(wb[keep][cand] - np.asarray(d["box"])).max(axis=1).min())
        worst = max(worst, dist)
        require(dist <= 0.505, f"box off by {dist} px")
    return worst


def _post(base, body: bytes, ctype: str, path="/v1/detect"):
    """(status, JSON answer, seconds) of one POST."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base + path, data=body, headers={"Content-Type": ctype})
    t0 = time.monotonic()
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read()), time.monotonic() - t0
    except urllib.error.HTTPError as e:
        return e.code, {"error": e.read().decode(errors="replace")}, time.monotonic() - t0


def _bodies(pages_u8):
    """Each uint8 BGR page as an .npy body and as a PNG body."""
    import numpy as np

    from tdnet_torch.data import png

    out = []
    for page in pages_u8:
        buf = io.BytesIO()
        np.save(buf, page)
        out.append(((buf.getvalue(), "application/x-npy"),
                    (png.encode_png(np.ascontiguousarray(page[:, :, ::-1])), "image/png")))
    return out


def _serve(predictor, **kw):
    import threading

    from tdnet_torch.bin.serve import build_server

    httpd, batcher = build_server(predictor, port=0, **kw)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return f"http://127.0.0.1:{httpd.server_address[1]}", httpd, batcher


def _stop(httpd, batcher):
    httpd.shutdown()
    httpd.server_close()
    batcher.close()


def phase_serve(dev):
    """The serving path: a ResNet-50 RetinaNet (1 class, the predict
    phase's weights) written as a .tdn by the port's save_model and read
    back by load_model, behind tdnet_torch.bin.serve's HTTP server in bf16
    with device normalize (uint8 through the fused stem, the NMS kernel in
    the tail), max_batch 16, max_delay 50 ms. 32 concurrent requests: the
    predict phase's 16 pages twice, half as .npy and half as PNG bodies;
    counters set to 0 just before them and read just after. Then an f32
    server on 4 pages against Predictor.predict_batch on the same pages,
    the threshold in the widest gap of a probe run (phase_parity's rule)."""
    import threading

    import numpy as np
    import torch

    from tdnet_torch.models.io import load_model, save_model
    from tdnet_torch.models.retinanet import RetinaNet
    from tdnet_torch.train.predictor import Predictor

    out_dir = ROOT / "build" / "chip_smoke" / "serve"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    bundle = str(out_dir / "model.tdn")
    t0 = time.monotonic()
    save_model(bundle, RetinaNet(1), smoke_variables(),
               inference_config={"min_side": MIN_SIDE, "max_side": MAX_SIDE})
    model, variables, meta = load_model(bundle, dtype=torch.bfloat16)
    bundle_s = time.monotonic() - t0
    inference = meta["inference"]
    sides = dict(min_side=inference["min_side"], max_side=inference["max_side"])
    pred = Predictor(model, variables, device=dev, device_preprocess=True, **sides)
    require(pred.fused_stem and pred.batch_size == 16,
            f"fused_stem {pred.fused_stem}, batch_size {pred.batch_size}")
    pages = [p.astype(np.uint8) for p in synthetic_pages(N_LANDSCAPE, N_PORTRAIT, SEED)]
    bodies = _bodies(pages)
    base, httpd, batcher = _serve(pred, max_batch=SERVE_MAX_BATCH,
                                  max_delay_ms=SERVE_MAX_DELAY_MS)
    try:
        # warm-up: each bucket at the batch sizes the timed run gives
        warm = [None] * len(pages)
        threads = [threading.Thread(target=lambda i=i: warm.__setitem__(
            i, _post(base, *bodies[i][0]))) for i in range(len(pages))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        require(all(w[0] == 200 for w in warm), f"warm-up answers {[w[0] for w in warm]}")

        requests = [bodies[i % len(pages)][(i // len(pages)) % 2]
                    for i in range(SERVE_REQUESTS)]
        answers = [None] * len(requests)
        counters = _all_counters()
        for c in counters.values():
            c.reset()
        before = batcher.stats()
        pred.host_prep_s = pred.dispatch_s = 0.0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        sync(dev)
        t0 = time.monotonic()
        threads = [threading.Thread(target=lambda i=i: answers.__setitem__(
            i, _post(base, *requests[i]))) for i in range(len(requests))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        elapsed = time.monotonic() - t0
        launches = {k: c.count for k, c in counters.items()}
        stats = batcher.stats()
    finally:
        _stop(httpd, batcher)
    codes = [a[0] for a in answers]
    require(all(c == 200 for c in codes), f"answers {codes}")
    batches = stats["batches"] - before["batches"]
    require(batches < len(requests), f"{batches} batches for {len(requests)} requests")
    require(stats["fused_stem"] is True and stats["fused_stem_fallback"] is None,
            f"/stats fused_stem {stats['fused_stem']}")
    require(launches["stem"] >= 1 and launches["nms"] >= 1, f"serve launches {launches}")
    from tdnet_torch.data import png

    require(all(np.array_equal(png.decode_png(b[1][0])[:, :, ::-1], p)
                for b, p in zip(bodies, pages)), "a PNG body decodes to other pixels")
    n_det = sum(len(a[1]["detections"]) for a in answers)
    require(n_det > 0, "no detections served")
    lat = np.sort([a[2] for a in answers]) * 1e3
    q = lambda f: float(lat[min(len(lat) - 1, int(f * len(lat)))])
    parity = _serve_parity(dev, bundle, sides)
    emit({"phase": "serve", "ok": True, "model": "resnet50 retinanet, 1 class (.tdn)",
          "dtype": "bfloat16", "bundle_mb": os.path.getsize(bundle) / 2 ** 20,
          "bundle_write_read_s": bundle_s, "requests": len(requests),
          "bodies": {"npy": len(requests) // 2, "png": len(requests) // 2},
          "max_batch": SERVE_MAX_BATCH, "max_delay_ms": SERVE_MAX_DELAY_MS,
          "seconds": elapsed, "requests_per_s": len(requests) / elapsed,
          "latency_ms": {"p50": q(0.5), "p90": q(0.9), "p99": q(0.99)},
          "batches": batches,
          "mean_batch_size": (stats["images"] - before["images"]) / batches,
          "host_prep_s": pred.host_prep_s, "dispatch_s": pred.dispatch_s,
          "detections": n_det, "launches": launches,
          "peak_mem_gb": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                          if dev.type == "cuda" else None),
          "server_stats": stats, "parity_f32": parity})
    return launches


def _serve_parity(dev, bundle, sides):
    """An f32 server's answers to 4 pages vs Predictor.predict_batch on the
    same pages (both device-normalize, TF32 off)."""
    import threading

    import numpy as np

    from tdnet_torch.models.io import load_model
    from tdnet_torch.train.predictor import Predictor

    def predictor(thr):
        model, variables, _ = load_model(bundle)
        return Predictor(model, variables, device=dev, device_preprocess=True,
                         score_threshold=thr, **sides)

    pages = [p.astype(np.uint8) for p in synthetic_pages(4, 0, SEED + 6)]
    thr, gap = _gap_threshold(predictor(0.05).predict_batch(pages))
    direct = predictor(thr).predict_batch(pages)
    base, httpd, batcher = _serve(predictor(thr), max_batch=4, max_delay_ms=SERVE_MAX_DELAY_MS,
                                  default_threshold=thr)
    answers = [None] * len(pages)
    try:
        bodies = _bodies(pages)
        threads = [threading.Thread(target=lambda i=i: answers.__setitem__(
            i, _post(base, *bodies[i][i % 2]))) for i in range(len(pages))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        _stop(httpd, batcher)
    require(all(a[0] == 200 for a in answers), f"answers {[a[0] for a in answers]}")
    worst = max(_served_match(a[1]["detections"], d, thr) for a, d in zip(answers, direct))
    n = sum(len(a[1]["detections"]) for a in answers)
    require(n > 0, "serve parity compared no detections")
    return {"pages": len(pages), "score_threshold": thr, "threshold_gap": gap,
            "detections_compared": n, "max_box_diff_px": worst}


def phase_cli(dev):
    """The predict and evaluate CLIs on the card, from the serve phase's
    .tdn: predict on 4 PNG pages (f32, host normalize) writes one JSONL
    line a page, each page's detections those of a direct f32 Predictor
    above a threshold in the widest gap of a probe run; evaluate on a CSV
    dataset of 8 synthetic table pages (their ruled tables as the GT) exits
    0 and prints the mAP lines (random weights: no mAP target). Counters
    set to 0 just before the CLIs and read just after."""
    import numpy as np

    from tdnet_torch.bin import evaluate, predict
    from tdnet_torch.data.image import read_image_bgr, write_image_bgr
    from tdnet_torch.models.io import load_model
    from tdnet_torch.train.predictor import Predictor

    work = ROOT / "build" / "chip_smoke" / "cli"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    bundle = str(ROOT / "build" / "chip_smoke" / "serve" / "model.tdn")
    paths = []
    for i, page in enumerate(synthetic_pages(3, 1, SEED + 7)):
        paths.append(str(work / f"page{i}.png"))
        write_image_bgr(paths[-1], page.astype(np.uint8))
    pages = [read_image_bgr(p) for p in paths]
    model, variables, meta = load_model(bundle)
    sides = dict(min_side=meta["inference"]["min_side"], max_side=meta["inference"]["max_side"])
    probe = Predictor(model, variables, device=dev, score_threshold=0.05, **sides)
    thr, gap = _gap_threshold([probe(p) for p in pages])
    direct = Predictor(model, variables, device=dev, score_threshold=0.05, **sides)

    ds_pages, ds_boxes = synthetic_pages(6, 2, SEED + 8, with_boxes=True)
    rows = []
    for i, (page, boxes) in enumerate(zip(ds_pages, ds_boxes)):
        write_image_bgr(work / f"gt{i}.png", page.astype(np.uint8))
        rows += [f"gt{i}.png,{int(b[0])},{int(b[1])},{int(b[2])},{int(b[3])},table"
                 for b in boxes]
    (work / "annotations.csv").write_text("\n".join(rows) + "\n")
    (work / "classes.csv").write_text("table,0\n")

    counters = _all_counters()
    for c in counters.values():
        c.reset()
    log = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(log):
        rc_predict = predict.main([bundle, *paths, "--output-dir", str(work / "out"),
                                   "--score-threshold", repr(thr), "--device", dev.type])
        t_predict = time.monotonic() - t0
        rc_eval = evaluate.main(["--image-min-side", str(MIN_SIDE), "--image-max-side",
                                 str(MAX_SIDE), "--device", dev.type, "csv", str(work / "annotations.csv"),
                                 str(work / "classes.csv"), bundle])
    t_eval = time.monotonic() - t0 - t_predict
    launches = {k: c.count for k, c in counters.items()}
    out = log.getvalue().splitlines()
    require(rc_predict == 0 and rc_eval == 0, f"exit codes {rc_predict}, {rc_eval}: {out}")
    lines = [json.loads(x) for x in (work / "out" / "detections.jsonl").read_text().splitlines()]
    require([x["image"] for x in lines] == paths, "one JSONL line a page, in order")
    worst, n = 0.0, 0
    for line, page in zip(lines, pages):
        worst = max(worst, _served_match(line["detections"], direct(page), thr))
        n += len(line["detections"])
        require((work / "out" / f"det_{Path(line['image']).stem}.png").is_file(),
                "annotated copy missing")
    require(n > 0, "predict CLI compared no detections")
    maps = [x for x in out if x.startswith("mAP")]
    require(len(maps) == 2 and any("instances of class table" in x for x in out),
            f"evaluate printed {out[-4:]}")
    require(launches["nms"] >= 1, f"cli launches {launches}")
    emit({"phase": "cli", "ok": True, "predict": {
              "pages": len(paths), "score_threshold": thr, "threshold_gap": gap,
              "detections_compared": n, "max_box_diff_px": worst, "seconds": t_predict},
          "evaluate": {"pages": len(ds_pages), "gt_boxes": len(rows), "seconds": t_eval,
                       "printed": [x for x in out if "average precision" in x] + maps},
          "launches": launches})
    return launches


def main() -> int:
    if not (ROOT / "tdnet_torch" / "__init__.py").is_file():
        print("chip_smoke: tdnet_torch/ is missing next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    phase = "device"
    try:
        import torch

        smi_line = phase_device()
        phase = "build"
        phase_build()
        dev = torch.device("cuda")
        phase = "kernels"
        kres = phase_kernels(dev)
        phase = "predict"
        variables = smoke_variables()
        launches = phase_predict(dev, variables)
        phase = "parity"
        phase_parity(dev, variables)
        del variables
        phase = "train"
        train_launches = phase_train(dev)
        phase = "train_parity"
        phase_train_parity(dev)
        phase = "predict_soft"
        soft_launches = phase_predict_soft(dev)
        phase = "predict_r101"
        r101_launches = phase_predict_r101(dev)
        phase = "serve"
        serve_launches = phase_serve(dev)
        phase = "cli"
        cli_launches = phase_cli(dev)
    except Exception as exc:  # report the failed phase, print no result
        import traceback

        traceback.print_exc()
        emit({"phase": phase, "ok": False, "error": f"{type(exc).__name__}: {exc}"})
        return 1

    # launches: the main paths' runs (predict's two routes, training,
    # config 5, config 4, serving, the CLIs); conv1x1 (B7) is wired into no
    # model, in the JAX package too, so no path launches it
    runs = (launches, train_launches, soft_launches, r101_launches,
            serve_launches, cli_launches)
    sources = {
        "ingest": ("tdnet_torch/csrc/ingest.cu", "tdnet/ops/pallas_ingest.py:137"),
        "stem": ("tdnet_torch/csrc/stem.cu", "tdnet/ops/pallas_stem.py:676"),
        "nms": ("tdnet_torch/csrc/nms.cu", "tdnet/ops/pallas_nms.py:268"),
        "stem_bwd": ("tdnet_torch/csrc/stem_bwd.cu", "tdnet/ops/pallas_stem.py:492"),
        "soft_nms": ("tdnet_torch/csrc/soft_nms.cu", "tdnet/ops/soft_nms.py:211"),
        "block": ("tdnet_torch/csrc/block.cu", "tdnet/ops/pallas_block.py:262"),
        "conv1x1": ("tdnet_torch/csrc/conv1x1.cu", "tdnet/ops/pallas_conv.py:108"),
    }
    # library_ms: no single PyTorch call computes ingest (normalize +
    # round), nms or soft_nms (null; nms and soft_nms also report their
    # times at bench.py's batch of 128 pages); for stem it is the port's unfused
    # path (stem_reference_packed: the normalize kernel, cuDNN bf16 conv,
    # BN, ReLU, pool), for stem_bwd that path's autograd backward with its
    # forward (the "remat" route), for block the unfused path on the same
    # input (one Bottleneck: cuDNN bf16 convolutions and PyTorch's
    # elementwise kernels; stage 4 at batch 16), for conv1x1 the unfused
    # tail (torch.matmul bf16, then elementwise ops)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(r.get(name, 0) for r in runs),
         "max_abs_err": kres[name]["max_abs_err"],
         "ms": kres[name]["ms"], "plain_ms": kres[name]["plain_ms"],
         "bound_ms": kres[name]["bound"][0], "bound_by": kres[name]["bound"][1],
         "library_ms": kres[name].get("library_ms"),
         **({"batch_128": {"shape": kres[name]["batch_128"]["shape"],
                           "ms": kres[name]["batch_128"]["ms"],
                           "plain_ms": kres[name]["batch_128"]["plain_ms"],
                           "bound_ms": kres[name]["batch_128"]["bound"][0],
                           "bound_by": kres[name]["batch_128"]["bound"][1],
                           "library_ms": None}}
            if "batch_128" in kres[name] else {}),
         **({"note": "no path runs it: wired into no model, in the JAX package too"}
            if name == "conv1x1" else {})}
        for name, (src, rep) in sources.items()]})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
