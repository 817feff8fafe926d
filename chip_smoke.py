#!/usr/bin/env python3
"""Smoke run of tdnet_torch's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``tdnet_torch/csrc/`` (into
``build/tdnet_torch/``), holds each kernel against its plain PyTorch version
at the main paths' shapes and times both, and drives the port's main paths
with random weights made from a seed, RetinaNet at full width and depth
(ResNet-50, ResNet-101 for config 4, and one model of each other backbone
family):

- batched page inference (``Predictor.predict_batch``, bf16, uint8 pages
  through the fused ingest+stem kernel, the NMS kernel in the deferred
  tail), then CUDA-vs-CPU f32 detections on the same pages;
- training (in-memory pages -> ``BatchLoader`` -> the prefetcher -> ``fit``
  -> ``make_train_step`` on the fused-stem route with its backward kernel,
  bf16, batch 8 at 800x1344, 20 steps on one batch), a checkpoint round
  trip, then one f32 step on CUDA against the same step on the CPU;
- the train CLI (``tdnet_torch.bin.train``) on PNG pages with a CSV, bf16,
  from a ``.tdn``, with per-epoch evaluation, snapshots and a bundle; a run
  resumed from the epoch-1 snapshot against the unbroken one; the bundle
  through the ``predict`` CLI;
- multi-class soft-NMS inference (config 5: 3-class ResNet-50, bf16, the
  deferred tail's soft-NMS kernel in place of the NMS kernel), then
  CUDA-vs-CPU f32 detections;
- ResNet-101 at the 1024x1024 bucket (config 4: bf16, batch 16, every
  stage's identity run through the fused bottleneck kernel), then
  CUDA-vs-CPU f32 detections at 512x512 and the f32 model with the kernel
  on and off;
- the other backbone families (SE-ResNet-50 through the fused stem; VGG-16
  in caffe mode, DenseNet-121 and MobileNet in tf mode through the normalize
  kernel; all through the NMS kernel): the 16 pages in bf16, CUDA-vs-CPU
  f32 detections at 512x512 and a ``.tdn`` round trip for each, 2 bf16
  train steps of SE-ResNet-50 (the stem kernels, forward and backward) and
  DenseNet-121 (the normalize kernel), and one f32 SE-ResNet-50 step on
  CUDA against the CPU;
- serving: a ResNet-50 ``.tdn`` written and read back by the port, behind
  ``tdnet_torch.bin.serve`` (bf16, device normalize, 32 concurrent
  ``.npy`` and PNG requests), then an f32 server against
  ``Predictor.predict_batch``;
- the ``predict`` and ``evaluate`` CLIs on that bundle;
- the table workflow's tools chained on ResNet-50: VOC XML ->
  ``csv_from_xml`` -> ``train --coco-evaluation`` -> ``convert_model`` ->
  ``evaluate --coco`` -> ``predict --labels`` (captioned pages) ->
  ``export_keras`` -> ``evaluate`` of the ``.h5``, and ``debug``;
- JPEG and BMP pages (``tests/golden/jpeg``, both decode routes held to
  the references' digests) through ``train pascal``, ``evaluate`` of
  Pascal VOC, COCO (``--coco``), Open Images and KITTI layouts,
  ``predict`` and ``serve``;
- the other page formats (``tests/golden/pages``: progressive, CMYK and
  4:1:1 JPEG, RLE8 BMP, CCITT G4, LZW and JPEG TIFF, PBM, GIF, arithmetic
  and lossless JPEG, Sun raster, lossless and lossy WebP; both decode
  routes held to the references' digests) through ``train csv``,
  ``predict`` and ``serve``;
- data parallelism: ``train --distributed`` in two child ranks (one card:
  they share it over gloo; more: a card each over NCCL), plain and with
  ``--zero`` (its bundle byte-equal to plain's), an f32 step against one
  process at the same global batch, and ``evaluate --distributed --coco``
  against one process; and a 1-rank NCCL group through the same CLIs;
- the other parallel forms: ``PipelineTrainer`` (two cards, or both stages
  on one) and ``train --pipeline`` (two cards), ``train --spatial 2`` and
  ``--tensor-parallel 2`` in two child ranks with per-epoch evaluation,
  each form's f32 step against the plain one, and ``evaluate`` of each
  form's bundle.

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
INGEST_BURST = 10                     # B3 timed in bursts of 10 calls (device time)
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
# the train CLI: 4 pages at batch 2 (--steps 0: 2 steps an epoch), 2 epochs
TRAIN_CLI_PAGES, TRAIN_CLI_BATCH, TRAIN_CLI_EPOCHS = 4, 2, 2
# train_cli_init: where --imagenet-weights finds its file ($TDNET_PRETRAINED_DIR),
# and the warm-up's CUDA-vs-CPU bound on each new mean and var, relative to
# the larger of the element and its leaf's largest magnitude (f32, TF32 off)
PRETRAINED_DIR = ROOT / "build" / "chip_smoke" / "pretrained"
WARMUP_TOL = 1e-3
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
# (tools/perf_fused_conv.py), checked at batch 4, timed at batch 16 in
# bursts of 10 calls
CONV1X1_STAGES = [(2, 200, 336, 64, 256), (3, 100, 168, 128, 512),
                  (4, 50, 84, 256, 1024), (5, 25, 42, 512, 2048)]
CONV1X1_BATCH, CONV1X1_TIMED_BATCH, CONV1X1_TIMED = 4, 16, (2, 3, 4, 5)
CONV1X1_BURST = 10
# the bf16 kernel vs its plain version: least share of outputs equal, most
# ulps of the element's chain scale (the largest magnitude among the plain
# version's rounded intermediates y, y * inv, + off, + residual, and 1; the
# offset and residual may cancel the output into a lower binade). The two
# differ only where the f32 sums, run in another order, round the product y
# to the neighbouring bf16 value: one ulp of y times inv (< 1.5 here), and
# the three roundings after it can each add one ulp, so 4.5 ulps of the
# chain scale bound it. The contracted-FMA control must fail the share.
CONV1X1_BF16_LIMITS = {"share_equal": 0.999, "max_ulps_chain": 4.5}
# the table workflow: TABLE_PAGES pages with VOC XML and one without (a
# negative), a quarter held out; train at batch 2, 2 steps an epoch, 2
# epochs with the COCO evaluation; predict --labels on TABLE_PREDICT pages,
# each drawing at least TABLE_DRAWN detections
TABLE_PAGES, TABLE_BATCH, TABLE_STEPS, TABLE_EPOCHS = 10, 2, 2, 2
TABLE_PREDICT, TABLE_DRAWN = 3, 5
COCO_KEYS = ("AP", "AP50", "AP75", "AP_small", "AP_medium", "AP_large",
             "AR1", "AR10", "AR100", "AR_small", "AR_medium", "AR_large")
# 9 anchors a location, as the checkpoint's heads, at other scales
TABLE_ANCHORS_INI = """[anchor_parameters]
sizes   = 32 64 128 256 512
strides = 8 16 32 64 128
ratios  = 0.5 1 2
scales  = 1 1.2 1.6
"""
# the datasets phase: the full-size JPEG pages of tests/golden/jpeg
# (tools/make_jpeg_pages.py; each file's two reference decodes by SHA-256
# in digests.json), in a VOC, a COCO, an Open Images and a KITTI layout;
# train pascal for DATASET_STEPS bf16 steps at batch DATASET_BATCH
JPEG_PAGES = ROOT / "tests" / "golden" / "jpeg"
DATASET_BATCH, DATASET_STEPS = 2, 2
# the pages phase: the full-size pages of tests/golden/pages
# (tools/make_pages.py) through train csv (PAGES_STEPS bf16 steps at batch
# PAGES_BATCH), predict and serve
GOLDEN_PAGES = ROOT / "tests" / "golden" / "pages"
PAGES_BATCH, PAGES_STEPS = 2, 2
PAGES_MATCH_PX = 0.005  # the 2-decimal rounding of a JSON box
# the distributed phase: DIST_RANKS ranks through the train CLI at batch
# DIST_BATCH a rank for DIST_STEPS steps (one pass over DIST_PAGES pages)
DIST_RANKS, DIST_BATCH, DIST_STEPS, DIST_PAGES = 2, 2, 2, 8
DIST_NORMALIZE_BACKBONE = "mobilenet"  # a family that takes the normalize kernel
DIST_EVAL_GT = 3  # GT boxes a golden page: the model's own best (phase_distributed)
# the golden pages phase_distributed evaluates on: the eight of slice 15,
# which both routes read
DIST_EVAL_PAGES = ("cmyk.jpg", "g4.tif", "jpeg_ycc.tif", "lzw_pred.tif", "prog_cv2.jpg",
                   "prog_pil.jpg", "rle8.bmp", "sub411.jpg")
# the parallel_forms phase: PF_PAGES pages at the 800x1344 bucket (two of
# them the per-epoch evaluation's); the pipeline at batch PF_PIPE_BATCH in
# PF_PIPE_MICRO microbatches, PF_STEPS bf16 steps; --spatial / --tensor-parallel
# 2 in DIST_RANKS child ranks at batch PF_BATCH a data row for PF_STEPS bf16
# steps; each form's f32 step at PF_F32_BATCH against the plain one
PF_PAGES, PF_STEPS, PF_BATCH, PF_F32_BATCH = 4, 2, 1, 1
PF_PIPE_BATCH, PF_PIPE_MICRO = 4, 2
PF_LR = 1e-4
R101_SIDE, R101_PAGE, R101_PAGES = 1024, (1100, 1000), 16  # -> 1024x931, bucket 1024^2
# the backbones phase: one RetinaNet of each other family, full width and
# depth; CUDA-vs-CPU parity at 512x512 (pages of R101's parity), 2 bf16 train
# steps at batch 2 of TRAIN_PAGE pages, one f32 SE-ResNet-50 step CUDA vs CPU
BACKBONES = ("seresnet50", "vgg16", "densenet121", "mobilenet")
BACKBONE_PARITY_SIDE = 512
BACKBONE_LOGIT_STD = 0.5  # the class head's spread on the parity pages (_backbone_variables)
BACKBONE_TRAIN = ("seresnet50", "densenet121")
BACKBONE_TRAIN_BATCH, BACKBONE_TRAIN_STEPS = 2, 2
BACKBONE_STEP_SIDES, BACKBONE_STEP_PAGE = (256, 256), (256, 256)
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
    device time as [name, ms] with their counts of launches
    (``top_kernels_launches``, by the same 80-character names)."""
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
    spans, by_name, counts, hit_us, hits = [], {}, {}, 0.0, 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        by_name[e.name] = by_name.get(e.name, 0.0) + (b - a) / 1e3
        counts[e.name] = counts.get(e.name, 0) + 1
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
            "top_kernels_ms": [[n[:80], round(ms, 4)] for n, ms in ranked],
            "top_kernels_launches": {n[:80]: counts[n] for n, _ in ranked}}


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
          "tf32": "off (cudnn and matmul)", "packages": _probe_packages()})
    return smi_line


def _probe_packages():
    """Whether h5py and torchvision import here (a record for later work:
    nothing on the port's path uses either), each in a child interpreter
    so that nothing of them is loaded into this one."""
    found = {}
    for name in ("h5py", "torchvision"):
        res = subprocess.run(
            [sys.executable, "-c", f"import {name}; print({name}.__version__)"],
            capture_output=True, text=True, timeout=120)
        found[name] = (res.stdout.strip() if res.returncode == 0
                       else "absent: " + (res.stderr.strip().splitlines() or ["?"])[-1][:120])
    return found


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

    from tdnet_torch.ops import stem
    from tdnet_torch.ops.stem_vjp import stem_reference_packed

    rng = np.random.RandomState(SEED)
    results = {}

    results["ingest"] = check_ingest(dev, rng)

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


def check_ingest(dev, rng):
    """The normalize kernel (B3) vs its plain version on INGEST_ROWS x 3072
    random bytes, caffe and tf, f32 and bf16: bit-exact. Timed in bursts of
    INGEST_BURST calls (one call's host work would otherwise show in the
    event time of a 0.05-0.1 ms kernel) in bf16, the Predictor's dtype on
    the flat route, and in f32, each beside its device time a launch
    (``device_profile`` over one burst) and its bound."""
    import numpy as np
    import torch

    from tdnet_torch.ops import ingest

    x = torch.from_numpy(rng.randint(0, 256, (INGEST_ROWS, 3072)).astype(np.uint8)).to(dev)
    err = 0.0
    for mode in ("caffe", "tf"):
        for dt in (torch.float32, torch.bfloat16):
            got = ingest.normalize_uint8_rows(x, mode, dt)
            want = ingest.normalize_uint8_rows_plain(x, mode, dt)
            require(torch.equal(got, want), f"ingest {mode} {dt} differs from plain")
            err = max(err, (got.float() - want.float()).abs().max().item())
    timed = {}
    for dt in (torch.bfloat16, torch.float32):
        def run(dt=dt):
            return ingest.normalize_uint8_rows(x, "caffe", dt)

        prof = device_profile(lambda: [run() for _ in range(INGEST_BURST)],
                              match="normalize_u8")
        timed[str(dt).split(".")[-1]] = {
            "ms": median_ms(run, burst=INGEST_BURST),
            "device_ms": prof["matched_ms"] / max(prof["matched_kernels"], 1),
            "plain_ms": median_ms(
                lambda: ingest.normalize_uint8_rows_plain(x, "caffe", dt)),
            # reads 1 byte and writes 2 or 4 per element; a subtract and a
            # multiply
            "bound": bound(x.numel() * (1 + dt.itemsize), x.numel() * 2, "f32")}
    del x
    return {"max_abs_err": err, **timed["bfloat16"], "shape": [INGEST_ROWS, 3072],
            "dtype": "bfloat16", "float32": timed["float32"]}


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

    Timed at batch 16 with the residual, at every stage of CONV1X1_TIMED,
    in bursts of CONV1X1_BURST calls: the kernel (and its device time a
    launch by ``device_profile``), the port's unfused tail on the same input as the
    library yardstick (torch.matmul in bf16, then PyTorch's elementwise
    ops), and the product alone (torch.matmul bf16 into bf16: what cuBLAS
    reaches on the same operands, without the residual's bytes); the plain
    version in single calls."""
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
        x2 = x.reshape(-1, k)

        def kernel():
            return conv1x1.fused_conv1x1(x, wt, inv, off, residual=res)

        def unfused():
            y = (x2 @ w16).reshape(res.shape)
            return torch.relu(y * inv16 + off16 + res)

        m = x2.shape[0]
        prof = device_profile(lambda: [kernel() for _ in range(CONV1X1_BURST)],
                              match="conv1x1")
        timed.append({
            "stage": stage, "shape": [CONV1X1_TIMED_BATCH, h, w, k], "n": n,
            "ms": median_ms(kernel, burst=CONV1X1_BURST),
            "device_ms": prof["matched_ms"] / max(prof["matched_kernels"], 1),
            "plain_ms": median_ms(lambda: conv1x1.fused_conv1x1_plain(
                x, wt, inv, off, residual=res), iters=5),
            "library_ms": median_ms(unfused, burst=CONV1X1_BURST),
            # the product alone, what cuBLAS reaches on the same operands
            "matmul_ms": median_ms(lambda: torch.matmul(x2, w16), burst=CONV1X1_BURST),
            # bf16 x, weight, residual in and out; f32 BN pair; the product
            # on the bf16 tensor cores
            "bound": bound(2 * (m * k + k * n + 2 * m * n) + 8 * n, 2 * m * k * n, "bf16")})
        del x, x2, res, wt, w16
    first = timed[0]
    return {"max_abs_err": worst, "ms": first["ms"], "plain_ms": first["plain_ms"],
            "library_ms": first["library_ms"], "matmul_ms": first["matmul_ms"],
            "bound": first["bound"], "timed": timed, "checks": checks,
            "bf16_limits": CONV1X1_BF16_LIMITS,
            "library": "the unfused tail: torch.matmul bf16, then * inv + off + "
                       "residual and ReLU as PyTorch elementwise ops; matmul: "
                       "torch.matmul bf16 alone"}


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


def _host_batch(pages, boxes, sides, batch_size, preprocess_mode="caffe"):
    """One BatchLoader batch (uint8 canvases, device_normalize) of pages
    whose resize scale is 1.0."""
    from tdnet_torch.data.generator import BatchLoader, LoaderConfig

    loader = BatchLoader(PageDataset(pages, boxes), LoaderConfig(
        batch_size=batch_size, min_side=sides[0], max_side=sides[1],
        preprocess_mode=preprocess_mode, device_normalize=True, shuffle=False))
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
    pages, boxes = synthetic_pages(2, 0, SEED + 3, sizes=(PARITY_PAGE, None),
                                   with_boxes=True)
    host = next(_host_batch(pages, boxes, PARITY_SIDES, 2).epoch())
    res = _step_parity(dev, "resnet50", host)
    emit({"phase": "train_parity", "ok": True, "pages": 2,
          "bucket": list(PARITY_SIDES), "dtype": "float32", **res})


def _step_parity(dev, backbone, host):
    """One f32 fused-stem train step of a ``backbone`` RetinaNet (1 class,
    random weights from the seed) on CUDA and on the CPU on the host batch,
    held to phase_train_parity's bounds."""
    import numpy as np
    import torch

    from tdnet_torch.models.retinanet import RetinaNet
    from tdnet_torch.train.step import (create_optimizer, create_train_state,
                                        make_train_step)
    from tdnet_torch.weights import random_variables

    variables = random_variables(1, backbone, seed=SEED)
    runs = {}
    for name, d in (("gpu", dev), ("cpu", torch.device("cpu"))):
        model = RetinaNet(1, backbone)
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
    return {"num_positive": gm["num_positive"], "loss_gpu": gm["loss"],
            "loss_cpu": cm["loss"], "worst_metric_rel": worst_metric,
            "worst_tensor": worst[0], "worst_tensor_rel_fro": worst[1],
            "whole_grad_rel_fro": total, "tensors_compared": len(cg)}


def phase_train_cli(dev):
    """The train CLI in-process, as a user runs it: TRAIN_CLI_PAGES
    synthetic table pages written as PNG with an annotations CSV, ``--bf16
    --device-normalize`` at the 800/1333 sides, batch TRAIN_CLI_BATCH,
    ``--steps 0`` (one pass an epoch), TRAIN_CLI_EPOCHS epochs, ``--weights``
    a .tdn of smoke_variables, snapshots, JSONL metrics, ``--model-path``,
    and ``--evaluation`` on two of the pages. Counters set to 0 just before
    the run and read just after. Then a run resumed with ``--snapshot`` from
    the epoch-1 snapshot: its final state (weights, BN statistics, Adam
    moments, step, lr) must equal the unbroken run's bit for bit, so both
    runs take PyTorch's deterministic algorithms (cuDNN's, and the FPN's
    index_select backward without atomics) and the stem kernels sum in a
    fixed order. Then the bundle through the predict CLI on one page (uint8,
    the fused stem), counters set to 0 just before it."""
    import warnings

    import numpy as np
    import torch

    from tdnet_torch.bin import predict, train
    from tdnet_torch.data.image import write_image_bgr
    from tdnet_torch.models.io import save_model
    from tdnet_torch.models.retinanet import RetinaNet
    from tdnet_torch.ops import stem

    t_phase = time.monotonic()
    work = ROOT / "build" / "chip_smoke" / "train_cli"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    pages, boxes = synthetic_pages(TRAIN_CLI_PAGES, 0, SEED + 9,
                                   sizes=(TRAIN_PAGE, None), with_boxes=True)
    rows = []
    for i, (page, page_boxes) in enumerate(zip(pages, boxes)):
        write_image_bgr(work / f"page{i}.png", page.astype(np.uint8))
        rows.append([f"page{i}.png,{int(b[0])},{int(b[1])},{int(b[2])},{int(b[3])},table"
                     for b in page_boxes])
    (work / "annotations.csv").write_text("\n".join(sum(rows, [])) + "\n")
    (work / "val.csv").write_text("\n".join(sum(rows[:2], [])) + "\n")
    (work / "classes.csv").write_text("table,0\n")
    with torch.device("meta"):
        record = RetinaNet(1)  # the model record save_model reads
    save_model(str(work / "init.tdn"), record, smoke_variables())

    def argv(out, *extra, val=False):
        return ["--bf16", "--device-normalize", "--batch-size", str(TRAIN_CLI_BATCH),
                "--epochs", str(TRAIN_CLI_EPOCHS), "--steps", "0", "--log-every", "1",
                "--image-min-side", str(MIN_SIDE), "--image-max-side", str(MAX_SIDE),
                "--weights", str(work / "init.tdn"),
                "--snapshot-path", str(out / "snapshots"),
                "--metrics-path", str(out / "metrics.jsonl"),
                "--model-path", str(out / "model.tdn"), "--device", dev.type, *extra,
                "csv", str(work / "annotations.csv"), str(work / "classes.csv"),
                *(["--val-annotations", str(work / "val.csv")] if val else [])]

    steps_per_epoch = TRAIN_CLI_PAGES // TRAIN_CLI_BATCH
    total_steps = steps_per_epoch * TRAIN_CLI_EPOCHS
    full, resumed = work / "full", work / "resumed"
    counters = {**_all_counters(), "stem_bwd": stem.BWD_LAUNCHES}
    log = io.StringIO()
    with _deterministic(), warnings.catch_warnings(record=True) as caught, \
            contextlib.redirect_stdout(log):
        warnings.simplefilter("always")
        for c in counters.values():
            c.reset()
        sync(dev)
        t0 = time.monotonic()
        rc = train.main(argv(full, "--evaluation", val=True))
        sync(dev)
        train_s = time.monotonic() - t0
        launches = {k: c.count for k, c in counters.items()}
        src = work / "epoch1" / str(steps_per_epoch)
        shutil.copytree(full / "snapshots" / str(steps_per_epoch), src)
        t0 = time.monotonic()
        rc_resume = train.main(argv(resumed, "--snapshot", str(src.parent)))
        resume_s = time.monotonic() - t0
    out = log.getvalue().splitlines()
    require(rc == 0 and rc_resume == 0, f"exit codes {rc}, {rc_resume}: {out[-5:]}")
    require(launches["stem"] >= total_steps and launches["stem_bwd"] >= total_steps
            and launches["nms"] > 0, f"the train CLI skipped a kernel: {launches}")
    recs = [json.loads(x) for x in (full / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in recs if "step" in r]
    epochs = [r for r in recs if "epoch_loss" in r]
    require([r["step"] for r in steps] == list(range(1, total_steps + 1)),
            f"step records {[r.get('step') for r in steps]}")
    require(len(epochs) == TRAIN_CLI_EPOCHS
            and all("mAP" in r and "weighted_mAP" in r for r in epochs),
            f"epoch records {epochs}")
    losses = [r["loss"] for r in steps]
    require(np.isfinite(losses).all(), f"non-finite loss: {losses}")
    snapshot_steps = sorted(int(d.name) for d in (full / "snapshots").iterdir())
    require(snapshot_steps == [steps_per_epoch, total_steps],
            f"snapshots {snapshot_steps}")
    require(f"resumed from step {steps_per_epoch} (epoch 1)" in out,
            "the resumed run did not report its step")
    final = str(total_steps)
    got = torch.load(resumed / "snapshots" / final / "state.pt", weights_only=True)
    want = torch.load(full / "snapshots" / final / "state.pt", weights_only=True)
    unequal = [k for k in want if not _states_equal(got.get(k), want[k])]
    require(not unequal, f"the resumed run's final {unequal} differ from the "
            f"unbroken run's; nondeterminism warnings: "
            f"{sorted({str(w.message)[:120] for w in caught})}")
    del got, want
    for d in (full / "snapshots", resumed / "snapshots", src.parent):
        shutil.rmtree(d)  # ~0.4 GB a snapshot (weights and Adam moments)

    for c in counters.values():
        c.reset()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(log):
        rc_predict = predict.main([str(full / "model.tdn"), str(work / "page0.png"),
                                   "--output-dir", str(work / "predict"), "--bf16",
                                   "--device-normalize", "--device", dev.type])
    sync(dev)
    predict_s = time.monotonic() - t0
    predict_launches = {k: c.count for k, c in counters.items()}
    lines = (work / "predict" / "detections.jsonl").read_text().splitlines()
    require(rc_predict == 0 and len(lines) == 1, f"predict: rc {rc_predict}, {lines}")
    require(predict_launches["stem"] > 0 and predict_launches["nms"] > 0,
            f"predict skipped a kernel: {predict_launches}")
    emit({"phase": "train_cli", "ok": True, "model": "resnet50 retinanet, 1 class",
          "dtype": "bfloat16", "pages": TRAIN_CLI_PAGES, "batch": TRAIN_CLI_BATCH,
          "epochs": TRAIN_CLI_EPOCHS, "steps": total_steps,
          "loss_first": losses[0],
          "loss_last_mean": float(np.mean(losses[-steps_per_epoch:])),
          "images_per_sec_median": float(np.median([r["images_per_sec"] for r in steps])),
          "epoch_mAP": [r["mAP"] for r in epochs],
          "resume": "bit-equal (weights, BN statistics, Adam moments, step, lr)",
          "nondeterminism_warnings": len(caught),
          "predict_detections": len(json.loads(lines[0])["detections"]),
          "launches": launches, "predict_launches": predict_launches,
          "train_s": train_s, "resume_s": resume_s, "predict_s": predict_s,
          "seconds": time.monotonic() - t_phase})
    return {k: launches[k] + predict_launches[k] for k in launches}


def _h5_numbers(path, seconds):
    mb = os.path.getsize(path) / 1e6
    return {"MB": round(mb, 3), "s": seconds, "MB_per_s": mb / seconds}


def phase_train_cli_init(dev):
    """The train CLI's initial-weight flags at full width, on the PNG pages
    and CSVs of the ``train_cli`` phase (which writes them):

    1. ``smoke_variables()`` (ResNet-50 RetinaNet, 1 class) written as a
       keras ``.h5`` by the port's HDF5 writer, read back by
       ``load_keras_retinanet_h5(strict=True)``: bit-equal, with the write
       and read seconds and MB/s;
    2. its backbone alone as ``ResNet-50-model.keras.h5`` in
       ``$TDNET_PRETRAINED_DIR`` (set by ``main`` before the port is
       imported, since the search directories are read at import, as in
       the reference);
    3. ``bn_warmup`` on the card (f32, TF32 off) and on the CPU on the same
       2 batches of 2 pages at 256x384: every new mean and var within
       WARMUP_TOL of the CPU's, relative to the larger of the element and
       the leaf's largest magnitude;
    4. the train CLI with ``--bf16 --device-normalize --imagenet-weights
       --bn-warmup 2 --random-transform --tensorboard-dir --evaluation
       --steps 0``, batch TRAIN_CLI_BATCH, TRAIN_CLI_EPOCHS epochs:
       the lookup resolves to step 2's file, the keras import summary
       matches every backbone weight, the warm-up line is printed, the
       stem, stem_bwd and nms kernels launch (counters set to 0 just
       before the run), losses are finite, and the event file (read by the
       port's reader, every CRC checked) holds one scalar a numeric value
       of each JSONL record at that record's step;
    5. the evaluate CLI on step 1's ``.h5`` on CUDA: the NMS kernel
       launches (counters set to 0 just before it)."""
    import numpy as np
    import torch

    from tdnet_torch.bin import evaluate, train
    from tdnet_torch.compat.keras_import import (export_random_keras_weights,
                                                 keras_name_map,
                                                 load_keras_retinanet_h5)
    from tdnet_torch.device import no_tf32
    from tdnet_torch.models.retinanet import RetinaNet
    from tdnet_torch.ops import stem
    from tdnet_torch.train import weights
    from tdnet_torch.train.events import read_events
    from tdnet_torch.weights import random_variables

    t_phase = time.monotonic()
    pages_dir = ROOT / "build" / "chip_smoke" / "train_cli"
    work = ROOT / "build" / "chip_smoke" / "train_cli_init"
    shutil.rmtree(work, ignore_errors=True)
    shutil.rmtree(PRETRAINED_DIR, ignore_errors=True)
    work.mkdir(parents=True)
    PRETRAINED_DIR.mkdir(parents=True)

    def leaves(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, prefix + (k,))
            else:
                yield prefix + (k,), v

    # 1. the full model through the port's HDF5 writer and reader
    variables = smoke_variables()
    full = work / "full.h5"
    t0 = time.monotonic()
    export_random_keras_weights(str(full), variables)
    write = _h5_numbers(full, time.monotonic() - t0)
    t0 = time.monotonic()
    loaded = load_keras_retinanet_h5(str(full), random_variables(1, "resnet50", seed=SEED + 1),
                                     strict=True)
    read = _h5_numbers(full, time.monotonic() - t0)
    got, want = dict(leaves(loaded)), dict(leaves(variables))
    require(got.keys() == want.keys(), "the .h5 round trip lost or added leaves")
    unequal = [p for p, v in want.items()
               if got[p].dtype != v.dtype or not np.array_equal(got[p], v)]
    require(not unequal, f"the .h5 round trip changed {unequal[:3]}")
    del loaded, got

    # 2. the backbone alone, where --imagenet-weights looks
    backbone_map = {k: v for k, v in keras_name_map().items() if v[0] == "backbone"}
    imagenet = PRETRAINED_DIR / "ResNet-50-model.keras.h5"
    export_random_keras_weights(str(imagenet), variables, name_map=backbone_map)
    n_backbone = sum(1 for p, _ in want.items() if p[1] == "backbone")
    require(str(PRETRAINED_DIR) in weights.IMAGENET_SEARCH_DIRS,
            f"TDNET_PRETRAINED_DIR is not searched: {weights.IMAGENET_SEARCH_DIRS}")
    del want

    # 3. the warm-up on the card against the CPU
    wpages = synthetic_pages(4, 0, SEED + 11, sizes=(PARITY_PAGE, None))
    batches = [np.stack([p.astype(np.uint8) for p in wpages[i:i + 2]]) for i in (0, 2)]
    stats = {}
    with no_tf32():
        for name, d in (("gpu", dev), ("cpu", torch.device("cpu"))):
            t0 = time.monotonic()
            out = weights.bn_warmup(RetinaNet(1), variables, iter(batches), num_batches=2,
                                    verbose=False, device=d)
            stats[name] = (dict(leaves(out["batch_stats"])), time.monotonic() - t0)
    warm_worst = 0.0
    for p, c in stats["cpu"][0].items():
        g = stats["gpu"][0][p]
        warm_worst = max(warm_worst, float((np.abs(g - c) / np.maximum(
            np.abs(c), np.abs(c).max())).max()))
    require(warm_worst <= WARMUP_TOL, f"bn_warmup CUDA vs CPU: {warm_worst:.3g} > {WARMUP_TOL}")
    warm_s = {k: v[1] for k, v in stats.items()}
    del stats, variables

    # 4. the train CLI from the ImageNet lookup, warmed up, augmented
    tb, metrics = work / "tb", work / "metrics.jsonl"
    argv = ["--bf16", "--device-normalize", "--imagenet-weights", "--bn-warmup", "2",
            "--random-transform", "--tensorboard-dir", str(tb), "--evaluation",
            "--steps", "0", "--epochs", str(TRAIN_CLI_EPOCHS),
            "--batch-size", str(TRAIN_CLI_BATCH), "--log-every", "1",
            "--image-min-side", str(MIN_SIDE), "--image-max-side", str(MAX_SIDE),
            "--no-snapshots", "--metrics-path", str(metrics), "--device", dev.type,
            "csv", str(pages_dir / "annotations.csv"), str(pages_dir / "classes.csv"),
            "--val-annotations", str(pages_dir / "val.csv")]
    counters = {**_all_counters(), "stem_bwd": stem.BWD_LAUNCHES}
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        for c in counters.values():
            c.reset()
        sync(dev)
        t0 = time.monotonic()
        rc = train.main(argv)
        sync(dev)
        train_s = time.monotonic() - t0
    launches = {k: c.count for k, c in counters.items()}
    out = log.getvalue().splitlines()
    require(rc == 0, f"train exit code {rc}: {out[-5:]}")
    summary = f"keras h5 import: matched {n_backbone} weights from {imagenet}"
    require(summary in out, f"no import summary {summary!r}: {out[:6]}")
    warm_line = "bn_warmup: re-estimated BatchNorm statistics from 2 batches"
    require(warm_line in out, f"no warm-up line: {out[:8]}")
    total_steps = TRAIN_CLI_PAGES // TRAIN_CLI_BATCH * TRAIN_CLI_EPOCHS
    require(launches["stem"] >= total_steps and launches["stem_bwd"] >= total_steps
            and launches["nms"] > 0, f"the train CLI skipped a kernel: {launches}")
    recs = [json.loads(x) for x in metrics.read_text().splitlines()]
    losses = [r["loss"] for r in recs if "step" in r]
    require(len(losses) == total_steps and np.isfinite(losses).all(),
            f"step losses {losses}")
    (event_file,) = tb.iterdir()
    events = read_events(str(event_file))
    require(events[0]["file_version"] == "brain.Event:2", "no file_version event")
    scalars = sorted((e["step"], v["tag"], v["value"]) for e in events[1:] for v in e["values"])
    expected = sorted(
        (int(r.get("step", r.get("epoch", 0))), k, float(np.float32(v)))
        for r in recs for k, v in r.items()
        if k != "step" and isinstance(v, (int, float)))
    require(scalars == expected, f"event file {scalars[:4]} != JSONL {expected[:4]}")

    # 5. the evaluate CLI on the full .h5
    for c in counters.values():
        c.reset()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(log):
        rc_eval = evaluate.main(["--bf16", "--image-min-side", str(MIN_SIDE),
                                 "--image-max-side", str(MAX_SIDE), "--device", dev.type,
                                 "csv", str(pages_dir / "val.csv"),
                                 str(pages_dir / "classes.csv"), str(full)])
    sync(dev)
    eval_s = time.monotonic() - t0
    eval_launches = {k: c.count for k, c in counters.items()}
    printed = log.getvalue().splitlines()
    require(rc_eval == 0 and printed[-1].startswith("mAP: "), f"evaluate: {printed[-3:]}")
    require(eval_launches["nms"] > 0, f"evaluate skipped the NMS kernel: {eval_launches}")
    shutil.rmtree(PRETRAINED_DIR)
    full.unlink()
    emit({"phase": "train_cli_init", "ok": True, "model": "resnet50 retinanet, 1 class",
          "h5_write": write, "h5_read": read, "h5_round_trip": "bit-equal (strict)",
          "imagenet_weights": str(imagenet.relative_to(ROOT)),
          "backbone_weights_matched": n_backbone,
          "warmup_cuda_vs_cpu_max_rel": warm_worst, "warmup_tol": WARMUP_TOL,
          "warmup_s": warm_s, "dtype": "bfloat16", "steps": total_steps,
          "loss_first": losses[0], "loss_last": losses[-1],
          "epoch_mAP": [r["mAP"] for r in recs if "mAP" in r],
          "tensorboard_scalars": len(scalars), "launches": launches,
          "evaluate_launches": eval_launches, "evaluate_mAP": printed[-1],
          "train_s": train_s, "evaluate_s": eval_s,
          "seconds": time.monotonic() - t_phase})
    return {k: launches[k] + eval_launches[k] for k in launches}


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


def _backbone_variables(name, probe_pages, mode):
    """(variables, the logits' standard deviation as drawn): random weights
    of a ``name`` RetinaNet from the seed, the class head's bias at -2
    (smoke_variables' rule) and its kernel scaled so that the logits on the
    probe pages (resized to BACKBONE_PARITY_SIDE, f32 on the CPU) spread by
    BACKBONE_LOGIT_STD around it, as ResNet-50's random trunk spreads them
    by itself (~0.6). Some families' trunks, as drawn, leave the logits
    nearly flat: their scores tie, and greedy NMS on ties picks by the last
    bits of the sums, which differ between two correct devices."""
    import numpy as np
    import torch

    from tdnet_torch.models.retinanet import RetinaNet
    from tdnet_torch.ops.ingest import normalize_uint8_rows
    from tdnet_torch.train.predictor import Predictor
    from tdnet_torch.weights import random_variables

    v = random_variables(1, name, seed=SEED)
    head = v["params"]["classification_submodel"]["head"]
    head["bias"][:] = -2.0
    probe = Predictor(RetinaNet(1, name), v, device="cpu", device_preprocess=True,
                      min_side=BACKBONE_PARITY_SIDE, max_side=BACKBONE_PARITY_SIDE,
                      preprocess_mode=mode)
    canvases = np.stack([probe._prepare(p)[0] for p in probe_pages])
    b, h, w, _ = canvases.shape
    with torch.inference_mode():
        x = normalize_uint8_rows(torch.from_numpy(canvases.reshape(b * h, w * 3)), mode)
        logits = probe.model(x.reshape(b, h, w, 3))["classification"]
    drawn = float(logits.std())
    head["kernel"] *= BACKBONE_LOGIT_STD / drawn
    return v, drawn


def _backbone_predict(dev, name, pages, buckets, scales):
    """One family's inference: Predictor.predict_batch in bf16 on the 16
    pages of the predict phase (a warm-up run that records the normalize
    kernel's modes, then a timed run with the counters set to 0 just before
    it and read just after), CUDA-vs-CPU f32 parity at 512x512, and a .tdn
    round trip whose detections must be bit-equal."""
    import numpy as np
    import torch

    import tdnet_torch.train.predictor as predictor_mod
    from tdnet_torch.models import backbone
    from tdnet_torch.models.io import load_model, save_model
    from tdnet_torch.models.retinanet import RetinaNet, takes_fused_stem
    from tdnet_torch.train.predictor import Predictor

    mode = backbone(name).preprocess_mode
    parity_pages = synthetic_pages(2, 0, SEED + 5, sizes=((550, 500), None))
    variables, drawn_std = _backbone_variables(name, parity_pages, mode)
    sides = dict(min_side=MIN_SIDE, max_side=MAX_SIDE, preprocess_mode=mode)
    pred = Predictor(RetinaNet(1, name, dtype=torch.bfloat16), variables,
                     device=dev, device_preprocess=True, **sides)
    fused = takes_fused_stem(name)
    require(pred.fused_stem is (fused and dev.type == "cuda"),
            f"{name}: fused_stem {pred.fused_stem}")

    modes = []
    orig = predictor_mod.normalize_uint8_rows

    def recording(rows, mode_, **kw):
        modes.append(mode_)
        return orig(rows, mode_, **kw)

    predictor_mod.normalize_uint8_rows = recording
    try:
        pred.predict_batch(pages)  # warm-up
    finally:
        predictor_mod.normalize_uint8_rows = orig
    counters = _all_counters()
    out, elapsed, launches = _timed_predict(pred, pages, counters, dev)
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else None)
    n_det = check_detections(out, pages, buckets, scales)
    if dev.type == "cuda":
        if fused:
            want = launches["stem"] >= 1 and launches["ingest"] == 0 and not modes
        else:
            want = (launches["ingest"] >= 1 and launches["stem"] == 0
                    and set(modes) == {mode})
        require(want and launches["nms"] >= 1,
                f"{name}: launches {launches}, normalize modes {modes}")

    small = dict(min_side=BACKBONE_PARITY_SIDE, max_side=BACKBONE_PARITY_SIDE,
                 preprocess_mode=mode)
    parity = _device_parity(
        lambda d, thr: Predictor(RetinaNet(1, name), variables, device=d,
                                 device_preprocess=True, score_threshold=thr, **small),
        parity_pages, dev)

    # the bundle: written, read back, the same detections bit for bit (bf16)
    out_dir = ROOT / "build" / "chip_smoke" / "backbones"
    out_dir.mkdir(parents=True, exist_ok=True)
    bundle = out_dir / f"{name}.tdn"
    t0 = time.monotonic()
    save_model(str(bundle), RetinaNet(1, name), variables,
               inference_config={"preprocess_mode": mode})
    model, loaded, meta = load_model(str(bundle), dtype=torch.bfloat16)
    bundle_s = time.monotonic() - t0
    require(model.backbone_name == name and meta["inference"]["preprocess_mode"] == mode,
            f"{name}: bundle record {model.backbone_name}, {meta['inference']}")
    dets = [Predictor(m, v, device=dev, device_preprocess=True, **small)
            .predict_batch(parity_pages)
            for m, v in ((RetinaNet(1, name, dtype=torch.bfloat16), variables),
                         (model, loaded))]
    require(all(np.array_equal(a, b) for x, y in zip(*dets) for a, b in zip(x, y)),
            f"{name}: the bundle's detections differ from the in-memory model's")
    bundle_mb = bundle.stat().st_size / 2 ** 20
    bundle.unlink()
    return {"preprocess_mode": mode, "logit_std_as_drawn": drawn_std,
            "fused_stem": pred.fused_stem,
            "images_per_s": len(pages) / elapsed, "seconds": elapsed,
            "host_prep_s": pred.host_prep_s, "dispatch_s": pred.dispatch_s,
            "detections": n_det, "normalize_modes": sorted(set(modes)),
            "launches": launches, "peak_mem_gb": peak, "parity_f32_512": parity,
            "bundle_mb": bundle_mb, "bundle_write_read_s": bundle_s}


def _backbone_train(dev, name):
    """BACKBONE_TRAIN_STEPS bf16 train steps of a ``name`` RetinaNet at batch
    BACKBONE_TRAIN_BATCH on TRAIN_PAGE pages (bucket 800x1344), uint8
    through the route the train step picks (the fused stem and its backward
    kernel for SE-ResNet, the normalize kernel in the family's mode for the
    others); counters set to 0 just before the steps and read just after.
    Losses finite, the weights changed."""
    import numpy as np
    import torch

    from tdnet_torch.models import backbone
    from tdnet_torch.models.retinanet import RetinaNet, takes_fused_stem
    from tdnet_torch.ops import stem
    from tdnet_torch.train.step import (create_optimizer, create_train_state,
                                        make_train_step)
    from tdnet_torch.weights import random_variables

    mode = backbone(name).preprocess_mode
    pages, boxes = synthetic_pages(BACKBONE_TRAIN_BATCH, 0, SEED + 6,
                                   sizes=(TRAIN_PAGE, None), with_boxes=True)
    host = next(_host_batch(pages, boxes, (MIN_SIDE, MAX_SIDE),
                            BACKBONE_TRAIN_BATCH, mode).epoch())
    model = RetinaNet(1, name, dtype=torch.bfloat16)
    state = create_train_state(model, random_variables(1, name, seed=SEED), device=dev,
                               optimizer=create_optimizer(TRAIN_LR, 1e6))
    step = make_train_step(model, num_classes=1, preprocess_mode=mode)
    watched = ["backbone.conv1.weight", "classification_submodel.head.weight"]
    if name.startswith("se"):
        watched.append("backbone.stage5_block2.se_expand.weight")
    params = dict(model.named_parameters())
    before = {k: params[k].detach().clone() for k in watched}
    batch = _to_device(host, dev)
    counters = dict(_all_counters(), stem_bwd=stem.BWD_LAUNCHES)
    for c in counters.values():
        c.reset()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sync(dev)
    t0 = time.monotonic()
    losses = []
    for _ in range(BACKBONE_TRAIN_STEPS):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    sync(dev)
    seconds = time.monotonic() - t0
    launches = {k: c.count for k, c in counters.items()}
    require(np.isfinite(losses).all(), f"{name}: losses {losses}")
    changed = {k: not torch.equal(before[k], params[k].detach()) for k in watched}
    require(all(changed.values()), f"{name}: weights unchanged {changed}")
    if dev.type == "cuda":
        if takes_fused_stem(name):
            want = (launches["stem"] >= BACKBONE_TRAIN_STEPS
                    and launches["stem_bwd"] >= BACKBONE_TRAIN_STEPS
                    and launches["ingest"] == 0)
        else:
            want = launches["ingest"] >= BACKBONE_TRAIN_STEPS and launches["stem"] == 0
        require(want, f"{name} training launches: {launches}")
    return {"preprocess_mode": mode, "batch": BACKBONE_TRAIN_BATCH,
            "bucket": [batch["images"].shape[1], batch["images"].shape[2] // 3],
            "steps": BACKBONE_TRAIN_STEPS, "losses": losses,
            "step_s": seconds / BACKBONE_TRAIN_STEPS, "weights_changed": changed,
            "launches": launches,
            "peak_mem_gb": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                            if dev.type == "cuda" else None)}


def phase_backbones(dev):
    """The other backbone families at full width and depth (1 class, random
    weights from the seed): SE-ResNet-50 through the fused stem kernels,
    VGG-16 (caffe), DenseNet-121 and MobileNet (tf) through the normalize
    kernel, every one through the NMS kernel. For each: the predict phase's
    16 pages in bf16, CUDA vs CPU in f32 at 512x512, a .tdn round trip; 2
    bf16 train steps of SE-ResNet-50 (stem, stem_bwd) and DenseNet-121
    (ingest); one f32 SE-ResNet-50 step on CUDA against the CPU at 256x256
    (phase_train_parity's bounds)."""
    from tdnet_torch.data.generator import default_buckets, pick_bucket
    from tdnet_torch.data.image import compute_resize_scale

    t_phase = time.monotonic()
    pages = synthetic_pages(N_LANDSCAPE, N_PORTRAIT, SEED)
    scales = [compute_resize_scale(p.shape, MIN_SIDE, MAX_SIDE) for p in pages]
    buckets = [pick_bucket(round(p.shape[0] * s), round(p.shape[1] * s),
                           default_buckets(MIN_SIDE, MAX_SIDE))
               for p, s in zip(pages, scales)]
    inference = {name: _backbone_predict(dev, name, pages, buckets, scales)
                 for name in BACKBONES}
    train = {name: _backbone_train(dev, name) for name in BACKBONE_TRAIN}
    step_pages, step_boxes = synthetic_pages(1, 0, SEED + 7, sizes=(BACKBONE_STEP_PAGE, None),
                                             with_boxes=True)
    host = next(_host_batch(step_pages, step_boxes, BACKBONE_STEP_SIDES, 1).epoch())
    step_parity = _step_parity(dev, "seresnet50", host)
    total = {}
    for res in list(inference.values()) + list(train.values()):
        for k, v in res["launches"].items():
            total[k] = total.get(k, 0) + v
    emit({"phase": "backbones", "ok": True, "dtype": "bfloat16",
          "pages": len(pages), "buckets": sorted({str(b) for b in buckets}),
          "inference": inference, "train": train,
          "train_parity_seresnet50": {"bucket": list(BACKBONE_STEP_SIDES), "batch": 1,
                                      "dtype": "float32", **step_parity},
          "launches": total, "seconds": time.monotonic() - t_phase})
    return total


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

    require(all(np.array_equal(png.decode_png(b[1][0], route="cv2")[:, :, ::-1], p)
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
        worst = max(worst, _served_match(line["detections"], probe(page), thr))
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


def _voc_xml(path, boxes) -> None:
    """A VOC-style annotation file of table boxes."""
    objects = "".join(
        "<object><name>table</name><bndbox>" + "".join(
            f"<{k}>{int(v)}</{k}>" for k, v in zip(("xmin", "ymin", "xmax", "ymax"), b))
        + "</bndbox></object>" for b in boxes)
    Path(path).write_text(f"<annotation><filename>{Path(path).stem}.png</filename>"
                          f"{objects}</annotation>")


def _tree_equal(got, want) -> bool:
    """Two {params, batch_stats} numpy trees with the same leaves, bit for bit."""
    import numpy as np

    if isinstance(want, dict):
        return (isinstance(got, dict) and sorted(got) == sorted(want)
                and all(_tree_equal(got[k], want[k]) for k in want))
    got, want = np.asarray(got), np.asarray(want)
    return got.dtype == want.dtype and got.shape == want.shape and \
        got.tobytes() == want.tobytes()


def _tool_runner(dev, counters, seconds, launches):
    """run(step, main, argv): one tool's main, the counters set to 0 just
    before it and read just after into ``launches[step]``, its seconds into
    ``seconds[step]``; returns its printed lines and requires exit code 0."""

    def run(step, main, argv):
        log = io.StringIO()
        for c in counters.values():
            c.reset()
        sync(dev)
        t0 = time.monotonic()
        with contextlib.redirect_stdout(log):
            rc = main(argv)
        sync(dev)
        seconds[step] = time.monotonic() - t0
        launches[step] = {k: c.count for k, c in counters.items()}
        out = log.getvalue().splitlines()
        require(rc == 0, f"{step} exited {rc}: {out[-5:]}")
        return out

    return run


def phase_table_workflow(dev):
    """The table workflow's tools in-process, as a user chains them, on
    the card, ResNet-50 at full width and depth from smoke_variables:
    TABLE_PAGES synthetic table pages (TRAIN_PAGE, PNG) with one VOC XML
    each and one page without (a negative) -> ``csv_from_xml --val-split
    0.25`` (its rows must be the boxes written) -> ``train --bf16
    --device-normalize --coco-evaluation`` (batch 2, 2 steps an epoch, 2
    epochs, snapshots; the 12 COCO keys in each epoch's record) ->
    ``convert_model`` of the last snapshot, plainly and with ``--no-nms
    --config`` (weights bit-equal to the checkpoint's) -> ``evaluate
    --coco`` on the bundle (the VOC lines, the 12 summary lines, AP_table)
    -> ``predict --labels`` on TABLE_PREDICT pages (each annotated copy
    byte-equal to ``draw_detections`` of its JSONL line's detections, which
    must be the same predictor's, rounded; each holding caption pixels) -> ``export_keras``
    (the .h5 loads back bit-equal through ``load_initial_weights``;
    ``evaluate`` on it prints the bundle's VOC lines) -> ``debug --anchors
    --limit 2`` (2 PNGs). Each step's launch counters set to 0 just before
    it and read just after."""
    import numpy as np
    import torch

    from tdnet_torch.bin import (convert_model, csv_from_xml, debug, evaluate,
                                 export_keras, predict, train)
    from tdnet_torch.data.image import read_image_bgr, write_image_bgr
    from tdnet_torch.models.io import load_model, save_model
    from tdnet_torch.models.retinanet import RetinaNet
    from tdnet_torch.ops import stem
    from tdnet_torch.train.weights import load_initial_weights
    from tdnet_torch.utils.colors import label_color
    from tdnet_torch.utils.visualization import draw_box, draw_detections
    from tdnet_torch.weights import random_variables, variables_from_torch_state

    t_phase = time.monotonic()
    work = ROOT / "build" / "chip_smoke" / "table_workflow"
    shutil.rmtree(work, ignore_errors=True)
    for d in ("pages", "xml"):
        (work / d).mkdir(parents=True)
    pages, boxes = synthetic_pages(TABLE_PAGES + 1, 0, SEED + 13,
                                   sizes=(TRAIN_PAGE, None), with_boxes=True)
    want_rows, paths = [], []
    for i, (page, page_boxes) in enumerate(zip(pages, boxes)):
        paths.append(str(work / "pages" / f"page{i:02d}.png"))
        write_image_bgr(paths[-1], page.astype(np.uint8))
        if i == TABLE_PAGES:  # no XML: a negative
            want_rows.append(f"{paths[-1]},,,,,")
            continue
        _voc_xml(work / "xml" / f"page{i:02d}.xml", page_boxes)
        want_rows += [f"{paths[-1]},{int(b[0])},{int(b[1])},{int(b[2])},{int(b[3])},table"
                      for b in page_boxes]
    (work / "anchors.ini").write_text(TABLE_ANCHORS_INI)
    with torch.device("meta"):
        record = RetinaNet(1)  # the model record save_model reads
    save_model(str(work / "init.tdn"), record, smoke_variables())

    counters = {**_all_counters(), "stem_bwd": stem.BWD_LAUNCHES}
    seconds, launches = {}, {}
    run = _tool_runner(dev, counters, seconds, launches)

    csv_dir, snaps = work / "csv", work / "snapshots"
    data = ["csv", str(csv_dir / "annotations.csv"), str(csv_dir / "classes.csv")]
    sides = ["--image-min-side", str(MIN_SIDE), "--image-max-side", str(MAX_SIDE)]
    on_card = ["--device", dev.type]

    # 1. VOC XML -> annotations.csv, val_annotations.csv, classes.csv
    run("csv_from_xml", csv_from_xml.main,
        [str(work / "pages"), "--xml-dir", str(work / "xml"), "--out-dir", str(csv_dir),
         "--val-split", "0.25", "--seed", "0"])
    train_rows = (csv_dir / "annotations.csv").read_text().splitlines()
    val_rows = (csv_dir / "val_annotations.csv").read_text().splitlines()
    val_pages = sorted({r.split(",")[0] for r in val_rows})
    require(sorted(train_rows + val_rows) == sorted(want_rows)
            and len(val_pages) == (TABLE_PAGES + 1) // 4
            and (csv_dir / "classes.csv").read_text() == "table,0\n",
            f"csv_from_xml rows differ from the boxes written: {len(train_rows)} + "
            f"{len(val_rows)} rows for {len(want_rows)}")

    # 2. train with the per-epoch COCO evaluation
    total_steps = TABLE_STEPS * TABLE_EPOCHS
    run("train", train.main,
        ["--bf16", "--device-normalize", "--batch-size", str(TABLE_BATCH),
         "--epochs", str(TABLE_EPOCHS), "--steps", str(TABLE_STEPS), "--log-every", "1",
         *sides, "--weights", str(work / "init.tdn"), "--snapshot-path", str(snaps),
         "--metrics-path", str(work / "metrics.jsonl"), "--coco-evaluation", *on_card,
         *data, "--val-annotations", str(csv_dir / "val_annotations.csv")])
    recs = [json.loads(x) for x in (work / "metrics.jsonl").read_text().splitlines()]
    epochs = [r for r in recs if "epoch_loss" in r]
    require(len(epochs) == TABLE_EPOCHS and all(
        all(isinstance(r.get(k), float) for k in COCO_KEYS) and "AP_table" in r
        for r in epochs), f"epoch records {epochs}")
    losses = [r["loss"] for r in recs if "step" in r]
    require(len(losses) == total_steps and np.isfinite(losses).all(), f"losses {losses}")
    t = launches["train"]
    require(t["stem"] >= total_steps and t["stem_bwd"] >= total_steps and t["nms"] >= 1,
            f"train skipped a kernel: {t}")

    # 3. the last snapshot -> two bundles
    bundle, bundle_nonms = work / "model.tdn", work / "model_nonms.tdn"
    run("convert_model", convert_model.main, [str(snaps), str(bundle)])
    run("convert_model_no_nms", convert_model.main,
        [str(snaps), str(bundle_nonms), "--no-nms", "--config", str(work / "anchors.ini")])
    payload = torch.load(snaps / str(total_steps) / "state.pt", weights_only=True)
    want = variables_from_torch_state({**payload["params"], **payload["batch_stats"]})
    metas = {}
    for path in (bundle, bundle_nonms):
        _, variables, metas[path.name] = load_model(str(path))
        require(_tree_equal(variables, want), f"{path.name}: weights differ from the checkpoint's")
    require(metas["model.tdn"]["inference"]["nms"] is True
            and metas["model.tdn"]["anchors"] is None
            and metas["model_nonms.tdn"]["inference"]["nms"] is False
            and metas["model_nonms.tdn"]["anchors"]["scales"] == [1.0, 1.2, 1.6],
            f"bundle meta {metas}")
    del payload, want
    shutil.rmtree(snaps)  # ~0.4 GB a snapshot (weights and Adam moments)

    # 4. evaluate --coco on the bundle
    card = ["--bf16", "--device-normalize", *sides, *on_card]
    out = run("evaluate_coco", evaluate.main, ["--coco", *card, *data, str(bundle)])
    require(len(out) == 16 and "instances of class table with average precision" in out[0]
            and out[1].startswith("mAP using the weighted average")
            and out[2].startswith("mAP: ")
            and all(x.startswith((" Average Precision", " Average Recall")) for x in out[3:15])
            and out[15].startswith("AP_table: "), f"evaluate --coco printed {out}")
    voc, summary = out[:3], out[3:]

    # 5. predict --labels: a threshold that draws TABLE_DRAWN or more a page
    shown = paths[:TABLE_PREDICT]
    argv = [str(bundle), *shown, "--labels", str(csv_dir / "classes.csv"),
            "--output-dir", str(work / "predict"), "--bf16", "--device-normalize", *on_card]
    probe = predict.predictor_from_bundle(str(bundle), predict.parse_args(argv),
                                          device_preprocess=True)
    raw = {p: probe(read_image_bgr(p)) for p in shown}
    thr = min(float(np.sort(r[1])[::-1][TABLE_DRAWN - 1]) for r in raw.values()) - 1e-4
    require(thr > 0.05, f"fewer than {TABLE_DRAWN} detections on a page (threshold {thr})")
    del probe
    run("predict", predict.main, [*argv, "--score-threshold", repr(thr)])
    lines = [json.loads(x) for x in (work / "predict" / "detections.jsonl").read_text().splitlines()]
    require([x["image"] for x in lines] == shown, "one JSONL line a page, in order")
    names = {0: "table"}.get
    drawn = 0
    for line in lines:
        page = read_image_bgr(line["image"]).astype(np.uint8)
        copy = work / "predict" / f"det_{Path(line['image']).stem}.png"
        dets = line["detections"]
        # the JSONL holds the probe's detections above the threshold, rounded
        b, sc, lb = raw[line["image"]]
        keep = np.where(sc > thr)[0]
        require(dets == [{"box": [round(float(v), 2) for v in b[i]],
                          "score": round(float(sc[i]), 4), "label": int(lb[i])}
                         for i in keep],
                f"{copy.name}: the JSONL differs from the same predictor's detections")
        require(len(dets) >= TABLE_DRAWN, f"{copy.name}: {len(dets)} detections drawn")
        drawn += len(dets)
        redraw = page.copy()
        draw_detections(redraw, b, sc, lb, label_to_name=names, score_threshold=thr)
        write_image_bgr(work / "redraw.png", redraw)
        require((work / "redraw.png").read_bytes() == copy.read_bytes(),
                f"{copy.name} differs from draw_detections of its JSONL line's detections")
        boxes_only = page.copy()
        for d in dets:
            draw_box(boxes_only, d["box"], label_color(d["label"]))
        require((redraw != boxes_only).any(axis=2).sum() > 50, f"{copy.name}: no captions")
    del raw

    # 6. export_keras, then the .h5 back
    h5 = work / "model.h5"
    run("export_keras", export_keras.main, [str(bundle), str(h5)])
    _, variables, _ = load_model(str(bundle))
    back = load_initial_weights(str(h5), random_variables(1, "resnet50", seed=SEED + 1),
                                verbose=False)
    require(_tree_equal(back, variables), "the .h5 does not load back to the bundle's weights")
    del back, variables
    out = run("evaluate_h5", evaluate.main, [*card, *data, str(h5)])
    require(out[0].startswith("keras h5 import: matched ") and out[1:] == voc,
            f"evaluate on the .h5 printed {out}, on the .tdn {voc}")

    # 7. debug --anchors
    out = run("debug", debug.main, ["--output-dir", str(work / "debug"), "--anchors",
                                    "--limit", "2", *sides, *data])
    written = sorted(p.name for p in (work / "debug").glob("debug_*.png"))
    require(len(written) == 2 and len(out) == 2, f"debug wrote {written}: {out}")

    total = {k: sum(step[k] for step in launches.values()) for k in counters}
    require(total["stem"] >= 1 and total["stem_bwd"] >= 1 and total["nms"] >= 1,
            f"table_workflow skipped a kernel: {total}")
    emit({"phase": "table_workflow", "ok": True, "model": "resnet50 retinanet, 1 class",
          "pages": TABLE_PAGES + 1, "csv_rows": len(want_rows), "val_pages": len(val_pages),
          "train": {"dtype": "bfloat16", "batch": TABLE_BATCH, "steps": total_steps,
                    "loss_first": losses[0], "loss_last": losses[-1],
                    "epoch_coco": [{k: r[k] for k in ("AP", "AP50", "AR100")} for r in epochs]},
          "evaluate_coco": {"voc": voc, "summary": summary},
          "predict": {"pages": len(shown), "score_threshold": thr, "detections_drawn": drawn},
          "bundle_MB": bundle.stat().st_size / 1e6, "h5_MB": h5.stat().st_size / 1e6,
          "seconds": seconds, "launches": launches, "launches_total": total,
          "phase_seconds": time.monotonic() - t_phase})
    return total


def _bmp24(bgr) -> bytes:
    """An (H, W, 3) uint8 BGR page as a 24-bit bottom-up BMP."""
    import struct

    import numpy as np

    h, w = bgr.shape[:2]
    rows = np.zeros((h, (3 * w + 3) // 4 * 4), np.uint8)
    rows[:, :3 * w] = bgr.reshape(h, 3 * w)
    body = rows[::-1].tobytes()
    return struct.pack("<2sIHHIIiiHHIIiiII", b"BM", 54 + len(body), 0, 0, 54, 40, w, h,
                       1, 24, 0, len(body), 2835, 2835, 0, 0) + body


def _sha256(a) -> str:
    import hashlib

    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def phase_datasets(dev):
    """JPEG and BMP pages through the dataset CLIs on the card, ResNet-50
    at full width and depth: the four full-size JPEG pages of
    ``tests/golden/jpeg`` decoded by both routes (file: PIL's; body: cv2's,
    which turns the EXIF-6 page upright), each SHA-256 equal to the
    references' in ``digests.json``, and ``image_size`` equal to the frame
    header; a BMP page written here with numpy, decoded to its pixels. Then
    a VOCdevkit of the pages (one XML a page, class diningtable) ->
    ``train pascal`` (bf16, batch 2, 2 steps, random 20-class weights, a
    bundle) -> ``evaluate pascal --set-name test`` on it; a COCO layout ->
    ``evaluate --coco coco``; an Open Images layout (normalised boxes,
    ``--labels-filter``) and a KITTI layout (PNG pages) -> ``evaluate``;
    ``predict`` on the JPEG pages and the BMP (each page's detections a
    direct predictor's on the port's decode); the JPEG and BMP files POSTed
    to ``serve`` (each answer the predictor's on the port's cv2-route
    decode, the EXIF-6 page's on the upright page). The evaluations, predict
    and serve use one 1-class bundle (smoke_variables, f32 through the
    fused stem, device normalize) and bf16 where the tool takes it. Each
    step's launch counters set to 0 just before it and read just after."""
    import numpy as np
    import torch

    from tdnet_torch.bin import evaluate, predict, train
    from tdnet_torch.data import bmp, jpeg
    from tdnet_torch.data.image import image_size, read_image_bgr, write_image_bgr
    from tdnet_torch.models.io import load_model, save_model
    from tdnet_torch.models.retinanet import RetinaNet
    from tdnet_torch.ops import stem
    from tdnet_torch.train.predictor import Predictor

    t_phase = time.monotonic()
    work = ROOT / "build" / "chip_smoke" / "datasets"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    digests = json.loads((JPEG_PAGES / "digests.json").read_text())
    names = sorted(digests)
    require(len(names) == 4, f"{len(names)} JPEG pages in {JPEG_PAGES}")

    # 1. both decode routes against the references' digests
    decode_ms = {"pil": {}, "cv2": {}}
    files, pil_bgr, cv2_bgr = {}, {}, {}
    for name in names:
        path, info = JPEG_PAGES / name, digests[name]
        files[name] = data = path.read_bytes()
        t0 = time.perf_counter()
        rgb = jpeg.decode_jpeg(data, route="pil")
        t1 = time.perf_counter()
        body = jpeg.decode_jpeg(data, route="cv2")
        t2 = time.perf_counter()
        decode_ms["pil"][name], decode_ms["cv2"][name] = (t1 - t0) * 1e3, (t2 - t1) * 1e3
        pil_bgr[name] = np.ascontiguousarray(rgb[:, :, ::-1])
        cv2_bgr[name] = np.ascontiguousarray(body[:, :, ::-1])
        require(_sha256(rgb) == info["pil_rgb_sha256"], f"{name}: file route differs from PIL")
        require(_sha256(cv2_bgr[name]) == info["cv2_bgr_sha256"],
                f"{name}: body route differs from cv2.imdecode")
        size = (rgb.shape[1], rgb.shape[0])
        require(image_size(path) == jpeg.jpeg_size(data) == tuple(info["size"]) == size,
                f"{name}: image_size {image_size(path)}, header {jpeg.jpeg_size(data)}, "
                f"decoded {size}")
    turned = [n for n in names if cv2_bgr[n].shape != pil_bgr[n].shape]
    require(len(turned) == 1 and np.array_equal(np.rot90(cv2_bgr[turned[0]], 1),
                                                pil_bgr[turned[0]]),
            f"the EXIF-6 page is not turned upright by the body route: {turned}")
    landscape = [n for n in names if pil_bgr[n].shape[1] > pil_bgr[n].shape[0]]
    bmp_path = work / "page.bmp"
    bmp_path.write_bytes(_bmp24(pil_bgr[names[0]]))
    t0 = time.perf_counter()
    bmp_page = read_image_bgr(bmp_path)
    bmp_ms = (time.perf_counter() - t0) * 1e3
    require(np.array_equal(bmp_page, pil_bgr[names[0]])
            and np.array_equal(bmp.decode_bmp(bmp_path.read_bytes(), "cv2")[:, :, ::-1],
                               pil_bgr[names[0]]),
            "the BMP page does not decode to the pixels written")

    # 2. the layouts
    voc = work / "VOCdevkit" / "VOC2007"
    for d in ("JPEGImages", "Annotations", "ImageSets/Main"):
        (voc / d).mkdir(parents=True)
    stems = [Path(n).stem for n in names]
    for name, stem_name in zip(names, stems):
        (voc / "JPEGImages" / name).write_bytes(files[name])
        objects = "".join(  # VOC coordinates count from 1
            "<object><name>diningtable</name><bndbox>" + "".join(
                f"<{k}>{v + 1}</{k}>" for k, v in zip(("xmin", "ymin", "xmax", "ymax"), b))
            + "</bndbox></object>" for b in digests[name]["boxes"])
        (voc / "Annotations" / f"{stem_name}.xml").write_text(
            f"<annotation><filename>{name}</filename>{objects}</annotation>")
    test_set = [Path(landscape[0]).stem, Path(turned[0]).stem]
    (voc / "ImageSets" / "Main" / "trainval.txt").write_text("\n".join(stems) + "\n")
    (voc / "ImageSets" / "Main" / "test.txt").write_text("\n".join(test_set) + "\n")

    coco = work / "coco"
    (coco / "annotations").mkdir(parents=True)
    (coco / "images" / "val2017").mkdir(parents=True)
    images, anns = [], []
    for i, name in enumerate(names):
        (coco / "images" / "val2017" / name).write_bytes(files[name])
        w, h = digests[name]["size"]
        images.append({"id": i + 1, "file_name": name, "width": w, "height": h})
        anns += [{"id": len(anns) + 1, "image_id": i + 1, "category_id": 1,
                  "bbox": [b[0], b[1], b[2] - b[0], b[3] - b[1]], "iscrowd": 0,
                  "area": (b[2] - b[0]) * (b[3] - b[1])} for b in digests[name]["boxes"]]
    (coco / "annotations" / "instances_val2017.json").write_text(json.dumps(
        {"images": images, "annotations": anns,
         "categories": [{"id": 1, "name": "table"}]}))

    oi = work / "oi"
    (oi / "annotations").mkdir(parents=True)
    (oi / "images" / "validation").mkdir(parents=True)
    (oi / "annotations" / "class-descriptions-boxable.csv").write_text(
        "/m/04bcr3,Table\n/m/0c_jw,Furniture\n")
    rows = ["ImageID,Source,LabelName,Confidence,XMin,XMax,YMin,YMax,IsOccluded"]
    for name in landscape:
        (oi / "images" / "validation" / f"{Path(name).stem}.jpg").write_bytes(files[name])
        w, h = digests[name]["size"]
        for mid, boxes in (("/m/04bcr3", digests[name]["boxes"]), ("/m/0c_jw", [[0, 0, w, h]])):
            rows += [f"{Path(name).stem},xclick,{mid},1,{b[0] / w!r},{b[2] / w!r},"
                     f"{b[1] / h!r},{b[3] / h!r},0" for b in boxes]
    (oi / "annotations" / "validation-annotations-bbox.csv").write_text("\n".join(rows) + "\n")

    kitti = work / "kitti" / "train"
    (kitti / "images").mkdir(parents=True)
    (kitti / "labels").mkdir()
    for i, name in enumerate(landscape):
        write_image_bgr(kitti / "images" / f"{i:06d}.png", pil_bgr[name])
        (kitti / "labels" / f"{i:06d}.txt").write_text("".join(
            f"Car 0.00 0 0.00 {b[0]:.2f} {b[1]:.2f} {b[2]:.2f} {b[3]:.2f} "
            "1.50 1.60 3.90 1.80 1.50 8.50 0.00\n" for b in digests[name]["boxes"]))

    bundle = work / "table.tdn"
    with torch.device("meta"):
        record = RetinaNet(1)  # the model record save_model reads
    save_model(str(bundle), record, smoke_variables(),
               inference_config={"min_side": MIN_SIDE, "max_side": MAX_SIDE})

    counters = {**_all_counters(), "stem_bwd": stem.BWD_LAUNCHES}
    seconds, launches = {}, {}
    run = _tool_runner(dev, counters, seconds, launches)
    sides = ["--image-min-side", str(MIN_SIDE), "--image-max-side", str(MAX_SIDE)]
    on_card = ["--device", dev.type]
    card = ["--device-normalize", *sides, *on_card]

    # 3. train pascal, then evaluate pascal on its bundle
    voc_bundle = work / "voc.tdn"
    run("train_pascal", train.main,
        ["--bf16", "--batch-size", str(DATASET_BATCH), "--epochs", "1",
         "--steps", str(DATASET_STEPS), "--log-every", "1", "--no-snapshots",
         "--model-path", str(voc_bundle), "--metrics-path", str(work / "metrics.jsonl"),
         *card, "pascal", str(voc)])
    recs = [json.loads(x) for x in (work / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in recs if "step" in r]
    require(len(losses) == DATASET_STEPS and np.isfinite(losses).all(), f"losses {losses}")
    out = run("evaluate_pascal", evaluate.main,
              ["--bf16", *card, "pascal", str(voc), str(voc_bundle), "--set-name", "test"])
    require(len(out) == 22 and any("instances of class diningtable" in x for x in out)
            and out[-1].startswith("mAP: "), f"evaluate pascal printed {out}")
    voc_lines = [x for x in out if "diningtable" in x or x.startswith("mAP")]

    # 4. evaluate --coco coco, evaluate open_images and kitti
    out = run("evaluate_coco", evaluate.main,
              ["--coco", "--bf16", *card, "coco", str(coco), str(bundle),
               "--set-name", "val2017"])
    require(len(out) == 16 and out[15].startswith("AP_table: "), f"evaluate --coco printed {out}")
    coco_lines = [out[0], out[2], out[3], out[15]]
    out = run("evaluate_open_images", evaluate.main,
              ["--bf16", *card, "open_images", str(oi), str(bundle), "--subset", "validation",
               "--labels-filter", "Table"])
    require(len(out) == 3 and "instances of class Table" in out[0], f"open_images printed {out}")
    oi_lines = out
    out = run("evaluate_kitti", evaluate.main,
              ["--bf16", *card, "kitti", str(work / "kitti"), str(bundle), "--subset", "train"])
    require(len(out) == 11 and any("instances of class Car" in x for x in out),
            f"kitti printed {out}")
    kitti_lines = [x for x in out if "class Car" in x or x.startswith("mAP")]

    # 5. predict on the JPEG pages and the BMP (f32, device normalize)
    model, variables, meta = load_model(str(bundle))
    inference = dict(min_side=meta["inference"]["min_side"],
                     max_side=meta["inference"]["max_side"])

    def predictor(thr):
        return Predictor(model, variables, device=dev, device_preprocess=True,
                         score_threshold=thr, **inference)

    paths = [str(JPEG_PAGES / n) for n in names] + [str(bmp_path)]
    file_pages = [pil_bgr[n].astype(np.float32) for n in names] + [bmp_page]  # as read
    probe = predictor(0.05)  # the predict CLI's: the bundle's threshold, then its own
    thr, gap = _gap_threshold([probe(p) for p in file_pages])
    run("predict", predict.main, [str(bundle), *paths, "--output-dir", str(work / "predict"),
                                  "--score-threshold", repr(thr), "--device-normalize",
                                  *on_card])
    lines = [json.loads(x) for x in (work / "predict" / "detections.jsonl").read_text().splitlines()]
    require([x["image"] for x in lines] == paths, "one JSONL line a page, in order")
    worst, n_predict = 0.0, 0
    for line, page in zip(lines, file_pages):
        worst = max(worst, _served_match(line["detections"], probe(page), thr))
        n_predict += len(line["detections"])
    require(n_predict > 0, "predict compared no detections")

    # 6. serve: the JPEG files and the BMP as bodies, one at a time
    body_pages = [cv2_bgr[n] for n in names] + [pil_bgr[names[0]]]  # uint8, as decoded
    bodies = [(files[n], "image/jpeg") for n in names] + [(bmp_path.read_bytes(), "image/bmp")]
    direct = predictor(thr)
    base, httpd, batcher = _serve(predictor(thr), max_batch=4,
                                  max_delay_ms=SERVE_MAX_DELAY_MS, default_threshold=thr)
    try:
        for c in counters.values():
            c.reset()
        sync(dev)
        t0 = time.monotonic()
        answers = [_post(base, *b) for b in bodies]
        sync(dev)
        seconds["serve"] = time.monotonic() - t0
        launches["serve"] = {k: c.count for k, c in counters.items()}
    finally:
        _stop(httpd, batcher)
    require(all(a[0] == 200 for a in answers), f"serve answers {[a[:2] for a in answers]}")
    serve_worst, n_served = 0.0, 0
    for a, page in zip(answers, body_pages):
        require(a[1]["image_hw"] == list(page.shape[:2]),
                f"served image_hw {a[1]['image_hw']}, decoded {page.shape[:2]}")
        serve_worst = max(serve_worst, _served_match(a[1]["detections"],
                                                     direct.predict_batch([page])[0], thr))
        n_served += len(a[1]["detections"])
    require(n_served > 0, "serve compared no detections")

    for step, got in launches.items():
        want = ("stem", "stem_bwd") if step == "train_pascal" else ("stem", "nms")
        require(all(got[k] >= 1 for k in want), f"{step} skipped a kernel: {got}")
    total = {k: sum(step[k] for step in launches.values()) for k in counters}
    emit({"phase": "datasets", "ok": True,
          "pages": {n: {"bytes": digests[n]["bytes"], "size": digests[n]["size"]} for n in names},
          "decode_ms": {r: {k: round(v, 1) for k, v in d.items()} for r, d in decode_ms.items()},
          "decode_ms_mean": {r: sum(d.values()) / len(d) for r, d in decode_ms.items()},
          "bmp_ms": bmp_ms, "exif6_page": turned[0],
          "train_pascal": {"dtype": "bfloat16", "batch": DATASET_BATCH, "losses": losses},
          "evaluate": {"pascal": voc_lines, "coco": coco_lines, "open_images": oi_lines,
                       "kitti": kitti_lines},
          "predict": {"pages": len(paths), "score_threshold": thr, "threshold_gap": gap,
                      "detections_compared": n_predict, "max_box_diff_px": worst},
          "serve": {"bodies": len(bodies), "detections_compared": n_served,
                    "max_box_diff_px": serve_worst},
          "seconds": seconds, "launches": launches, "launches_total": total,
          "phase_seconds": time.monotonic() - t_phase})
    return total


def phase_pages(dev):
    """The page formats beyond sequential JPEG through the main path on the
    card, ResNet-50 at full width and depth: every page of
    ``tests/golden/pages`` (progressive JPEG from PIL and from cv2, CMYK
    and 4:1:1 JPEG, an RLE8 BMP, CCITT G4, LZW-with-predictor,
    JPEG-compressed and YCbCr LZW TIFF, a P4 PBM, a GIF, sequential and
    progressive arithmetic-coded JPEG, lossless JPEG, a byte-encoded Sun
    raster, WebP: lossless with a palette and with thousands of colours,
    lossy, lossy with alpha, lossy with EXIF orientation 6 (the routes
    part: cv2 turns it), lossy with the simple filter in 4 partitions; an
    APNG whose IDAT image is not a frame (the routes part: cv2 reads the
    first frame), a PNG with EXIF orientation 6 (cv2 turns it), a CIE
    L*a*b* TIFF (LittleCMS on the file route, libtiff on the body route),
    a 12-bit JPEG, a gray PFM and a Radiance HDR page; JPEG 2000: a 9/7
    JP2 with three rate layers, a 5/3 RPCL codestream in 512x512 tiles
    with 128x128 precincts, cv2's own JP2 and a 16-bit gray JP2 on which
    the routes part; the pages only PIL reads: 32-bit float and integer
    gray TIFF, an RLE colour-mapped top-down TGA, an 8-bit PCX with its
    palette, a 16-bit RLE SGI, an ICO of a PNG and a BMP frame, BC7 and
    BC6H DDS, QOI and IM with a Lut; and the twenty of slice 23: a DIB, a
    CUR, a DCX, a version-1 MSP, an XBM, a SPIDER page, an ICNS of a PNG
    and an RLE icon, a DXT1 BLP2, a PackBits PSD, an XPM, a FITS page, a
    GBR brush, a BC1 FTEX, a PIXAR page, a McIDAS area, an IMT page, an XV
    thumbnail, a BRUN FLC, a Photo CD base image and an IPTC page; each
    refused on the body route; and six AVIF pages, read by both routes
    through the port's AV1 decoder: Pillow's and cv2's default encodes of
    the full page, lossless 4:4:4, low quality with loop restoration, 4:0:0
    in tiles and a BT.709 limited-range ``colr``) decoded by both
    routes, each SHA-256 equal to the references' in ``digests.json``,
    each route a reference refuses raising (PIL's on the arithmetic page
    past its first 64 KiB, the 12-bit JPEG and the HDR page; cv2's on the
    Sun raster, the 12-bit JPEG and the gray PFM, which it returns as one
    channel), and ``image_size`` equal to PIL's size, raising where PIL
    cannot open the file; a CSV of the pages
    the file route reads -> ``train csv`` (bf16, batch 2, 2 steps, the
    fused stem and its backward kernel); ``predict`` on those files (each
    page's detections a direct predictor's on the file route's decode);
    every file POSTed to ``serve`` one at a time (each answer the
    predictor's on the body route's decode, a 400 where the body route
    refuses, as the reference's server answers when ``cv2.imdecode``
    returns None). Boxes are held to PAGES_MATCH_PX. Each step's launch
    counters set to 0 just before it and read just after."""
    import numpy as np
    import torch

    from tdnet_torch.bin import predict, train
    from tdnet_torch.data.image import decode_image, image_size
    from tdnet_torch.models.io import load_model, save_model
    from tdnet_torch.models.retinanet import RetinaNet
    from tdnet_torch.ops import stem
    from tdnet_torch.train.predictor import Predictor

    t_phase = time.monotonic()
    work = ROOT / "build" / "chip_smoke" / "pages"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    digests = json.loads((GOLDEN_PAGES / "digests.json").read_text())
    names = sorted(digests)
    on_disk = sorted(p.name for p in GOLDEN_PAGES.iterdir() if p.name != "digests.json")
    require(names == on_disk, f"digests.json lists {names}, {GOLDEN_PAGES} holds {on_disk}")

    # 1. both decode routes against the references' digests, refusals raising
    decode_ms = {"pil": {}, "cv2": {}}
    files, file_rgb, body_bgr = {}, {}, {}
    for name in names:
        path, info = GOLDEN_PAGES / name, digests[name]
        files[name] = data = path.read_bytes()
        refused = info.get("refused", {})
        for route, decoded in (("pil", file_rgb), ("cv2", body_bgr)):
            t0 = time.perf_counter()
            try:
                image = decode_image(data, route=route)
            except ValueError as e:
                image = e
            decode_ms[route][name] = (time.perf_counter() - t0) * 1e3
            if route in refused:
                require(isinstance(image, ValueError),
                        f"{name}: the {route} route reads a page its reference refuses "
                        f"({refused[route]})")
                continue
            require(not isinstance(image, ValueError), f"{name}: {route} route: {image}")
            decoded[name] = image if route == "pil" else np.ascontiguousarray(image[:, :, ::-1])
            want = info["pil_rgb_sha256" if route == "pil" else "cv2_bgr_sha256"]
            require(_sha256(decoded[name]) == want, f"{name}: {route} route differs from "
                    f"{'PIL' if route == 'pil' else 'cv2.imdecode'}")
        if info["size"] is None:  # PIL cannot open the file, and image_size raises
            try:
                size = image_size(path)
            except ValueError:
                size = None
            require(size is None, f"{name}: image_size {size}, where PIL cannot open the file")
            continue
        shape = (file_rgb.get(name) if name in file_rgb else body_bgr[name]).shape
        require(image_size(path) == tuple(info["size"]) == (shape[1], shape[0]),
                f"{name}: image_size {image_size(path)}, PIL {info['size']}")
    both = [n for n in names if not digests[n].get("refused")]
    parted = [n for n in both if not np.array_equal(file_rgb[n], body_bgr[n][:, :, ::-1])]
    require(parted == [n for n in both if not digests[n]["routes_equal"]],
            f"the routes part on {parted}")
    readable = [n for n in names if n in file_rgb]  # the file route's pages

    # 2. train csv on the pages the file route reads
    rows = []
    for name in readable:
        rows += [f"{GOLDEN_PAGES / name},{b[0]},{b[1]},{b[2]},{b[3]},table"
                 for b in digests[name]["boxes"]]
    (work / "annotations.csv").write_text("\n".join(rows) + "\n")
    (work / "classes.csv").write_text("table,0\n")
    bundle = work / "table.tdn"
    with torch.device("meta"):
        record = RetinaNet(1)  # the model record save_model reads
    save_model(str(bundle), record, smoke_variables(),
               inference_config={"min_side": MIN_SIDE, "max_side": MAX_SIDE})
    counters = {**_all_counters(), "stem_bwd": stem.BWD_LAUNCHES}
    seconds, launches = {}, {}
    run = _tool_runner(dev, counters, seconds, launches)
    sides = ["--image-min-side", str(MIN_SIDE), "--image-max-side", str(MAX_SIDE)]
    on_card = ["--device", dev.type]
    run("train_csv", train.main,
        ["--bf16", "--batch-size", str(PAGES_BATCH), "--epochs", "1",
         "--steps", str(PAGES_STEPS), "--log-every", "1", "--no-snapshots",
         "--weights", str(bundle), "--model-path", str(work / "trained.tdn"),
         "--metrics-path", str(work / "metrics.jsonl"), "--device-normalize", *sides,
         *on_card, "csv", str(work / "annotations.csv"), str(work / "classes.csv")])
    recs = [json.loads(x) for x in (work / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in recs if "step" in r]
    require(len(losses) == PAGES_STEPS and np.isfinite(losses).all(), f"losses {losses}")

    # 3. predict on the files (f32, device normalize)
    model, variables, meta = load_model(str(bundle))
    inference = dict(min_side=meta["inference"]["min_side"],
                     max_side=meta["inference"]["max_side"])

    def predictor(thr):
        return Predictor(model, variables, device=dev, device_preprocess=True,
                         score_threshold=thr, **inference)

    paths = [str(GOLDEN_PAGES / n) for n in readable]
    file_pages = [np.ascontiguousarray(file_rgb[n][:, :, ::-1]).astype(np.float32)
                  for n in readable]  # as read_image_bgr reads them
    probe = predictor(0.05)  # the predict CLI's: the bundle's threshold, then its own
    thr, gap = _gap_threshold([probe(p) for p in file_pages])
    run("predict", predict.main, [str(bundle), *paths, "--output-dir", str(work / "predict"),
                                  "--score-threshold", repr(thr), "--device-normalize",
                                  *on_card])
    lines = [json.loads(x) for x in (work / "predict" / "detections.jsonl").read_text().splitlines()]
    require([x["image"] for x in lines] == paths, "one JSONL line a page, in order")
    worst, n_predict = 0.0, 0
    for line, page in zip(lines, file_pages):
        worst = max(worst, _served_match(line["detections"], probe(page), thr))
        n_predict += len(line["detections"])
    require(n_predict > 0, "predict compared no detections")
    require(worst <= PAGES_MATCH_PX + 1e-6, f"predict's boxes off by {worst} px")

    # 4. serve: every file as a body, one at a time
    ctypes = {".jpg": "image/jpeg", ".bmp": "image/bmp", ".tif": "image/tiff",
              ".pbm": "image/x-portable-bitmap", ".gif": "image/gif",
              ".ras": "image/x-sun-raster", ".webp": "image/webp", ".png": "image/png",
              ".pfm": "image/x-portable-floatmap", ".hdr": "image/vnd.radiance",
              ".jp2": "image/jp2", ".j2k": "image/x-jp2-codestream", ".tga": "image/x-tga",
              ".pcx": "image/x-pcx", ".sgi": "image/sgi", ".ico": "image/vnd.microsoft.icon",
              ".dds": "image/vnd-ms.dds", ".qoi": "image/qoi", ".im": "image/x-im",
              ".dib": "image/bmp", ".psd": "image/vnd.adobe.photoshop", ".xbm": "image/x-xbitmap",
              ".xpm": "image/x-xpixmap", ".fits": "image/fits", ".icns": "image/icns",
              ".avif": "image/avif"}
    direct = predictor(thr)
    base, httpd, batcher = _serve(predictor(thr), max_batch=4,
                                  max_delay_ms=SERVE_MAX_DELAY_MS, default_threshold=thr)
    try:
        for c in counters.values():
            c.reset()
        sync(dev)
        t0 = time.monotonic()
        answers = [_post(base, files[n], ctypes.get(Path(n).suffix, "application/octet-stream"))
                   for n in names]
        sync(dev)
        seconds["serve"] = time.monotonic() - t0
        launches["serve"] = {k: c.count for k, c in counters.items()}
    finally:
        _stop(httpd, batcher)
    statuses = {n: a[0] for a, n in zip(answers, names)}
    require(statuses == {n: 200 if n in body_bgr else 400 for n in names},
            f"serve answers {statuses} (400 where the body route refuses)")
    serve_worst, n_served = 0.0, 0
    for a, name in zip(answers, names):
        if name not in body_bgr:
            require("could not decode image body" in a[1].get("error", ""),
                    f"{name}: served {a[1]}")
            continue
        page = body_bgr[name]
        require(a[1]["image_hw"] == list(page.shape[:2]),
                f"served image_hw {a[1]['image_hw']}, decoded {page.shape[:2]}")
        serve_worst = max(serve_worst, _served_match(a[1]["detections"],
                                                     direct.predict_batch([page])[0], thr))
        n_served += len(a[1]["detections"])
    require(n_served > 0, "serve compared no detections")
    require(serve_worst <= PAGES_MATCH_PX + 1e-6, f"served boxes off by {serve_worst} px")

    for step, got in launches.items():
        want = ("stem", "stem_bwd") if step == "train_csv" else ("stem", "nms")
        require(all(got[k] >= 1 for k in want), f"{step} skipped a kernel: {got}")
    total = {k: sum(step[k] for step in launches.values()) for k in counters}
    emit({"phase": "pages", "ok": True,
          "pages": {n: {"bytes": digests[n]["bytes"], "size": digests[n]["size"]} for n in names},
          "refused": {n: sorted(digests[n]["refused"]) for n in names
                      if digests[n].get("refused")},
          "routes_parted": parted,
          "decode_ms": decode_ms,
          "decode_ms_mean": {r: sum(d.values()) / len(d) for r, d in decode_ms.items()},
          "train_csv": {"dtype": "bfloat16", "batch": PAGES_BATCH, "losses": losses,
                        "seconds_per_step": seconds["train_csv"] / PAGES_STEPS,
                        "launches_per_step": {k: v / PAGES_STEPS for k, v
                                              in launches["train_csv"].items()}},
          "predict": {"pages": len(paths), "score_threshold": thr, "threshold_gap": gap,
                      "detections_compared": n_predict, "max_box_diff_px": worst},
          "serve": {"bodies": len(names), "refused_400": len(names) - len(body_bgr),
                    "detections_compared": n_served, "max_box_diff_px": serve_worst},
          "seconds": seconds, "launches": launches, "launches_total": total,
          "phase_seconds": time.monotonic() - t_phase})
    return total


def _cli_runs(dev, runs, said):
    """(name, main, argv) runs in this process, in order, each with the
    stem, stem_bwd, nms and ingest counters set to 0 just before it and
    read just after; "distributed:" lines go to ``said``. A non-zero exit
    fails."""
    from tdnet_torch.ops import ingest, nms_kernel, stem

    counters = {"ingest": ingest.LAUNCHES, "stem": stem.LAUNCHES,
                "stem_bwd": stem.BWD_LAUNCHES, "nms": nms_kernel.LAUNCHES}
    results = []
    for name, main, argv in runs:
        log = io.StringIO()
        for c in counters.values():
            c.reset()
        sync(dev)
        t0 = time.monotonic()
        with contextlib.redirect_stdout(log):
            rc = main(argv)
        sync(dev)
        out = log.getvalue().splitlines()
        said += [x for x in out if x.startswith("distributed:")]
        results.append({"name": name, "rc": rc, "seconds": time.monotonic() - t0,
                        "launches": {k: c.count for k, c in counters.items()},
                        "stdout": [x for x in out if not x.startswith("distributed:")][-40:]})
        require(rc == 0, f"{name} exited {rc}: {out[-5:]}")
    return results


@contextlib.contextmanager
def _deterministic():
    """PyTorch's deterministic algorithms and cuDNN's, as phase_train_cli
    takes them: the bit-for-bit comparisons need them."""
    import torch

    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        torch.backends.cudnn.deterministic = prev[2]


def _one_rank_group(dev, runs):
    """The runs in this process inside a 1-rank group made here by hand
    (NCCL on the card, gloo on the CPU), destroyed after. The group is
    synthetic: the port's ``initialize_distributed`` makes none for one
    process, so this is how NCCL's path (the DDP reducer and the step's
    all-reduces) runs on a machine with one card."""
    import torch.distributed as dist

    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        said = [f"distributed: rank 0 of 1, backend {dist.get_backend()}"]
        with _deterministic():
            return {"backend": said, "runs": _cli_runs(dev, runs, said)}
    finally:
        dist.destroy_process_group()


def _distributed_child(spec_path) -> int:
    """One rank of the distributed phase (``chip_smoke.py
    --distributed-child spec.json``): the spec's CLI runs in order in this
    process (``_cli_runs``). Prints one ``DISTRIBUTED_CHILD`` JSON line; a
    failure raises."""
    sys.path.insert(0, str(ROOT))
    import torch

    from tdnet_torch.bin import evaluate, train

    spec = json.loads(Path(spec_path).read_text())
    # as the parent (phase_device): full f32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    said = []
    tools = {"train": train.main, "evaluate": evaluate.main}
    with _deterministic():
        results = _cli_runs(torch.device(spec["device"]),
                            [(run["name"], tools[run["tool"]], run["argv"])
                             for run in spec["runs"]], said)
    print("DISTRIBUTED_CHILD " + json.dumps({"backend": said, "runs": results}), flush=True)
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_children(work, name, specs, timeout=600):
    """Start one child a spec (all together), wait for all, return their
    results in order; any child that fails fails the phase, with its
    output's tail."""
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    procs = []
    for i, spec in enumerate(specs):
        path = work / f"{name}{i}.json"
        path.write_text(json.dumps(spec))
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--distributed-child", str(path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for i, (p, out) in enumerate(zip(procs, outs)):
        lines = [x for x in out.splitlines() if x.startswith("DISTRIBUTED_CHILD ")]
        require(p.returncode == 0 and lines,
                f"{name} child {i} exited {p.returncode}:\n" + "\n".join(out.splitlines()[-30:]))
        results.append(json.loads(lines[-1].split(" ", 1)[1]))
    return results


def _variables_leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _variables_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def phase_distributed(dev):
    """Data parallelism through the train and evaluate CLIs, one process a
    rank, ResNet-50 at full width and depth from a .tdn of smoke_variables,
    DIST_PAGES synthetic PNG table pages at 800x1300 (bucket 800x1344),
    ``--device-normalize`` (the fused stem and its backward kernel on every
    rank):

    - this process without a group, as a user runs one card: ``train`` bf16
      at batch DIST_BATCH for DIST_STEPS steps (the one-rank step time),
      ``train`` f32 at batch 2 x DIST_BATCH for one step, and ``evaluate
      --coco`` on the 8 pages DIST_EVAL_PAGES of tests/golden/pages (their GT: a direct
      Predictor's DIST_EVAL_GT best boxes a page);
    - this process in a synthetic 1-rank NCCL group (``_one_rank_group``),
      so that NCCL's path runs on any card count: the f32 step again;
    - then DIST_RANKS ranks with ``--distributed`` (one card: they share it
      over gloo; more cards: a card each over NCCL): ``train`` bf16 at batch
      DIST_BATCH a rank for DIST_STEPS steps, the same with ``--zero``,
      ``train`` f32 one step, MobileNet (``DIST_NORMALIZE_BACKBONE``, random
      weights) bf16 for DIST_STEPS steps, whose step takes the sharded
      normalize kernel, and ``evaluate --distributed --coco``.

    Held: ``--zero``'s bundle byte-equal to plain data parallelism's; the
    2-rank f32 step, and the 1-rank NCCL one, against the plain step on the
    same global batch (num_positive exact, loss rtol 1e-4, grad_norm rtol
    1e-3, every weight moved by at most lr and at most 5% of them apart by
    more than 1e-3 lr + 1e-7, as tests/test_torch_train.py holds the port
    against the reference); the sharded evaluation's printed lines equal to
    one process's; the stem and stem_bwd kernels launched on every rank for
    every ResNet train step, the ingest kernel for every MobileNet step,
    the NMS kernel on every rank's evaluation. Each run's counters are set
    to 0 just before it and read just after, in its process."""
    import numpy as np
    import torch

    from tdnet_torch.bin import evaluate, train
    from tdnet_torch.data.image import read_image_bgr, write_image_bgr
    from tdnet_torch.models.io import load_model, save_model
    from tdnet_torch.models.retinanet import RetinaNet
    from tdnet_torch.train.predictor import Predictor

    t_phase = time.monotonic()
    work = ROOT / "build" / "chip_smoke" / "distributed"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    pages, boxes = synthetic_pages(DIST_PAGES, 0, SEED + 17, sizes=(TRAIN_PAGE, None),
                                   with_boxes=True)
    rows = []
    for i, (page, page_boxes) in enumerate(zip(pages, boxes)):
        write_image_bgr(work / f"page{i}.png", page.astype(np.uint8))
        rows += [f"page{i}.png,{int(b[0])},{int(b[1])},{int(b[2])},{int(b[3])},table"
                 for b in page_boxes]
    (work / "annotations.csv").write_text("\n".join(rows) + "\n")
    (work / "classes.csv").write_text("table,0\n")
    with torch.device("meta"):
        record = RetinaNet(1)  # the model record save_model reads
    init = smoke_variables()
    save_model(str(work / "init.tdn"), record, init,
               inference_config={"min_side": MIN_SIDE, "max_side": MAX_SIDE})
    # the evaluation's GT: the model's own DIST_EVAL_GT best boxes a page
    # (random weights reach no page's tables), so that the compared AP lines
    # turn on every rank's detections and scores
    golden = [GOLDEN_PAGES / n for n in DIST_EVAL_PAGES]
    model, variables, _ = load_model(str(work / "init.tdn"))
    probe = Predictor(model, variables, device=dev, device_preprocess=True,
                      min_side=MIN_SIDE, max_side=MAX_SIDE)
    gt_rows = []
    for path, (det_boxes, scores, _) in zip(golden, probe.predict_batch(
            [read_image_bgr(p) for p in golden])):
        for b in np.asarray(det_boxes)[np.argsort(-np.asarray(scores))][:DIST_EVAL_GT]:
            x1, y1, x2, y2 = (int(round(float(v))) for v in b)
            if x2 > x1 and y2 > y1:
                gt_rows.append(f"{path},{x1},{y1},{x2},{y2},table\n")
    (work / "golden.csv").write_text("".join(gt_rows))
    del model, variables, probe

    def train_argv(name, batch, steps, *extra):
        return ["--device", dev.type, "--device-normalize", "--batch-size", str(batch),
                "--steps", str(steps),
                "--epochs", "1", "--log-every", "1", "--no-snapshots",
                "--weights", str(work / "init.tdn"), "--seed", "3",
                "--image-min-side", str(MIN_SIDE), "--image-max-side", str(MAX_SIDE),
                "--metrics-path", str(work / f"{name}.jsonl"),
                "--model-path", str(work / f"{name}.tdn"), *extra,
                "csv", str(work / "annotations.csv"), str(work / "classes.csv")]

    eval_argv = ["--device", dev.type, "--device-normalize", "--coco",
                 "--image-min-side", str(MIN_SIDE),
                 "--image-max-side", str(MAX_SIDE), "csv", str(work / "golden.csv"),
                 str(work / "classes.csv"), str(work / "init.tdn")]
    seconds = {"prep": time.monotonic() - t_phase}
    t0 = time.monotonic()
    said = []
    with _deterministic():
        one = {"backend": said, "runs": _cli_runs(dev, [
            ("bf16", train.main, train_argv("one_bf16", DIST_BATCH, DIST_STEPS, "--bf16")),
            ("f32", train.main, train_argv("one_f32", 2 * DIST_BATCH, 1)),
            ("evaluate", evaluate.main, eval_argv)], said)}
    require(not said, f"one process made a group: {said}")
    seconds["one_process"] = time.monotonic() - t0
    t0 = time.monotonic()
    nccl = _one_rank_group(dev, [("f32", train.main,
                                  train_argv("nccl_f32", 2 * DIST_BATCH, 1))])
    seconds["one_rank_group"] = time.monotonic() - t0
    t0 = time.monotonic()
    spec = f"127.0.0.1:{_free_port()},{DIST_RANKS},"
    ranks = _run_children(work, "rank", [{"device": dev.type, "runs": [
        {"name": "bf16", "tool": "train",
         "argv": train_argv("two_bf16", DIST_BATCH, DIST_STEPS, "--bf16",
                            "--distributed", spec + str(r))},
        {"name": "zero", "tool": "train",
         "argv": train_argv("two_zero", DIST_BATCH, DIST_STEPS, "--bf16", "--zero",
                            "--distributed", spec + str(r))},
        {"name": "f32", "tool": "train",
         "argv": train_argv("two_f32", DIST_BATCH, 1, "--distributed", spec + str(r))},
        {"name": "mobilenet", "tool": "train",
         "argv": ["--device", dev.type, "--device-normalize", "--bf16",
                  "--backbone", DIST_NORMALIZE_BACKBONE, "--batch-size", str(DIST_BATCH),
                  "--steps", str(DIST_STEPS), "--epochs", "1", "--log-every", "1",
                  "--no-snapshots", "--seed", "3", "--image-min-side", str(MIN_SIDE),
                  "--image-max-side", str(MAX_SIDE),
                  "--metrics-path", str(work / "two_mobilenet.jsonl"),
                  "--distributed", spec + str(r),
                  "csv", str(work / "annotations.csv"), str(work / "classes.csv")]},
        {"name": "evaluate", "tool": "evaluate",
         "argv": ["--distributed", spec + str(r), *eval_argv]}]}
        for r in range(DIST_RANKS)])

    seconds["ranks"] = time.monotonic() - t0
    backend = ("nccl" if dev.type == "cuda" and torch.cuda.device_count() >= DIST_RANKS
               else "gloo")
    require(nccl["backend"] == [f"distributed: rank 0 of 1, backend "
                                f"{'nccl' if dev.type == 'cuda' else 'gloo'}"],
            f"1-rank group: {nccl['backend']}")
    for r, got in enumerate(ranks):
        require(len(got["backend"]) == 1 and f"rank {r} of {DIST_RANKS}, backend {backend}"
                in got["backend"][0], f"rank {r}: {got['backend']}")
    # kernels on every rank
    for who, got in ([("one", one), ("nccl", nccl)]
                     + [(f"rank {r}", x) for r, x in enumerate(ranks)]):
        for run in got["runs"]:
            n = run["launches"]
            if run["name"] == "evaluate":
                require(n["nms"] >= 1 and n["stem"] >= 1, f"{who} {run['name']}: {n}")
            elif run["name"] == "mobilenet":
                require(n["ingest"] >= DIST_STEPS and n["stem"] == n["stem_bwd"] == 0,
                        f"{who} {run['name']} skipped the normalize kernel: {n}")
            else:
                steps = 1 if run["name"] == "f32" else DIST_STEPS
                require(n["stem"] >= steps and n["stem_bwd"] >= steps,
                        f"{who} {run['name']} skipped a kernel: {n}")
    # --zero is plain data parallelism, bit for bit
    sha = {n: _sha256(np.frombuffer((work / f"{n}.tdn").read_bytes(), np.uint8))
           for n in ("two_bf16", "two_zero")}
    require(sha["two_bf16"] == sha["two_zero"], "--zero's bundle differs from plain DP's")
    recs = {n: [json.loads(x) for x in (work / f"{n}.jsonl").read_text().splitlines()
                if '"step"' in x] for n in ("one_bf16", "two_bf16", "two_zero", "one_f32",
                                             "nccl_f32", "two_f32", "two_mobilenet")}
    require(len(recs["two_mobilenet"]) == DIST_STEPS, f"mobilenet: {recs['two_mobilenet']}")
    require(recs["two_zero"] == [dict(r, images_per_sec=z["images_per_sec"]) for r, z
                                 in zip(recs["two_bf16"], recs["two_zero"])],
            "--zero's metrics differ from plain DP's")
    # the 2-rank and the 1-rank NCCL f32 steps against the plain one at the
    # same global batch
    lr = 1e-5
    want = dict(_variables_leaves(load_model(str(work / "one_f32.tdn"))[1]["params"]))
    before = dict(_variables_leaves(init["params"]))
    m1 = recs["one_f32"][0]
    f32 = {}
    for name in ("two_f32", "nccl_f32"):
        m2 = recs[name][0]
        require(m1["num_positive"] == m2["num_positive"] > 0, f"num_positive {m1}, {m2}")
        for k, rtol in (("loss", 1e-4), ("classification_loss", 1e-4),
                        ("regression_loss", 1e-4), ("grad_norm", 1e-3)):
            require(abs(m1[k] - m2[k]) <= rtol * abs(m1[k]),
                    f"{name} {k}: plain {m1[k]}, {m2[k]}")
        got = dict(_variables_leaves(load_model(str(work / f"{name}.tdn"))[1]["params"]))
        n_params = n_apart = n_unequal = 0
        worst_move = 0.0
        for path, w in want.items():
            moved_2, moved_1 = got[path] - before[path], w - before[path]
            worst_move = max(worst_move, float(np.abs(moved_2).max()),
                             float(np.abs(moved_1).max()))
            n_apart += int((np.abs(moved_2 - moved_1) > 1e-3 * lr + 1e-7).sum())
            n_unequal += int((got[path] != w).sum())
            n_params += w.size
        require(worst_move <= lr * (1 + 1e-3) + 1e-7, f"{name}: a weight moved {worst_move}")
        require(n_apart <= 0.05 * n_params, f"{name}: {n_apart} of {n_params} weights apart")
        f32[name] = {"metrics": m2, "weights_apart": n_apart, "weights_unequal": n_unequal,
                     "weights": n_params}
    # the sharded evaluation prints one process's lines
    printed = [run["stdout"] for run in ranks[0]["runs"] if run["name"] == "evaluate"][0]
    want_printed = [run["stdout"] for run in one["runs"] if run["name"] == "evaluate"][0]
    require(printed == want_printed and any(x.startswith("mAP: ") and x != "mAP: 0.0000"
                                            for x in printed),
            f"2-rank evaluate printed {printed[-6:]}, 1 process {want_printed[-6:]}")
    other = [run["stdout"] for run in ranks[1]["runs"] if run["name"] == "evaluate"][0]
    require(not any(x.startswith("mAP") for x in other), f"rank 1 printed {other[-3:]}")

    def step_seconds(name, batch):
        return [batch / r["images_per_sec"] for r in recs[name]]

    launches = {}
    for got in [one, nccl] + ranks:
        for run in got["runs"]:
            for k, v in run["launches"].items():
                launches[k] = launches.get(k, 0) + v
    for f in work.glob("*.tdn"):
        f.unlink()  # 139 MiB each
    emit({"phase": "distributed", "ok": True, "ranks": DIST_RANKS, "backend": backend,
          "cards": torch.cuda.device_count(), "model": "resnet50 retinanet, 1 class",
          "pages": DIST_PAGES, "batch_per_rank": DIST_BATCH, "steps": DIST_STEPS,
          "step_seconds": {"one_rank_bf16": step_seconds("one_bf16", DIST_BATCH),
                           "two_rank_bf16_rank0": step_seconds("two_bf16", DIST_BATCH),
                           "two_rank_zero_rank0": step_seconds("two_zero", DIST_BATCH)},
          "f32_step": {"one_process_batch": 2 * DIST_BATCH, "one": m1,
                       "two_ranks": f32["two_f32"], "one_rank_nccl": f32["nccl_f32"]},
          "mobilenet_two_ranks": recs["two_mobilenet"],
          "zero": "bundle byte-equal to plain DP's, metrics equal",
          "evaluate_printed": printed,
          "seconds": {**seconds, "one": {r["name"]: r["seconds"] for r in one["runs"]},
                      "nccl": {r["name"]: r["seconds"] for r in nccl["runs"]},
                      **{f"rank{i}": {r["name"]: r["seconds"] for r in x["runs"]}
                         for i, x in enumerate(ranks)}},
          "launches": {"one": {r["name"]: r["launches"] for r in one["runs"]},
                       "nccl": {r["name"]: r["launches"] for r in nccl["runs"]},
                       **{f"rank{i}": {r["name"]: r["launches"] for r in x["runs"]}
                          for i, x in enumerate(ranks)}},
          "launches_total": launches,
          "phase_seconds": time.monotonic() - t_phase})
    return launches


def _weights_against(name, got_path, want_path, before, lr):
    """A form's f32 bundle against the plain one's: every weight moved by at
    most lr, at most 5% of them apart by more than 1e-3 lr + 1e-7."""
    from tdnet_torch.models.io import load_model

    want = dict(_variables_leaves(load_model(str(want_path))[1]["params"]))
    got = dict(_variables_leaves(load_model(str(got_path))[1]["params"]))
    n_params = n_apart = 0
    worst_move = 0.0
    for path, w in want.items():
        worst_move = max(worst_move, float(abs(got[path] - before[path]).max()),
                         float(abs(w - before[path]).max()))
        n_apart += int((abs(got[path] - w) > 1e-3 * lr + 1e-7).sum())
        n_params += w.size
    require(worst_move <= lr * (1 + 1e-3) + 1e-7, f"{name}: a weight moved {worst_move}")
    require(n_apart <= 0.05 * n_params, f"{name}: {n_apart} of {n_params} weights apart")
    return {"weights_apart": n_apart, "weights": n_params}


def _pipeline_library(dev, pages, boxes):
    """PipelineTrainer at full size (bf16, PF_PIPE_BATCH pages in
    PF_PIPE_MICRO microbatches, PF_STEPS steps: the step seconds), the
    stages' placement, and one f32 step at the 256x384 bucket against the
    plain gradient accumulation on the full model (num_positive exact, loss
    and the mean gradient's norm before the optimizer step rtol 1e-4,
    weights as _weights_against)."""
    import numpy as np
    import torch

    from tdnet_torch.device import no_tf32
    from tdnet_torch.models.retinanet import RetinaNet
    from tdnet_torch.ops.anchors import anchors_for_shape
    from tdnet_torch.ops.losses import focal, smooth_l1
    from tdnet_torch.ops.targets import batched_anchor_targets
    from tdnet_torch.parallel.pipeline import PipelineTrainer
    from tdnet_torch.train.step import ClippedAdam, create_optimizer, create_train_state
    from tdnet_torch.weights import random_variables

    def squared_norm(params) -> float:
        return sum(float(torch.linalg.vector_norm(p.grad.double())) ** 2
                   for p in params if p.grad is not None)

    class NormAdam(ClippedAdam):
        """Keeps the squared norm of the gradients it is given, before its
        clip: the pipeline's summed, 1/n-scaled gradient."""

        def step(self, closure=None, **kw):
            self.squared = squared_norm(p for g in self.param_groups for p in g["params"])
            return super().step(closure, **kw)

    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if dev.type != "cuda":
        devices = (dev, dev)
    elif cards >= 2:
        devices = (torch.device("cuda", 0), torch.device("cuda", 1))
    else:
        devices = (torch.device("cuda", 0), torch.device("cuda", 0))
        print("parallel_forms: one card: both pipeline stages on cuda:0", flush=True)

    def float_batch(sides, batch_size, page_list, box_list):
        from tdnet_torch.data.generator import BatchLoader, LoaderConfig

        loader = BatchLoader(PageDataset(page_list, box_list), LoaderConfig(
            batch_size=batch_size, min_side=sides[0], max_side=sides[1], shuffle=False))
        return next(loader.epoch())

    host = float_batch((MIN_SIDE, MAX_SIDE), PF_PIPE_BATCH, pages, boxes)
    trainer = PipelineTrainer(RetinaNet(1, dtype=torch.bfloat16), 1, devices,
                              optimizer_factory=create_optimizer(1e-5, 1e-3))
    states = trainer.states_from_variables(smoke_variables())
    step_s, metrics = [], []
    for _ in range(PF_STEPS):
        for d in set(devices):
            sync(d)
        t0 = time.monotonic()
        states, m = trainer.step(states, host, num_microbatches=PF_PIPE_MICRO)
        for d in set(devices):
            sync(d)
        step_s.append(time.monotonic() - t0)
        metrics.append(m)
        require(np.isfinite(m["loss"]) and m["num_positive"] > 0, f"pipeline step {m}")
    for state, d in zip(states, devices):
        tensors = list(state.model.parameters()) + [
            v for st in state.optimizer.state.values() for v in st.values()
            if torch.is_tensor(v) and v.dim()]
        require(all(t.device == d for t in tensors), f"a stage tensor is off {d}")
    del states, trainer

    ppages, pboxes = synthetic_pages(2, 0, SEED + 3, sizes=(PARITY_PAGE, None),
                                     with_boxes=True)
    phost = float_batch(PARITY_SIDES, 2, ppages, pboxes)
    variables = random_variables(1, "resnet50", seed=SEED)
    with no_tf32():
        trainer = PipelineTrainer(RetinaNet(1), 1, devices,
                                  optimizer_factory=lambda p: NormAdam(p, lr=PF_LR,
                                                                       clipnorm=1e-3))
        pstates = trainer.states_from_variables(variables)
        pstates, pm = trainer.step(pstates, phost, num_microbatches=2)
        piped_norm = float(np.sqrt(sum(s.optimizer.squared for s in pstates)))
        piped = trainer.merged_state_dict(pstates)
        model = RetinaNet(1)
        state = create_train_state(model, variables, device=devices[0],
                                   optimizer=create_optimizer(PF_LR, 1e-3))
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(devices[0])
                 for k, v in phost.items()}
        anchors = torch.tensor(anchors_for_shape(PARITY_SIDES), dtype=torch.float32,
                               device=devices[0])
        losses, positives = [], 0
        for k in range(2):
            sl = slice(k, k + 1)
            out = model(batch["images"][sl])
            labels, reg = batched_anchor_targets(
                anchors, batch["gt_boxes"][sl], batch["gt_labels"][sl],
                batch["gt_mask"][sl], batch["image_hw"][sl], 1)
            npos = (labels[..., -1] == 1).sum()
            loss = (focal()(labels, out["classification"], npos)
                    + smooth_l1()(reg, out["regression"], npos))
            loss.backward()
            losses.append(float(loss.detach()))
            positives += int(npos)
        for p in model.parameters():
            if p.grad is not None:
                p.grad.mul_(0.5)
        plain_norm = float(np.sqrt(squared_norm(
            p for g in state.optimizer.param_groups for p in g["params"])))
        state.optimizer.step()
    require(pm["num_positive"] == positives > 0, f"num_positive {pm} vs {positives}")
    require(abs(pm["loss"] - np.mean(losses)) <= 1e-4 * abs(np.mean(losses)),
            f"loss {pm['loss']} vs {np.mean(losses)}")
    require(abs(piped_norm - plain_norm) <= 1e-4 * plain_norm,
            f"gradient norm {piped_norm} vs {plain_norm}")
    before = {k: v.detach().cpu() for k, v in
              create_train_state(RetinaNet(1), variables, device="cpu").model.state_dict().items()}
    n_params = n_apart = 0
    worst_move = 0.0
    for k, w in model.state_dict().items():
        if not w.is_floating_point():
            continue
        w, g = w.detach().cpu(), piped[k]
        worst_move = max(worst_move, float((g - before[k]).abs().max()),
                         float((w - before[k]).abs().max()))
        n_apart += int(((g - w).abs() > 1e-3 * PF_LR + 1e-7).sum())
        n_params += w.numel()
    require(worst_move <= PF_LR * (1 + 1e-3) + 1e-7, f"pipeline f32: moved {worst_move}")
    require(n_apart <= 0.05 * n_params, f"pipeline f32: {n_apart} of {n_params} apart")
    return {"devices": [str(d) for d in devices], "bf16_step_seconds": step_s,
            "bf16_metrics": metrics,
            "f32_vs_accumulation": {"num_positive": positives, "loss": pm["loss"],
                                    "loss_plain": float(np.mean(losses)),
                                    "grad_norm": piped_norm, "grad_norm_plain": plain_norm,
                                    "weights_apart": n_apart, "weights": n_params}}


def phase_parallel_forms(dev):
    """Pipeline, spatial and tensor parallelism on ResNet-50 at the 800x1344
    bucket (``parallel/pipeline.py``, ``spatial.py``, ``tensor.py``):

    - ``PipelineTrainer`` bf16 (``_pipeline_library``): cards 0 and 1 when
      there are two, both stages on card 0 otherwise (printed); its f32 step
      against the plain gradient accumulation; then ``train --pipeline`` with
      per-epoch evaluation when there are two cards (skipped, and printed,
      otherwise);
    - DIST_RANKS child ranks (``_run_children``; gloo on one card, NCCL with
      a card each): ``train --spatial 2 --device-normalize`` and ``train
      --tensor-parallel 2 --device-normalize`` bf16 with per-epoch evaluation
      (the NMS kernel), each form's f32 step, and ``evaluate
      --device-normalize`` of each form's bundle (the stem and NMS kernels);
    - this process: the plain f32 step (``--no-fused-stem``: the normalize
      kernel and cuDNN, the forms' route) that the forms' f32 steps are held
      against (num_positive exact, loss, its parts and grad_norm rtol 1e-4,
      weights as ``_weights_against``).

    Required launches, each run's counters set to 0 just before it and read
    just after, in its process: the spatial and tensor steps the normalize
    kernel on every rank at every step (a spatial rank on its band of rows,
    a tensor rank on the whole pages) and neither stem kernel, every
    per-epoch evaluation the NMS kernel, every ``evaluate`` the stem and NMS
    kernels."""
    import numpy as np
    import torch

    from tdnet_torch.bin import train
    from tdnet_torch.data.image import write_image_bgr
    from tdnet_torch.models.io import load_model, save_model
    from tdnet_torch.models.retinanet import RetinaNet

    t_phase = time.monotonic()
    work = ROOT / "build" / "chip_smoke" / "parallel_forms"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    pages, boxes = synthetic_pages(PF_PAGES, 0, SEED + 23, sizes=(TRAIN_PAGE, None),
                                   with_boxes=True)
    rows = []
    for i, (page, page_boxes) in enumerate(zip(pages, boxes)):
        write_image_bgr(work / f"page{i}.png", page.astype(np.uint8))
        rows.append([f"page{i}.png,{int(b[0])},{int(b[1])},{int(b[2])},{int(b[3])},table"
                     for b in page_boxes])
    (work / "annotations.csv").write_text("\n".join(sum(rows, [])) + "\n")
    (work / "val.csv").write_text("\n".join(sum(rows[:2], [])) + "\n")
    (work / "classes.csv").write_text("table,0\n")
    with torch.device("meta"):
        record = RetinaNet(1)
    init = smoke_variables()
    save_model(str(work / "init.tdn"), record, init)
    seconds = {"prep": time.monotonic() - t_phase}

    t0 = time.monotonic()
    pipeline = _pipeline_library(dev, pages, boxes)
    seconds["pipeline_library"] = time.monotonic() - t0

    def argv(name, batch, steps, *extra, evaluation=False, f32=False):
        return ["--device", dev.type, "--batch-size", str(batch), "--steps", str(steps),
                "--epochs", "1", "--log-every", "1", "--no-snapshots",
                "--weights", str(work / "init.tdn"), "--seed", "3", "--lr", str(PF_LR),
                "--image-min-side", str(MIN_SIDE), "--image-max-side", str(MAX_SIDE),
                "--metrics-path", str(work / f"{name}.jsonl"),
                "--model-path", str(work / f"{name}.tdn"),
                *([] if f32 else ["--bf16"]), *(["--evaluation"] if evaluation else []),
                *extra, "csv", str(work / "annotations.csv"), str(work / "classes.csv"),
                *(["--val-annotations", str(work / "val.csv")] if evaluation else [])]

    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    said = []
    t0 = time.monotonic()
    with _deterministic():
        one_runs = [("plain_f32", train.main,
                     argv("plain_f32", PF_F32_BATCH, 1, "--device-normalize", "--no-fused-stem",
                          f32=True))]
        if cards >= 2:
            one_runs.append(("pipeline", train.main,
                             argv("pipeline", PF_PIPE_BATCH, PF_STEPS, "--pipeline",
                                  evaluation=True)))
        else:
            print("parallel_forms: one card: train --pipeline skipped (it needs two)",
                  flush=True)
        one = _cli_runs(dev, one_runs, said)
    seconds["one_process"] = time.monotonic() - t0

    t0 = time.monotonic()
    spec = f"127.0.0.1:{_free_port()},{DIST_RANKS},"
    forms = (("spatial", "--spatial"), ("tensor", "--tensor-parallel"))
    ranks = _run_children(work, "form", [{"device": dev.type, "runs": [
        *({"name": name, "tool": "train",
           "argv": argv(name, PF_BATCH, PF_STEPS, flag, "2", "--device-normalize",
                        "--distributed", spec + str(r), evaluation=True)}
          for name, flag in forms),
        *({"name": f"{name}_f32", "tool": "train",
           "argv": argv(f"{name}_f32", PF_F32_BATCH, 1, flag, "2", "--device-normalize",
                        "--distributed", spec + str(r), f32=True)}
          for name, flag in forms),
        *({"name": f"evaluate_{name}", "tool": "evaluate",
           "argv": ["--device", dev.type, "--device-normalize", "--distributed", spec + str(r),
                    "--image-min-side", str(MIN_SIDE), "--image-max-side", str(MAX_SIDE),
                    "csv", str(work / "val.csv"), str(work / "classes.csv"),
                    str(work / f"{name}.tdn")]}
          for name, _ in forms)]} for r in range(DIST_RANKS)])
    seconds["ranks"] = time.monotonic() - t0

    backend = "nccl" if dev.type == "cuda" and cards >= DIST_RANKS else "gloo"
    for r, got in enumerate(ranks):
        require(len(got["backend"]) == 1 and f"rank {r} of {DIST_RANKS}, backend {backend}"
                in got["backend"][0], f"rank {r}: {got['backend']}")
        for run in got["runs"]:
            n, name = run["launches"], run["name"]
            if name.startswith("evaluate"):
                ok = n["stem"] >= 1 and n["nms"] >= 1
            else:
                steps = 1 if name.endswith("f32") else PF_STEPS
                ok = n["ingest"] >= steps and n["stem"] == n["stem_bwd"] == 0
            if name in ("spatial", "tensor"):
                ok = ok and n["nms"] >= 1  # the per-epoch evaluation
            require(ok, f"rank {r} {name}: launches {n}, said {run['stdout'][-8:]}")
    if cards >= 2:
        n = one[1]["launches"]
        require(n["nms"] >= 1 and n["ingest"] == n["stem"] == n["stem_bwd"] == 0,
                f"train --pipeline launches {n}")

    recs = {n: [json.loads(x) for x in (work / f"{n}.jsonl").read_text().splitlines()
                if '"step"' in x]
            for n in ("plain_f32", "spatial", "tensor", "spatial_f32", "tensor_f32",
                      *(("pipeline",) if cards >= 2 else ()))}
    before = dict(_variables_leaves(init["params"]))
    m1 = recs["plain_f32"][0]
    f32 = {}
    for name in ("spatial_f32", "tensor_f32"):
        m2 = recs[name][0]
        require(m1["num_positive"] == m2["num_positive"] > 0, f"num_positive {m1}, {m2}")
        for k in ("loss", "classification_loss", "regression_loss", "grad_norm"):
            require(abs(m1[k] - m2[k]) <= 1e-4 * abs(m1[k]), f"{name} {k}: {m1[k]}, {m2[k]}")
        f32[name] = {"metrics": m2, **_weights_against(
            name, work / f"{name}.tdn", work / "plain_f32.tdn", before, PF_LR)}
    for name in ("spatial", "tensor"):
        require(len(recs[name]) == PF_STEPS and all(np.isfinite(r["loss"])
                                                     for r in recs[name]),
                f"{name}: {recs[name]}")
        load_model(str(work / f"{name}.tdn"))  # the bundle reads back

    def step_seconds(name, batch):
        return [batch / r["images_per_sec"] for r in recs[name]]

    launches = {}
    for got in [{"runs": one}] + ranks:
        for run in got["runs"]:
            for k, v in run["launches"].items():
                launches[k] = launches.get(k, 0) + v
    for f in work.glob("*.tdn"):
        f.unlink()  # 139 MiB each
    emit({"phase": "parallel_forms", "ok": True, "ranks": DIST_RANKS, "backend": backend,
          "cards": cards, "model": "resnet50 retinanet, 1 class, 800x1344",
          "pipeline": pipeline,
          "train_pipeline": ("ran" if cards >= 2 else "skipped: one card"),
          "step_seconds": {"spatial_rank0": step_seconds("spatial", PF_BATCH),
                           "tensor_rank0": step_seconds("tensor", PF_BATCH),
                           **({"pipeline_cli": step_seconds("pipeline", PF_PIPE_BATCH)}
                              if cards >= 2 else {})},
          "f32_step": {"plain": m1, **f32},
          "seconds": {**seconds, "one": {r["name"]: r["seconds"] for r in one},
                      **{f"rank{i}": {r["name"]: r["seconds"] for r in x["runs"]}
                         for i, x in enumerate(ranks)}},
          "launches": {"one": {r["name"]: r["launches"] for r in one},
                       **{f"rank{i}": {r["name"]: r["launches"] for r in x["runs"]}
                          for i, x in enumerate(ranks)}},
          "launches_total": launches,
          "phase_seconds": time.monotonic() - t_phase})
    return launches


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--distributed-child":
        return _distributed_child(sys.argv[2])
    if not (ROOT / "tdnet_torch" / "__init__.py").is_file():
        print("chip_smoke: tdnet_torch/ is missing next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    # read when tdnet_torch.train.weights is imported, as in the reference
    os.environ["TDNET_PRETRAINED_DIR"] = str(PRETRAINED_DIR)
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
        phase = "train_cli"
        train_cli_launches = phase_train_cli(dev)
        phase = "train_cli_init"
        init_launches = phase_train_cli_init(dev)
        phase = "predict_soft"
        soft_launches = phase_predict_soft(dev)
        phase = "predict_r101"
        r101_launches = phase_predict_r101(dev)
        phase = "backbones"
        backbone_launches = phase_backbones(dev)
        phase = "serve"
        serve_launches = phase_serve(dev)
        phase = "cli"
        cli_launches = phase_cli(dev)
        phase = "table_workflow"
        table_launches = phase_table_workflow(dev)
        phase = "datasets"
        dataset_launches = phase_datasets(dev)
        phase = "pages"
        page_launches = phase_pages(dev)
        phase = "distributed"
        dist_launches = phase_distributed(dev)
        phase = "parallel_forms"
        forms_launches = phase_parallel_forms(dev)
    except Exception as exc:  # report the failed phase, print no result
        import traceback

        traceback.print_exc()
        emit({"phase": phase, "ok": False, "error": f"{type(exc).__name__}: {exc}"})
        return 1

    # launches: the main paths' runs (predict's two routes, training, the
    # train CLI and its initial-weight flags, config 5, config 4, the other
    # backbone families, serving, the CLIs, the table workflow, the JPEG and
    # BMP pages through the dataset CLIs, the other page formats through
    # train, predict and serve, data parallelism through the train and
    # evaluate CLIs in child ranks, the pipeline, spatial and tensor forms);
    # conv1x1 (B7) is wired into no model, in
    # the JAX package too, so no path launches it
    runs = (launches, train_launches, train_cli_launches, init_launches,
            soft_launches, r101_launches, backbone_launches, serve_launches,
            cli_launches, table_launches, dataset_launches, page_launches,
            dist_launches, forms_launches)
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
    # tail (torch.matmul bf16, then elementwise ops; its matmul_ms is the
    # product alone, stage 2 at batch 16)
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
         **({"matmul_ms": kres[name]["matmul_ms"],
             "note": "no path runs it: wired into no model, in the JAX package too"}
            if name == "conv1x1" else {})}
        for name, (src, rep) in sources.items()]})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
