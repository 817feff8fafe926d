#!/usr/bin/env python3
"""Smoke run of tdnet_torch's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``tdnet_torch/csrc/`` (into
``build/tdnet_torch/``), holds each kernel against its plain PyTorch version
at the main paths' shapes and times both, and drives the port's two main
paths with random weights made from a seed, ResNet-50 RetinaNet at full
width and depth:

- batched page inference (``Predictor.predict_batch``, bf16, uint8 pages
  through the fused ingest+stem kernel, the NMS kernel in the deferred
  tail), then CUDA-vs-CPU f32 detections on the same pages;
- training (in-memory pages -> ``BatchLoader`` -> the prefetcher -> ``fit``
  -> ``make_train_step`` on the fused-stem route with its backward kernel,
  bf16, batch 8 at 800x1344, 20 steps on one batch), a checkpoint round
  trip, then one f32 step on CUDA against the same step on the CPU.

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
NMS_ROWS, NMS_K = 16, 1024
BF16_WITHIN_ULP_MIN = 0.999           # share of bf16 stem outputs within 1 ulp
STEM_BWD_SHAPE = (8, 800, 1344 * 3)   # the train phase's batch
TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR = 8, 20, 3e-4
TRAIN_PAGE = (800, 1300)              # resize scale 1.0 -> bucket 800x1344
PARITY_SIDES, PARITY_PAGE = (256, 384), (256, 384)
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 tensor-core
# and f32 (outside the tensor cores) operations/s
PEAK = {"bytes": 3.35e12, "bf16": 989e12, "f32": 67e12}
# operations of one exact IoU in the NMS kernel: 2 max, 2 min, 2 subtract,
# 2 clamps, a product, the union's add and subtract, a divide, a compare
IOU_OPS = 13


class PhaseError(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond, msg) -> None:
    if not cond:
        raise PhaseError(msg)


def median_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median of per-call CUDA-event times, after warm-up calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
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

    from tdnet_torch.ops import ingest, nms_kernel, stem

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
                ulp = bf16_ulp(torch.maximum(got.abs(), want.abs()))
                within = ((d <= ulp) | (d <= 1e-5)).float().mean().item()
                info["share_within_1ulp"] = within
                info["share_exact"] = (d == 0).float().mean().item()
                require(within >= BF16_WITHIN_ULP_MIN,
                        f"stem bf16 {shape}: only {within} within 1 ulp")
            stem_info.append(info)
        if shape == STEM_SHAPES[0]:
            b, h, w3 = shape
            results["stem"] = {
                "ms": median_ms(lambda: stem.fused_stem_packed(
                    packed, k7, inv, off, "caffe", torch.bfloat16)),
                "plain_ms": median_ms(lambda: stem.fused_stem_plain(
                    packed, k7, inv, off, "caffe", torch.bfloat16)),
                "shape": list(shape),
                # u8 in, bf16 pooled out; 147 bf16-rounded products a conv
                # output and channel
                "bound": bound(b * h * w3 + b * (h // 4) * (w3 // 12) * 64 * 2,
                               2 * 147 * 64 * b * (h // 2) * (w3 // 6), "bf16")}
        del packed, got, want, d
    results["stem"]["max_abs_err"] = stem_err
    results["stem"]["checks"] = stem_info

    # ---- nms: clustered candidates, invalid slots, exact keep masks
    centres = rng.uniform(0, 1344, (NMS_ROWS, 12, 2))
    pick = rng.randint(0, 12, (NMS_ROWS, NMS_K))
    c = np.take_along_axis(centres, pick[..., None], axis=1) \
        + rng.normal(0, 12, (NMS_ROWS, NMS_K, 2))
    wh = rng.uniform(20, 300, (NMS_ROWS, NMS_K, 2))
    boxes = torch.from_numpy(np.concatenate([c - wh / 2, c + wh / 2], -1)
                             .astype(np.float32)).to(dev)
    valid_np = rng.uniform(size=(NMS_ROWS, NMS_K)) > 0.05
    valid_np[:, -100:] = False  # the below-threshold tail of a top-k row
    valid = torch.from_numpy(valid_np).to(dev)
    got = nms_kernel.nms_keep(boxes, valid, 0.5)
    want = nms_kernel.nms_keep_plain(boxes, valid, 0.5)
    mism = int((got != want).sum().item())
    require(mism == 0, f"nms keep masks differ in {mism} slots")
    require(0 < int(want.sum().item()) < int(valid.sum().item()),
            "nms test rows kept nothing or suppressed nothing")
    results["nms"] = {
        "max_abs_err": (got.float() - want.float()).abs().max().item(),
        "mismatched_slots": mism,
        "kept": int(got.sum().item()), "valid": int(valid.sum().item()),
        "ms": median_ms(lambda: nms_kernel.nms_keep(boxes, valid, 0.5)),
        "plain_ms": median_ms(lambda: nms_kernel.nms_keep_plain(boxes, valid, 0.5)),
        "shape": [NMS_ROWS, NMS_K],
        # this run's work: each kept box against every later box of its row
        "bound": bound(boxes.numel() * 4 + 2 * valid.numel(),
                       IOU_OPS * nms_pairs(got), "f32")}
    del boxes, valid, got, want

    results["stem_bwd"] = check_stem_bwd(dev, rng, k7, inv, off)
    emit({"phase": "kernels", "ok": True, "results": results})
    return results


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
    remat in f32: relative Frobenius <= 1e-4."""
    import numpy as np
    import torch

    from tdnet_torch.ops import stem
    from tdnet_torch.ops.stem_vjp import fused_stem_train

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
    checks, worst = [], 0.0
    for name, page in pages.items():
        packed = torch.from_numpy(page).to(dev)
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
    timed = {"ms": median_ms(lambda: stem.fused_stem_bwd_packed(
                 packed, k7, inv, off, dy, "caffe", torch.bfloat16)),
             "plain_ms": median_ms(lambda: stem.fused_stem_bwd_plain(
                 packed, k7, inv, off, dy, "caffe", torch.bfloat16), iters=5)}
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


def check_detections(out, pages, buckets, scales):
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
            require((s[ok] > 0.05).all() and (l[ok] == 0).all(), "bad scores/labels")
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


def phase_parity(dev, variables):
    """2 pages in f32 through the Predictor on CUDA (the kernels) and on the
    CPU (their plain versions). The score threshold is set inside the
    widest gap of the CUDA run's scores (ranks 30..120), so every
    detection is clear of it."""
    import numpy as np
    import torch

    from tdnet_torch.models.retinanet import RetinaNet
    from tdnet_torch.train.predictor import Predictor

    pages = synthetic_pages(2, 0, SEED + 1)
    sides = dict(min_side=MIN_SIDE, max_side=MAX_SIDE)
    probe = Predictor(RetinaNet(1), variables, device=dev,
                      device_preprocess=True, **sides).predict_batch(pages)
    s = np.sort(np.concatenate([p[1][p[1] > -1] for p in probe]))[::-1]
    require(s.size > 120, f"only {s.size} detections to set a threshold from")
    gaps = s[30:120] - s[31:121]
    i = 30 + int(np.argmax(gaps))
    thr = float((s[i] + s[i + 1]) / 2)

    runs = {}
    for name, d in (("gpu", dev), ("cpu", torch.device("cpu"))):
        pred = Predictor(RetinaNet(1), variables, device=d,
                         device_preprocess=True, score_threshold=thr, **sides)
        runs[name] = pred.predict_batch(pages)
    worst = 0.0
    n = 0
    for got, want in zip(runs["gpu"], runs["cpu"]):
        worst = max(worst, _match(got, want))
        n += int((got[1] > -1).sum())
    require(n > 0, "parity compared no detections")
    emit({"phase": "parity", "ok": True, "pages": len(pages),
          "score_threshold": thr, "threshold_gap": float(gaps.max()),
          "detections_compared": n, "max_box_diff_px": worst,
          "score_rtol": 1e-4, "box_tol_px": 0.5})


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
    except Exception as exc:  # report the failed phase, print no result
        import traceback

        traceback.print_exc()
        emit({"phase": phase, "ok": False, "error": f"{type(exc).__name__}: {exc}"})
        return 1

    # launches: the main paths' runs (predict's two routes, then training)
    total = {k: launches.get(k, 0) + train_launches.get(k, 0)
             for k in ("ingest", "stem", "nms", "stem_bwd")}
    sources = {
        "ingest": ("tdnet_torch/csrc/ingest.cu", "tdnet/ops/pallas_ingest.py:137"),
        "stem": ("tdnet_torch/csrc/stem.cu", "tdnet/ops/pallas_stem.py:676"),
        "nms": ("tdnet_torch/csrc/nms.cu", "tdnet/ops/pallas_nms.py:268"),
        "stem_bwd": ("tdnet_torch/csrc/stem_bwd.cu", "tdnet/ops/pallas_stem.py:492"),
    }
    # library_ms: no single PyTorch call computes any of these functions
    # (normalize + round; normalize + conv + BN + ReLU + pool; greedy NMS;
    # the stem's pool-routed filter and BN gradients)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": total[name], "max_abs_err": kres[name]["max_abs_err"],
         "ms": kres[name]["ms"], "plain_ms": kres[name]["plain_ms"],
         "bound_ms": kres[name]["bound"][0], "bound_by": kres[name]["bound"][1],
         "library_ms": None}
        for name, (src, rep) in sources.items()]})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
