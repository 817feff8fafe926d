#!/usr/bin/env python3
"""A/B of the port's fused stem kernels on one NVIDIA GPU, one checkout a
run. Run it in turns from one call (parent, change, change, parent):

    python3 tools/torch_stem_ab.py --root build/parent --label parent \\
        --out build/stem_ab/parent_1.json
    python3 tools/torch_stem_ab.py --root . --label change \\
        --out build/stem_ab/change_1.json

It imports ``tdnet_torch`` and ``chip_smoke.py``'s helpers from ``--root``
(so each checkout builds and runs its own kernels) and measures, with
random weights from seed 0:

- B1 ``fused_stem_packed`` bf16 at (16, 800, 1344*3) and B4
  ``fused_stem_bwd_packed`` bf16 at (8, 800, 1344*3): CUDA-event medians
  of 20 calls;
- the ResNet-50 RetinaNet bf16 train step at batch 8 on one resident batch
  (chip_smoke's train pages): host clock over 10 synchronized steps, and a
  ``torch.profiler`` window of 3 steps: the union of the device's kernel
  and copy intervals per step (busy; user annotations left out), its share
  of the window's wall time, and the kernels with the most device time;
- config 1's dispatch: ``Predictor.predict_batch`` (bf16, fused stem) on
  16 landscape pages (one 800x1344 bucket), 3 timed batches: dispatch_s
  and host_prep_s a batch; and a profiler window of one batch.

Prints one JSON line (with ``nvidia-smi``'s name and power limit) and
writes it to ``--out``. Exits non-zero without a GPU. Imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def _load_chip_smoke(root: Path):
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke_ab", root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _profile(fn, steps: int):
    """Run fn `steps` times under torch.profiler: (wall s, busy s: the
    union of the device's kernel and copy intervals, the 8 kernels with the
    most device time as [name, ms])."""
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
    spans, by_name = [], {}
    for e in prof.events():
        # kernels and copies only: a user annotation's device span (the
        # optimizer's record_function) covers the gaps between its kernels
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        by_name[e.name] = by_name.get(e.name, 0.0) + (b - a) / 1e3
    spans.sort()
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:  # union of the kernels' intervals
        if b > end:
            busy_us += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return wall, busy_us / 1e6, [[n[:80], round(ms, 4)] for n, ms in top]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=".", help="checkout whose tdnet_torch runs")
    ap.add_argument("--label", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    cs = _load_chip_smoke(root)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_stem_ab: no CUDA GPU", file=sys.stderr)
        return 2
    import tdnet_torch

    if not Path(tdnet_torch.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"tdnet_torch came from {tdnet_torch.__file__}, not {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from tdnet_torch import _build

    _build.build(force=True)
    from tdnet_torch.models.retinanet import RetinaNet
    from tdnet_torch.ops import stem
    from tdnet_torch.train.predictor import Predictor
    from tdnet_torch.train.step import create_optimizer, create_train_state, make_train_step
    from tdnet_torch.weights import random_variables

    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    bf = torch.bfloat16
    k7 = torch.from_numpy(rng.normal(0, 0.08, (7, 7, 3, 64)).astype(np.float32)).to(dev)
    inv = torch.from_numpy(rng.uniform(0.5, 1.5, 64).astype(np.float32)).to(dev)
    off = torch.from_numpy(rng.normal(0, 0.5, 64).astype(np.float32)).to(dev)
    fwd_in = torch.from_numpy(rng.randint(0, 256, (16, 800, 1344 * 3)).astype(np.uint8)).to(dev)
    bwd_in = fwd_in[:8].contiguous()
    dy = torch.from_numpy(rng.normal(0, 1, (8, 200, 336, 64)).astype(np.float32)).to(dev).to(bf)
    res = {"label": args.label, "nvidia_smi": smi, "torch": torch.__version__,
           "b1_ms": cs.median_ms(lambda: stem.fused_stem_packed(
               fwd_in, k7, inv, off, "caffe", bf), iters=20),
           "b4_ms": cs.median_ms(lambda: stem.fused_stem_bwd_packed(
               bwd_in, k7, inv, off, dy, "caffe", bf), iters=20)}
    del fwd_in, bwd_in, dy

    # train step, batch 8 at 800x1344, resident batch
    pages, boxes = cs.synthetic_pages(cs.TRAIN_BATCH, 0, cs.SEED + 2,
                                      sizes=(cs.TRAIN_PAGE, None), with_boxes=True)
    loader = cs._host_batch(pages, boxes, (cs.MIN_SIDE, cs.MAX_SIDE), cs.TRAIN_BATCH)
    model = RetinaNet(1, dtype=bf)
    state = create_train_state(model, random_variables(1, "resnet50", seed=cs.SEED),
                               device=dev, optimizer=create_optimizer(cs.TRAIN_LR, 1e6))
    step = make_train_step(model, num_classes=1)
    batch = cs._to_device(next(loader.epoch()), dev)
    for _ in range(3):
        step(state, batch)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(10):
        step(state, batch)
    torch.cuda.synchronize()
    res["train_step_ms"] = (time.monotonic() - t0) / 10 * 1e3
    wall, busy, top = _profile(lambda: step(state, batch), 3)
    res["train_profile"] = {"steps": 3, "wall_ms_per_step": wall / 3 * 1e3,
                            "device_busy_ms_per_step": busy / 3 * 1e3,
                            "device_busy_share": busy / wall, "top_kernels_ms": top}
    del state, step, batch, model
    torch.cuda.empty_cache()

    # config 1 dispatch: 16 landscape pages, one bucket
    pages = cs.synthetic_pages(16, 0, cs.SEED)
    pred = Predictor(RetinaNet(1, dtype=bf), cs.smoke_variables(), device=dev,
                     device_preprocess=True, min_side=cs.MIN_SIDE, max_side=cs.MAX_SIDE)
    pred.predict_batch(pages)  # warm-up
    disp, prep = [], []
    for _ in range(3):
        pred.host_prep_s = pred.dispatch_s = 0.0
        pred.predict_batch(pages)
        disp.append(pred.dispatch_s)
        prep.append(pred.host_prep_s)
    res["predict"] = {"pages": 16, "dispatch_s": disp, "host_prep_s": prep,
                      "dispatch_s_median": statistics.median(disp),
                      "host_prep_s_median": statistics.median(prep)}
    wall, busy, top = _profile(lambda: pred.predict_batch(pages), 1)
    res["predict_profile"] = {"wall_s": wall, "device_busy_ms": busy * 1e3,
                              "top_kernels_ms": top}
    line = json.dumps(res)
    print(line, flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
