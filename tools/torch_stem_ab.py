#!/usr/bin/env python3
"""A/B of the port's fused stem kernels on one NVIDIA GPU, one checkout a
run. Run it in turns from one call (parent, change, change, parent):

    python3 tools/torch_stem_ab.py --root build/parent --label parent \\
        --out build/stem_ab/parent_1.json
    python3 tools/torch_stem_ab.py --root . --label change \\
        --out build/stem_ab/change_1.json

It imports ``tdnet_torch`` from ``--root`` (so each checkout builds and
runs its own kernels) and its helpers from this checkout's
``chip_smoke.py``, and measures, with random weights from seed 0:

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

Prints chip_smoke.py's device line, then one JSON line (with
``nvidia-smi``'s name and power limit), which it also writes to ``--out``. Exits non-zero without a GPU. Imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

from _torch_chip import load_chip_smoke, use_checkout


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=".", help="checkout whose tdnet_torch runs")
    ap.add_argument("--label", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    cs = load_chip_smoke()
    use_checkout(root)

    import numpy as np
    import torch

    smi = cs.phase_device()  # raises without a GPU; TF32 off
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
    prof = cs.device_profile(lambda: step(state, batch), steps=3)
    busy_s = prof["device_busy_ms"] / 1e3
    res["train_profile"] = {"steps": 3, "wall_ms_per_step": prof["wall_s"] / 3 * 1e3,
                            "device_busy_ms_per_step": prof["device_busy_ms"] / 3,
                            "device_busy_share": busy_s / prof["wall_s"],
                            "top_kernels_ms": prof["top_kernels_ms"]}
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
    prof = cs.device_profile(lambda: pred.predict_batch(pages))
    res["predict_profile"] = {k: prof[k] for k in ("wall_s", "device_busy_ms",
                                                   "top_kernels_ms")}
    line = json.dumps(res)
    print(line, flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
