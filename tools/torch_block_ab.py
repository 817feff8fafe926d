#!/usr/bin/env python3
"""A/B of the port's fused bottleneck kernel (B6) on one NVIDIA GPU, one
checkout a run. Run it in turns from one call (parent, change, change,
parent):

    python3 tools/torch_block_ab.py --root build/parent --label parent \\
        --out build/block_ab/parent_1.json
    python3 tools/torch_block_ab.py --root . --label change \\
        --out build/block_ab/change_1.json

It imports ``tdnet_torch`` from ``--root`` (so each checkout builds and
runs its own kernels) and its helpers from this checkout's
``chip_smoke.py``, and measures, with inputs and weights made on the
device from seed 0 (the same for every checkout):

- ``fused_bottleneck`` bf16, one launch at each of config 4's four stage
  shapes at batch 16 (ResNet-101 at 1024x1024: stages 2-5, H = W 256 to
  32, C 256 to 2048, M 64 to 512): medians of 20 CUDA-event timings of 10
  calls in a row (so the wrapper's host work does not show), with the bound
  (``chip_smoke.block_bound``), and the SHA-256 of the output's bytes
  (equal digests across checkouts: bit-equal outputs);
- config 4's dispatch: ``Predictor.predict_batch`` (ResNet-101, bf16,
  ``block_kernel=True``, 16 pages at the 1024x1024 bucket), 3 timed
  batches (dispatch_s and host_prep_s a batch), and one batch under
  ``torch.profiler`` (``chip_smoke.device_profile``): the device's busy
  time, the block kernel's summed device time and the kernels with the
  most device time.

Prints chip_smoke.py's device line, then one JSON line (with
``nvidia-smi``'s name and power limit), which it also writes to
``--out``. Exits non-zero without a GPU. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import sys
from pathlib import Path

from _torch_chip import load_chip_smoke, use_checkout

# config 4 (ResNet-101 at 1024^2): (stage, H = W, C, M)
STAGES = [(2, 256, 256, 64), (3, 128, 512, 128), (4, 64, 1024, 256), (5, 32, 2048, 512)]
BATCH = 16


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=".", help="checkout whose tdnet_torch runs")
    ap.add_argument("--label", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--no-r101", action="store_true", help="kernel times only")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    cs = load_chip_smoke()
    use_checkout(root)

    import numpy as np
    import torch

    smi = cs.phase_device()  # raises without a GPU
    from tdnet_torch import _build
    from tdnet_torch.ops import block

    _build.build(force=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device=dev) * s

    res = {"label": args.label, "root": str(root), "nvidia_smi": smi,
           "torch": torch.__version__, "stages": []}
    for stage, hw, c, m in STAGES:
        x = randn(BATCH, hw, hw, c).to(torch.bfloat16)
        w = (randn(c, m, s=c ** -0.5), randn(3, 3, m, m, s=(9 * m) ** -0.5),
             randn(m, c, s=0.5 * m ** -0.5), 1.0 + 0.5 * randn(m).tanh(),
             0.1 * randn(m), 1.0 + 0.5 * randn(m).tanh(), 0.1 * randn(m),
             1.0 + 0.5 * randn(c).tanh(), 0.1 * randn(c))
        out = block.fused_bottleneck(x, *w)
        (bound_ms, _), flops = cs.block_bound(x, 1, c, m)
        ms = cs.median_ms(lambda: block.fused_bottleneck(x, *w), iters=20, warmup=3,
                          burst=10)
        res["stages"].append({
            "stage": stage, "shape": [BATCH, hw, hw, c], "cmid": m, "ms": ms,
            "tflops": flops / ms / 1e9, "bound_ms": bound_ms,
            "sha256": hashlib.sha256(out.view(torch.int16).cpu().numpy().tobytes()).hexdigest(),
            "checksum": out.float().sum().item()})
        print(json.dumps(res["stages"][-1]), flush=True)
        del x, w, out
    torch.cuda.empty_cache()

    if not args.no_r101:
        from tdnet_torch.models.retinanet import RetinaNet
        from tdnet_torch.train.predictor import Predictor
        from tdnet_torch.weights import random_variables

        rs = np.random.RandomState(4)
        pages = []
        for _ in range(BATCH):  # near-square page-like canvases -> 1024x931
            page = np.full((1100, 1000, 3), 245, np.uint8)
            y0, x0 = rs.randint(50, 500), rs.randint(50, 400)
            page[y0:y0 + 400, x0:x0 + 500] = 60
            pages.append(page.astype(np.float32))
        variables = random_variables(1, "resnet101", seed=0)
        variables["params"]["classification_submodel"]["head"]["bias"][:] = -2.0
        pred = Predictor(RetinaNet(1, "resnet101", dtype=torch.bfloat16, block_kernel=True),
                         variables, device=dev, device_preprocess=True,
                         min_side=1024, max_side=1024)
        pred.predict_batch(pages)  # warm-up
        disp, prep = [], []
        for _ in range(3):
            pred.host_prep_s = pred.dispatch_s = 0.0
            torch.cuda.synchronize()
            pred.predict_batch(pages)
            disp.append(pred.dispatch_s)
            prep.append(pred.host_prep_s)
        prof = cs.device_profile(lambda: pred.predict_batch(pages), "bottleneck")
        res["r101"] = {"pages": BATCH, "dispatch_s": disp, "host_prep_s": prep,
                       "dispatch_s_median": statistics.median(disp),
                       "profile": {"wall_s": prof["wall_s"],
                                   "device_busy_ms": prof["device_busy_ms"],
                                   "block_ms": prof["matched_ms"],
                                   "block_kernels": prof["matched_kernels"],
                                   "block_share_of_busy":
                                       prof["matched_ms"] / prof["device_busy_ms"],
                                   "top_kernels_ms": prof["top_kernels_ms"]}}
    line = json.dumps(res)
    print(line, flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
