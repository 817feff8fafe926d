#!/usr/bin/env python3
"""A/B of the port's NMS (B2) and soft-NMS (B5) kernels on one NVIDIA GPU,
one checkout a run. Run it in turns from one call (parent, change, change,
parent):

    python3 tools/torch_nms_ab.py --root build/parent --label parent \\
        --out build/nms_ab/parent_1.json
    python3 tools/torch_nms_ab.py --root . --label change \\
        --out build/nms_ab/change_1.json

It imports ``tdnet_torch`` from ``--root`` (so each checkout builds and
runs its own kernels) and its inputs and helpers from this checkout's
``chip_smoke.py`` (``nms_inputs`` and ``soft_inputs`` from numpy seed 0:
the same for every checkout), and measures:

- ``nms_keep`` at IoU 0.5 on (16, 1024) and (128, 1024) rows (config 1's
  batch of 16 pages, ``bench.py``'s 128);
- ``soft_nms_rescore_batched``, gaussian (sigma 0.5) and linear (IoU
  0.3), 300 picks, on (48, 1024) and (384, 1024) rows (config 5's 16
  pages x 3 classes, and 128 pages x 3);

each as the median of 20 CUDA-event timings of bursts of 10 calls (so the
wrapper's host work overlaps the device work before it), beside the
device time of each kernel a call (``torch.profiler`` over one burst, by
kernel name: ``device_ms``), the host's time to enqueue a call (a burst on
the host clock without a synchronise: ``host_ms``; where it exceeds the
device time, the event time measures the host), and the SHA-256 of the
output's bytes (equal digests across checkouts: equal keep masks,
bit-equal scores).

Prints chip_smoke.py's device line, then one JSON line (with
``nvidia-smi``'s name and power limit), which it also writes to
``--out``. Exits non-zero without a GPU. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

from _torch_chip import load_chip_smoke, use_checkout

BURST, TIMINGS = 10, 20


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

    smi = cs.phase_device()  # raises without a GPU
    from tdnet_torch import _build
    from tdnet_torch.ops import nms_kernel, soft_nms

    _build.build(force=True)
    dev = torch.device("cuda")

    def digest(t):
        return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()

    def timed(fn):
        """ms, device_ms by kernel and host_ms, a call"""
        ms = cs.median_ms(fn, iters=TIMINGS, warmup=3, burst=BURST)
        prof = cs.device_profile(lambda: [fn() for _ in range(BURST)], top=4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(BURST):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3 / BURST
        torch.cuda.synchronize()
        return {"ms": ms, "host_ms": host_ms,
                "device_ms": {n: t / BURST for n, t in prof["top_kernels_ms"]}}

    res = {"label": args.label, "root": str(root), "nvidia_smi": smi,
           "torch": torch.__version__, "nms": [], "soft_nms": []}
    for (r, k), (b_np, v_np) in cs.nms_inputs(np.random.RandomState(0)).items():
        if (r, k) not in cs.NMS_SHAPES:
            continue
        boxes = torch.from_numpy(b_np).to(dev)
        valid = torch.from_numpy(v_np).to(dev)
        keep = nms_kernel.nms_keep(boxes, valid, 0.5)
        res["nms"].append({"shape": [r, k], "kept": int(keep.sum().item()),
                           **timed(lambda: nms_kernel.nms_keep(boxes, valid, 0.5)),
                           "sha256": digest(keep)})
        print(json.dumps(res["nms"][-1]), flush=True)
    for (r, k), (b_np, s_np) in cs.soft_inputs(np.random.RandomState(0)).items():
        boxes = torch.from_numpy(b_np).to(dev)
        scores = torch.from_numpy(s_np).to(dev)
        for method in ("gaussian", "linear"):
            kw = dict(method=method, sigma=cs.SOFT_SIGMA, iou_threshold=0.3,
                      max_selections=cs.SOFT_PICKS)
            out = soft_nms.soft_nms_rescore_batched(boxes, scores, **kw)
            res["soft_nms"].append({
                "shape": [r, k], "method": method,
                "selected": int((out > 0).sum().item()),
                **timed(lambda: soft_nms.soft_nms_rescore_batched(boxes, scores, **kw)),
                "sha256": digest(out)})
            print(json.dumps(res["soft_nms"][-1]), flush=True)
    line = json.dumps(res)
    print(line, flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
