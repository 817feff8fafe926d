#!/usr/bin/env python3
"""The fused bottleneck kernel (B6) on one NVIDIA GPU: what ptxas made of
its two bodies, then chip_smoke.py's block check and config 4.

    python3 tools/torch_block_kernels.py [--no-r101]

Compiles ``tdnet_torch/csrc/block.cu`` with the port's nvcc flags and
``-Xptxas -v`` and prints each kernel's registers, stack frame, spills and
static shared memory, and the dynamic shared memory and persistent grid of
the bf16 body at config 4's four stage shapes at batch 16
(``block.launch_info``);
then builds the kernel library and runs ``chip_smoke.check_block`` (the f32
chains, the bf16 blocks with their controls and bit-equal reruns, the times
at batch 16; one JSON line) and, unless ``--no-r101``,
``chip_smoke.phase_predict_r101`` (config 4 with its profiled dispatch). A
first check of a kernel change before the whole ``chip_smoke.py``. Exits
non-zero without a GPU or on a failed check.
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback

from _torch_chip import ROOT, ptxas_report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--no-r101", action="store_true", help="skip config 4")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import numpy as np
    import torch

    from tdnet_torch.ops import block

    try:
        print(cs.phase_device(), flush=True)
        if ptxas_report("block.cu") != 0:
            return 1
        cs.phase_build()
        b = cs.BLOCK_TIMED_BATCH
        print(json.dumps({"launch_info": [
            {"stage": s, "shape": [b, hw, hw, c], "cmid": m,
             **block.launch_info(b, hw, hw, c, m)}
            for s, hw, c, m, _ in cs.BLOCK_STAGES]}), flush=True)
        dev = torch.device("cuda")
        cs.emit({"phase": "block", "ok": True,
                 "results": cs.check_block(dev, np.random.RandomState(cs.SEED))})
        if not args.no_r101:
            cs.phase_predict_r101(dev)
    except Exception:
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
