#!/usr/bin/env python3
"""The fused stem kernels on one NVIDIA GPU: what ptxas made of them, then
chip_smoke.py's kernels phase.

    python3 tools/torch_stem_kernels.py

Compiles ``tdnet_torch/csrc/stem.cu`` and ``stem_bwd.cu`` with the port's
nvcc flags and ``-Xptxas -v`` and prints each kernel's registers, stack
frame, spills and shared memory; then builds the kernel library and runs
``chip_smoke.phase_kernels`` (every kernel against its plain version at
the main paths' shapes, with times; one JSON line). A first check of a
kernel change before the whole ``chip_smoke.py``. Exits non-zero without a
GPU or on a failed check.
"""

from __future__ import annotations

import sys
import traceback

from _torch_chip import ROOT, ptxas_report


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch

    try:
        print(cs.phase_device(), flush=True)
        for src in ("stem.cu", "stem_bwd.cu"):
            if ptxas_report(src) != 0:
                return 1
        cs.phase_build()
        cs.phase_kernels(torch.device("cuda"))
    except Exception:
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
