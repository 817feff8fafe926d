#!/usr/bin/env python3
"""Where the NMS scan's time goes, on one NVIDIA GPU: ``clock64`` stamps in
a copy of the scan kernel.

    python3 tools/torch_nms_scan_clock.py

Copies this checkout's ``tdnet_torch`` to ``build/nms_scan_clock/``, adds
to the copy of ``csrc/nms.cu`` a record of four ``clock64`` stamps a
64-box chunk for row 0 (chunk start, the chunk's rows in shared memory,
the chunk resolved, the forward pass done) and an entry that reads them
back, builds the copy, runs ``nms_keep`` on ``chip_smoke.nms_inputs``'s
(16, 1024) rows (numpy seed 0) and prints one JSON line: the row's cycles,
and for each chunk its kept boxes and the cycles of its stage-and-wait,
resolution and forward phases. The stamps cost a few instructions a
chunk; the kernel in the tree has none. Raises if the source no longer
has the lines it instruments. Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import sys
from pathlib import Path

from _torch_chip import ROOT, load_chip_smoke, use_checkout

COPY = ROOT / "build" / "nms_scan_clock"
# (line in csrc/nms.cu, what the copy puts in its place)
PATCHES = [
    ("// one warp a row; WPL removed words a lane",
     "__device__ long long g_clk[256][4];\n__device__ int g_kept[256];\n\n"
     "// one warp a row; WPL removed words a lane"),
    ("  for (int c = 0; c < words; ++c) {\n    if (c + 1 < words) stage_chunk(c + 1);",
     "  const bool rec = row == 0 && lane == 0;\n"
     "  for (int c = 0; c < words; ++c) {\n    const long long t0 = clock64();\n"
     "    if (c + 1 < words) stage_chunk(c + 1);"),
    ("    const u64* rows = stage + (c & 1) * kChunk * words;\n",
     "    const u64* rows = stage + (c & 1) * kChunk * words;\n"
     "    const long long t1 = clock64();\n"),
    ("    if (lo < k) rkeep[lo]",
     "    const long long t2 = clock64();\n"
     "    if (rec) { g_clk[c][0] = t0; g_clk[c][1] = t1; g_clk[c][2] = t2;"
     " g_kept[c] = __popc(kept_lo) + __popc(kept_hi); }\n"
     "    if (lo < k) rkeep[lo]"),
    ("    __syncwarp();  // every lane is done with this buffer before it is restaged",
     "    __syncwarp();  // every lane is done with this buffer before it is restaged\n"
     "    if (rec) g_clk[c][3] = clock64();"),
]
READBACK = """
TDNET_EXPORT int tdnet_scan_clock(void* clk, void* kept) {
  cudaError_t e = cudaMemcpyFromSymbol(clk, g_clk, sizeof(g_clk));
  if (e != cudaSuccess) return e;
  return cudaMemcpyFromSymbol(kept, g_kept, sizeof(g_kept));
}
"""


def instrumented_copy() -> Path:
    shutil.rmtree(COPY, ignore_errors=True)
    COPY.mkdir(parents=True)
    shutil.copytree(ROOT / "tdnet_torch", COPY / "tdnet_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = COPY / "tdnet_torch" / "csrc" / "nms.cu"
    text = src.read_text()
    for old, new in PATCHES:
        if text.count(old) != 1:
            raise RuntimeError(f"csrc/nms.cu no longer has one {old!r}")
        text = text.replace(old, new)
    src.write_text(text + READBACK)
    return COPY


def main() -> int:
    import numpy as np

    cs = load_chip_smoke()
    use_checkout(instrumented_copy())
    import torch

    smi = cs.phase_device()  # raises without a GPU
    from tdnet_torch import _build
    from tdnet_torch.ops import nms_kernel

    _build.build(force=True)
    dev = torch.device("cuda")
    boxes, valid = (torch.from_numpy(a).to(dev)
                    for a in cs.nms_inputs(np.random.RandomState(0))[(16, 1024)])
    for _ in range(3):
        nms_kernel.nms_keep(boxes, valid, 0.5)
    torch.cuda.synchronize()
    lib = _build.library()
    lib.tdnet_scan_clock.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    clk = np.zeros((256, 4), np.int64)
    kept = np.zeros(256, np.int32)
    _build.check(lib.tdnet_scan_clock(clk.ctypes.data, kept.ctypes.data), "readback")
    words = 16
    chunks = [{"chunk": c, "kept": int(kept[c]),
               "stage_wait": int(clk[c, 1] - clk[c, 0]),
               "resolve": int(clk[c, 2] - clk[c, 1]),
               "forward": int(clk[c, 3] - clk[c, 2]) if c + 1 < words else 0}
              for c in range(words)]
    print(json.dumps({"nvidia_smi": smi, "shape": [16, 1024], "row": 0,
                      "cycles": int(clk[words - 1, 2] - clk[0, 0]),
                      "chunks": chunks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
