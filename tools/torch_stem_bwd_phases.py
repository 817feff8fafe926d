#!/usr/bin/env python3
"""Where the bf16 stem backward kernel spends its time, on one NVIDIA GPU,
without a profiler: the kernel built whole and with one phase left out.

    python3 tools/torch_stem_bwd_phases.py

Copies ``tdnet_torch/csrc`` into ``build/stem_bwd_phases/``, makes one
variant of ``stem_bwd.cu`` per phase of ``stem_bwd_mma_kernel`` with that
phase removed (normalize + im2col, the conv, the first-max pick, the
routing step that gathers da and writes dz, the filter-gradient GEMM),
compiles each with the port's nvcc flags into its own library, and times
each at (8, 800, 1344) bf16 (CUDA-event medians of 20 calls, two rounds in
turns). A variant computes wrong gradients and changes what the compiler
keeps in registers, so a difference to the whole kernel is that phase's
cost only roughly. Prints one JSON line per round. Exits non-zero without a
GPU.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# (phase, the line that starts it, how to leave it out)
ANCHORS = {
    "norm_im2col": "    tl::normalize_window(s_win, s_u8 + (it & 1)",
    "conv": "    tl::conv_mma<kNT>(s_a, s_w, row0, col0, lane, z);",
    "argmax": "    // ---- 3. first maximum of each pooled window",
    "routing": "    // ---- 3-5. each z's owner",
    "dw": "    // ---- 5. filter gradient",
}


def _variant(lines, phase):
    """stem_bwd.cu with `phase` of the bf16 kernel left out."""
    lines = list(lines)
    first = next(i for i, line in enumerate(lines) if "stem_bwd_mma_kernel(" in line)

    def at(text, start=first):
        return next(i for i in range(start, len(lines)) if lines[i].startswith(text))

    i = at(ANCHORS[phase])
    if phase == "norm_im2col":
        lines[i] = "    if (0) " + lines[i].lstrip()
        j = at("    tl::build_im2col(s_a, s_win);", i)
        lines[j] = "    if (0) tl::build_im2col(s_a, s_win);"
    elif phase == "conv":
        lines[i] = ("    for (int i = 0; i < 2; ++i) for (int j = 0; j < kNT; ++j) "
                    "for (int e = 0; e < 4; ++e) z[i][j][e] = 0.001f * (i + j + e + lane);")
    elif phase == "argmax":
        end = at("    tl::cp_async_wait<0>();", i)
        lines[i] = "    if (0) {"
        lines[end - 1] += " }"
    elif phase == "routing":
        end = at("    __syncthreads();", i + 1)
        lines[i] = "    if (0) {"
        lines[end - 1] += " }"
    elif phase == "dw":
        lines[i] = "    if (0)"
    return "\n".join(lines)


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from tdnet_torch import _build
    from tdnet_torch.ops.ingest import mode_constants

    if not torch.cuda.is_available():
        print("torch_stem_bwd_phases: no CUDA GPU", file=sys.stderr)
        return 2
    smi = cs.phase_device()
    work = ROOT / "build" / "stem_bwd_phases"
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(_build._CSRC, work / "csrc")
    lines = (_build._CSRC / "stem_bwd.cu").read_text().split("\n")
    procs = []
    for name in ["whole", *ANCHORS]:
        src = work / f"{name}.cu"
        src.write_text("\n".join(lines) if name == "whole" else _variant(lines, name))
        so = work / f"{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(work / "csrc"),
               str(src), str(work / "csrc" / "common.cu"), "-o", str(so)]
        procs.append((name, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    fns = {}
    for name, so, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"{name}: nvcc failed\n{out}", file=sys.stderr)
            return 1
        fn = ctypes.CDLL(str(so)).tdnet_fused_stem_bwd
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, f, f, f, f, i, i, p]
        fn.restype = i
        fns[name] = fn

    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    k7 = torch.from_numpy(rng.normal(0, 0.08, (7, 7, 3, 64)).astype(np.float32)).to(dev)
    inv = torch.from_numpy(rng.uniform(0.5, 1.5, 64).astype(np.float32)).to(dev)
    off = torch.from_numpy(rng.normal(0, 0.5, 64).astype(np.float32)).to(dev)
    b, h, w = 8, 800, 1344
    packed = torch.from_numpy(rng.randint(0, 256, (b, h, w * 3)).astype(np.uint8)).to(dev)
    dy = torch.from_numpy(rng.normal(0, 1, (b, h // 4, w // 4, 64))
                          .astype(np.float32)).to(dev).to(torch.bfloat16)
    blocks = 264
    out = torch.empty(9536, device=dev)
    part = torch.empty((blocks, 9536), device=dev)
    mean, scale = mode_constants("caffe")

    def run(fn):
        err = fn(packed.data_ptr(), k7.data_ptr(), inv.data_ptr(), off.data_ptr(),
                 dy.data_ptr(), part.data_ptr(), out.data_ptr(), b, h, w,
                 float(mean[0]), float(mean[1]), float(mean[2]), float(scale), 1,
                 blocks, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: {err}")

    for rnd in range(2):
        ms = {name: cs.median_ms(lambda fn=fn: run(fn), iters=20) for name, fn in fns.items()}
        print(json.dumps({"round": rnd, "nvidia_smi": smi, "shape": [b, h, w * 3],
                          "ms_whole_and_without": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
