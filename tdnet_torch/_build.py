"""Build and load the port's CUDA kernels (the counterpart of
``tdnet/native/__init__.py``'s self-build, without its numpy fallback).

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a``; the objects are linked into
``build/tdnet_torch/libtdnet_torch_kernels.so`` and loaded with ``ctypes``.
The sources expose a plain C interface (no PyTorch headers), so a full build
takes seconds. The build happens at the first kernel launch; a failed build
raises.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an
exception naming the kernel.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["LaunchCounter", "build", "check", "library"]

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "tdnet_torch"
LIB_PATH = BUILD_DIR / "libtdnet_torch_kernels.so"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every entry point (pointers and the stream as c_void_p:
# ctypes would otherwise pass them as 32-bit ints and cut them)
_SIGNATURES = {
    "tdnet_normalize_u8": [_P, _P, ctypes.c_int64, _I, _F, _F, _F, _F, _P],
    "tdnet_fused_stem": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F,
                         _I, _P],
    "tdnet_nms_keep": [_P, _P, _P, _I, _I, _F, _P],
    "tdnet_fused_stem_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F,
                             _F, _F, _I, _I, _P],
    "tdnet_soft_nms": [_P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _P],
    "tdnet_bottleneck": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                         _I, _I, _I, _I, _P],
    "tdnet_conv1x1": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None


class LaunchCounter:
    """Counts the launches of one kernel; its wrapper adds one where it
    launches the kernel, and nowhere else."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def reset(self) -> None:
        self.count = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the tdnet_torch "
        "CUDA kernels cannot be built")


def _sources():
    return sorted(_CSRC.glob("*.cu"))


def _up_to_date() -> bool:
    if not LIB_PATH.exists():
        return False
    built = LIB_PATH.stat().st_mtime
    deps = _sources() + sorted(_CSRC.glob("*.cuh")) + [Path(__file__)]
    return all(p.stat().st_mtime <= built for p in deps)


def build(force: bool = False) -> Path:
    """Compile csrc/*.cu (one nvcc per source, in parallel) and link the
    shared library. Returns its path; raises RuntimeError on any failure."""
    if not force and _up_to_date():
        return LIB_PATH
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        errors = []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{src.name}:\n{out}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp_lib = Path(tmp) / LIB_PATH.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp_lib),
             *[str(o) for _, o, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        os.replace(tmp_lib, LIB_PATH)  # atomic: concurrent loaders see
        # either the old library or the whole new one
    return LIB_PATH


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.tdnet_error_string.argtypes = [ctypes.c_int]
            lib.tdnet_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().tdnet_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {kernel} failed: error {err} ({msg})")
