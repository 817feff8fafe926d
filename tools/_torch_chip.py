"""Helpers shared by the port's GPU tools (``tools/torch_*.py``).

- :func:`load_chip_smoke`: this checkout's ``chip_smoke.py`` as a module,
  for its timing, profiling and input helpers (it imports ``tdnet_torch``
  only inside its functions, so they run the package that
  :func:`use_checkout` put first on ``sys.path``);
- :func:`use_checkout`: import ``tdnet_torch`` from another checkout (the
  A/B tools' ``--root``) and check that it came from there;
- :func:`ptxas_report`: what ptxas made of one kernel source.
"""

from __future__ import annotations

import importlib.util
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def load_chip_smoke():
    """This checkout's chip_smoke.py, loaded before any ``--root`` goes on
    sys.path."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod
    spec.loader.exec_module(mod)
    return mod


def use_checkout(root: Path):
    """Put `root` first on sys.path and import its tdnet_torch; raises if
    the package came from anywhere else."""
    sys.path.insert(0, str(root))
    import tdnet_torch

    if not Path(tdnet_torch.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"tdnet_torch came from {tdnet_torch.__file__}, not {root}")
    return tdnet_torch


def ptxas_report(src: str) -> int:
    """Compile one source of ``tdnet_torch/csrc`` with the port's nvcc flags
    and -Xptxas -v; print each kernel's entry, registers, stack frame,
    spills and shared memory, and any error or warning. Returns nvcc's exit
    code."""
    from tdnet_torch import _build

    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
             "-I", str(_build._CSRC), "-c", str(_build._CSRC / src),
             "-o", str(Path(tmp) / "k.o")],
            capture_output=True, text=True)
    print(f"{src}: nvcc exit {r.returncode}")
    for line in (r.stdout + r.stderr).splitlines():
        if any(k in line for k in ("Compiling entry", "registers", "spill",
                                   "smem", "error", "warning")):
            print("  " + line.strip())
    return r.returncode
