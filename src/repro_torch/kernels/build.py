"""Build the CUDA sources under ``csrc/`` into plain-C shared libraries.

Each ``csrc/<name>.cu`` (plus the shared ``*.cuh`` headers) compiles with
``nvcc`` for ``sm_90a`` into ``build/repro_torch/<hash>/lib<name>.so`` at
the root of the checkout (the directory is git-ignored) and is loaded with
ctypes.  The hash covers the sources and the flags, so an edited source
builds anew and an unchanged one is reused.  Nothing builds at import: the
first launch builds what it needs, and ``build`` compiles several sources
at once, one ``nvcc`` process each, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("fused_lloyd", "assignment", "update", "fused_bounds")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and under CUDA_HOME); the CUDA "
        "kernels of repro_torch build only where the CUDA toolkit is")


def tile_rows() -> int:
    """Rows per X tile, ``kTN`` of ``csrc/nearest.cuh`` (what each
    library's ``*_tile_rows()`` returns), read from the source so that
    the plain versions tile rows as the kernels do where no library can
    be built."""
    found = re.search(r"constexpr int kTN = (\d+);",
                      (CSRC / "nearest.cuh").read_text())
    if found is None:
        raise RuntimeError("csrc/nearest.cuh does not define kTN")
    return int(found.group(1))


def library_path(name: str) -> Path:
    """Where ``lib<name>.so`` of the current sources lives once built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{name}.so"


def build(names: Sequence[str] = KERNELS) -> Dict[str, str]:
    """Compile every library of ``names`` that is not built yet, all in
    parallel; returns each name's compiler log (ptxas register and spill
    report; empty when it was already built).  Raises RuntimeError with
    the compiler's output when a build fails."""
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    logs = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{logs[name]}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(logs[name])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>.so``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib
