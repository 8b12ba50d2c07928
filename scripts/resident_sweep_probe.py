#!/usr/bin/env python3
"""Resident-sweep probe: the assignment kernel (csrc/assignment.cu) of
another checkout, as it builds from that checkout's sources, against this
checkout's, on one NVIDIA GPU at the main path's shape (USCensus1990,
2,458,285 x 69, K = 1000).  It checks that a change to the shared sweep
(csrc/sweep_fp32.cuh) left the resident path (rows that fit the
shared-memory X tile) as it was.

    git archive <commit> src/repro_torch/kernels/csrc | tar -x -C <dir>
    python3 scripts/resident_sweep_probe.py <dir>

Builds the other checkout's csrc/assignment.cu with nvcc into build/
(git-ignored), binds its launcher with the launch signature it had before
the force_stream argument, then requires both launches to give the same
labels and distances bit for bit at all rows and on a 16,384-row predict
chunk; compares the SASS of the float32 and bfloat16 resident kernels
(``cuobjdump -sass``, instructions only); and times both launchers with
CUDA events, in turns (other, this, this, other), each called through
ctypes with preallocated outputs, so that only the kernels differ.

Prints the card's name and power limit first.  Exits non-zero without a
CUDA device or when the two builds disagree.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# the resident kernels' mangled names: before (one template argument) and
# after (the element type and kStream = false)
SASS_PAIRS = (
    ("_ZN5repro2f812assign_tilesIfEEvPKT_lPKfS6_iiiiPiPf",
     "_ZN5repro2f812assign_tilesIfLb0EEEvPKT_lPKfS6_iiiiPiPf"),
    ("_ZN5repro2f812assign_tilesI13__nv_bfloat16EEvPKT_lPKfS7_iiiiPiPf",
     "_ZN5repro2f812assign_tilesI13__nv_bfloat16Lb0EEEvPKT_lPKfS7_iiiiPiPf"))


def sass(cuobjdump: str, lib_path: Path, fun: str):
    """The function's SASS instructions (no addresses, no encodings)."""
    out = subprocess.run([cuobjdump, "-sass", "-fun", fun, str(lib_path)],
                         capture_output=True, text=True, check=True).stdout
    ins = []
    for line in out.splitlines():
        line = line.strip()
        if line.startswith("/*") and "*/" in line:
            body = line.split("*/", 1)[1].strip()
            if body and not body.startswith("/*"):
                ins.append(body.split(";")[0].strip())
    return ins


def main() -> int:
    import torch
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("resident_sweep_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.kernels import build

    print(cs.nvidia_smi_line(), flush=True)
    other_src = Path(sys.argv[1]) / "src/repro_torch/kernels/csrc"
    other = build.BUILD_ROOT / "probe" / "libassignment_other.so"
    other.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(other),
                    str(other_src / "assignment.cu")], check=True,
                   capture_output=True, text=True)
    build.build(["assignment"])
    this = build.library_path("assignment")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs = {"other": ctypes.CDLL(str(other)), "this": ctypes.CDLL(str(this))}
    libs["other"].assignment_launch.argtypes = [p, i, ll, p, i, i, i, i, i,
                                                p, p, p, p]
    libs["this"].assignment_launch.argtypes = [p, i, ll, p, i, i, i, i, i,
                                               i, p, p, p, p]
    for lib in libs.values():
        lib.assignment_launch.restype = i
        lib.assignment_scratch_floats.argtypes = [i] * 3
        lib.assignment_scratch_floats.restype = ll

    x = torch.from_numpy(make_dataset(cs.MAIN_N_NAME)).cuda()
    n, d = x.shape
    k = cs.MAIN_K
    gen = torch.Generator(device="cuda").manual_seed(0)
    c = x[torch.randperm(n, generator=gen, device="cuda")[:k]].contiguous()
    scratch = torch.empty(libs["this"].assignment_scratch_floats(1, k, d),
                          device="cuda")
    chunk = x[:16384].contiguous()
    outs = {m: (torch.empty(m, dtype=torch.int32, device="cuda"),
                torch.empty(m, device="cuda")) for m in (n, 16384)}

    def launch(name, xx):
        lab, mind = outs[xx.shape[0]]
        stream = torch.cuda.current_stream().cuda_stream
        head = (xx.data_ptr(), 0, 0, c.data_ptr(), 0, 1, xx.shape[0], k, d)
        tail = (scratch.data_ptr(), lab.data_ptr(), mind.data_ptr(), stream)
        rc = libs[name].assignment_launch(
            *head, *((0,) if name == "this" else ()), *tail)
        if rc != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
        return lab, mind

    same = True
    for xx in (x, chunk):
        a = [t.clone() for t in launch("other", xx)]
        b = launch("this", xx)
        eq = torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        print(f"  {xx.shape[0]} rows: labels and distances bit-equal {eq}")
        same = same and eq
    cuobjdump = str(Path(build._nvcc()).parent / "cuobjdump")
    for before, after in SASS_PAIRS:
        a, b = sass(cuobjdump, other, before), sass(cuobjdump, this, after)
        print(f"  SASS of {after}: {len(a)} and {len(b)} instructions, "
              f"identical {a == b}")
    times = {}
    for rows, xx, iters in (("all rows", x, 10), ("chunk", chunk, 200)):
        for name in ("other", "this", "this", "other"):
            times.setdefault(f"{name} {rows}", []).append(cs.event_ms(
                torch, lambda j, name=name, xx=xx: launch(name, xx), iters))
    print("  ms in turns: " + "; ".join(f"{key} {v!r}"
                                        for key, v in times.items()))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
