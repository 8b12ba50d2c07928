#!/usr/bin/env python3
"""Design probe of the bf16 tensor-core sweep: several copies of
src/repro_torch/kernels/csrc, each holding a variant of the sweep, built
and held side by side on one NVIDIA GPU.

    python3 scripts/tc_variant_probe.py first=build/v0 this=src/repro_torch/kernels/csrc

Each NAME=DIR builds DIR/assignment.cu with nvcc into build/repro_torch/
variants/NAME/ (git-ignored) and prints ptxas' registers and spills of its
tensor-core kernels (``assign_tc``).  Then, for each variant:

- the cross terms (``assignment_cross_launch``) of 4,096 bf16 rows against
  256 centroids near them, at d = 69, 821 and 4096, against an f64 product
  of the same values: the largest error and the mean signed error,
  relative to |x| |c|;
- the bf16 assignment (``assignment_launch`` on bf16 X and C), timed with
  CUDA events in turns (each variant in order, then in reverse; the
  faster of its two turns printed) at USCensus1990 (2,458,285 x 69) with
  K = 256 and 1000 on all rows and on a 16,384-row chunk, and at
  Meta-Llama-3-8B's embedding table's shape (128,256 x 4096, drawn on the
  card as chip_smoke.py's phase 18 draws it) with K = 256 and 1000.

A variant is a copy of csrc with one change (unpack one with ``git archive
<commit> src/repro_torch/kernels/csrc``, or copy the tree and edit it).
Prints the card's name and power limit first; exits non-zero without a
CUDA device or when a build fails.
"""

from __future__ import annotations

import collections
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("tc_variant_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.kernels import build

    variants = dict(arg.split("=", 1) for arg in sys.argv[1:])
    print(cs.nvidia_smi_line(), flush=True)
    nvcc = build._nvcc()
    out = build.BUILD_ROOT / "variants"
    procs = {}
    for name, src in variants.items():
        (out / name).mkdir(parents=True, exist_ok=True)
        procs[name] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-o", str(out / name / "libassignment.so"),
             str(Path(src) / "assignment.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        path = out / name / "libassignment.so"
        path.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            print(f"nvcc failed for {name}:\n{log}", file=sys.stderr)
            return 1
        for fname, rep in cs.ptxas_report(path, "assign_tc").items():
            print(f"{name} ptxas {fname}: {rep}")
        lib = ctypes.CDLL(str(path))
        lib.assignment_launch.argtypes = [p, i, ll, p, i, i, i, i, i, i, p,
                                          p, p, p]
        lib.assignment_cross_launch.argtypes = [p, ll, p, i, i, i, i, p, p,
                                                p]
        lib.assignment_scratch_floats.argtypes = [i] * 3
        lib.assignment_scratch_floats.restype = ll
        libs[name] = lib
    dev = torch.device("cuda")
    bufs = {}

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def launch(name, x, c):
        n, d = x.shape
        k = c.shape[0]
        key = (name, n, k, d)
        if key not in bufs:
            bufs[key] = (torch.empty(n, dtype=torch.int32, device=dev),
                         torch.empty(n, device=dev),
                         torch.empty(libs[name].assignment_scratch_floats(
                             1, k, d), device=dev))
        lab, mind, scratch = bufs[key]
        rc = libs[name].assignment_launch(
            x.data_ptr(), 1, 0, c.data_ptr(), 1, 1, n, k, d, 0,
            scratch.data_ptr(), lab.data_ptr(), mind.data_ptr(), stream())
        if rc != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {rc}")

    def cross(name, x, c):
        n, d = x.shape
        k = c.shape[0]
        got = torch.empty(1, n, k, device=dev)
        scratch = torch.empty(libs[name].assignment_scratch_floats(1, k, d),
                              device=dev)
        rc = libs[name].assignment_cross_launch(
            x.data_ptr(), 0, c.data_ptr(), 1, n, k, d, scratch.data_ptr(),
            got.data_ptr(), stream())
        if rc != 0:
            raise RuntimeError(f"{name} cross terms failed: CUDA error {rc}")
        return got[0]

    gen = torch.Generator(device=dev).manual_seed(0)
    for d in (69, 821, 4096):
        x = (torch.randn(4096, d, generator=gen, device=dev)
             + torch.randn(1, d, generator=gen, device=dev)).bfloat16()
        c = x[torch.randperm(4096, generator=gen, device=dev)[:256]]
        c = (c.float() + 0.1 * torch.randn(c.shape, generator=gen,
                                           device=dev)).bfloat16()
        xd, cd = x.double(), c.double()
        norms = xd.norm(dim=-1)[:, None] * cd.norm(dim=-1)[None]
        for name in libs:
            err = (cross(name, x, c).double() - xd @ cd.T) / norms
            print(f"cross terms at d={d}, {name}: largest error "
                  f"{float(err.abs().max())!r} of |x| |c|, mean signed "
                  f"{float(err.mean())!r}", flush=True)

    x = torch.from_numpy(make_dataset(cs.MAIN_N_NAME)).to(dev).bfloat16()
    cases = []
    for k in (256, 1000):
        c = x[torch.randperm(x.shape[0], generator=gen, device=dev)[:k]]
        cases += [(f"USCensus1990 K={k} all rows", x, c.contiguous(), 10),
                  (f"USCensus1990 K={k} chunk", x[:16384], c.contiguous(),
                   100)]
    table = cs.wide_table(torch, dev, cs.LLAMA_VOCAB, cs.LLAMA_HIDDEN,
                          cs.WIDE_COMPONENTS).bfloat16()
    for k in (256, 1000):
        c = table[torch.randperm(table.shape[0], generator=gen,
                                 device=dev)[:k]].contiguous()
        cases.append((f"wide K={k} all rows", table, c, 5))
    for label, xx, cc, iters in cases:
        got = collections.defaultdict(list)
        for name in list(libs) + list(libs)[::-1]:
            got[name].append(cs.event_ms(
                torch, lambda j, name=name: launch(name, xx, cc), iters,
                warmup=1))
        print(f"{label} ms: " + "; ".join(
            f"{name} {min(ts)!r}" for name, ts in got.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
