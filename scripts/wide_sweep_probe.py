#!/usr/bin/env python3
"""Sweep probe: this checkout's assignment kernel (csrc/assignment.cu)
against another checkout's, as each builds from its own sources, on one
NVIDIA GPU.  It checks that a change to the sweeps kept their bits and
times both in turns.

    mkdir -p build/parent
    git archive <commit> src/repro_torch/kernels/csrc | tar -x -C build/parent
    python3 scripts/wide_sweep_probe.py build/parent

The other checkout's launcher must take ``force_stream`` (the signature
since wide rows streamed).  Both libraries are built with nvcc into
build/probe/ (git-ignored), each beside its compiler log.  Another design
of this checkout's sweep is timed the same way: unpack a copy of csrc
holding it as the other checkout.

Wide rows (Meta-Llama-3-8B's embedding table, 128,256 x 4096 f32, drawn on
the card as chip_smoke.py's phase 18 draws it; centroids drawn from its
rows): the streamed launches (``force_stream``) of both checkouts at
K = 256 and K = 1000, on all rows and on a 16,384-row predict chunk, f32
and bf16 X (against f32 centroids: bf16 X and C take the tensor-core
sweep, which scripts/tc_sweep_probe.py holds), must give the same labels
and min distances bit for bit; then
each is timed with CUDA events in turns (other, this, this, other), with
``addmm`` + ``argmin`` on the same operands (upcast for bf16) in the same
turns.

The resident path (USCensus1990, 2,458,285 x 69, K = 1000): the resident
launches equal bit for bit on all rows and on a chunk, the SASS of the
resident kernels (float32 and bfloat16; ``cuobjdump -sass``, instructions
only) identical, and both timed in turns (other, this, this, other).
Both sides' csrc/fused_bounds.cu are built too, and every kernel in them
must have the same SASS on both sides.

Also prints ptxas' registers and spills of every sweep kernel and an
opcode count of the streamed kernel's SASS.  Prints the card's name and
power limit first.  Exits non-zero without a CUDA device or when any two
builds disagree.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

CHUNK = 16384


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("other", type=Path)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("wide_sweep_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from chip_smoke import opcode_counts, sass_functions
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.kernels import build

    print(cs.nvidia_smi_line(), flush=True)
    nvcc = build._nvcc()
    probe_dir = build.BUILD_ROOT / "probe"
    src = {"other": args.other / "src/repro_torch/kernels/csrc",
           "this": build.CSRC}
    # the assignment of each side, and both sides' bounded kernels (their
    # SASS must not move)
    jobs = {(side, lib): probe_dir / side / f"lib{lib}.so"
            for side in src for lib in ("assignment", "fused_bounds")}
    procs = {}
    for (side, lib), path in jobs.items():
        path.parent.mkdir(parents=True, exist_ok=True)
        procs[(side, lib)] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-o", str(path),
             str(src[side] / f"{lib}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for job, proc in procs.items():
        log, _ = proc.communicate()
        jobs[job].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            print(f"nvcc failed for {job}:\n{log}", file=sys.stderr)
            return 1
    paths = {side: jobs[(side, "assignment")] for side in src}
    for side in src:
        print(f"ptxas, {side}:")
        for fname, report in cs.ptxas_report(
                paths[side], "assign_(stream|tiles)").items():
            print(f"  {fname}: {report}")
    cuobjdump = str(Path(nvcc).parent / "cuobjdump")
    funs = {name: sass_functions(cuobjdump, paths[name])
            for name in ("other", "this")}
    for fname, ins in funs["this"].items():
        if "assign_stream" in fname:
            counts = opcode_counts(ins)
            print(f"SASS of {fname}: {len(ins)} instructions; "
                  + ", ".join(f"{op} {n}" for op, n in counts.most_common()))
    resident = {}
    for side in ("other", "this"):
        for fname, ins in funs[side].items():
            if "assign_tiles" in fname and ("Lb1E" not in fname):
                typ = "bf16" if "bfloat16" in fname else "f32"
                resident[(side, typ)] = (fname, ins)
    same_sass = True
    for typ in ("f32", "bf16"):
        (fa, a), (fb, b) = resident[("other", typ)], resident[("this", typ)]
        print(f"resident SASS {typ}: {fa} ({len(a)} instructions) and {fb} "
              f"({len(b)}), identical {a == b}")
        same_sass = same_sass and a == b
    bounds = {side: sass_functions(cuobjdump, jobs[(side, "fused_bounds")])
              for side in ("other", "this")}
    equal = [f for f, ins in bounds["other"].items()
             if bounds["this"].get(f) == ins]
    print(f"fused_bounds.cu: {len(equal)} of {len(bounds['other'])} kernels "
          f"with the other's SASS ({len(bounds['this'])} here)")
    same_sass = same_sass and len(equal) == len(bounds["other"]) \
        == len(bounds["this"])

    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs = {name: ctypes.CDLL(str(paths[name])) for name in src}
    for lib in libs.values():
        lib.assignment_launch.argtypes = [p, i, ll, p, i, i, i, i, i, i, p,
                                          p, p, p]
        lib.assignment_launch.restype = i
        lib.assignment_scratch_floats.argtypes = [i] * 3
        lib.assignment_scratch_floats.restype = ll
    dev = torch.device("cuda")
    outs = {}

    def launch(name, xx, cc, stream_x):
        n, d = xx.shape
        k = cc.shape[0]
        key = (n, k, d)
        if key not in outs:
            outs[key] = (torch.empty(n, dtype=torch.int32, device=dev),
                         torch.empty(n, device=dev),
                         torch.empty(libs[name].assignment_scratch_floats(
                             1, k, d), device=dev))
        lab, mind, scratch = outs[key]
        code = {torch.float32: 0, torch.bfloat16: 1}
        rc = libs[name].assignment_launch(
            xx.data_ptr(), code[xx.dtype], 0, cc.data_ptr(), code[cc.dtype],
            1, n, k, d, int(stream_x), scratch.data_ptr(), lab.data_ptr(),
            mind.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
        return lab, mind

    def library(xx, cc):
        xf, cf = xx.float(), cc.float()
        return torch.argmin(torch.addmm(torch.sum(cf * cf, dim=-1), xf, cf.T,
                                        alpha=-2.0), dim=1)

    def turns(label, xx, cc, stream_x, iters):
        order = ["library", "other", "this", "this", "other", "library"]
        got = collections.defaultdict(list)
        for name in order:
            fn = (lambda j: library(xx, cc)) if name == "library" else \
                (lambda j, name=name: launch(name, xx, cc, stream_x))
            got[name].append(cs.event_ms(torch, fn, iters, warmup=1))
        print(f"  {label} ms in turns: " + "; ".join(
            f"{name} {ts!r}" for name, ts in got.items()), flush=True)
        return got

    same = True
    table = cs.wide_table(torch, dev, cs.LLAMA_VOCAB, cs.LLAMA_HIDDEN,
                          cs.WIDE_COMPONENTS)
    gen = torch.Generator(device=dev).manual_seed(1)
    print(f"wide rows: {tuple(table.shape)}", flush=True)
    for k in (256, 1000):
        c = table[torch.randperm(table.shape[0], generator=gen,
                                 device=dev)[:k]].contiguous()
        for dt in (torch.float32, torch.bfloat16):
            xk, ck = table.to(dt), c
            for rows, xx in (("all rows", xk), ("chunk", xk[:CHUNK])):
                ref = [t.clone() for t in launch("other", xx, ck, True)]
                got = launch("this", xx, ck, True)
                eq = torch.equal(ref[0], got[0]) and torch.equal(ref[1], got[1])
                tag = "bf16" if dt == torch.bfloat16 else "f32"
                print(f"  K={k} {tag} {rows}: streamed launches bit-equal "
                      f"{eq}", flush=True)
                same = same and eq
            del xk
    print("wide rows, times:")
    for k in (256, 1000):
        c = table[torch.randperm(table.shape[0], generator=gen,
                                 device=dev)[:k]].contiguous()
        for dt in ((torch.float32, torch.bfloat16) if k == 256
                   else (torch.float32,)):
            xk, ck = table.to(dt), c
            tag = "bf16" if dt == torch.bfloat16 else "f32"
            turns(f"K={k} {tag} all rows", xk, ck, True, 5 if k == 256 else 3)
            turns(f"K={k} {tag} chunk", xk[:CHUNK], ck, True, 50)
            del xk
    del table

    x = torch.from_numpy(make_dataset(cs.MAIN_N_NAME)).to(dev)
    c = x[torch.randperm(x.shape[0], generator=gen,
                         device=dev)[:cs.MAIN_K]].contiguous()
    print(f"resident: {tuple(x.shape)}, K={cs.MAIN_K}")
    for rows, xx in (("all rows", x), ("chunk", x[:CHUNK])):
        a = [t.clone() for t in launch("other", xx, c, False)]
        b = launch("this", xx, c, False)
        eq = torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        print(f"  {rows}: resident launches bit-equal {eq}")
        same = same and eq
    for rows, xx, iters in (("all rows", x, 10), ("chunk", x[:CHUNK], 200)):
        turns(f"resident {rows}", xx, c, False, iters)
    return 0 if same and same_sass else 1


if __name__ == "__main__":
    sys.exit(main())
