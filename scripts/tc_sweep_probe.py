#!/usr/bin/env python3
"""Tensor-core sweep probe: this checkout's kernels (csrc/) against another
checkout's, as each builds from its own sources, on one NVIDIA GPU.

    mkdir -p build/parent
    git archive <commit> src/repro_torch/kernels/csrc | tar -x -C build/parent
    python3 scripts/tc_sweep_probe.py build/parent [--quick]

Both sides' assignment.cu, fused_lloyd.cu and fused_bounds.cu are built
with nvcc into build/repro_torch/probe/ (git-ignored), in parallel.  Then:

- SASS (``cuobjdump -sass``, instructions only): every kernel of the other
  side's three libraries is in this side's with the same instructions;
  this side's other kernels must be the tensor-core sweep's (``assign_tc``,
  ``bounds_tc``, ``pack_c``), whose HGMMA / HMMA instructions are counted;
  ptxas' registers and spills of each.
- Bits: the f32 launches (resident at USCensus1990, 2,458,285 x 69,
  K = 1000, all rows and a 16,384-row chunk; streamed at 128,256 x 4096,
  K = 256, a chunk) and the mixed ones (bf16 X, f32 C) equal the other
  side's bit for bit.
- The tensor-core sweep at USCensus1990, K = 1000 (all rows) and at
  128,256 x 4096, K = 256 and 1000: against the plain version (labels but
  at near ties, min distances within 1e-5 of |x|^2 + max |c|^2), a
  relaunch equal, the fused step's energy against the plain one; its
  cross terms against an f64 product of the same bf16 values at d = 69,
  821 and 4096, relative to |x| |c| and to |x|^2 + |c|^2.
- Times (CUDA events, in turns: library, other, this, this, other,
  library) of the bf16 assignment: this side's tensor-core sweep, the
  other side's bf16 launch, ``torch.mm(x, c.T, out_dtype=torch.float32)``
  with the same epilogue and ``argmin`` (where torch has that overload),
  and f32 ``addmm`` + ``argmin`` on the upcast operands.

``--quick`` stops after the SASS, the bits at a chunk and the tensor-core
checks on small shapes.  Prints the card's name and power limit first.
Exits non-zero without a CUDA device or when a check fails.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

CHUNK = 16384
LIBS = ("assignment", "fused_lloyd", "fused_bounds")
TC_KERNELS = r"assign_tc|bounds_tc|pack_c"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("other", type=Path)
    parser.add_argument("--quick", action="store_true")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("tc_sweep_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from chip_smoke import opcode_counts, sass_functions
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.kernels import assignment as A
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_lloyd as F
    from repro_torch.kernels import ref

    print(cs.nvidia_smi_line(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    nvcc = build._nvcc()
    probe_dir = build.BUILD_ROOT / "probe"
    src = {"other": args.other / "src/repro_torch/kernels/csrc",
           "this": build.CSRC}
    jobs = {(side, lib): probe_dir / side / f"lib{lib}.so"
            for side in src for lib in LIBS}
    procs = {}
    for (side, lib), path in jobs.items():
        path.parent.mkdir(parents=True, exist_ok=True)
        procs[(side, lib)] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-o", str(path),
             str(src[side] / f"{lib}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    # the wrappers' own libraries (build/repro_torch/<hash>/), meanwhile
    build.build(("assignment", "fused_lloyd"))
    for job, proc in procs.items():
        log, _ = proc.communicate()
        jobs[job].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            print(f"nvcc failed for {job}:\n{log}", file=sys.stderr)
            return 1
    ok = True
    cuobjdump = str(Path(nvcc).parent / "cuobjdump")
    for lib in LIBS:
        funs = {side: sass_functions(cuobjdump, jobs[(side, lib)])
                for side in src}
        same = [f for f, ins in funs["other"].items()
                if funs["this"].get(f) == ins]
        new = sorted(set(funs["this"]) - set(funs["other"]))
        stray = [f for f in new if not re.search(TC_KERNELS, f)]
        print(f"{lib}.cu: {len(same)} of {len(funs['other'])} kernels with "
              f"the other's SASS; new here: {len(new)} (not the tensor-core "
              f"sweep's: {stray})")
        ok = ok and len(same) == len(funs["other"]) and not stray
        for f in new:
            counts = opcode_counts(funs["this"][f])
            print(f"  {f}: {len(funs['this'][f])} instructions, HGMMA "
                  f"{sum(n for op, n in counts.items() if op.startswith('HGMMA'))},"
                  f" HMMA {sum(n for op, n in counts.items() if op.startswith('HMMA'))}"
                  "; " + ", ".join(f"{op} {n}"
                                   for op, n in counts.most_common(16)))
        for f, rep in cs.ptxas_report(jobs[("this", lib)],
                                      TC_KERNELS).items():
            print(f"  ptxas {f}: {rep}")
    sys.stdout.flush()

    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs = {side: ctypes.CDLL(str(jobs[(side, "assignment")]))
            for side in src}
    for lib in libs.values():
        lib.assignment_launch.argtypes = [p, i, ll, p, i, i, i, i, i, i, p,
                                          p, p, p]
        lib.assignment_launch.restype = i
        lib.assignment_scratch_floats.argtypes = [i] * 3
        lib.assignment_scratch_floats.restype = ll
    dev = torch.device("cuda")
    bufs = {}

    def launch(side, xx, cc):
        n, d = xx.shape
        k = cc.shape[0]
        key = (side, n, k, d)
        if key not in bufs:
            bufs[key] = (torch.empty(n, dtype=torch.int32, device=dev),
                         torch.empty(n, device=dev),
                         torch.empty(libs[side].assignment_scratch_floats(
                             1, k, d), device=dev))
        lab, mind, scratch = bufs[key]
        code = {torch.float32: 0, torch.bfloat16: 1}
        rc = libs[side].assignment_launch(
            xx.data_ptr(), code[xx.dtype], 0, cc.data_ptr(), code[cc.dtype],
            1, n, k, d, 0, scratch.data_ptr(), lab.data_ptr(),
            mind.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{side} launch failed: CUDA error {rc}")
        return lab, mind

    def same_bits(label, xx, cc):
        a = [t.clone() for t in launch("other", xx, cc)]
        b = launch("this", xx, cc)
        eq = torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        print(f"  {label}: bit-equal to the other side {eq}", flush=True)
        return eq

    def tc_check(label, xb, cb, w=None):
        """The tensor-core contract at one shape; -> (worst near-tie gap,
        min-distance error relative to |x|^2 + max |c|^2)."""
        got = F.fused_lloyd(xb, cb, w)
        lab, mind = A.assignment(xb, cb)
        want = F.fused_lloyd_plain(xb, cb, w)
        agree, gap = ref.tie_gap(got[0][None], want[0][None], xb, cb[None])
        xf, cf = xb.float(), cb.float()
        scale = (torch.sum(xf * xf, -1) + torch.sum(cf * cf, -1).max()
                 ).clamp_min(1.0)
        err = float(((got[1] - want[1]).abs() / scale).max())
        e_rel = float((got[4] - want[4]).abs() / want[4].abs())
        one = torch.equal(lab, got[0]) and torch.equal(mind, got[1])
        again = F.fused_lloyd(xb, cb, w)
        rep = all(torch.equal(a, b) for a, b in zip(again, got))
        print(f"  tensor cores [{label}]: labels agree {agree!r} (near-tie "
              f"gap {gap!r}), min_sqdist {err!r} of |x|^2 + max |c|^2, "
              f"energy {e_rel!r} relative to the plain one; assignment = "
              f"fused {one}, relaunch equal {rep}", flush=True)
        return (agree == 1.0 or gap <= ref.NEAR_TIE) and err <= 1e-5 \
            and one and rep

    def cross_error(d, n=4096, k=256, seed=0):
        gen = torch.Generator(device=dev).manual_seed(seed)
        x = (torch.randn(n, d, generator=gen, device=dev)
             + torch.randn(1, d, generator=gen, device=dev)).bfloat16()
        c = x[torch.randperm(n, generator=gen, device=dev)[:k]]
        c = (c.float() + 0.1 * torch.randn(c.shape, generator=gen,
                                           device=dev)).bfloat16()[None]
        got = A.cross_terms(x, c)[0].double()
        xd, cd = x.double(), c[0].double()
        want = xd @ cd.T
        nx, nc = torch.sum(xd * xd, -1), torch.sum(cd * cd, -1)
        err = (got - want).abs()
        by_norms = float((err / (nx.sqrt()[:, None] * nc.sqrt()[None])).max())
        by_sq = float((err / (nx[:, None] + nc[None])).max())
        bias = float(((got - want) / (nx.sqrt()[:, None]
                                      * nc.sqrt()[None])).mean())
        print(f"  cross terms at d={d} ({n} x {k}): largest error "
              f"{by_norms!r} of |x| |c|, {by_sq!r} of |x|^2 + |c|^2; mean "
              f"signed error {bias!r} of |x| |c|", flush=True)
        return by_norms

    print("bits of the f32 and mixed launches against the other side:")
    x = torch.from_numpy(make_dataset(cs.MAIN_N_NAME)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    c = x[torch.randperm(x.shape[0], generator=gen,
                         device=dev)[:cs.MAIN_K]].contiguous()
    xb, cb = x.bfloat16(), c.bfloat16()
    rows = [("chunk", slice(0, CHUNK))]
    if not args.quick:
        rows.append(("all rows", slice(None)))
    for label, sl in rows:
        ok = same_bits(f"USCensus1990 f32 {label}", x[sl], c) and ok
        ok = same_bits(f"USCensus1990 bf16 X, f32 C {label}", xb[sl],
                       c) and ok
    print("the tensor-core sweep against the plain version:")
    for d, k in ((1, 37), (69, 1000), (80, 257), (821, 256), (822, 1000),
                 (4096, 257)):
        xs = x[:5000, :min(d, 69)]
        if d > 69:
            xs = torch.cat([xs] * (d // 69 + 1), dim=1)[:, :d]
        xs = xs.contiguous()
        cs_ = xs[torch.randperm(5000, generator=gen, device=dev)[:k]]
        ok = tc_check(f"N=5000, d={d}, K={k}", xs.bfloat16(),
                      cs_.bfloat16().contiguous()) and ok
    for d in (69, 821, 4096):
        cross_error(d)
    if args.quick:
        print(f"tc_sweep_probe (quick): {'ok' if ok else 'FAILED'}")
        return 0 if ok else 1

    ok = tc_check("USCensus1990, K=1000, all rows", xb, cb) and ok

    def library_mm(xx, cc, csq):
        """torch.mm with f32 output on the bf16 operands, the epilogue and
        argmin; None where torch lacks the overload."""
        try:
            prod = torch.mm(xx, cc.T, out_dtype=torch.float32)
        except (RuntimeError, TypeError):
            return None
        xf = xx.float()
        dist = torch.clamp_min(torch.sum(xf * xf, -1, keepdim=True)
                               - 2.0 * prod + csq, 0.0)
        return torch.argmin(dist, dim=1)

    def upcast(xx, cc, csq):
        return torch.argmin(torch.addmm(csq, xx.float(), cc.float().T,
                                        alpha=-2.0), dim=1)

    def turns(label, xx, cc, iters):
        cf = cc.float()
        csq = torch.sum(cf * cf, -1)
        has_mm = library_mm(xx[:128], cc, csq) is not None
        fns = {"this": lambda j: launch("this", xx, cc),
               "other": lambda j: launch("other", xx, cc),
               "upcast addmm": lambda j: upcast(xx, cc, csq)}
        if has_mm:
            fns["mm f32 out"] = lambda j: library_mm(xx, cc, csq)
        order = [f for f in ("mm f32 out", "upcast addmm") if f in fns]
        order = order + ["other", "this", "this", "other"] + order[::-1]
        got = collections.defaultdict(list)
        for name in order:
            got[name].append(cs.event_ms(torch, fns[name], iters, warmup=1))
        print(f"  {label} ms in turns: " + "; ".join(
            f"{name} {ts!r}" for name, ts in got.items())
            + ("" if has_mm else "; torch.mm(out_dtype=float32): not in "
               "this torch"), flush=True)

    print("times, bf16 X and C:")
    turns("USCensus1990 K=1000 all rows", xb, cb, 10)
    turns("USCensus1990 K=1000 chunk", xb[:CHUNK], cb, 100)
    del x, xb
    table = cs.wide_table(torch, dev, cs.LLAMA_VOCAB, cs.LLAMA_HIDDEN,
                          cs.WIDE_COMPONENTS)
    tb = table.to(torch.bfloat16)
    for k in (256, 1000):
        ck = table[torch.randperm(table.shape[0], generator=gen,
                                  device=dev)[:k]].contiguous()
        ok = same_bits(f"wide f32 K={k} chunk", table[:CHUNK], ck) and ok
        ok = tc_check(f"wide K={k}, all rows", tb, ck.bfloat16()) and ok
        turns(f"wide K={k} all rows", tb, ck.bfloat16(), 5)
        turns(f"wide K={k} chunk", tb[:CHUNK], ck.bfloat16(), 50)
    print(f"tc_sweep_probe: {'ok' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
