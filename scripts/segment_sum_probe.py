#!/usr/bin/env python3
"""bf16 segment-sum probe: this checkout's segment sum over a bf16 X
(csrc/segment_sum_bf16.cuh, ``sum16::slabs``) against another checkout's
(which may run the float32 kernel on a bf16 X), as each builds from its
own sources, on one NVIDIA GPU.

    mkdir -p build/parent
    git archive <commit> src/repro_torch/kernels/csrc | tar -x -C build/parent
    python3 scripts/segment_sum_probe.py build/parent [--quick]

Both sides' update.cu, fused_lloyd.cu and fused_bounds.cu are built with
nvcc into build/repro_torch/probe/ (git-ignored), in parallel.  Then:

- SASS (``cuobjdump -sass``, instructions only): every kernel of the other
  side's three libraries but its bf16 ``update_slabs`` is in this side's
  with the same instructions, and this side's other kernels are the bf16
  segment sum's (``sum16``); their ptxas registers, spills and stack
  (none may spill or keep a stack frame), and the FFMA count of each side's
  float32 ``update_slabs`` (0: its products and sums round apart).  (The
  other side may hold another design of the bf16 segment sum: its
  launcher then takes the bf16 layout, with the other side's geometry.)
- Bits: this side's bf16 update equals the other side's bf16 update bit
  for bit (sums and counts) on the USCensus1990 stand-in (2,458,285 x 69)
  at K = 1000 and on Meta-Llama-3-8B's embedding table (128,256 x 4096,
  drawn on the card as chip_smoke.py's phase 18 draws it) at K = 256,
  each with the labels of centroids after three Lloyd steps, on the rows
  as drawn and sorted by label, unweighted and (USCensus1990) weighted.
- Times (CUDA events, in turns: other, this, this, other, with
  ``index_add_`` of the upcast X in every turn) of the bf16 update in
  each of those cases.

``--quick`` checks on the first 16,384 rows of each X and times nothing;
``--update-only`` builds and compares update.cu alone.
Prints the card's name and power limit first.  Exits non-zero without a
CUDA device or when a check fails.
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

LIBS = ("update", "fused_lloyd", "fused_bounds")
NEW_KERNELS = r"sum16"
WARM_STEPS = 3   # Lloyd steps from random rows to the centroids labelled
CHECK_ROWS = 16384


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("other", type=Path)
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--update-only", action="store_true",
                        help="build and compare update.cu alone")
    args = parser.parse_args()
    libs = LIBS[:1] if args.update_only else LIBS
    import torch
    if not torch.cuda.is_available():
        print("segment_sum_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from chip_smoke import opcode_counts, sass_functions
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.kernels import build, tiles
    from repro_torch.kernels import fused_lloyd as F
    from repro_torch.kernels import update as U

    print(cs.nvidia_smi_line(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    nvcc = build._nvcc()
    probe_dir = build.BUILD_ROOT / "probe"
    src = {"other": args.other / "src/repro_torch/kernels/csrc",
           "this": build.CSRC}
    jobs = {(side, lib): probe_dir / side / f"lib{lib}.so"
            for side in src for lib in libs}
    procs = {}
    for (side, lib), path in jobs.items():
        path.parent.mkdir(parents=True, exist_ok=True)
        procs[(side, lib)] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-o", str(path),
             str(src[side] / f"{lib}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    # the wrappers' own libraries (build/repro_torch/<hash>/), meanwhile
    build.build(("update", "fused_lloyd"))
    for job, proc in procs.items():
        log, _ = proc.communicate()
        jobs[job].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            print(f"nvcc failed for {job}:\n{log}", file=sys.stderr)
            return 1
    ok = True
    cuobjdump = str(Path(nvcc).parent / "cuobjdump")
    for lib in libs:
        funs = {side: sass_functions(cuobjdump, jobs[(side, lib)])
                for side in src}
        gone = [f for f in funs["other"]
                if "update_slabs" in f and "bfloat16" in f]
        kept = [f for f in funs["other"] if f not in gone]
        same = [f for f in kept if funs["this"].get(f) == funs["other"][f]]
        new = sorted(set(funs["this"]) - set(funs["other"]))
        stray = [f for f in new if not re.search(NEW_KERNELS, f)]
        print(f"{lib}.cu: {len(same)} of the other's {len(kept)} kernels "
              f"(its bf16 update_slabs apart: {len(gone)}) with the same "
              f"SASS; new here: {new} (not the bf16 segment sum's: {stray})")
        ok = ok and len(same) == len(kept) and not stray and len(new) == 1
        for side in src:
            for f, ins in funs[side].items():
                if "update_slabs" in f and "bfloat16" not in f:
                    print(f"  {side}: the f32 update_slabs FFMA "
                          f"{opcode_counts(ins).get('FFMA', 0)}, FMUL "
                          f"{opcode_counts(ins).get('FMUL', 0)}, FADD "
                          f"{opcode_counts(ins).get('FADD', 0)}")
        for f in new:
            counts = opcode_counts(funs["this"][f])
            print(f"  {f}: {len(funs['this'][f])} instructions; "
                  + ", ".join(f"{op} {n}" for op, n in
                              counts.most_common(20)))
        report = cs.ptxas_report(jobs[("this", lib)], NEW_KERNELS)
        print(f"  ptxas, this: {report}")
        if len(report) != 1 or any(
                r.get("spill_stores", 0) + r.get("spill_loads", 0)
                + r.get("stack", 0) for r in report.values()):
            print("  the bf16 segment sum spills, keeps a stack frame or is "
                  "not there")
            ok = False
    sys.stdout.flush()

    # the other side's update, called with its own launcher and layout:
    # before the bf16 segment sum, tiles.update_layout with its geometry
    # (it sums a bf16 X on the float32 layout); with one (another design
    # of it), tiles.update_bf16_layout with its bf16 geometry
    p, i = ctypes.c_void_p, ctypes.c_int
    other = ctypes.CDLL(str(jobs[("other", "update")]))
    has16 = hasattr(other, "update_bf16_geometry")
    other.update_launch.argtypes = [p, i, ctypes.c_longlong, p, p] \
        + [i] * (13 if has16 else 12) + [p, p, p, p]
    other.update_launch.restype = i
    U.bind_geometry(other)
    geom = (ctypes.c_int * 4)()
    other.update_geometry(geom)
    geom16 = (ctypes.c_int * 6)()
    if has16:
        other.update_bf16_geometry(geom16)
    dev = torch.device("cuda")

    def launch_other(xx, lab, k, w):
        n, d = xx.shape
        lay = tiles.update_layout(n, 1, k, d, *geom)
        if has16:
            lay = tiles.update_bf16_layout(n, 1, k, d, lay, *geom16)
        f32 = dict(dtype=torch.float32, device=dev)
        sums = torch.empty((k, d), **f32)
        counts = torch.empty((k,), **f32)
        part = torch.empty((lay.slabs, k, d + 1), **f32)
        rc = other.update_launch(
            xx.data_ptr(), tiles.type_code(xx), 0, lab.data_ptr(),
            None if w is None else w.data_ptr(), 1, n, k, d, lay.groups,
            lay.width, lay.warps, lay.ranges, lay.range_k, lay.slabs,
            lay.tiles_per_slab, lay.smem_bytes,
            *((lay.stages,) if has16 else ()), part.data_ptr(),
            sums.data_ptr(), counts.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the other side's update failed: {rc}")
        return sums, counts

    gen = torch.Generator(device=dev).manual_seed(1)
    x69 = torch.from_numpy(make_dataset(cs.MAIN_N_NAME)).to(dev)
    n_wide = CHECK_ROWS if args.quick else cs.LLAMA_VOCAB
    table = cs.wide_table(torch, dev, cs.LLAMA_VOCAB, cs.LLAMA_HIDDEN,
                          cs.WIDE_COMPONENTS)[:n_wide].contiguous()
    if args.quick:
        x69 = x69[:CHECK_ROWS].contiguous()

    def labelled(xx, k):
        """The labels of xx at centroids after WARM_STEPS Lloyd steps from
        k random rows."""
        c = xx[torch.randperm(xx.shape[0], generator=gen, device=dev)[:k]]
        for _ in range(WARM_STEPS):
            out = F.fused_lloyd(xx, c)
            fill = out[3][:, None] > 0
            c = torch.where(fill, out[2] / out[3][:, None].clamp_min(1.0), c)
        return F.fused_lloyd(xx, c)[0]

    cases = {}
    for where, xx, k in (("USCensus1990", x69, cs.MAIN_K),
                         ("table", table, cs.WIDE_K)):
        lab = labelled(xx, k)
        order = torch.argsort(lab, stable=True)
        xb = xx.to(torch.bfloat16)
        cases[(where, k, "as drawn")] = (xb, lab, None)
        cases[(where, k, "sorted by label")] = (
            xb[order].contiguous(), lab[order].contiguous(), None)
        if where == "USCensus1990":
            w = torch.rand(xx.shape[0], generator=gen, device=dev) * 2
            cases[(where, k, "as drawn, weighted")] = (xb, lab, w)
    del x69, table
    lib = U._bind(build.load("update"))
    for key, (xb, lab, w) in cases.items():
        before = U.bf16_launches
        got = U.update(xb, lab, key[1], w)
        want = launch_other(xb, lab, key[1], w)
        eq = all(torch.equal(a, b) for a, b in zip(got, want))
        lay = U.layout(lib, xb.shape[0], 1, key[1], xb.shape[1],
                       torch.bfloat16)
        print(f"  {key}: X {tuple(xb.shape)}, this side's bf16 update "
              f"(layout {lay}) bit-equal to the other side's {eq}; bf16 "
              f"launches {U.bf16_launches - before}", flush=True)
        ok = ok and eq and U.bf16_launches == before + 1
    if args.quick:
        print(f"segment_sum_probe (quick): {'ok' if ok else 'FAILED'}")
        return 0 if ok else 1

    # times in turns, index_add_ of the upcast X in every turn
    for key, (xb, lab, w) in cases.items():
        k = key[1]
        lab_l = lab.long()
        sums_buf = torch.zeros(k, xb.shape[1], device=dev)
        got = collections.defaultdict(list)
        for side in ("other", "this", "this", "other"):
            fn = (lambda i: launch_other(xb, lab, k, w)) if side == "other" \
                else (lambda i: U.update(xb, lab, k, w))
            got[side].append(cs.event_ms(torch, fn, 10, warmup=2))
            got["index_add_"].append(cs.event_ms(
                torch, lambda i: sums_buf.index_add_(0, lab_l, xb.float()),
                10, warmup=2))
        mean = {s: sum(v) / len(v) for s, v in got.items()}
        print(f"  {key}: ms in turns " + "; ".join(
            f"{s} {v!r}" for s, v in got.items())
            + f"; this / other {mean['this'] / mean['other']!r}, this / "
            f"index_add_ {mean['this'] / mean['index_add_']!r}", flush=True)
    print(f"segment_sum_probe: {'ok' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
