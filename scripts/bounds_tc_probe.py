#!/usr/bin/env python3
"""Bounded tensor-core sweep probe: this checkout's bounded step
(csrc/fused_bounds.cu; on bf16 X and C with gs a multiple of 8 the
tensor-core sweep of csrc/sweep_tc.cuh, ``bounds_tc``) against another
checkout's, as each builds from its own sources, on one NVIDIA GPU.

    mkdir -p build/parent
    git archive <commit> src/repro_torch/kernels/csrc | tar -x -C build/parent
    python3 scripts/bounds_tc_probe.py build/parent [--quick]

Both sides' fused_bounds.cu and fused_lloyd.cu are built with nvcc into
build/repro_torch/probe/ (git-ignored), in parallel, each beside its
compiler log.  Then:

- ptxas' registers, spills and stack of this side's ``bounds_tc``
  kernels (none may spill or keep a stack frame).
- Bits: the bounded launches that keep the FP32 sweeps (f32 operands,
  bf16 X against f32 C and the reverse, and bf16 X and C at gs 12, not a
  multiple of 8) equal the other side's in every output, on the
  USCensus1990 stand-in (2,458,285 x 69) at K = 1000 and on
  Meta-Llama-3-8B's embedding table (128,256 x 4096 f32, drawn on the
  card as chip_smoke.py's phase 18 draws it) at K = 256, from the initial
  carry and from carried bounds.
- The tensor-core contract of this side's bf16 launches against the plain
  version (chip_smoke.py's compare_wide and accept_wide) on 16,384 rows of
  each case, and the anchor (ub^2 = +inf, lb^2 = 0) at all rows: the bf16
  fused step's five outputs bit for bit.
- Times (CUDA events, in turns: other, this, this, other, with this
  side's bf16 fused step in every turn) of the bf16 bounded step: at
  USCensus1990, K = 1000, the default groups (G = 2) from the initial
  carry (skip 0) and gs 64 on rows sorted by label from carried bounds;
  on the table, gs 16, at K = 256 and 1000 from the initial carry and at
  K = 256 carried on sorted rows; on the table's four 1024-wide subspaces
  (one R = 4 launch) at K = 256, initial and carried.  Each case prints
  its skipped share.

``--quick`` checks on the first 16,384 rows of each X and times nothing.
Prints the card's name and power limit first.  Exits non-zero without a
CUDA device or when a check fails.
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

LIBS = ("fused_bounds", "fused_lloyd")
WARM_STEPS = 3   # Lloyd steps from random rows to the centroids timed
CHECK_ROWS = 16384


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("other", type=Path)
    parser.add_argument("--quick", action="store_true")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bounds_tc_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import get_backend
    from repro_torch.core import applications as app
    from repro_torch.core.backends import bounds
    from repro_torch.core.backends.fused_bounds import (engine_group_size,
                                                        squared_bounds)
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_lloyd as F

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
    for job, proc in procs.items():
        log, _ = proc.communicate()
        jobs[job].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            print(f"nvcc failed for {job}:\n{log}", file=sys.stderr)
            return 1
    ok = True
    report = cs.ptxas_report(jobs[("this", "fused_bounds")], "bounds_tc")
    for f, rep in report.items():
        print(f"ptxas, this: {f}: {rep}")
    if not report or any(r.get("spill_stores", 0) + r.get("spill_loads", 0)
                         + r.get("stack", 0) for r in report.values()):
        print("  a bounded tensor-core kernel spills or keeps a stack frame")
        ok = False
    sys.stdout.flush()

    libs = {side: {lib: ctypes.CDLL(str(jobs[(side, lib)])) for lib in LIBS}
            for side in src}

    def use(side):
        build._loaded.update(libs[side])

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    tile_rows = build.tile_rows()
    gen = torch.Generator(device=dev).manual_seed(1)
    use("this")
    x69 = torch.from_numpy(make_dataset(cs.MAIN_N_NAME)).to(dev)
    n_wide = CHECK_ROWS if args.quick else cs.LLAMA_VOCAB
    table = cs.wide_table(torch, dev, cs.LLAMA_VOCAB, cs.LLAMA_HIDDEN,
                          cs.WIDE_COMPONENTS)[:n_wide].contiguous()
    if args.quick:
        x69 = x69[:CHECK_ROWS].contiguous()
    blocks = app._subspace_blocks(table, cs.WIDE_SUBSPACES)

    def warm(xx, k):
        """Centroids after WARM_STEPS Lloyd steps from k random rows of
        each problem (xx (N, d) or (R, N, d)) -> (R, k, d)."""
        xb = xx if xx.dim() == 3 else xx[None]
        c = torch.stack([p[torch.randperm(p.shape[0], generator=gen,
                                          device=dev)[:k]] for p in xb])
        for _ in range(WARM_STEPS):
            out = F.fused_lloyd(xx, c)
            fill = out[3][..., None] > 0
            c = torch.where(fill, out[2] / out[3][..., None].clamp_min(1.0),
                            c)
        return c.contiguous()

    def initial(xx, c, k, gs):
        return xx, c, squared_bounds(bounds.init_carry(xx, c, k, gs), c, k,
                                     gs)

    def carried(xx, c, k, gs):
        """Rows sorted by label, and the bounds one fused_bounds engine
        step leaves from c: -> (sorted X, the step's centroids, bounds)."""
        lab = F.fused_lloyd(xx, c)[0]
        order = torch.argsort(lab, dim=-1, stable=True)
        if xx.dim() == 2:
            xs = xx[order[0]].contiguous()
        else:
            xs = torch.gather(xx, 1, order[..., None].expand(
                -1, -1, xx.shape[-1])).contiguous()
        bk = get_backend("fused_bounds", group_size=gs)
        carry = bk.batched_init_carry(xs, c, k)
        res, carry = bk.batched_step(xs, c, k, carry)
        c2 = bk.centroids_from_step(xs, res, k, c)
        return xs, c2, squared_bounds(carry, c2, k, gs)

    def launch(side, xx, cc, bnds, gs):
        use(side)
        out = F.fused_lloyd(xx, cc, bounds=bnds, gs=gs)
        use("this")
        return out

    k69 = cs.MAIN_K
    gs69 = engine_group_size(k69)
    c69 = warm(x69, k69)
    cases = {
        ("USCensus1990", k69, gs69, "skip 0"): initial(x69, c69, k69, gs69),
        ("USCensus1990 sorted", k69, 64, "carried"):
            carried(x69, c69, k69, 64)}
    for where, xx in (("table", table), ("subspaces", blocks)):
        for k in (256, 1000) if where == "table" else (256,):
            c = warm(xx, k)
            cases[(where, k, 16, "skip 0")] = initial(xx, c, k, 16)
            if k == 256:
                cases[(where, k, 16, "carried")] = carried(xx, c, k, 16)
    skips = {}
    for key, (xx, c, bnds) in cases.items():
        skips[key] = float(launch("this", xx.to(bf16), c.to(bf16), bnds,
                                  key[2])[6].mean())
        print(f"{key}: X {tuple(xx.shape)}, G {bnds[1].shape[-1]}, skipped "
              f"share {skips[key]!r}", flush=True)

    # the FP32 routes: both sides' bits
    types = {"f32": (torch.float32, torch.float32),
             "bf16 X, f32 C": (bf16, torch.float32),
             "f32 X, bf16 C": (torch.float32, bf16),
             "bf16, gs 12": (bf16, bf16)}
    for key, (xx, c, bnds) in cases.items():
        if key[0] == "subspaces" or key[1] == 1000 and key[0] == "table":
            continue
        for tname, (tx, tc) in types.items():
            xt, ct = xx.to(tx), c.to(tc)
            gs, b = key[2], bnds
            if tname == "bf16, gs 12":
                gs = 12
                b = squared_bounds(bounds.init_carry(xt, ct.float(), key[1],
                                                     gs), ct.float(), key[1],
                                   gs)
            a = [t.clone() for t in launch("other", xt, ct, b, gs)]
            got = launch("this", xt, ct, b, gs)
            eq = all(torch.equal(p, q) for p, q in zip(a, got))
            print(f"  {key}, {tname}: every output bit-equal to the other "
                  f"side's {eq}", flush=True)
            ok = ok and eq
            del xt, ct, a, got

    # this side's tensor-core contract, and the anchor
    for key, (xx, c, bnds) in cases.items():
        sl = slice(0, CHECK_ROWS)
        xb = xx[..., sl, :].contiguous().to(bf16)
        cb = c.to(bf16)
        bs = tuple(t[..., sl].contiguous() if t.dim() == bnds[0].dim()
                   else t[..., sl, :].contiguous() for t in bnds)
        before = F.bounds_tc_launches
        got = F.fused_lloyd(xb, cb, bounds=bs, gs=key[2])
        res = cs.compare_wide(torch, got, F.fused_bounds_plain(
            xb, cb, None, *bs, key[2], tile_rows), xb, cb, None,
            bounds=(bs[1], bs[2]), tile_rows=tile_rows)
        print(f"  {key}, bf16 on {CHECK_ROWS} rows: {cs.fmt_bounds(res)}; "
              f"on the tensor cores {F.bounds_tc_launches - before}",
              flush=True)
        try:
            cs.accept_wide(res, str(key))
        except cs.PhaseError as e:
            print(f"  FAILED: {e}")
            ok = False
        ok = ok and F.bounds_tc_launches == before + 1
    for what, xx, c, gs in (("USCensus1990", x69, c69, gs69),
                            ("table", table, cases[("table", 256, 16,
                                                    "skip 0")][1], 16)):
        xb, cb = xx.to(bf16), c.to(bf16)
        k = c.shape[-2]
        n = xx.shape[0]
        lab0 = torch.randint(0, k, (1, n), generator=gen, device=dev,
                             dtype=torch.int32)
        anchor = (lab0, torch.zeros((1, n, -(-k // gs)), device=dev),
                  torch.full((1, n), float("inf"), device=dev))
        got = F.fused_lloyd(xb, cb, bounds=anchor, gs=gs)
        eq = all(torch.equal(p, q) for p, q in zip(got[:5],
                                                    F.fused_lloyd(xb, cb)))
        eq_g = torch.equal(got[5].amin(dim=-1), got[1])
        print(f"  the anchor, {what}: the bf16 fused step's outputs bit for "
              f"bit {eq}, least group minimum = distance {eq_g}", flush=True)
        ok = ok and eq and eq_g
    if args.quick:
        print(f"bounds_tc_probe (quick): {'ok' if ok else 'FAILED'}")
        return 0 if ok else 1

    # times in turns
    for key, (xx, c, bnds) in cases.items():
        xt, ct = xx.to(bf16), c.to(bf16)
        iters = 5 if key[1] == 256 or key[0].startswith("USC") else 3
        fused = (lambda i, xt=xt, ct=ct: F.fused_lloyd(xt, ct))
        got = collections.defaultdict(list)
        for side in ("other", "this", "this", "other"):
            got[side].append(cs.event_ms(
                torch, lambda i, side=side, xt=xt, ct=ct, bnds=bnds, gs=key[2]:
                launch(side, xt, ct, bnds, gs), iters, warmup=1))
            got["fused"].append(cs.event_ms(torch, fused, iters, warmup=1))
        mean = {s: sum(v) / len(v) for s, v in got.items()}
        print(f"  {key}, bf16 (skipped {skips[key]!r}): ms in turns "
              + "; ".join(f"{s} {v!r}" for s, v in got.items())
              + f"; this / other {mean['this'] / mean['other']!r}, this / "
              f"the bf16 fused step {mean['this'] / mean['fused']!r}",
              flush=True)
        del xt, ct
    print(f"bounds_tc_probe: {'ok' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
