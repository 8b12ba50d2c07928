#!/usr/bin/env python3
"""Bounded streamed sweep probe: this checkout's bounded step
(csrc/fused_bounds.cu; past the resident X tile csrc/sweep_bounded.cuh)
against another checkout's, as each builds from its own sources, on one
NVIDIA GPU.

    mkdir -p build/parent
    git archive <commit> src/repro_torch/kernels/csrc | tar -x -C build/parent
    python3 scripts/bounds_stream_probe.py build/parent [--quick]

Both sides' fused_bounds.cu, fused_lloyd.cu and assignment.cu are built
with nvcc into build/repro_torch/probe/ (git-ignored), in parallel, each
beside its compiler log.  Then:

- SASS (``cuobjdump -sass``, instructions only) of the resident kernels:
  ``bounds_tiles`` (the resident bounded sweep; a template argument of the
  other side's name that this side dropped is ignored) must be identical;
  ``assign_tiles`` (the assignment and the fused step) is compared and
  its differing instructions are printed.  ptxas' registers and spills of
  this side's streamed kernel (``bounds_stream``, which must not spill)
  and the other side's streamed ``bounds_tiles``.
- Bits: on Meta-Llama-3-8B's embedding table (128,256 x 4096 f32, drawn
  on the card as chip_smoke.py's phase 18 draws it) and on its four
  1024-wide subspaces as one R = 4 launch, the streamed bounded launches
  of both sides at K = 256 and 1000, gs 16, from the initial carry (skip
  0) and from bounds carried one ``fused_bounds`` engine step on rows
  sorted by label, with f32, bf16 and mixed operands (bf16 X against f32
  C, and the reverse): every output (labels, min distances, sums,
  counts, energy, group minima, skipped share) equal.  The assignment's
  resident (USCensus1990 stand-in, K = 1000) and streamed (the table,
  K = 256) launches of both sides equal too.
- Times (CUDA events, in turns: other, this, this, other) of the
  streamed bounded step, with this side's fused step in the same turns.

``--quick`` runs the bits on the table's first 16,384 rows and times
nothing.  Prints the card's name and power limit first.  Exits non-zero
without a CUDA device or when a check fails.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import difflib
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

LIBS = ("fused_bounds", "fused_lloyd", "assignment")
GS = 16
WARM_STEPS = 3   # Lloyd steps from random rows to the centroids timed


def resident_name(name: str) -> str:
    """A bounds_tiles kernel's name without the trailing ``false``
    template argument (the streamed flag this side dropped)."""
    return re.sub(r"(bounds_tilesILb[01]E(?:f|13__nv_bfloat16))Lb0E",
                  r"\1", name)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("other", type=Path)
    parser.add_argument("--quick", action="store_true")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bounds_stream_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from chip_smoke import sass_functions
    from repro_torch.core import get_backend
    from repro_torch.core import applications as app
    from repro_torch.core.backends import bounds
    from repro_torch.core.backends.fused_bounds import squared_bounds
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.kernels import assignment as A
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
    cuobjdump = str(Path(nvcc).parent / "cuobjdump")
    for side, pattern in (("this", "bounds_stream"),
                          ("other", "bounds_tiles")):
        for f, rep in cs.ptxas_report(jobs[(side, "fused_bounds")],
                                      pattern).items():
            print(f"ptxas, {side}: {f}: {rep}")
            if side == "this" and rep.get("spill_stores", 0) + rep.get(
                    "spill_loads", 0) > 0:
                print("  the streamed bounded kernel spills")
                ok = False
    for lib in LIBS:
        funs = {side: sass_functions(cuobjdump, jobs[(side, lib)])
                for side in src}
        for f, ins in funs["other"].items():
            if "bounds_tiles" in f and "Lb1EE" not in f:
                mine = funs["this"].get(resident_name(f))
                same = mine == ins
                print(f"{lib}.cu {resident_name(f)}: {len(ins)} "
                      f"instructions, identical SASS {same}")
                ok = ok and same
            elif "assign_tiles" in f:
                mine = funs["this"].get(f, [])
                diff = [line for line in difflib.unified_diff(
                    ins, mine, lineterm="", n=0)
                    if line[:1] in "+-" and line[:3] not in ("+++", "---")]
                print(f"{lib}.cu {f}: {len(ins)} / {len(mine)} "
                      f"instructions, identical SASS {ins == mine}"
                      + ("" if ins == mine else
                         f"; differing: {diff[:12]}"))
    sys.stdout.flush()

    libs = {side: {lib: ctypes.CDLL(str(jobs[(side, lib)])) for lib in LIBS}
            for side in src}

    def use(side):
        build._loaded.update(libs[side])

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    n = 16384 if args.quick else cs.LLAMA_VOCAB
    table = cs.wide_table(torch, dev, cs.LLAMA_VOCAB, cs.LLAMA_HIDDEN,
                          cs.WIDE_COMPONENTS)[:n].contiguous()
    blocks = app._subspace_blocks(table, cs.WIDE_SUBSPACES)
    gen = torch.Generator(device=dev).manual_seed(1)
    use("this")

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

    def carried(xx, c, k):
        """Rows sorted by label, and the bounds one fused_bounds engine
        step leaves from c: -> (sorted X, the step's centroids, bounds)."""
        lab = F.fused_lloyd(xx, c)[0]
        order = torch.argsort(lab, dim=-1, stable=True)
        if xx.dim() == 2:
            xs = xx[order[0]].contiguous()
        else:
            xs = torch.gather(xx, 1, order[..., None].expand(
                -1, -1, xx.shape[-1])).contiguous()
        bk = get_backend("fused_bounds", group_size=GS)
        carry = bk.batched_init_carry(xs, c, k)
        res, carry = bk.batched_step(xs, c, k, carry)
        c2 = bk.centroids_from_step(xs, res, k, c)
        return xs, c2, squared_bounds(carry, c2, k, GS)

    def launch(side, xx, cc, bnds):
        use(side)
        out = F.fused_lloyd(xx, cc, bounds=bnds, gs=GS, _stream=True)
        use("this")
        return out

    cases = {}
    for where, xx in (("table", table), ("subspaces", blocks)):
        for k in (256, 1000):
            c = warm(xx, k)
            r = c.shape[0]
            init = squared_bounds(bounds.init_carry(xx, c, k, GS), c, k, GS)
            xs, c2, moved = carried(xx, c, k)
            cases[(where, k, "skip 0")] = (xx, c, init)
            cases[(where, k, "carried")] = (xs, c2, moved)
            print(f"{where} {tuple(xx.shape)}, K = {k}, R = {r}: skipped "
                  f"share of the carried step "
                  f"{float(launch('this', xs, c2, moved)[6].mean())!r}",
                  flush=True)
    types = {"f32": (torch.float32, torch.float32),
             "bf16": (bf16, bf16),
             "bf16 X, f32 C": (bf16, torch.float32),
             "f32 X, bf16 C": (torch.float32, bf16)}
    for (where, k, how), (xx, c, bnds) in cases.items():
        for tname, (tx, tc) in types.items():
            xt, ct = xx.to(tx), c.to(tc)
            a = [t.clone() for t in launch("other", xt, ct, bnds)]
            b = launch("this", xt, ct, bnds)
            eq = all(torch.equal(p, q) for p, q in zip(a, b))
            print(f"  {where}, K = {k}, {how}, {tname}: every output "
                  f"bit-equal {eq}", flush=True)
            ok = ok and eq
            del xt, ct
    # the assignment: both sides' launches on ordinary rows
    x69 = torch.from_numpy(make_dataset(cs.MAIN_N_NAME)).to(dev)
    if args.quick:
        x69 = x69[:16384].contiguous()
    c69 = x69[torch.randperm(x69.shape[0], generator=gen,
                             device=dev)[:cs.MAIN_K]].contiguous()
    c256 = table[torch.randperm(n, generator=gen, device=dev)[:256]]
    for what, xx, cc in (("resident, USCensus1990", x69, c69),
                         ("streamed, the table", table, c256)):
        got = {}
        for side in src:
            use(side)
            got[side] = [t.clone() for t in A.assignment(xx, cc)]
        use("this")
        eq = all(torch.equal(p, q) for p, q in zip(got["other"],
                                                    got["this"]))
        print(f"  the assignment, {what}: bit-equal {eq}", flush=True)
        ok = ok and eq
    del x69, c69
    if args.quick:
        return 0 if ok else 1

    # times in turns
    timed = {}
    for key in (("table", 256, "skip 0"), ("subspaces", 256, "skip 0"),
                ("table", 1000, "skip 0"), ("table", 256, "carried"),
                ("subspaces", 256, "carried")):
        xx, c, bnds = cases[key]
        for tname in ("f32", "bf16") if key[1] == 256 else ("f32",):
            tx = types[tname][0]
            xt, ct = xx.to(tx), c.to(tx)
            label = f"{key[0]}, K = {key[1]}, {key[2]}, {tname}"
            fused = (lambda i, xt=xt, ct=ct: F.fused_lloyd(xt, ct))
            got = collections.defaultdict(list)
            for side in ("other", "this", "this", "other"):
                got[side].append(cs.event_ms(
                    torch, lambda i, side=side, xt=xt, ct=ct, bnds=bnds:
                    launch(side, xt, ct, bnds), 5 if key[1] == 256 else 3,
                    warmup=1))
                got["fused"].append(cs.event_ms(torch, fused,
                                                5 if key[1] == 256 else 3,
                                                warmup=1))
            mean = {s: sum(v) / len(v) for s, v in got.items()}
            timed[label] = mean
            print(f"  {label}: ms in turns " + "; ".join(
                f"{s} {v!r}" for s, v in got.items())
                + f"; this / other {mean['this'] / mean['other']!r}, this"
                f" / the fused step {mean['this'] / mean['fused']!r}",
                flush=True)
            del xt, ct
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
