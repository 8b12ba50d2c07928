#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the four CUDA kernels from src/repro_torch/kernels/csrc, in
     parallel;
  3. every kernel against its plain PyTorch version at small ragged,
     weighted, batched and wide shapes (the fused-bounds kernel on bounds
     of real drift-updated carries, with group sizes that do and do not
     divide 64, the default 512 at K = 1000 among them, and on
     cluster-ordered cases where most cells skip); the update at
     K = 20,000 (cluster ranges); the assignment on exact integer ties
     (the lowest index wins) and on a NaN row; two cases at the paper's
     Table 3 shapes (K = 10 on d = 2, K = 100 on d = 3);
  4. repeated launches of every case are bitwise equal;
  5. the main path at full size: AAKMeans(n_clusters=1000,
     backend="fused").fit(x).predict(x) on the USCensus1990 shape
     (2,458,285 x 69 f32); launch counts prove it ran on the kernels;
     both kernels against their plain versions on the final centroids,
     the assignment on a full and on the padded tail predict chunk;
     predict's labels equal to the fused step's, and the assignment
     kernel's labels and distances at all rows equal to the fused step's
     bit for bit;
  5a. the "pallas" path at full size: fit + predict from the same seed,
     one assignment and one update launch per step, ending at the fused
     fit's energy; both kernels against their plain versions at the
     fit's shapes;
  5b. the "fused_bounds" path at full size: the default groups (G = 2),
     then the cluster-ordered layout with 64-centroid groups, its skipped
     shares per trip; the kernel against its plain version on each run's
     last bounds;
  6. the dense oracle's fit from the same seeds at full size ends at the
     fused fit's energy;
  7. fused against dense trajectories at a mid size, every fused step
     redone by the dense oracle, every fused-bounds step by the fused
     kernel;
  8. kernel times (CUDA events) at the main path's shapes: the fused step,
     the pallas pair (the assignment at all rows and the update) and the
     bounded step at the default groups and at 64-centroid groups with
     nothing skipped and on the cluster-ordered run's last step, in turns
     (each time the mean of two turns in opposite orders), the fused
     step's time over the pair's; the assignment at predict's chunk;
     beside their bound, plain and library times; the dense oracle's
     one-hot stats against index_add_, and its step.  A distance kernel's bound is the lower of its FP32-core bound
     and its split-TF32 bound (three TF32 products per f32 product on the
     tensor cores); both are printed.
  9. the single-problem path at full size: aa_kmeans(backend="fused")
     from phase 5's seeds equals phase 5's fit bit for bit (it is the
     batched driver at R = 1); aa_kmeans_traced on an instrumented engine
     takes its iterations, with one pass for the init, one per accepted
     iteration, two per rejected one and one that detects convergence;
  10. the paper's Tables 2 and 3 at full size on the same data: Table 3's
     five cases (kmeans++, afk-mc2, bf, clarans at K = 10, clarans at
     K = 100, seeded on the card and timed apart), each as lloyd_kmeans
     against aa_kmeans on "dense" and as the same-engine pair on "fused";
     lloyd_iteration on pallas_lloyd_ops (the assignment and update
     kernels) against the dense ops; the traced fused_bounds engine at
     K = 100; Table 2's fixed and dynamic m at m0 = 2 and 5.  Energies
     finite, seeds (K, d) on the card, a converged Lloyd run's labels its
     centroids' assignment, each algorithm's fused and dense runs within
     1e-3; who wins is printed, not checked.  Then the fused step, the
     assignment and the update against their plain versions at each
     case's last AA centroids, and the bounded step with 16-centroid
     groups at K = 100, as phases 3 and 5 hold them;
Phases 9 and 10 run between phases 7 and 8, so that phase 8's kernel line
counts their launches.
Every path is driven with the launch counts set to 0 just before it and
read just after; the {"kernels": ...} line sums them over the paths.
Prints one {"kernels": [...]} line, the card's name and power limit, and
last {"ok": true, "device": {...}}.  Exits non-zero without that line
when there is no CUDA device or the port is not beside this script.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_FP32_PER_S = 67e12        # H100 SXM FP32, CUDA cores
PEAK_TF32_PER_S = 495e12       # H100 SXM TF32 tensor cores, dense
MAIN_N_NAME = "USCensus1990"   # 2,458,285 x 69 (the paper's Table 1)
MAIN_K = 1000

# (label, n, k, d, r, x per problem, weights: None | "n" | "rn")
CASES = [
    ("ragged", 1000, 37, 69, None, False, None),
    ("(N,) weights", 4097, 1000, 9, None, False, "n"),
    ("R=3 shared X", 3001, 130, 20, 3, False, None),
    ("R=3 per-problem X, (R,N) weights", 2001, 45, 33, 3, True, "rn"),
    ("wide d=385", 2000, 50, 385, None, False, None),
    ("wide d=561", 1500, 40, 561, 2, False, "rn"),
    ("K=1000, default groups", 3000, 1000, 69, None, False, "n"),
    ("R=2, K=700", 2500, 700, 40, 2, False, "rn"),
    ("Table 3: K=10, d=2", 5000, 10, 2, None, False, None),
    ("Table 3: K=100, d=3", 5000, 100, 3, None, False, "n"),
]
# group size of the fused-bounds kernel per case, none clipped by K (None:
# the engine's default, 512 at K = 1000, so G = 2); 24, 40 and 200 divide
# neither 64 (the row tile) nor K, groups of 200 straddle the 256-centroid
# chunk at K = 700, and 512 spans two chunks; at Table 3's shapes 8 gives
# G = 2 at K = 10 and 24 G = 5 at K = 100
CASE_GROUPS = (8, 24, 64, 40, 16, 24, None, 200, 8, 24)
# cluster-ordered cases: (K, rows per cluster, group size, the least
# skipped share); the owner's group never skips, so G = 2 skips < 1/2
ORDERED_CASES = ((64, 256, 8, 0.5), (1000, 80, 200, 0.5),
                 (1000, 80, None, 0.25))
ORDERED_GS = 64   # groups of the cluster-ordered runs (G = 16 at K = 1000)
# the paper's Table 3 cases (seeding, K) and phase 10's iteration cap
TABLE3_CASES = (("kmeans++", 10), ("afk-mc2", 10), ("bf", 10),
                ("clarans", 10), ("clarans", 100))
PHASE10_MAX_ITER = 1000


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def tie_gap(torch, lab, lab_p, x, c):
    """(share of rows whose labels agree, the largest relative gap between
    the f64 distances to the two labels where they differ)."""
    xs = x if x.dim() == 3 else x.expand(c.shape[0], *x.shape)
    diff = lab != lab_p
    gap = 0.0
    if bool(diff.any()):
        rr, nn = torch.nonzero(diff, as_tuple=True)
        xr = xs[rr, nn].double()
        d_k = ((xr - c[rr, lab[rr, nn].long()].double()) ** 2).sum(-1)
        d_p = ((xr - c[rr, lab_p[rr, nn].long()].double()) ** 2).sum(-1)
        gap = float(((d_k - d_p).abs() / d_p.abs().clamp_min(1.0)).max())
    return float(1.0 - diff.float().mean()), gap


def compare(torch, got, want, x, c, w):
    """Kernel outputs against the plain version's on the same inputs.
    Labels may differ only where the two distances tie to within the
    reported gap; stats are compared for the assignment the kernel made."""
    from repro_torch.kernels import ref
    lab, mind = got[0], got[1]
    lab_p, mind_p = want[0], want[1]
    xs = x if x.dim() == 3 else x.expand(c.shape[0], *x.shape)
    agree, gap = tie_gap(torch, lab, lab_p, x, c)
    scale = mind_p.abs().clamp_min(1.0)
    mind_err = float(((mind - mind_p).abs() / scale).max())
    out = {"agree": agree, "gap": gap,
           "mind_rel": mind_err,
           "mind_abs": float((mind - mind_p).abs().max())}
    if len(got) == 5:
        sums_e, cnt_e = [], []
        for i in range(c.shape[0]):
            wi = None if w is None else (w[i] if w.dim() == 2 else w)
            s, n = ref.update_ref(xs[i], lab[i], c.shape[1], wi)
            sums_e.append(float((got[2][i] - s).abs().max()
                                / s.abs().max().clamp_min(1.0)))
            cnt_e.append(float((got[3][i] - n).abs().max()
                               / n.abs().max().clamp_min(1.0)))
        out["sums_rel"] = max(sums_e)
        out["counts_rel"] = max(cnt_e)
        out["energy_rel"] = float(((got[4] - want[4]).abs()
                                   / want[4].abs().clamp_min(1e-30)).max())
    return out


def accept(res, what):
    check(res["agree"] == 1.0 or res["gap"] <= 1e-5,
          f"{what}: labels differ beyond a near tie (gap {res['gap']:.2e})")
    check(res["mind_rel"] <= 1e-5,
          f"{what}: min_sqdist off by {res['mind_rel']:.2e} relative")
    if "sums_rel" in res:
        # 1e-4: the reduction-order tolerance of tests/test_kernels_v2.py
        check(res["sums_rel"] <= 1e-4, f"{what}: sums off by "
              f"{res['sums_rel']:.2e} of their scale")
        check(res["counts_rel"] <= 1e-6, f"{what}: counts off by "
              f"{res['counts_rel']:.2e}")
        check(res["energy_rel"] <= 1e-6, f"{what}: energy off by "
              f"{res['energy_rel']:.2e} relative")


def fmt(res):
    s = (f"labels agree {res['agree']:.7f} (near-tie gap {res['gap']:.2e}),"
         f" min_sqdist rel {res['mind_rel']:.2e} (abs {res['mind_abs']:.2e})")
    if "sums_rel" in res:
        s += (f", sums {res['sums_rel']:.2e}, counts "
              f"{res['counts_rel']:.2e}, energy rel {res['energy_rel']:.2e}")
    return s


def compare_stats(got, want):
    """Update-kernel (sums, counts) against the plain version's."""
    (s, n), (ws, wn) = got, want
    return {"sums_rel": float((s - ws).abs().max()
                              / ws.abs().max().clamp_min(1.0)),
            "counts_rel": float((n - wn).abs().max()
                                / wn.abs().max().clamp_min(1.0)),
            "sums_abs": float((s - ws).abs().max())}


def accept_stats(res, what):
    # the tolerances the fused kernel's stats are held to
    check(res["sums_rel"] <= 1e-4, f"{what}: sums off by "
          f"{res['sums_rel']:.2e} of their scale")
    check(res["counts_rel"] <= 1e-6, f"{what}: counts off by "
          f"{res['counts_rel']:.2e}")


def compare_bounds(torch, got, want, x, c, w, lb_sq, ub_sq, tile_rows):
    """Fused-bounds outputs (batched, 7 of them) against the plain
    version's: the fused step's five as ``compare`` holds them, plus the
    skipped share, the skipped group minima (the input bound, bit for
    bit) and the computed ones.  The bounds come from real Lloyd steps,
    after which a centroid can sit on a row: there |x|^2 - 2 x.c + |c|^2
    cancels to a few ulps of |x|^2 on one side and 0 on the other, so
    distances and group minima are relative to max(value, |x|^2, 1) and
    energies to max(energy, sum of w |x|^2)."""
    from repro_torch.kernels import ref
    out = compare(torch, got[:5], want[:5], x, c, w)
    xs = x if x.dim() == 3 else x.expand(c.shape[0], *x.shape)
    xsq = torch.sum(xs * xs, dim=-1)                          # (R, N)
    out["mind_rel"] = float(((got[1] - want[1]).abs() / torch.maximum(
        want[1].abs(), xsq).clamp_min(1.0)).max())
    wsq = torch.sum(xsq if w is None else xsq * w, dim=-1)   # (R,)
    out["energy_rel"] = float(((got[4] - want[4]).abs() / torch.maximum(
        want[4].abs(), wsq).clamp_min(1e-30)).max())
    computed = torch.stack([ref.computed_cells(lb, ub, tile_rows)
                            for lb, ub in zip(lb_sq, ub_sq)])
    g, wg = got[5], want[5]
    out["skipped"] = [float(v) for v in got[6]]
    out["skip_equal"] = torch.equal(got[6], want[6])
    out["gmin_skipped_equal"] = torch.equal(g[~computed], lb_sq[~computed]) \
        and torch.equal(wg[~computed], lb_sq[~computed])
    gscale = torch.maximum(wg.abs(), xsq[..., None]).clamp_min(1.0)
    out["gmin_rel"] = float(((g - wg).abs() / gscale)[computed].max()) \
        if bool(computed.any()) else 0.0
    return out


def accept_bounds(res, what, exact_labels=True):
    """``exact_labels=False``: as ``accept``, labels may differ on near
    ties (the rule phase 5 holds the fused kernel to at full size)."""
    if exact_labels:
        check(res["agree"] == 1.0, f"{what}: labels differ on "
              f"{1 - res['agree']:.2e} of rows")
    check(res["skip_equal"], f"{what}: skipped shares differ")
    check(res["gmin_skipped_equal"],
          f"{what}: a skipped group's minimum is not its bound")
    check(res["gmin_rel"] <= 1e-5, f"{what}: computed group minima off by "
          f"{res['gmin_rel']:.2e} relative")
    accept(res, what)


def fmt_bounds(res):
    return (f"{fmt(res)}, skipped {res['skipped']} (equal "
            f"{res['skip_equal']}), skipped group minima equal "
            f"{res['gmin_skipped_equal']}, computed ones rel "
            f"{res['gmin_rel']:.2e}")


def drifted_bounds(group_size, x, c, w, steps):
    """Bounds of a real carry: the fused_bounds engine with
    ``group_size`` steps from its init carry ``steps`` times, each time to
    the Lloyd update of the last step; -> (centroids of the next step
    (R, K, d), the engine's group size, the kernel's (lab0, lb_sq, ub_sq)
    for them)."""
    from repro_torch.core import get_backend
    from repro_torch.core.backends.fused_bounds import (engine_group_size,
                                                        squared_bounds)
    bk = get_backend("fused_bounds", group_size=group_size)
    k = c.shape[-2]
    gs = engine_group_size(k, group_size)
    carry = bk.init_carry(x, c, k)
    for _ in range(steps):
        res, carry = bk.batched_step(x, c, k, carry, w=w)
        c = bk.centroids_from_step(x, res, k, c)
    return c, gs, squared_bounds(carry, c, k, gs)


class StepRecorder:
    """A backend whose batched step records each step's skipped share
    (fused_bounds carries) and keeps the last step's inputs."""

    def __init__(self, bk):
        import dataclasses
        self.skips, self.last = [], None

        def step(x_, cs, k, carries, w=None):
            self.last = (cs, carries)
            res, carries = bk.batched_step(x_, cs, k, carries, w=w)
            self.skips.append(carries[4].skipped_frac)
            return res, carries

        self.backend = dataclasses.replace(bk, name=f"{bk.name}+record",
                                           batched_step_fn=step)


def trips_of(model):
    """Loop trips of a fit: an accepted iteration is one trip, a rejected
    one two (the paper's 2t - a), plus the trip that detects
    convergence."""
    converged = model.n_iter_ <= model.max_iter
    return 2 * model.n_iter_ - 2 + int(converged) - model.n_accepted_


def event_ms(torch, fn, iters, warmup=2):
    """Mean device time of fn(i) over ``iters`` calls, by CUDA events."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = n_ops / PEAK_FP32_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def distance_bound_ms(n_bytes, n_cross, n_other):
    """Bounds of a distance kernel whose cross terms x.c are ``n_cross``
    f32 operations (2NKd) beside ``n_other`` others (norms, compares):
    -> (bound ms, what bounds it, FP32-core bound ms, split-TF32 bound
    ms).  f32-accurate cross terms take the FP32 cores at 67 TFLOP/s, or
    three TF32 products on the tensor cores at 495 TFLOP/s while the rest
    runs on the FP32 cores; the bound is the lower of the two."""
    fp32, fp32_by = bound_ms(n_bytes, n_cross + n_other)
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_tc = 3 * n_cross / PEAK_TF32_PER_S
    t_other = n_other / PEAK_FP32_PER_S
    tc = max(t_bytes, t_tc, t_other) * 1e3
    tc_by = ("bytes" if t_bytes >= max(t_tc, t_other) else
             "split-tf32 operations" if t_tc >= t_other else "operations")
    return (tc, tc_by, fp32, tc) if tc < fp32 else (fp32, fp32_by, fp32, tc)


def phase9(torch, x, c0, model, zero_counts, read_counts, path_launches):
    """The single-problem path at full size: aa_kmeans on phase 5's data
    from phase 5's seeds is phase 5's fit (the batched driver at R = 1)
    bit for bit; the traced driver on an instrumented engine counts one
    pass for the init, one per accepted iteration, two per rejected one
    and one that detects convergence, and takes aa_kmeans's iterations."""
    import numpy as np
    from repro_torch.core.backends import get_backend, instrument
    from repro_torch.core.kmeans import (KMeansConfig, aa_kmeans,
                                         aa_kmeans_traced)
    print("phase 9: the single-problem path at full size (aa_kmeans, "
          "fused, phase 5's seeds)")
    cfg = KMeansConfig(k=MAIN_K, max_iter=model.max_iter)
    zero_counts()
    t0 = time.perf_counter()
    res = aa_kmeans(x, c0, cfg, backend="fused")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, plain = read_counts()
    path_launches["aa_kmeans (fused)"] = counts
    n_iter, n_acc = int(res.n_iter), int(res.n_accepted)
    converged = bool(res.converged)
    trips = 2 * n_iter - 2 + int(converged) - n_acc
    same = {"labels": torch.equal(res.labels, model.labels_),
            "centroids": torch.equal(res.centroids, model.centroids_),
            "energy": float(res.energy) == model.inertia_,
            "n_iter": n_iter == model.n_iter_,
            "n_accepted": n_acc == model.n_accepted_}
    print(f"  aa_kmeans: {wall!r} s wall, n_iter {n_iter}, n_accepted "
          f"{n_acc}, converged {converged}, energy {float(res.energy)!r}; "
          f"trips {trips}, fused launches {counts['fused_lloyd']}, "
          f"plain-version calls {plain}")
    print(f"  equal bit for bit to phase 5's fit: {same}", flush=True)
    check(all(same.values()), f"aa_kmeans differs from phase 5's fit: "
          f"{same}")
    check(counts["fused_lloyd"] == 1 + trips and plain == 0
          and sum(counts.values()) == counts["fused_lloyd"],
          "aa_kmeans did not run on the fused kernel, one launch a trip")
    passes = []
    bk = instrument(get_backend("fused"), lambda: passes.append(1))
    zero_counts()
    tr = aa_kmeans_traced(x, c0, cfg, backend=bk)
    counts_t, plain_t = read_counts()
    path_launches["aa_kmeans_traced (fused)"] = counts_t
    expected = 1 + sum(1 if a else 2 for a in tr.accepted) \
        + int(bool(tr.result.converged))
    m = np.array(tr.m_values)
    print(f"  aa_kmeans_traced on the instrumented engine: "
          f"{tr.wall_time_s!r} s wall, n_iter {int(tr.result.n_iter)}, "
          f"n_accepted {int(tr.result.n_accepted)}; steps {len(passes)} vs "
          f"1 + sum(1 if accepted else 2) + converged = {expected}; fused "
          f"launches {counts_t['fused_lloyd']}; m over the iterations: mean "
          f"{float(m.mean())!r}, max {int(m.max())}", flush=True)
    check(len(passes) == expected == counts_t["fused_lloyd"]
          and plain_t == 0, "the traced pass count breaks the acceptance "
          "formula")
    check(int(tr.result.n_iter) == n_iter
          and int(tr.result.n_accepted) == n_acc,
          "aa_kmeans_traced takes other iterations than aa_kmeans")
    sys.stdout.flush()


def phase10(torch, dev, x, zero_counts, read_counts, path_launches,
            tile_rows):
    """The paper's protocols on the card at full size on the USCensus1990
    stand-in: Table 3's five cases (seeded on the card, seeding timed
    apart), each as lloyd_kmeans against aa_kmeans on "dense" and as the
    same-engine pair on "fused"; one lloyd_iteration on the assignment
    and update kernels (pallas_lloyd_ops) against the dense ops; the
    traced bounded engine at K = 100; Table 2's four runs.  Who wins is
    printed, not checked.  Then each kernel against its plain version at
    phase 10's shapes; -> the largest absolute distance (update: sums)
    error per kernel."""
    import numpy as np
    from benchmarks_torch.common import timed
    from repro_torch.core.anderson import AAConfig
    from repro_torch.core import init_schemes
    from repro_torch.core.backends import get_backend
    from repro_torch.core.init_schemes import INIT_SCHEMES
    from repro_torch.core.kmeans import (KMeansConfig, aa_kmeans,
                                         aa_kmeans_traced)
    from repro_torch.core.lloyd import lloyd_iteration, lloyd_kmeans
    from repro_torch.kernels import assignment as A
    from repro_torch.kernels import fused_lloyd as F
    from repro_torch.kernels import update as U
    from repro_torch.kernels.ops import pallas_lloyd_ops
    n, d = x.shape
    cap = PHASE10_MAX_ITER
    print(f"phase 10: Tables 2 and 3 on the card ({MAIN_N_NAME}, {n} x {d}; "
          f"max_iter {cap}, the protocol's 1000)")
    fused = get_backend("fused")

    def once(fn):
        """(output, wall s) of one run, ending in a device sync."""
        return timed(fn, warmup=0, reps=1)

    zero_counts()
    summary = {"dense": [0, 0, 0], "fused": [0, 0, 0]}  # wins, iter wins, n
    seeds, finals = {}, {}
    for init, k in TABLE3_CASES:
        gen = torch.Generator(device=dev).manual_seed(0)
        c0, seed_s = once(lambda: INIT_SCHEMES[init](gen, x, k))
        check(tuple(c0.shape) == (k, d) and c0.device.type == "cuda",
              f"{init} seeds: shape {tuple(c0.shape)} on {c0.device}")
        seeds[(init, k)] = c0
        cfg = KMeansConfig(k=k, max_iter=cap)
        lcfg = KMeansConfig(k=k, max_iter=cap, accelerated=False)
        lloyd_d, t_ld = once(lambda: lloyd_kmeans(x, c0, k, cap))
        aa_d, t_ad = once(lambda: aa_kmeans(x, c0, cfg, backend="dense"))
        lloyd_f, t_lf = once(lambda: aa_kmeans(x, c0, lcfg, backend=fused))
        aa_f, t_af = once(lambda: aa_kmeans(x, c0, cfg, backend=fused))
        rows = (("dense", lloyd_d[3], float(lloyd_d[2]), t_ld, aa_d, t_ad),
                ("fused", int(lloyd_f.n_iter), float(lloyd_f.energy), t_lf,
                 aa_f, t_af))
        finals[(init, k)] = aa_f.centroids
        # clarans's swap trials (one cost read each), so that its seeding
        # time can be read per trial
        line = [f"  {init} K={k}: seeding {seed_s!r} s"
                + (f" ({init_schemes.clarans_trials} trials)"
                   if init == "clarans" else "")]
        for eng, it_l, e_l, t_l, aa, t_a in rows:
            e_a = float(aa.energy)
            check(np.isfinite(e_l) and np.isfinite(e_a),
                  f"{init} K={k} {eng}: a non-finite energy")
            summary[eng][0] += int(t_a < t_l)
            summary[eng][1] += int(int(aa.n_iter) < it_l)
            summary[eng][2] += 1
            line.append(f"{eng}: Lloyd {it_l} it {t_l!r} s mse "
                        f"{e_l / n!r} | AA {int(aa.n_accepted)}/"
                        f"{int(aa.n_iter)} {t_a!r} s mse {e_a / n!r}")
        # each algorithm on the two engines from the same seeds: only
        # rounding sets them apart (phase 6's 1e-3)
        rel_l = abs(float(lloyd_f.energy) - float(lloyd_d[2])) \
            / float(lloyd_d[2])
        rel_a = abs(float(aa_f.energy) - float(aa_d.energy)) \
            / float(aa_d.energy)
        line.append(f"fused vs dense final energies: Lloyd {rel_l:.2e}, "
                    f"AA {rel_a:.2e} relative")
        print("\n    ".join(line), flush=True)
        check(rel_l <= 1e-3 and rel_a <= 1e-3, f"{init} K={k}: the fused "
              f"and dense runs end far apart")
        # Lloyd's fixed point: a converged run's labels are the assignment
        # of its centroids (each engine's own assignment)
        if lloyd_d[3] < cap:
            check(torch.equal(lloyd_d[1], get_backend("dense").assign(
                x, lloyd_d[0]).labels), f"{init} K={k}: dense Lloyd's "
                "labels are not its centroids' assignment")
        if bool(lloyd_f.converged):
            check(torch.equal(lloyd_f.labels, fused.assign(
                x, lloyd_f.centroids).labels), f"{init} K={k}: fused "
                "Lloyd's labels are not its centroids' assignment")
        # one Lloyd step on the assignment and update kernels against the
        # dense ops, and both against the f64 means of the kernels' labels:
        # the dense ops sum a cluster's rows (~250,000 at K = 10) in long
        # f32 matmul accumulations, about 1e-5 from the exact means, so
        # between the two only the stats' reduction-order tolerance holds
        # (1e-4 of their scale, as phases 3-5a); the kernels are held to
        # 1e-5 of the exact means
        c1_p, lab_p, e_p = lloyd_iteration(x, c0, k, ops=pallas_lloyd_ops())
        c1_d, lab_d, e_d = lloyd_iteration(x, c0, k)
        agree, gap = tie_gap(torch, lab_p[None], lab_d[None], x, c0[None])
        sums = torch.zeros((k, d), dtype=torch.float64, device=dev)
        sums.index_add_(0, lab_p.long(), x.double())
        counts = torch.bincount(lab_p.long(), minlength=k).double()
        exact = torch.where(counts[:, None] > 0, sums / counts.clamp_min(
            1.0)[:, None], c0.double())
        scale = exact.abs().max().clamp_min(1.0)
        err_p = float((c1_p.double() - exact).abs().max() / scale)
        err_d = float((c1_d.double() - exact).abs().max() / scale)
        err_pd = float((c1_p - c1_d).abs().max()
                       / c1_d.abs().max().clamp_min(1.0))
        print(f"    lloyd_iteration on pallas_lloyd_ops vs the dense ops: "
              f"labels agree {agree:.7f} (near-tie gap {gap:.2e}), "
              f"centroids {err_pd:.2e} of their scale, energy rel "
              f"{abs(float(e_p) - float(e_d)) / float(e_d):.2e}; against "
              f"the f64 means: kernels {err_p:.2e}, dense ops {err_d:.2e}")
        check(agree == 1.0 or gap <= 1e-5, f"{init} K={k}: pallas ops' "
              f"labels differ beyond a near tie")
        check(err_pd <= 1e-4, f"{init} K={k}: pallas ops' centroids off "
              f"the dense ops' by {err_pd:.2e}")
        check(err_p <= 1e-5, f"{init} K={k}: pallas ops' centroids off "
              f"the f64 means by {err_p:.2e}")
    for eng, (wins, iter_wins, total) in summary.items():
        print(f"  Table 3 summary, {eng}: AA faster in {wins}/{total}, fewer "
              f"iterations in {iter_wins}/{total}")
    # the bounded engine's trace at K = 100 (16-centroid groups, G = 7)
    c0 = seeds[("clarans", 100)]
    tr = aa_kmeans_traced(x, c0, KMeansConfig(k=100, max_iter=cap),
                          backend=get_backend("fused_bounds",
                                              group_size=16))
    post = tr.bound_phases["post_accept"]
    print(f"  aa_kmeans_traced on fused_bounds (clarans K=100, gs 16): "
          f"{int(tr.result.n_accepted)}/{int(tr.result.n_iter)} in "
          f"{tr.wall_time_s!r} s, mse {tr.mse!r}; skipped share after the "
          f"first accepted iteration {post['skipped_frac']!r} over "
          f"{post['n_iters']} iterations")
    check(np.isfinite(tr.mse) and len(tr.bound_stats) == len(tr.energies),
          "the bounded trace")
    # Table 2: fixed and dynamic m from the kmeans++ seeds at K = 10
    c0 = seeds[("kmeans++", 10)]
    times = {}
    for m0 in (2, 5):
        for dynamic in (False, True):
            cfg = KMeansConfig(k=10, max_iter=cap,
                               aa=AAConfig(m0=m0, dynamic_m=dynamic))
            tr = aa_kmeans_traced(x, c0, cfg, backend="dense")
            check(np.isfinite(tr.mse), "Table 2: a non-finite energy")
            times[(m0, dynamic)] = tr.wall_time_s
            print(f"  Table 2, m0={m0} {'dynamic' if dynamic else 'fixed'}: "
                  f"{int(tr.result.n_accepted)}/{int(tr.result.n_iter)} "
                  f"{tr.wall_time_s!r} s mse {tr.mse!r}, m mean "
                  f"{float(np.mean(tr.m_values))!r} max "
                  f"{max(tr.m_values)}")
    print(f"  Table 2 summary: dynamic m faster at m0=2 "
          f"{times[(2, True)] <= times[(2, False)]}, at m0=5 "
          f"{times[(5, True)] <= times[(5, False)]}")
    counts, plain = read_counts()
    path_launches["Tables 2 and 3"] = counts
    print(f"  launches: {counts}; plain-version calls {plain}", flush=True)
    check(plain == 0, "phase 10 called a plain version")
    check(all(v > 0 for v in counts.values()),
          "phase 10 did not launch every kernel")
    # every kernel of phase 10 against its plain version at the shapes
    # phase 10 gives it (the counts are read, so these launches are not
    # the path's): the fused step, the assignment and the update at each
    # case's last AA centroids and their labels (means: the seeds are rows
    # of x, where |x|^2 - 2 x.c + |c|^2 cancels to a few ulps of |x|^2 on
    # either side), and the bounded step with 16-centroid groups on the
    # bounds of two real steps from the clarans K = 100 seeds
    errs = dict.fromkeys(counts, 0.0)
    for (init, k), c in finals.items():
        got = tuple(o[None] for o in F.fused_lloyd(x, c))
        res = compare(torch, got, tuple(o[None] for o in F.fused_lloyd_plain(
            x, c)), x, c[None], None)
        res_a = compare(torch, tuple(o[None] for o in A.assignment(x, c)),
                        tuple(o[None] for o in A.assignment_plain(x, c)),
                        x, c[None], None)
        lab = got[0][0]
        res_u = compare_stats(U.update(x, lab, k), U.update_plain(x, lab, k))
        print(f"  [{init} K={k}, last AA centroids] fused vs plain: "
              f"{fmt(res)}; assignment vs plain: {fmt(res_a)}; update vs "
              f"plain: sums {res_u['sums_rel']:.2e} (abs "
              f"{res_u['sums_abs']:.2e}), counts {res_u['counts_rel']:.2e}")
        accept(res, f"fused [{init} K={k}]")
        accept(res_a, f"assignment [{init} K={k}]")
        accept_stats(res_u, f"update [{init} K={k}]")
        errs["fused_lloyd"] = max(errs["fused_lloyd"], res["mind_abs"])
        errs["assignment"] = max(errs["assignment"], res_a["mind_abs"])
        errs["update"] = max(errs["update"], res_u["sums_abs"])
    cb, gs, bnds = drifted_bounds(16, x, seeds[("clarans", 100)][None],
                                  None, steps=2)
    res_b = compare_bounds(torch, F.fused_lloyd(x, cb, bounds=bnds, gs=gs),
                           F.fused_bounds_plain(x, cb, None, *bnds, gs,
                                                tile_rows),
                           x, cb, None, bnds[1], bnds[2], tile_rows)
    print(f"  [clarans K=100, two steps' bounds] fused_bounds (gs={gs}, "
          f"G={bnds[1].shape[-1]}) vs plain: {fmt_bounds(res_b)}",
          flush=True)
    accept_bounds(res_b, "fused_bounds [clarans K=100, gs 16]",
                  exact_labels=False)
    errs["fused_bounds"] = res_b["mind_abs"]
    return errs


def run():
    """All phases; returns (nvidia-smi line, device name).  Raises
    PhaseError (or whatever a failing call raises) on the first failure."""
    import numpy as np
    import torch
    from repro_torch.core import AAKMeans, get_backend, lloyd
    from repro_torch.core.api import PREDICT_CHUNK
    from repro_torch.core.backends import bounds
    from repro_torch.core.backends.fused_bounds import (engine_group_size,
                                                        squared_bounds)
    from repro_torch.core.init_schemes import batched_init
    from repro_torch.core.kmeans import (KMeansConfig, _init_state,
                                         aa_kmeans_batched, batched_trip)
    from repro_torch.data.synthetic import (DATASETS, dataset_components,
                                            make_dataset)
    from repro_torch.device import resolve_device
    from repro_torch.kernels import assignment as A
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_lloyd as F
    from repro_torch.kernels import update as U
    from repro_torch.kernels.tiles import pad_rows

    # each kernel's (module, launch count, plain-version count)
    counters = {"fused_lloyd": (F, "launches", "plain_calls"),
                "assignment": (A, "launches", "plain_calls"),
                "update": (U, "launches", "plain_calls"),
                "fused_bounds": (F, "bounds_launches", "bounds_plain_calls")}
    path_launches = {}

    def zero_counts():
        for mod, launches, plain in counters.values():
            setattr(mod, launches, 0)
            setattr(mod, plain, 0)

    def read_counts():
        """The launches of every kernel since zero_counts, and the
        plain-version calls."""
        got = {name: getattr(mod, launches)
               for name, (mod, launches, _) in counters.items()}
        return got, sum(getattr(mod, p) for mod, _, p in counters.values())

    dev = resolve_device(None)
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    props = torch.cuda.get_device_properties(0)
    print(f"phase 1: {smi}")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, device "
          f"{name}, SMs {props.multi_processor_count}; bound peaks "
          f"{PEAK_BYTES_PER_S / 1e12} TB/s, {PEAK_FP32_PER_S / 1e12} "
          f"TFLOP/s FP32", flush=True)

    t0 = time.perf_counter()
    logs = build.build(build.KERNELS)
    print(f"phase 2: built {', '.join(build.KERNELS)} in "
          f"{time.perf_counter() - t0!r} s")
    for kname in build.KERNELS:
        print(f"  {kname}: {build.library_path(kname).relative_to(ROOT)}")
        for line in logs[kname].splitlines():
            entry = re.search(r"entry function '(\w+)'", line)
            if entry:
                print(f"    {entry.group(1)}")
            elif "registers" in line or "spill" in line:
                print(f"      {line.strip()}")
    tile_rows = build.tile_rows()
    lib_rows = {kname: getattr(build.load(kname), f"{kname}_tile_rows")()
                for kname in ("fused_lloyd", "fused_bounds")}
    print(f"  rows per tile: {lib_rows}, csrc/sweep_fp32.cuh kRows "
          f"{tile_rows}")
    check(set(lib_rows.values()) == {tile_rows},
          "the libraries and sweep_fp32.cuh disagree on the row tile")
    lib_u = U._bind(build.load("update"))
    spec_main = DATASETS[MAIN_N_NAME]
    print(f"  update layout at the main shape: "
          f"{U.layout(lib_u, spec_main.n, 1, MAIN_K, spec_main.d)}")
    sys.stdout.flush()

    print("phase 3: kernels against their plain versions")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for (label, n, k, d, r, x_per, wkind), group in zip(CASES, CASE_GROUPS):
        rr = r or 1
        x = torch.randn((rr, n, d) if x_per else (n, d), generator=gen,
                        device=dev)
        c = torch.randn((rr, k, d), generator=gen, device=dev)
        w = None
        if wkind == "n":
            w = torch.rand((n,), generator=gen, device=dev) * 2
        elif wkind == "rn":
            w = torch.rand((rr, n), generator=gen, device=dev) * 2
            w[:, : n // 5] = 0.0
        # r None: the unbatched form, c (K, d) and outputs without R
        ck = c if r else c[0]
        lift = (lambda out: out) if r else \
            (lambda out: tuple(o[None] for o in out))
        unlift = (lambda t: t) if r else (lambda t: t[0])
        got_f = lift(F.fused_lloyd(x, ck, w))
        got_a = lift(A.assignment(x, ck))
        want_f = lift(F.fused_lloyd_plain(x, ck, w))
        res_f = compare(torch, got_f, want_f, x, c, w)
        res_a = compare(torch, got_a, want_f[:2], x, c, None)
        print(f"  [{label}: N={n} K={k} d={d} R={rr}] fused: {fmt(res_f)};"
              f" assignment: {fmt(res_a)}")
        accept(res_f, f"fused [{label}]")
        accept(res_a, f"assignment [{label}]")
        # update: labels in [-1, K], so -1 and K land nowhere; (N,) weights
        lab_u = unlift(torch.randint(-1, k + 1, (rr, n), generator=gen,
                                     device=dev, dtype=torch.int32))
        w_u = None if w is None else (w if w.dim() == 1
                                      else w[0].contiguous())
        got_u = U.update(x, lab_u, k, w_u)
        res_u = compare_stats(got_u, U.update_plain(x, lab_u, k, w_u))
        print(f"    update: sums {res_u['sums_rel']:.2e}, counts "
              f"{res_u['counts_rel']:.2e}")
        accept_stats(res_u, f"update [{label}]")
        # fused-bounds on the bounds of two real steps
        cb, gs, bnds = drifted_bounds(group, x, c, w, steps=2)
        args_b = (x, unlift(cb), w, *(unlift(b) for b in bnds))
        got_b = lift(F.fused_lloyd(*args_b[:3], bounds=args_b[3:], gs=gs))
        want_b = lift(F.fused_bounds_plain(*args_b, gs, tile_rows))
        res_b = compare_bounds(torch, got_b, want_b, x, cb, w, bnds[1],
                               bnds[2], tile_rows)
        print(f"    fused_bounds (gs={gs}, G={bnds[1].shape[-1]}): "
              f"{fmt_bounds(res_b)}")
        accept_bounds(res_b, f"fused_bounds [{label}]")
        cases.append((x, ck, w, got_f, got_a, lift, (x, lab_u, k, w_u),
                      got_u, args_b, gs, got_b))
    # rows laid out cluster by cluster with the centroid order matching
    # (the reference's "ordered" layout): most cells skip
    d_o = 16
    for k_o, per, group, least in ORDERED_CASES:
        centers = torch.randn((k_o, d_o), generator=gen, device=dev) * 20.0
        x_o = (centers[:, None, :] + torch.randn(
            (k_o, per, d_o), generator=gen, device=dev)).reshape(-1, d_o)
        c_o = centers + 0.5 * torch.randn((k_o, d_o), generator=gen,
                                          device=dev)
        cb, gs, bnds = drifted_bounds(group, x_o, c_o[None], None, steps=3)
        got_b = F.fused_lloyd(x_o, cb, bounds=bnds, gs=gs)
        res_b = compare_bounds(torch, got_b, F.fused_bounds_plain(
            x_o, cb, None, *bnds, gs, tile_rows), x_o, cb, None, bnds[1],
            bnds[2], tile_rows)
        label = f"cluster-ordered: N={x_o.shape[0]} K={k_o} d={d_o}"
        print(f"  [{label}] fused_bounds (gs={gs}, G={bnds[1].shape[-1]}): "
              f"{fmt_bounds(res_b)}")
        accept_bounds(res_b, f"fused_bounds [{label}]")
        check(res_b["skipped"][0] > least, f"[{label}] skips no more "
              f"than {least} of its cells")
        cases.append((None, None, None, None, None, None, None, None,
                      (x_o, cb, None, *bnds), gs, got_b))
    # cases of one kernel each: (label, launch, its first outputs)
    single = []
    # the update's cluster-range layout: K too large for one block
    x_r = torch.randn((4000, 69), generator=gen, device=dev)
    lab_r = torch.randint(-1, 20001, (4000,), generator=gen, device=dev,
                          dtype=torch.int32)
    lay_r = U.layout(lib_u, 4000, 1, 20000, 69)
    got_u = U.update(x_r, lab_r, 20000)
    res_u = compare_stats(got_u, U.update_plain(x_r, lab_r, 20000))
    print(f"  [update, K=20000 N=4000 d=69: {lay_r.ranges} cluster ranges x "
          f"{lay_r.groups} column groups] sums {res_u['sums_rel']:.2e}, "
          f"counts {res_u['counts_rel']:.2e}")
    check(lay_r.ranges > 1, "K=20000 takes no cluster ranges")
    accept_stats(res_u, "update [K=20000]")
    single.append(("update K=20000", lambda: U.update(x_r, lab_r, 20000),
                   got_u))
    # exact ties: small integers, so every distance is exact; centroid
    # j + 10 duplicates j, and j must win
    x_t = torch.randint(-4, 5, (300, 6), generator=gen, device=dev).float()
    c_t = torch.randint(-4, 5, (10, 6), generator=gen, device=dev).float()
    c_t = torch.cat([c_t, c_t])
    got_t = A.assignment(x_t, c_t)
    want_t = A.assignment_plain(x_t, c_t)
    print(f"  [assignment, exact ties: N=300 K=20 d=6] labels equal "
          f"{torch.equal(got_t[0], want_t[0])}, all below the duplicates "
          f"{bool((got_t[0] < 10).all())}, distances equal "
          f"{torch.equal(got_t[1], want_t[1])}")
    check(torch.equal(got_t[0], want_t[0]) and bool((got_t[0] < 10).all())
          and torch.equal(got_t[1], want_t[1]),
          "assignment: an exact tie did not go to the lowest index")
    single.append(("assignment ties", lambda: A.assignment(x_t, c_t),
                   got_t))
    # a NaN row: NaN distance, label 0 (the first NaN), the rest unharmed
    x_n = torch.randn((1000, 69), generator=gen, device=dev)
    c_n = torch.randn((37, 69), generator=gen, device=dev)
    x_n[7] = float("nan")
    got_n = A.assignment(x_n, c_n)
    want_n = A.assignment_plain(x_n, c_n)
    nan_ok = bool(torch.isnan(got_n[1][7])) and int(got_n[0][7]) == 0 \
        and torch.equal(torch.isnan(got_n[1]), torch.isnan(want_n[1]))
    keep = ~torch.isnan(want_n[1])
    res_n = compare(torch, (got_n[0][keep][None], got_n[1][keep][None]),
                    (want_n[0][keep][None], want_n[1][keep][None]),
                    x_n[keep], c_n[None], None)
    print(f"  [assignment, a NaN row: N=1000 K=37 d=69] NaN row: label "
          f"{int(got_n[0][7])}, distance {float(got_n[1][7])}; the other "
          f"rows: {fmt(res_n)}")
    check(nan_ok, "assignment: the NaN row is not NaN with label 0")
    accept(res_n, "assignment [NaN row, the other rows]")
    single.append(("assignment NaN row", lambda: A.assignment(x_n, c_n),
                   got_n))

    print("phase 4: repeated launches are bitwise equal")
    for (x, c, w, got_f, got_a, lift, args_u, got_u, args_b, gs,
         got_b) in cases:
        label = "cluster-ordered" if x is None else "a phase-3 case"
        if x is not None:
            again = lift(F.fused_lloyd(x, c, w)) + lift(A.assignment(x, c)) \
                + U.update(*args_u)
            for a, b in zip(got_f + got_a + got_u, again):
                check(torch.equal(a, b), f"[{label}] relaunch differs")
        again_b = F.fused_lloyd(*args_b[:3], bounds=args_b[3:], gs=gs)
        if args_b[1].dim() == 2:          # the unbatched form
            again_b = tuple(o[None] for o in again_b)
        for a, b in zip(got_b, again_b):
            check(torch.equal(a, b), f"[{label}] fused_bounds relaunch "
                  f"differs")
    for label, launch, got in single:
        again = launch()
        for a, b in zip(got, again):
            check(torch.equal(a, b) or (torch.isnan(a).any() and torch.equal(
                torch.nan_to_num(a, nan=-1.0), torch.nan_to_num(b, nan=-1.0))),
                  f"[{label}] relaunch differs")
    print(f"  all {len(cases)} cases, all four kernels, and the "
          f"{len(single)} single-kernel cases: equal")
    del cases, single
    sys.stdout.flush()

    print("phase 5: main path at full size")
    spec = DATASETS[MAIN_N_NAME]
    t0 = time.perf_counter()
    x_np = make_dataset(MAIN_N_NAME)
    x = torch.from_numpy(x_np).to(dev)
    torch.cuda.synchronize()
    print(f"  data {tuple(x.shape)} f32 ({x.numel() * 4 / 1e6:.0f} MB) made "
          f"and copied in {time.perf_counter() - t0:.1f} s")
    check(tuple(x.shape) == (spec.n, spec.d), "dataset shape")
    t0 = time.perf_counter()
    # the fit's own seeds (AAKMeans seeds from a generator at seed 0);
    # phase 9 starts from them
    c0_main = batched_init("kmeans++",
                           torch.Generator(device=dev).manual_seed(0), x,
                           MAIN_K, 1)[0]
    torch.cuda.synchronize()
    seed_s = time.perf_counter() - t0
    model = AAKMeans(n_clusters=MAIN_K, backend="fused", n_init=1)
    zero_counts()
    t0 = time.perf_counter()
    model.fit(x)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    labels = model.predict(x)
    predict_s = time.perf_counter() - t0
    counts, plain = read_counts()
    path_launches["fused fit + predict"] = counts
    fused_launches, assign_launches = counts["fused_lloyd"], \
        counts["assignment"]
    converged = model.n_iter_ <= model.max_iter
    trips = trips_of(model)
    chunks = -(-spec.n // PREDICT_CHUNK)
    print(f"  seeding {seed_s!r} s (timed alone), fit {fit_s!r} s "
          f"(seeding included), predict {predict_s!r} s "
          f"({spec.n / predict_s!r} rows/s)")
    print(f"  n_iter_ {model.n_iter_}, n_accepted_ {model.n_accepted_}, "
          f"converged {converged}, inertia_ {model.inertia_!r}")
    print(f"  fused launches {fused_launches} vs 1 + trips = {1 + trips}; "
          f"assignment launches {assign_launches} vs predict chunks "
          f"{chunks}; plain-version calls {plain}", flush=True)
    check(fused_launches == 1 + trips, "fused launches != 1 + trips")
    check(assign_launches == chunks, "assignment launches != chunks")
    check(counts["update"] == counts["fused_bounds"] == 0,
          "the fused path launched another engine's kernel")
    check(plain == 0, "the main path called a plain version")
    check(np.isfinite(model.inertia_) and model.inertia_ > 0, "inertia")
    check(labels.shape == (spec.n,) and labels.min() >= 0
          and labels.max() < MAIN_K, "predict labels")
    c_fin = model.centroids_
    got = F.fused_lloyd(x, c_fin)
    want = F.fused_lloyd_plain(x, c_fin)
    res_main = compare(torch, tuple(g[None] for g in got),
                       tuple(v[None] for v in want), x, c_fin[None], None)
    print(f"  fused step vs plain step on the final centroids: "
          f"{fmt(res_main)}")
    accept(res_main, "fused at full size")
    # the fused step launches predict's sweep (sweep_fp32.cuh's
    # launch_assign), so their labels are equal by construction: these
    # checks hold the two wrappers' operands and outputs together
    lab_pred = torch.from_numpy(labels).to(dev)
    agree = float((lab_pred == got[0]).float().mean())
    print(f"  predict labels vs the fused step's on the same centroids: "
          f"{agree:.7f} equal, {int((lab_pred != got[0]).sum())} rows "
          f"differ")
    check(agree == 1.0, "predict and the fused step disagree")
    # ... and so are their distances, bit for bit, at all rows
    lab_all, mind_all = A.assignment(x, c_fin)
    same_d = torch.equal(mind_all, got[1])
    print(f"  the assignment kernel at all rows vs the fused step on the "
          f"same centroids: labels equal {torch.equal(lab_all, got[0])}, "
          f"distances equal bit for bit {same_d} "
          f"({int((mind_all != got[1]).sum())} rows differ)")
    check(same_d and torch.equal(lab_all, got[0]),
          "the fused step's distances are not the assignment kernel's")
    main_abs_err = res_main["mind_abs"]
    del got, want, lab_all, mind_all
    # the assignment kernel at the shape predict gives it: a full chunk
    # and the tail chunk padded with copies of its last row
    tail = spec.n % PREDICT_CHUNK
    assign_abs_err = 0.0
    for what, xc in (("full chunk", x[:PREDICT_CHUNK]),
                     (f"tail chunk ({tail} rows padded)",
                      pad_rows(x[spec.n - tail:], PREDICT_CHUNK))):
        res = compare(torch, tuple(o[None] for o in A.assignment(xc, c_fin)),
                      tuple(o[None] for o in A.assignment_plain(xc, c_fin)),
                      xc, c_fin[None], None)
        print(f"  assignment vs plain on predict's {what}: {fmt(res)}")
        accept(res, f"assignment at predict's {what}")
        assign_abs_err = max(assign_abs_err, res["mind_abs"])
    sys.stdout.flush()

    print("phase 5a: the pallas path at full size (the same seed)")
    model_p = AAKMeans(n_clusters=MAIN_K, backend="pallas", n_init=1)
    zero_counts()
    t0 = time.perf_counter()
    model_p.fit(x)
    torch.cuda.synchronize()
    fit_p_s = time.perf_counter() - t0
    counts_fit, _ = read_counts()
    t0 = time.perf_counter()
    labels_p = model_p.predict(x)
    predict_p_s = time.perf_counter() - t0
    counts_p, plain = read_counts()
    path_launches["pallas fit + predict"] = counts_p
    predict_launches = counts_p["assignment"] - counts_fit["assignment"]
    trips_p = trips_of(model_p)
    rel_p = abs(model_p.inertia_ - model.inertia_) / model.inertia_
    print(f"  fit {fit_p_s!r} s (seeding included), predict "
          f"{predict_p_s!r} s; n_iter_ {model_p.n_iter_}, n_accepted_ "
          f"{model_p.n_accepted_}, inertia_ {model_p.inertia_!r}, "
          f"{rel_p:.2e} relative from the fused fit's")
    print(f"  in the fit: assignment launches {counts_fit['assignment']}, "
          f"update launches {counts_fit['update']} vs 1 + trips = "
          f"{1 + trips_p}; predict: {predict_launches} assignment "
          f"launches vs {chunks} chunks; plain-version calls {plain}",
          flush=True)
    check(counts_fit["assignment"] == counts_fit["update"] == 1 + trips_p,
          "pallas launches != 1 + trips")
    check(predict_launches == chunks, "pallas predict launches != chunks")
    check(counts_p["fused_lloyd"] == counts_p["fused_bounds"] == 0,
          "the pallas path launched another engine's kernel")
    check(plain == 0, "the pallas path called a plain version")
    check(rel_p <= 1e-3, "pallas and fused fits end far apart")
    check(labels_p.shape == (spec.n,), "pallas predict labels")
    lab_p = model_p.labels_
    # both kernels at the shape the fit gives them: all rows, R = 1
    c_p = model_p.centroids_[None]
    res_a = compare(torch, A.assignment(x, c_p), A.assignment_plain(x, c_p),
                    x, c_p, None)
    print(f"  assignment vs plain on all rows at the fit's final centroids: "
          f"{fmt(res_a)}")
    accept(res_a, "assignment at the pallas fit's shape")
    assign_abs_err = max(assign_abs_err, res_a["mind_abs"])
    del c_p
    res_u = compare_stats(U.update(x, lab_p, MAIN_K),
                          U.update_plain(x, lab_p, MAIN_K))
    print(f"  update vs plain on the fit's last labels: sums "
          f"{res_u['sums_rel']:.2e} (abs {res_u['sums_abs']:.2e}), counts "
          f"{res_u['counts_rel']:.2e}")
    accept_stats(res_u, "update at full size")
    update_abs_err = res_u["sums_abs"]
    sys.stdout.flush()

    print("phase 5b: the fused_bounds path at full size")
    rec = StepRecorder(get_backend("fused_bounds"))
    gs_main = engine_group_size(MAIN_K)
    zero_counts()
    t0 = time.perf_counter()
    model_b = AAKMeans(n_clusters=MAIN_K, backend=rec.backend,
                       n_init=1).fit(x)
    torch.cuda.synchronize()
    fit_b_s = time.perf_counter() - t0
    counts_b, plain = read_counts()
    path_launches["fused_bounds fit"] = counts_b
    trips_b = trips_of(model_b)
    skips = torch.cat(rec.skips).tolist()
    rel_b = abs(model_b.inertia_ - model.inertia_) / model.inertia_
    print(f"  default groups: gs {gs_main}, G {-(-MAIN_K // gs_main)}; fit "
          f"{fit_b_s!r} s (seeding included); n_iter_ {model_b.n_iter_}, "
          f"n_accepted_ {model_b.n_accepted_}, inertia_ "
          f"{model_b.inertia_!r}, {rel_b:.2e} relative from the fused "
          f"fit's")
    print(f"  fused_bounds launches {counts_b['fused_bounds']} vs 1 + trips "
          f"= {1 + trips_b}; plain-version calls {plain}; skipped share: "
          f"first trip {skips[1]!r}, median {float(np.median(skips))!r}, "
          f"last trip {skips[-1]!r}", flush=True)
    check(counts_b["fused_bounds"] == 1 + trips_b,
          "fused_bounds launches != 1 + trips")
    check(sum(counts_b.values()) == counts_b["fused_bounds"],
          "the fused_bounds fit launched another kernel")
    check(plain == 0, "the fused_bounds path called a plain version")
    check(rel_b <= 1e-3, "fused_bounds and fused fits end far apart")
    cs_last, carry_last = rec.last
    bnds_d = squared_bounds(carry_last, cs_last, MAIN_K, gs_main)
    del rec, model_b, carry_last
    got = F.fused_lloyd(x, cs_last, bounds=bnds_d, gs=gs_main)
    res_d = compare_bounds(torch, got, F.fused_bounds_plain(
        x, cs_last, None, *bnds_d, gs_main, tile_rows), x, cs_last, None,
        bnds_d[1], bnds_d[2], tile_rows)
    print(f"  fused_bounds vs plain on the default fit's last bounds: "
          f"{fmt_bounds(res_d)}")
    accept_bounds(res_d, "fused_bounds at full size, default groups",
                  exact_labels=False)
    del got, cs_last, bnds_d
    # the cluster-ordered layout: rows sorted by their synthetic
    # component, seeds drawn evenly along the sorted rows
    order = torch.from_numpy(np.argsort(dataset_components(MAIN_N_NAME),
                                        kind="stable")).to(dev)
    x_ord = x[order].contiguous()
    del order
    seeds = x_ord[torch.linspace(0, spec.n - 1, MAIN_K,
                                 device=dev).long()][None]
    rec = StepRecorder(get_backend("fused_bounds", group_size=ORDERED_GS))
    gs_o = engine_group_size(MAIN_K, ORDERED_GS)
    zero_counts()
    t0 = time.perf_counter()
    model_o = AAKMeans(n_clusters=MAIN_K, backend=rec.backend,
                       n_init=1).fit(x_ord, c0s=seeds)
    torch.cuda.synchronize()
    fit_o_s = time.perf_counter() - t0
    counts_o, plain = read_counts()
    path_launches["fused_bounds fit, cluster-ordered"] = counts_o
    trips_o = trips_of(model_o)
    skips_o = torch.cat(rec.skips).tolist()
    print(f"  cluster-ordered, gs {gs_o}, G {-(-MAIN_K // gs_o)}: fit "
          f"{fit_o_s!r} s; n_iter_ {model_o.n_iter_}, n_accepted_ "
          f"{model_o.n_accepted_}, inertia_ {model_o.inertia_!r}; "
          f"fused_bounds launches {counts_o['fused_bounds']} vs 1 + trips "
          f"= {1 + trips_o}; skipped share: first trip {skips_o[1]!r}, "
          f"median {float(np.median(skips_o))!r}, last trip "
          f"{skips_o[-1]!r}", flush=True)
    check(counts_o["fused_bounds"] == 1 + trips_o,
          "ordered fused_bounds launches != 1 + trips")
    check(plain == 0, "the ordered run called a plain version")
    check(np.isfinite(model_o.inertia_), "ordered run inertia")
    check(skips_o[-1] > 0.0, "the cluster-ordered run skips nothing")
    cs_last, carry_last = rec.last
    bnds_o = squared_bounds(carry_last, cs_last, MAIN_K, gs_o)
    del rec, model_o, carry_last
    got = F.fused_lloyd(x_ord, cs_last, bounds=bnds_o, gs=gs_o)
    res_o = compare_bounds(torch, got, F.fused_bounds_plain(
        x_ord, cs_last, None, *bnds_o, gs_o, tile_rows), x_ord, cs_last,
        None, bnds_o[1], bnds_o[2], tile_rows)
    print(f"  fused_bounds vs plain on the ordered run's last bounds: "
          f"{fmt_bounds(res_o)}")
    accept_bounds(res_o, "fused_bounds at full size", exact_labels=False)
    bounds_abs_err = max(res_d["mind_abs"], res_o["mind_abs"])
    skip_conv = res_o["skipped"][0]
    del got
    sys.stdout.flush()

    print("phase 6: the dense oracle from the same seeds at full size")
    t0 = time.perf_counter()
    dense_model = AAKMeans(n_clusters=MAIN_K, backend="dense",
                           n_init=1).fit(x)
    torch.cuda.synchronize()
    rel = abs(dense_model.inertia_ - model.inertia_) / dense_model.inertia_
    print(f"  dense: fit {time.perf_counter() - t0!r} s, n_iter_ "
          f"{dense_model.n_iter_}, n_accepted_ {dense_model.n_accepted_}, "
          f"converged {dense_model.n_iter_ <= dense_model.max_iter}, "
          f"inertia_ {dense_model.inertia_!r}; fused ends {rel:.2e} "
          f"relative from it")
    check(rel <= 1e-3, "fused and dense fits end far apart at full size")
    del dense_model
    sys.stdout.flush()

    print("phase 7: fused vs dense trajectories (N=100000, d=69, K=256, "
          "n_init=3)")
    xm = x[:100000].contiguous()
    c0s = batched_init("kmeans++", torch.Generator(device=dev).manual_seed(1),
                       xm, 256, 3)
    cfg = KMeansConfig(k=256)
    fused, dense = get_backend("fused"), get_backend("dense")
    bounded = get_backend("fused_bounds", group_size=ORDERED_GS)
    worst = {"labels": 0.0, "energy": 0.0, "steps": 0}
    worst_b = {"agree": 1.0, "gap": 0.0, "energy": 0.0, "steps": 0}

    def checked(x_, cs, k, carries, w=None):
        res, carries = fused.batched_step(x_, cs, k, carries, w=w)
        ref_res, _ = dense.batched_step(x_, cs, k, carries, w=w)
        worst["steps"] += 1
        worst["labels"] = max(worst["labels"], float(
            (res.labels != ref_res.labels).float().mean()))
        worst["energy"] = max(worst["energy"], float(
            ((res.energy - ref_res.energy).abs() / ref_res.energy).max()))
        return res, carries

    def checked_bounds(x_, cs, k, carries, w=None):
        res, carries = bounded.batched_step(x_, cs, k, carries, w=w)
        ref_res, _ = fused.batched_step(x_, cs, k, (), w=w)
        agree, gap = tie_gap(torch, res.labels, ref_res.labels, x_, cs)
        worst_b["steps"] += 1
        worst_b["agree"] = min(worst_b["agree"], agree)
        worst_b["gap"] = max(worst_b["gap"], gap)
        worst_b["energy"] = max(worst_b["energy"], float(
            ((res.energy - ref_res.energy).abs() / ref_res.energy).max()))
        return res, carries

    checking = dataclasses.replace(fused, name="fused+dense-check",
                                   batched_step_fn=checked)
    checking_b = dataclasses.replace(bounded, name="fused_bounds+check",
                                     batched_step_fn=checked_bounds)
    runs = {}
    for label, bk in (("fused", fused), ("dense", dense),
                      ("fused, each step redone by dense", checking),
                      (f"fused_bounds (gs {ORDERED_GS}), each step redone "
                       f"by fused", checking_b)):
        t0 = time.perf_counter()
        res = aa_kmeans_batched(xm, c0s, cfg, backend=bk)
        torch.cuda.synchronize()
        runs[label] = res
        print(f"  {label}: n_iter {res.n_iter.tolist()}, n_accepted "
              f"{res.n_accepted.tolist()}, energy "
              f"{[repr(float(e)) for e in res.energy]}, "
              f"{time.perf_counter() - t0:.2f} s")
    print(f"  {worst['steps']} fused steps redone by the dense oracle: labels"
          f" differ on at most {worst['labels']:.2e} of rows, energies by at "
          f"most {worst['energy']:.2e} relative")
    print(f"  {worst_b['steps']} fused_bounds steps redone by the fused "
          f"kernel: labels agree on at least {worst_b['agree']:.7f} of rows "
          f"(largest near-tie gap {worst_b['gap']:.2e}), energies differ by "
          f"at most {worst_b['energy']:.2e} relative")
    check(worst["labels"] <= 1e-4 and worst["energy"] <= 1e-5,
          "a fused step disagrees with the dense oracle")
    check(worst_b["agree"] == 1.0 or worst_b["gap"] <= 1e-5,
          "a fused_bounds step's labels differ from the fused kernel's "
          "beyond a near tie")
    check(worst_b["energy"] <= 1e-5,
          "a fused_bounds step's energy differs from the fused kernel's")
    e_f, e_d = runs["fused"].energy, runs["dense"].energy
    rel = float(((e_f - e_d).abs() / e_d).max())
    print(f"  free-running final energies fused vs dense: {rel:.2e} "
          f"relative at most")
    check(rel <= 1e-3, "fused and dense solves end far apart")
    check(torch.equal(runs["fused"].centroids,
                      runs["fused, each step redone by dense"].centroids),
          "the fused trajectory is not reproducible")
    del xm, runs
    sys.stdout.flush()

    phase9(torch, x, c0_main, model, zero_counts, read_counts,
           path_launches)
    errs10 = phase10(torch, dev, x, zero_counts, read_counts, path_launches,
                     tile_rows)
    main_abs_err = max(main_abs_err, errs10["fused_lloyd"])
    assign_abs_err = max(assign_abs_err, errs10["assignment"])
    update_abs_err = max(update_abs_err, errs10["update"])
    bounds_abs_err = max(bounds_abs_err, errs10["fused_bounds"])

    print("phase 8: times at the main path's shapes (CUDA events, after a "
          "warm-up)")
    n, d, k = spec.n, spec.d, MAIN_K
    c_p = c_fin[None]
    # the bounded kernel's three cases: at the init carry (ub = inf, so
    # every cell computes) with the default groups and with gs_o, and the
    # cluster-ordered run's last step
    bounds_cases = []
    for what, xb, cb, gs in (
            ("default groups, skip 0", x, c_p, gs_main),
            (f"gs {gs_o}, skip 0", x, c_p, gs_o),
            (f"gs {gs_o}, the cluster-ordered run's last step", x_ord,
             cs_last, gs_o)):
        bnds = squared_bounds(bounds.init_carry(x, cb, k, gs), cb, k, gs) \
            if xb is x else bnds_o
        skip = float(F.fused_lloyd(xb, cb, bounds=bnds, gs=gs)[6][0])
        bounds_cases.append((what, xb, cb, gs, bnds, skip))
    # the kernels the main paths launch, timed in turns (this order, then
    # the reverse), 10 launches a turn; each time is the mean of the turns
    turned = {"fused_lloyd": lambda i: F.fused_lloyd(x, c_fin),
              "assignment, all rows": lambda i: A.assignment(x, c_p),
              "update": lambda i: U.update(x, lab_p, k)}
    for what, xb, cb, gs, bnds, _ in bounds_cases:
        turned[f"fused_bounds, {what}"] = (
            lambda i, xb=xb, cb=cb, gs=gs, bnds=bnds: F.fused_lloyd(
                xb, cb, bounds=bnds, gs=gs))
    turns = {what: [] for what in turned}
    for order in (list(turned), list(reversed(turned))):
        for what in order:
            turns[what].append(event_ms(torch, turned[what], 10))
    turn_ms = {what: sum(ts) / len(ts) for what, ts in turns.items()}
    print("  in turns: " + "; ".join(
        f"{what} {ts!r} ms" for what, ts in turns.items()))
    fused_ms = turn_ms["fused_lloyd"]
    assign_full_ms = turn_ms["assignment, all rows"]
    update_ms = turn_ms["update"]
    pair_ms = assign_full_ms + update_ms
    print(f"  fused step {fused_ms!r} ms against the pallas pair "
          f"(assignment at all rows + update) {pair_ms!r} ms: "
          f"{fused_ms / pair_ms!r} of it")
    fused_plain_ms = event_ms(torch, lambda i: F.fused_lloyd_plain(x, c_fin),
                              3, warmup=1)
    fused_bytes = 4 * (n * d + k * d) + 4 * (2 * n + k * d + k + 1)
    fused_bound, fused_by, fused_fp32, fused_tc = distance_bound_ms(
        fused_bytes, 2 * n * k * d, 3 * n * k + 2 * n * d)
    step = PREDICT_CHUNK
    n_chunks = n // step

    def chunk(i):
        return x[(i % n_chunks) * step:(i % n_chunks + 1) * step]

    assign_ms = event_ms(torch, lambda i: A.assignment(chunk(i), c_fin), 50)
    assign_plain_ms = event_ms(
        torch, lambda i: A.assignment_plain(chunk(i), c_fin), 50)
    c_sq = torch.sum(c_fin * c_fin, dim=-1)

    def library(i):
        xc = chunk(i)
        return torch.argmin(torch.addmm(c_sq, xc, c_fin.T, alpha=-2.0),
                            dim=1)

    library_ms = event_ms(torch, library, 50)

    def assign_bounds(rows):
        return distance_bound_ms(4 * (rows * d + k * d) + 4 * 2 * rows,
                                 2 * rows * k * d, 3 * rows * k)

    assign_bound, assign_by, assign_fp32, assign_tc = assign_bounds(step)
    # the shape the pallas fit gives it: all rows at R = 1
    library_full_ms = event_ms(
        torch, lambda i: torch.argmin(torch.addmm(c_sq, x, c_fin.T,
                                                  alpha=-2.0), dim=1), 5)
    full_bound, full_by, full_fp32, full_tc = assign_bounds(n)
    print(f"  fused_lloyd (N={n}, K={k}, d={d}, R=1): {fused_ms!r} ms, "
          f"bound {fused_bound!r} ms ({fused_by}; FP32-core bound "
          f"{fused_fp32!r} ms, split-TF32 bound {fused_tc!r} ms), plain "
          f"{fused_plain_ms!r} ms")
    print(f"  assignment (predict chunk {step} x {k} x {d}): "
          f"{assign_ms!r} ms, bound {assign_bound!r} ms ({assign_by}; "
          f"FP32-core bound {assign_fp32!r} ms), plain {assign_plain_ms!r} "
          f"ms, matmul+argmin {library_ms!r} ms")
    print(f"  assignment (the pallas fit's shape: all {n} rows x {k} x {d}, "
          f"R=1): {assign_full_ms!r} ms, bound {full_bound!r} ms "
          f"({full_by}; FP32-core bound {full_fp32!r} ms), matmul+argmin "
          f"{library_full_ms!r} ms")
    # the update kernel on the pallas fit's labels; its library yardstick
    # is the one call that computes the sums
    update_plain_ms = event_ms(torch, lambda i: U.update_plain(x, lab_p, k),
                               3, warmup=1)
    sums_buf = torch.zeros(k, d, device=dev)
    update_lib_ms = event_ms(
        torch, lambda i: sums_buf.index_add_(0, lab_p, x), 10)
    update_bytes = 4 * (n * d + n) + 4 * (k * d + k)
    update_bound, update_by = bound_ms(update_bytes, n * d + n)
    print(f"  update (N={n}, K={k}, d={d}, R=1, labels of the pallas fit): "
          f"{update_ms!r} ms, bound {update_bound!r} ms ({update_by}), "
          f"plain {update_plain_ms!r} ms, index_add_ (sums only) "
          f"{update_lib_ms!r} ms")
    # the dense oracle's stats (lloyd.weighted_cluster_sums: one-hot
    # matmuls over row chunks, so they repeat bit for bit) against the
    # index_add_ pair they replace, and the dense step they sit in
    ones = torch.ones(n, device=dev)
    lab_l = lab_p.long()
    onehot_ms = event_ms(torch, lambda i: lloyd.weighted_cluster_sums(
        x, lab_p, ones, k), 3, warmup=1)
    index_add_ms = event_ms(torch, lambda i: (
        torch.zeros(k, d, device=dev).index_add_(0, lab_l, x),
        torch.zeros(k, device=dev).index_add_(0, lab_l, ones)), 3, warmup=1)
    dense = get_backend("dense")
    dense_step_ms = event_ms(torch, lambda i: dense.step(x, c_fin, k), 3,
                             warmup=1)
    print(f"  the dense oracle's stats (N={n}, K={k}, d={d}): one-hot "
          f"chunks {onehot_ms!r} ms, index_add_ (sums and counts) "
          f"{index_add_ms!r} ms; the dense step {dense_step_ms!r} ms")
    del ones, lab_l

    def bounds_cost(g, skip):
        """(bytes, cross-term operations, other operations) of one bounded
        step with G groups of which the share ``skip`` of (tile, group)
        cells is skipped."""
        n_bytes = 4 * (n * d + k * d + 2 * n + n * g) \
            + 4 * (2 * n + n * g + k * d + k + 1) + 8
        return (n_bytes, (1.0 - skip) * 2 * n * k * d,
                (1.0 - skip) * 3 * n * k + 2 * n * d)

    bounds_rows = []
    for what, xb, cb, gs, bnds, skip in bounds_cases:
        ms = turn_ms[f"fused_bounds, {what}"]
        b_ms, b_by, b_fp32, _ = distance_bound_ms(
            *bounds_cost(bnds[1].shape[-1], skip))
        bounds_rows.append((what, skip, ms, b_ms, b_by, b_fp32, bnds))
        print(f"  fused_bounds ({what}: G={bnds[1].shape[-1]}, skipped "
              f"{skip!r}): {ms!r} ms ({ms / fused_ms!r} of the fused step), "
              f"bound {b_ms!r} ms ({b_by}; FP32-core bound {b_fp32!r} ms)")
    del bounds_cases
    (_, skip0, bounds_ms_main, bounds_bound, bounds_by, bounds_fp32,
     bnds0) = bounds_rows[0]
    bounds_plain_ms = event_ms(
        torch, lambda i: F.fused_bounds_plain(x, c_p, None, *bnds0,
                                              gs_main, tile_rows), 3,
        warmup=1)
    print(f"  fused_bounds plain (default groups, skip 0): "
          f"{bounds_plain_ms!r} ms; the ordered run converged at skip "
          f"{skip_conv!r}")
    kernel_s = fused_launches * fused_ms / 1e3
    print(f"  fit of phase 5 split: seeding {seed_s!r} s, fused launches x "
          f"kernel time {kernel_s!r} s, the rest (host loop, Anderson "
          f"window) {fit_s - seed_s - kernel_s!r} s")
    # one trip of the solver loop at the main path's shapes, with the
    # loop's one sync: the fused kernel's share of it bounds the device's
    # idle share from above
    cfg_main = KMeansConfig(k=k)
    bst = _init_state(x, c_fin[None], cfg_main, fused)
    trips = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(trips):
        bst = batched_trip(x, bst, cfg_main, fused)
        bool(torch.any(bst.pending))
    trip_ms = (time.perf_counter() - t0) / trips * 1e3
    print(f"  one loop trip: {trip_ms!r} ms wall; the fused kernel is "
          f"{fused_ms / trip_ms!r} of it, so the device idles at most "
          f"{max(0.0, 1 - fused_ms / trip_ms)!r} of a trip")
    print("  launches per path: " + "; ".join(
        f"{path}: " + ", ".join(f"{kn} {v}" for kn, v in c.items() if v)
        for path, c in path_launches.items()))
    total = {kn: sum(c[kn] for c in path_launches.values())
             for kn in counters}
    kernels = [
        {"name": "fused_lloyd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fused_lloyd.cu",
         "replaces": "src/repro/kernels/fused_lloyd.py:55",
         "launches": total["fused_lloyd"], "max_abs_err": main_abs_err,
         "ms": fused_ms, "plain_ms": fused_plain_ms,
         "bound_ms": fused_bound, "bound_by": fused_by,
         "fp32_bound_ms": fused_fp32, "library_ms": None},
        {"name": "assignment", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/assignment.cu",
         "replaces": "src/repro/kernels/assignment.py:37",
         "launches": total["assignment"], "max_abs_err": assign_abs_err,
         "ms": assign_ms, "plain_ms": assign_plain_ms,
         "bound_ms": assign_bound, "bound_by": assign_by,
         "fp32_bound_ms": assign_fp32, "library_ms": library_ms,
         "all_rows": {"ms": assign_full_ms, "bound_ms": full_bound,
                      "bound_by": full_by, "fp32_bound_ms": full_fp32,
                      "library_ms": library_full_ms}},
        {"name": "update", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/update.cu",
         "replaces": "src/repro/kernels/update.py:30",
         "launches": total["update"], "max_abs_err": update_abs_err,
         "ms": update_ms, "plain_ms": update_plain_ms,
         "bound_ms": update_bound, "bound_by": update_by,
         "fp32_bound_ms": update_bound, "library_ms": update_lib_ms},
        {"name": "fused_bounds", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fused_bounds.cu",
         "replaces": "src/repro/kernels/fused_lloyd.py:123",
         "launches": total["fused_bounds"], "max_abs_err": bounds_abs_err,
         "ms": bounds_ms_main, "plain_ms": bounds_plain_ms,
         "bound_ms": bounds_bound, "bound_by": bounds_by,
         "fp32_bound_ms": bounds_fp32, "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    return smi, name


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        print(f"chip_smoke: the port (src/repro_torch) is not under {ROOT}",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    try:
        smi, name = run()
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(f"power: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
