#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the CUDA kernels from src/repro_torch/kernels/csrc, in parallel;
  3. every kernel against its plain PyTorch version at small ragged,
     weighted, batched and wide shapes;
  4. repeated launches of every case are bitwise equal;
  5. the main path at full size: AAKMeans(n_clusters=1000,
     backend="fused").fit(x).predict(x) on the USCensus1990 shape
     (2,458,285 x 69 f32); launch counts prove it ran on the kernels;
     both kernels against their plain versions on the final centroids,
     the assignment on a full and on the padded tail predict chunk;
  6. the dense oracle's fit from the same seeds at full size ends at the
     fused fit's energy;
  7. fused against dense trajectories at a mid size, every fused step
     redone by the dense oracle;
  8. kernel times (CUDA events) at the main path's shapes, beside their
     bound, plain and library times.
Prints one {"kernels": [...]} line, the card's name and power limit, and
last {"ok": true, "device": {...}}.  Exits non-zero without that line
when there is no CUDA device or the port is not beside this script.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_FP32_PER_S = 67e12        # H100 SXM FP32, CUDA cores
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
]


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


def compare(torch, got, want, x, c, w):
    """Kernel outputs against the plain version's on the same inputs.
    Labels may differ only where the two distances tie to within the
    reported gap; stats are compared for the assignment the kernel made."""
    from repro_torch.kernels import ref
    lab, mind = got[0], got[1]
    lab_p, mind_p = want[0], want[1]
    xs = x if x.dim() == 3 else x.expand(c.shape[0], *x.shape)
    diff = lab != lab_p
    gap = 0.0
    if bool(diff.any()):
        # distances of each differing row to both candidates, in f64
        rr, nn = torch.nonzero(diff, as_tuple=True)
        xr = xs[rr, nn].double()
        d_k = ((xr - c[rr, lab[rr, nn].long()].double()) ** 2).sum(-1)
        d_p = ((xr - c[rr, lab_p[rr, nn].long()].double()) ** 2).sum(-1)
        gap = float(((d_k - d_p).abs() / d_p.abs().clamp_min(1.0)).max())
    scale = mind_p.abs().clamp_min(1.0)
    mind_err = float(((mind - mind_p).abs() / scale).max())
    out = {"agree": float(1.0 - diff.float().mean()), "gap": gap,
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


def run():
    """All phases; returns (nvidia-smi line, device name).  Raises
    PhaseError (or whatever a failing call raises) on the first failure."""
    import numpy as np
    import torch
    from repro_torch.core import AAKMeans, get_backend
    from repro_torch.core.api import PREDICT_CHUNK
    from repro_torch.core.init_schemes import batched_init
    from repro_torch.core.kmeans import (KMeansConfig, _init_state,
                                         aa_kmeans_batched, batched_trip)
    from repro_torch.data.synthetic import DATASETS, make_dataset
    from repro_torch.device import resolve_device
    from repro_torch.kernels import assignment as A
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_lloyd as F
    from repro_torch.kernels.tiles import pad_rows

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
            if "registers" in line or "spill" in line:
                print(f"    {line.strip()}")
    sys.stdout.flush()

    print("phase 3: kernels against their plain versions")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for label, n, k, d, r, x_per, wkind in CASES:
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
        got_f = lift(F.fused_lloyd(x, ck, w))
        got_a = lift(A.assignment(x, ck))
        want_f = lift(F.fused_lloyd_plain(x, ck, w))
        res_f = compare(torch, got_f, want_f, x, c, w)
        res_a = compare(torch, got_a, want_f[:2], x, c, None)
        print(f"  [{label}: N={n} K={k} d={d} R={rr}] fused: {fmt(res_f)};"
              f" assignment: {fmt(res_a)}")
        accept(res_f, f"fused [{label}]")
        accept(res_a, f"assignment [{label}]")
        cases.append((x, ck, w, got_f, got_a, lift))

    print("phase 4: repeated launches are bitwise equal")
    for (x, c, w, got_f, got_a, lift), case in zip(cases, CASES):
        again_f = lift(F.fused_lloyd(x, c, w))
        again_a = lift(A.assignment(x, c))
        for a, b in zip(got_f + got_a, again_f + again_a):
            check(torch.equal(a, b), f"[{case[0]}] relaunch differs")
    print(f"  all {len(cases)} cases, both kernels: equal")
    del cases
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
    batched_init("kmeans++", torch.Generator(device=dev).manual_seed(0), x,
                 MAIN_K, 1)
    torch.cuda.synchronize()
    seed_s = time.perf_counter() - t0
    model = AAKMeans(n_clusters=MAIN_K, backend="fused", n_init=1)
    F.launches = A.launches = F.plain_calls = A.plain_calls = 0
    t0 = time.perf_counter()
    model.fit(x)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    labels = model.predict(x)
    predict_s = time.perf_counter() - t0
    fused_launches, assign_launches = F.launches, A.launches
    plain = F.plain_calls + A.plain_calls
    converged = model.n_iter_ <= model.max_iter
    # one fused launch seeds the loop, then one per trip; an accepted
    # iteration is one trip, a rejected one two (the paper's 2t - a)
    trips = 2 * model.n_iter_ - 2 + int(converged) - model.n_accepted_
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
    agree = float((torch.from_numpy(labels).to(dev) == got[0]).float()
                  .mean())
    print(f"  predict labels vs the fused step's on the same centroids: "
          f"{agree:.7f} equal")
    check(agree == 1.0, "predict and the fused step disagree")
    main_abs_err = res_main["mind_abs"]
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
    worst = {"labels": 0.0, "energy": 0.0, "steps": 0}

    def checked(x_, cs, k, carries, w=None):
        res, carries = fused.batched_step(x_, cs, k, carries, w=w)
        ref_res, _ = dense.batched_step(x_, cs, k, carries, w=w)
        worst["steps"] += 1
        worst["labels"] = max(worst["labels"], float(
            (res.labels != ref_res.labels).float().mean()))
        worst["energy"] = max(worst["energy"], float(
            ((res.energy - ref_res.energy).abs() / ref_res.energy).max()))
        return res, carries

    checking = dataclasses.replace(fused, name="fused+dense-check",
                                   batched_step_fn=checked)
    runs = {}
    for label, bk in (("fused", fused), ("dense", dense),
                      ("fused, each step redone by dense", checking)):
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
    check(worst["labels"] <= 1e-4 and worst["energy"] <= 1e-5,
          "a fused step disagrees with the dense oracle")
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

    print("phase 8: times at the main path's shapes (CUDA events, after a "
          "warm-up)")
    n, d, k = spec.n, spec.d, MAIN_K
    fused_ms = event_ms(torch, lambda i: F.fused_lloyd(x, c_fin), 10)
    fused_plain_ms = event_ms(torch, lambda i: F.fused_lloyd_plain(x, c_fin),
                              3, warmup=1)
    fused_bytes = 4 * (n * d + k * d) + 4 * (2 * n + k * d + k + 1)
    fused_ops = 2 * n * k * d + 3 * n * k + 2 * n * d
    fused_bound, fused_by = bound_ms(fused_bytes, fused_ops)
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
    assign_bytes = 4 * (step * d + k * d) + 4 * 2 * step
    assign_ops = 2 * step * k * d + 3 * step * k
    assign_bound, assign_by = bound_ms(assign_bytes, assign_ops)
    print(f"  fused_lloyd (N={n}, K={k}, d={d}, R=1): {fused_ms!r} ms, "
          f"bound {fused_bound!r} ms ({fused_by}), plain "
          f"{fused_plain_ms!r} ms")
    print(f"  assignment (predict chunk {step} x {k} x {d}): "
          f"{assign_ms!r} ms, bound {assign_bound!r} ms ({assign_by}), "
          f"plain {assign_plain_ms!r} ms, matmul+argmin {library_ms!r} ms")
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
    kernels = [
        {"name": "fused_lloyd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fused_lloyd.cu",
         "replaces": "src/repro/kernels/fused_lloyd.py:55",
         "launches": fused_launches, "max_abs_err": main_abs_err,
         "ms": fused_ms, "plain_ms": fused_plain_ms,
         "bound_ms": fused_bound, "bound_by": fused_by, "library_ms": None},
        {"name": "assignment", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/assignment.cu",
         "replaces": "src/repro/kernels/assignment.py:37",
         "launches": assign_launches, "max_abs_err": assign_abs_err,
         "ms": assign_ms, "plain_ms": assign_plain_ms,
         "bound_ms": assign_bound, "bound_by": assign_by,
         "library_ms": library_ms},
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
