"""Paper Table 3 on the port: AA-KMeans against Lloyd across seedings and
cluster counts (counterpart of ``benchmarks/table3_vs_lloyd.py``).

Protocol, the reference's: for each dataset and each seeding in
{kmeans++, afk-mc2, bf, clarans} at K = 10, plus CLARANS at K = 100, run
Lloyd and Algorithm 1 from the SAME initial centroids to convergence
(at most 1000 iterations) and report iterations, warm wall time
and MSE.  Claims it measures (paper Sec. 3.2): AA wins most cases, a
mean time decrease of 25-33 %, MSE parity with Lloyd.

Lloyd column.  With ``backend="dense"`` it is the reference's protocol
unchanged: ``lloyd_kmeans`` against ``aa_kmeans(backend="dense")``.
With another backend the reference swaps only AA's engine, which would
time a kernel against plain torch; here the Lloyd column runs through
the same engine instead, as ``aa_kmeans(KMeansConfig(accelerated=False),
backend=...)`` (the reference's own plain-Lloyd route, the one its
``bf_init`` takes), and the summary counts wins against that column.

Timing.  Host clock, one untimed run then the median of ``reps`` (3),
each ending in ``torch.cuda.synchronize()``; seeding is timed apart.
The reference times jitted whole-loop programs; here Lloyd and AA are
both host loops, with one device-to-host sync per Lloyd iteration and
per AA trip.

    PYTHONPATH=src python -m benchmarks_torch.table3_vs_lloyd [--scale S]
        [--datasets A,B] [--cut NAME=SCALE] [--backend fused] [--out PATH]

writes ``BENCH_port_table3.json`` at the repo root (after every
dataset, with ``"complete": false`` until the last).
"""

from __future__ import annotations

import time

import torch

from benchmarks_torch.common import (MAX_ITER, csv_row, dataset,
                                     parse_args, record, scale_of, sync,
                                     timed)
from repro_torch.core.init_schemes import (afkmc2_init, bf_init,
                                           clarans_init, kmeanspp_init)
from repro_torch.core.kmeans import KMeansConfig, aa_kmeans
from repro_torch.core.lloyd import lloyd_kmeans
from repro_torch.data.synthetic import DATASETS
from repro_torch.device import resolve_device

INITS = {"kmeans++": kmeanspp_init, "afk-mc2": afkmc2_init,
         "bf": bf_init, "clarans": clarans_init}

TIMING = ("host clock; 1 warm-up then the median of 3 runs, each ending "
          "in torch.cuda.synchronize(); Lloyd and AA are both host loops, "
          "one sync per Lloyd iteration and per AA trip; seeding timed "
          "apart")


def lloyd_route(backend: str) -> str:
    return "lloyd_kmeans" if backend == "dense" else \
        f"aa_kmeans(accelerated=False, backend={backend!r})"


def seed_case(init_name: str, x, k: int, seed: int):
    """(c0, seconds) of one seeding on a fresh generator on x's device."""
    gen = torch.Generator(device=x.device).manual_seed(seed)
    sync()
    t0 = time.perf_counter()
    c0 = INITS[init_name](gen, x, k)
    sync()
    return c0, time.perf_counter() - t0


def one_case(x, c0, k, backend="dense", reps=3):
    """Lloyd and AA from the same c0 -> the case's iterations, times and
    MSEs."""
    if backend == "dense":
        (_, _, e_l, it_l), t_l = timed(
            lambda: lloyd_kmeans(x, c0, k, MAX_ITER), reps=reps)
    else:
        lcfg = KMeansConfig(k=k, max_iter=MAX_ITER, accelerated=False)
        res_l, t_l = timed(lambda: aa_kmeans(x, c0, lcfg, backend=backend),
                           reps=reps)
        e_l, it_l = res_l.energy, res_l.n_iter
    cfg = KMeansConfig(k=k, max_iter=MAX_ITER)
    res, t_a = timed(lambda: aa_kmeans(x, c0, cfg, backend=backend),
                     reps=reps)
    n = x.shape[0]
    return {"lloyd_iter": int(it_l), "lloyd_time_s": t_l,
            "lloyd_mse": float(e_l) / n,
            "aa_a": int(res.n_accepted), "aa_b": int(res.n_iter),
            "aa_time_s": t_a, "aa_mse": float(res.energy) / n}


def summarize(cases) -> dict:
    wins = sum(1 for c in cases if c["aa_time_s"] < c["lloyd_time_s"])
    iter_wins = sum(1 for c in cases if c["aa_b"] < c["lloyd_iter"])
    mean_dec = sum(1 - c["aa_time_s"] / c["lloyd_time_s"]
                   for c in cases) / max(len(cases), 1)
    mse_ok = sum(1 for c in cases if c["aa_mse"] <= c["lloyd_mse"] * 1.01)
    return {"cases": cases, "wins": wins, "iter_wins": iter_wins,
            "total": len(cases), "mean_time_decrease": mean_dec,
            "mse_parity": mse_ok}


def run(scale=0.05, datasets=None, seed=0, ks=(10,), clarans_ks=(10, 100),
        verbose=True, backend="dense", device=None, cuts=None, reps=3,
        on_dataset=None):
    """The protocol over ``datasets`` (default all 20) -> the reference's
    summary (``wins``, ``iter_wins``, ``total``, ``mean_time_decrease``,
    ``mse_parity``, ``cases``).  ``cuts`` {name: scale} runs a dataset at
    a smaller scale; ``on_dataset(summary)`` is called after each."""
    dev = resolve_device(device)
    cases = []
    for name in (datasets or list(DATASETS)):
        sc = scale_of(name, scale, cuts)
        x = dataset(name, sc, seed, dev)
        for init_name in INITS:
            for k in (clarans_ks if init_name == "clarans" else ks):
                if k >= x.shape[0] // 4:
                    continue
                c0, seed_s = seed_case(init_name, x, k, seed)
                case = one_case(x, c0, k, backend, reps)
                case.update(dataset=name, n=x.shape[0], scale=sc,
                            init=init_name, k=k, seed_s=seed_s)
                cases.append(case)
                if verbose:
                    print(f"{name:18s} {init_name:9s} K={k:4d} | seed "
                          f"{seed_s * 1e3:8.1f}ms | lloyd "
                          f"{case['lloyd_iter']:4d}it "
                          f"{case['lloyd_time_s'] * 1e3:9.1f}ms mse "
                          f"{case['lloyd_mse']:10.4f} | aa {case['aa_a']}/"
                          f"{case['aa_b']} {case['aa_time_s'] * 1e3:9.1f}ms "
                          f"mse {case['aa_mse']:10.4f}", flush=True)
        del x
        if on_dataset is not None:
            on_dataset(summarize(cases))
    return summarize(cases)


def main():
    a = parse_args("Paper Table 3 on the port", "BENCH_port_table3.json")
    dev = resolve_device(a.device)
    notes = f"{TIMING}; Lloyd column: {lloyd_route(a.backend)}"

    def write(summary, complete):
        record(a.out, "table3_vs_lloyd", summary, scale=a.scale,
               cuts=a.cuts, backend=a.backend, device=dev,
               complete=complete, notes=notes)

    s = run(scale=a.scale, datasets=a.datasets, backend=a.backend,
            device=dev, cuts=a.cuts,
            on_dataset=lambda part: write(part, False))
    write(s, True)
    print(csv_row("table3.aa_vs_lloyd", 0.0,
                  f"wins={s['wins']}/{s['total']} "
                  f"iter_wins={s['iter_wins']}/{s['total']} "
                  f"mean_time_decrease={s['mean_time_decrease']:.1%} "
                  f"mse_parity={s['mse_parity']}/{s['total']}"))
    return s


if __name__ == "__main__":
    main()
