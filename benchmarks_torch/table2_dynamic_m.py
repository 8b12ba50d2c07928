"""Paper Table 2 on the port: fixed-m against dynamic-m Anderson
acceleration (counterpart of ``benchmarks/table2_dynamic_m.py``).

Protocol, the reference's: for each dataset (the Table 1 stand-ins at
``scale``), K = 10 and K-Means++ seeds, run AA-KMeans with fixed m in
{2, 5} and with dynamic m started at {2, 5}; report a/b iterations, warm
wall time and MSE, and for the dynamic runs the mean and largest window
size over the iterations (from an untimed traced run; the headline time
stays the untraced run's).  Claim it measures (Sec. 3.1): dynamic m
takes less time than the same fixed m on most datasets.

Timing: host clock, one warm-up then the median of ``reps`` (3) runs, each
ending in ``torch.cuda.synchronize()``; AA is a host loop with one
device-to-host sync per trip (the reference times a jitted whole loop).

    PYTHONPATH=src python -m benchmarks_torch.table2_dynamic_m [--scale S]
        [--datasets A,B] [--cut NAME=SCALE] [--backend fused] [--out PATH]

writes ``BENCH_port_table2.json`` at the repo root (after every
dataset, with ``"complete": false`` until the last).
"""

from __future__ import annotations

import torch

from benchmarks_torch.common import (MAX_ITER, csv_row, dataset,
                                     parse_args, record, scale_of, timed,
                                     traced_run)
from repro_torch.core.anderson import AAConfig
from repro_torch.core.init_schemes import kmeanspp_init
from repro_torch.core.kmeans import KMeansConfig, aa_kmeans
from repro_torch.data.synthetic import DATASETS
from repro_torch.device import resolve_device

TIMING = ("host clock; 1 warm-up then the median of 3 runs, each ending "
          "in torch.cuda.synchronize(); AA is a host loop, one sync per "
          "trip; the m statistics come from an untimed traced run")


def run_one(x, c0, k, m0, dynamic, backend="dense", reps=3):
    cfg = KMeansConfig(k=k, max_iter=MAX_ITER,
                       aa=AAConfig(m0=m0, dynamic_m=dynamic))
    res, dt = timed(lambda: aa_kmeans(x, c0, cfg, backend=backend),
                    reps=reps)
    out = {"a": int(res.n_accepted), "b": int(res.n_iter),
           "time_s": dt, "mse": float(res.energy) / x.shape[0]}
    if dynamic:
        tr = traced_run(x, c0, cfg, backend=backend, warmup=False)
        out["mean_m"] = (sum(tr.m_values) / len(tr.m_values)
                         if tr.m_values else float(m0))
        out["max_m"] = max(tr.m_values, default=m0)
    return out


def summarize(rows, wins, total) -> dict:
    return {"wins_dynamic_m2": wins[2], "wins_dynamic_m5": wins[5],
            "total": total[2], "rows": rows}


def run(scale=0.05, k=10, datasets=None, seed=0, verbose=True,
        backend="dense", device=None, cuts=None, reps=3, on_dataset=None):
    """The protocol over ``datasets`` (default all 20) -> the reference's
    summary (``wins_dynamic_m2``, ``wins_dynamic_m5``, ``total``,
    ``rows``).  ``cuts`` {name: scale} runs a dataset at a smaller scale;
    ``on_dataset(summary)`` is called after each."""
    dev = resolve_device(device)
    rows = []
    wins = {2: 0, 5: 0}
    total = {2: 0, 5: 0}
    for name in (datasets or list(DATASETS)):
        sc = scale_of(name, scale, cuts)
        x = dataset(name, sc, seed, dev)
        c0 = kmeanspp_init(torch.Generator(device=dev).manual_seed(seed), x,
                           k)
        line = {"dataset": name, "n": x.shape[0], "scale": sc}
        for m0 in (2, 5):
            fx = run_one(x, c0, k, m0, False, backend, reps)
            dy = run_one(x, c0, k, m0, True, backend, reps)
            line[f"fixed_m{m0}"] = fx
            line[f"dyn_m{m0}"] = dy
            total[m0] += 1
            if dy["time_s"] <= fx["time_s"]:
                wins[m0] += 1
        rows.append(line)
        del x
        if verbose:
            f2, d2 = line["fixed_m2"], line["dyn_m2"]
            f5, d5 = line["fixed_m5"], line["dyn_m5"]
            print(f"{name:20s} N={line['n']:7d} | m=2 fixed {f2['a']}/"
                  f"{f2['b']} {f2['time_s'] * 1e3:8.1f}ms vs dyn {d2['a']}/"
                  f"{d2['b']} {d2['time_s'] * 1e3:8.1f}ms "
                  f"(m~{d2['mean_m']:.1f}) | m=5 fixed {f5['a']}/{f5['b']} "
                  f"{f5['time_s'] * 1e3:8.1f}ms vs dyn {d5['a']}/{d5['b']} "
                  f"{d5['time_s'] * 1e3:8.1f}ms (m~{d5['mean_m']:.1f})",
                  flush=True)
        if on_dataset is not None:
            on_dataset(summarize(rows, wins, total))
    return summarize(rows, wins, total)


def main():
    a = parse_args("Paper Table 2 on the port", "BENCH_port_table2.json")
    dev = resolve_device(a.device)

    def write(summary, complete):
        record(a.out, "table2_dynamic_m", summary, scale=a.scale,
               cuts=a.cuts, backend=a.backend, device=dev,
               complete=complete, notes=TIMING)

    s = run(scale=a.scale, datasets=a.datasets, backend=a.backend,
            device=dev, cuts=a.cuts,
            on_dataset=lambda part: write(part, False))
    write(s, True)

    def mean_t(key):
        return sum(r[key]["time_s"] for r in s["rows"]) / len(s["rows"])

    print(csv_row("table2.fixed_m2", mean_t("fixed_m2") * 1e6,
                  f"wins_dyn={s['wins_dynamic_m2']}/{s['total']}"))
    print(csv_row("table2.dynamic_m2", mean_t("dyn_m2") * 1e6))
    print(csv_row("table2.fixed_m5", mean_t("fixed_m5") * 1e6,
                  f"wins_dyn={s['wins_dynamic_m5']}/{s['total']}"))
    print(csv_row("table2.dynamic_m5", mean_t("dyn_m5") * 1e6))
    return s


if __name__ == "__main__":
    main()
