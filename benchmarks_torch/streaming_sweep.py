"""Streaming sweep on the port: mini-batch AA against mini-batch Lloyd and
full-batch AA (counterpart of ``benchmarks/streaming_sweep.py``).

    PYTHONPATH=src python -m benchmarks_torch.streaming_sweep \
        [--datasets A,B] [--scale S] [--backend fused] [--out PATH]

Two measurements:

1. quality, on the paper's Table 1 stand-ins.  Full-batch AA from the
   seeds (K-Means++ on the first rows) sets the target energy and its
   samples-read budget, (2t - a) N by the pass-count model (one pass per
   accepted iteration, two per rejected one).  Each mini-batch arm (AA
   and plain Lloyd, the same chunks and guard) then runs epoch by epoch
   from the same seeds; after every epoch its guard-picked centroids are
   priced on the FULL X (a measurement pass, not counted), and the arm
   records the samples it had read - chunk rows plus the validation rows
   the guard reads - and the time its epochs and their guard picks took
   (each timed, the pricing not) when it first comes within ``--target``
   (2 %) of the full-batch energy.  The reference's acceptance:
   mini-batch AA within 2 % on at most half of full-batch AA's samples.  Per dataset the
   validation chunk is min(val, N / 8) rows and a chunk
   min(chunk, (N - val) / 4), so every stand-in has at least four.

2. ingest, the streamed driver over a host-resident X (one stand-in,
   default Kddcup99, the largest): ``aa_kmeans_minibatch_streamed`` at
   prefetch 1 and prefetch 2 in turns (1, 2, 2, 1), each result equal bit
   for bit, with wall time, ingest GB/s, the per-chunk medians of the host
   gather, the pinned staging and the copy (CUDA events), and the peak
   device memory above what was allocated before the call; beside them
   ``aa_kmeans_minibatch`` over the same rows resident on the device.

Timing as ``benchmarks_torch/common.py::timed``: host clock, each run
ending in ``torch.cuda.synchronize()``, warm (one untimed run first);
the full-batch solve and one epoch of each arm from the seeds are the
median of 3; an arm's time to the target is its one run, after that
warm-up.

writes ``BENCH_port_streaming.json`` at the repo root.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from benchmarks_torch.common import (MAX_ITER, ROOT, csv_row, dataset,
                                     record, sync, timed)
from repro_torch.core.init_schemes import kmeanspp_init
from repro_torch.core.kmeans import (KMeansConfig, aa_kmeans,
                                     aa_kmeans_minibatch,
                                     aa_kmeans_minibatch_streamed,
                                     resolve_backend)
from repro_torch.core.minibatch import (MiniBatchConfig, guard_pick,
                                        minibatch_init, run_epoch)
from repro_torch.data.streaming import chunk_dataset, split_validation
from repro_torch.data.synthetic import DATASETS, make_dataset
from repro_torch.device import resolve_device
from repro_torch.runtime.prefetch import IngestMeter

TIMING = ("host clock, each run ending in torch.cuda.synchronize(); one "
          "untimed run first; full-batch solve and one epoch of each "
          "mini-batch arm from the seeds: median of 3; time_to_target_s: "
          "the arm's epochs and their guard picks as run, each timed, "
          "summed, the pricing passes not")


def _full_energy(x, c, k, bk) -> float:
    return float(bk.step(x, c, k, bk.init_carry(x, c, k))[0].energy)


def _arm(dc, x_val, x_price, c0, cfg, bk, target, max_epochs, seed):
    """One mini-batch arm epoch by epoch until its guard-picked centroids
    price within ``target`` on ``x_price`` -> (samples read, full-X
    energy, epochs used, seconds; max_epochs + 1 marks a miss).  The
    seconds are the host clock around each epoch and its guard pick,
    each ending in a sync, summed over the epochs run; the pricing pass
    is not timed."""
    n_chunks, b = dc.weights.shape
    v = x_val.shape[0]
    gen = torch.Generator().manual_seed(seed)
    state = minibatch_init(c0, cfg, bk)
    samples, e_now, train_s = 0, float("inf"), 0.0
    for epoch in range(1, max_epochs + 1):
        perm = torch.randperm(n_chunks, generator=gen).tolist()
        sync()
        t0 = time.perf_counter()
        state, _ = run_epoch(dc.chunks, dc.weights, x_val, state, cfg, bk,
                             perm)
        c_now = guard_pick(x_val, state, cfg, bk)[0]
        sync()
        train_s += time.perf_counter() - t0
        # each chunk step reads its B rows and the guard's V rows
        samples += n_chunks * (b + v)
        e_now = _full_energy(x_price, c_now, cfg.k, bk)
        if e_now <= target:
            return samples, e_now, epoch, train_s
    return samples, e_now, max_epochs + 1, train_s


def quality_case(x, k, chunk, val, backend, seed=0, decay=0.9,
                 max_epochs=12, rel_target=0.02, reps=3):
    """Full-batch AA, mini-batch AA and mini-batch Lloyd on x from the
    same seeds -> the case's record."""
    n = x.shape[0]
    val = min(val, n // 8)
    chunk = min(chunk, (n - val) // 4)
    bk = resolve_backend(backend)
    gen = torch.Generator(device=x.device).manual_seed(seed)
    x_train, x_val = split_validation(x, val, gen)
    c0 = kmeanspp_init(torch.Generator(device=x.device).manual_seed(seed + 1),
                       x[:4 * chunk], k)
    full, full_s = timed(lambda: aa_kmeans(
        x, c0, KMeansConfig(k=k, max_iter=MAX_ITER), backend=bk), reps=reps)
    t, a = int(full.n_iter), int(full.n_accepted)
    e_full = float(full.energy)
    out = {"n": n, "k": k, "chunk": chunk, "val": val, "decay": decay,
           "full": {"energy": e_full, "n_iter": t, "n_accepted": a,
                    "samples": (2 * t - a) * n, "time_s": full_s}}
    dc = chunk_dataset(x_train, chunk)
    for label, accelerated in (("minibatch-aa", True),
                               ("minibatch-lloyd", False)):
        cfg = MiniBatchConfig(k=k, chunk_size=chunk, decay=decay,
                              accelerated=accelerated)
        # the epoch timing's untimed first run also warms the arm
        perm = list(range(dc.chunks.shape[0]))
        _, epoch_s = timed(lambda: run_epoch(
            dc.chunks, dc.weights, x_val, minibatch_init(c0, cfg, bk), cfg,
            bk, perm), reps=reps)
        samples, e, epochs, train_s = _arm(
            dc, x_val, x, c0, cfg, bk, e_full * (1.0 + rel_target),
            max_epochs, seed + 2)
        out[label] = {"energy": e, "samples": samples, "epochs": epochs,
                      "reached": epochs <= max_epochs,
                      "ratio": samples / out["full"]["samples"],
                      "epoch_s": epoch_s, "time_to_target_s": train_s}
    return out


def run(scale=1.0, datasets=None, seed=0, k=20, chunk=8192, val=2048,
        max_epochs=12, rel_target=0.02, backend="dense", device=None,
        reps=3, verbose=True, on_dataset=None):
    """The quality protocol over ``datasets`` (default all 20 stand-ins)
    -> {"cases": [...], "aa_reached", "aa_within_half", "total"}.
    ``on_dataset(summary)`` is called after each."""
    dev = resolve_device(device)
    cases = []

    def summary():
        aa = [c["minibatch-aa"] for c in cases]
        return {"cases": cases, "total": len(cases),
                "aa_reached": sum(a["reached"] for a in aa),
                "aa_within_half": sum(a["reached"] and a["ratio"] <= 0.5
                                      for a in aa),
                "lloyd_reached": sum(c["minibatch-lloyd"]["reached"]
                                     for c in cases)}

    for name in (datasets or list(DATASETS)):
        x = dataset(name, scale, seed, dev)
        case = quality_case(x, k, chunk, val, backend, seed=seed,
                            max_epochs=max_epochs, rel_target=rel_target,
                            reps=reps)
        case["dataset"] = name
        cases.append(case)
        if verbose:
            f, aa, ll = (case["full"], case["minibatch-aa"],
                         case["minibatch-lloyd"])
            print(f"{name:18s} N={case['n']:8d} B={case['chunk']:5d} | full"
                  f" {f['n_iter']:4d}it {f['time_s'] * 1e3:9.1f}ms | aa "
                  f"{aa['ratio']:6.3f}x ({aa['epochs']} ep, "
                  f"{aa['time_to_target_s'] * 1e3:9.1f}ms) | lloyd "
                  f"{ll['ratio']:6.3f}x ({ll['epochs']} ep, "
                  f"{ll['time_to_target_s'] * 1e3:9.1f}ms)", flush=True)
        del x
        if on_dataset is not None:
            on_dataset(summary())
    return summary()


def _median(v):
    return float(np.median(v)) if len(v) else None


def ingest_demo(name="Kddcup99", scale=1.0, k=20, chunk=65536, val=8192,
                epochs=2, seed=0, backend="dense", device=None,
                verbose=True):
    """The streamed driver over the host-resident stand-in ``name`` at
    prefetch 1 and 2, in turns (1, 2, 2, 1) -> the arms' records, whether
    every result was equal bit for bit, and the device-resident driver's
    time over the same rows."""
    dev = resolve_device(device)
    x = make_dataset(name, scale=scale, seed=seed)    # host memory only
    n, d = x.shape
    val = min(val, n // 8)
    chunk = min(chunk, (n - val) // 4)
    x_val = torch.from_numpy(x[:val]).to(dev)
    x_host = x[val:]
    c0 = kmeanspp_init(torch.Generator(device=dev).manual_seed(seed), x_val,
                       k)
    bk = resolve_backend(backend)
    cfg = MiniBatchConfig(k=k, chunk_size=chunk, epochs=epochs)
    cuda = dev.type == "cuda"

    def arm(prefetch):
        meter = IngestMeter()
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
            before = torch.cuda.memory_allocated(dev)
        sync()
        t0 = time.perf_counter()
        meter.start()
        res = aa_kmeans_minibatch_streamed(
            x_host, x_val, c0, cfg, backend=bk, seed=seed, prefetch=prefetch,
            drop_remainder=True, meter=meter, device=dev)
        sync()
        wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated(dev) - before) / 1e6 \
            if cuda else None
        return res, {"prefetch": prefetch, "wall_s": wall,
                     "steps": res.n_steps, "chunks": meter.chunks,
                     "bytes": meter.bytes, "gbps": meter.bytes / wall / 1e9,
                     "gather_ms_median": _median(meter.fetch_s) * 1e3,
                     "stage_ms_median": _median(meter.stage_s) * 1e3,
                     "copy_ms_median": _median(meter.copy_ms()),
                     "peak_device_mb": peak}

    # one untimed run first (kernel builds, the allocator's pools)
    aa_kmeans_minibatch_streamed(
        x_host[:2 * chunk], x_val, c0, dataclasses.replace(cfg, epochs=1),
        backend=bk, seed=seed, drop_remainder=True, device=dev)
    runs = [arm(p) for p in (1, 2, 2, 1)]
    first = runs[0][0]
    equal = all(torch.equal(r.centroids, first.centroids)
                and torch.equal(r.energy, first.energy)
                and r.n_steps == first.n_steps for r, _ in runs)
    arms = [rec for _, rec in runs]
    n_train = x_host.shape[0]
    dc = chunk_dataset(torch.from_numpy(x_host[:n_train - n_train % chunk])
                       .to(dev), chunk)
    res_dev, resident_s = timed(lambda: aa_kmeans_minibatch(
        dc.chunks, dc.weights, x_val, c0, cfg, backend=bk,
        generator=torch.Generator().manual_seed(seed), device=dev), reps=1)
    out = {"dataset": name, "n": n, "d": d, "k": k, "chunk": chunk,
           "val": val, "epochs": epochs, "steps": first.n_steps,
           "x_bytes": int(x_host.nbytes), "equal": equal, "arms": arms,
           "resident_s": resident_s, "resident_steps": res_dev.n_steps}
    for p in (1, 2):
        walls = [a["wall_s"] for a in arms if a["prefetch"] == p]
        out[f"prefetch{p}_wall_s"] = min(walls)
    if verbose:
        for a in arms:
            print(f"ingest {name} prefetch {a['prefetch']}: "
                  f"{a['wall_s']:.3f} s, {a['gbps']:.3f} GB/s, gather "
                  f"{a['gather_ms_median']:.3f} ms, stage "
                  f"{a['stage_ms_median']:.3f} ms, copy "
                  f"{a['copy_ms_median']} ms per chunk, peak "
                  f"{a['peak_device_mb']} MB", flush=True)
        print(f"ingest {name}: results equal bit for bit {equal}; the "
              f"device-resident driver {resident_s:.3f} s", flush=True)
    return out


def write(path, summary, ingest: Optional[dict], *, device, complete,
          scale, backend="dense"):
    record(path, "streaming_sweep", {"quality": summary, "ingest": ingest},
           scale=scale, cuts=None, backend=backend, device=device,
           complete=complete, notes=TIMING)


def main():
    p = argparse.ArgumentParser(description="Streaming sweep on the port")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--datasets", default="",
                   help="comma-separated names (default: all 20)")
    p.add_argument("--backend", default="fused")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--ingest-dataset", default="Kddcup99")
    p.add_argument("--out", default=str(ROOT / "BENCH_port_streaming.json"))
    a = p.parse_args()
    dev = resolve_device(a.device)
    names = [s for s in a.datasets.split(",") if s] or None
    s = run(scale=a.scale, datasets=names, k=a.k, backend=a.backend,
            device=dev, on_dataset=lambda part: write(
                a.out, part, None, device=dev, complete=False,
                scale=a.scale, backend=a.backend))
    ingest = ingest_demo(a.ingest_dataset, scale=a.scale, k=a.k,
                         backend=a.backend, device=dev)
    write(a.out, s, ingest, device=dev, complete=True, scale=a.scale,
          backend=a.backend)
    print(csv_row("streaming_sweep.aa_within_half", 0.0,
                  f"{s['aa_within_half']}/{s['total']} (reached "
                  f"{s['aa_reached']}, lloyd {s['lloyd_reached']})"))
    print(csv_row("streaming_sweep.ingest_prefetch2_s",
                  ingest["prefetch2_wall_s"] * 1e6,
                  f"prefetch1={ingest['prefetch1_wall_s']:.3f}s;"
                  f"equal={ingest['equal']}"))
    return s, ingest


if __name__ == "__main__":
    main()
