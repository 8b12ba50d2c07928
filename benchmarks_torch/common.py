"""Shared utilities of the port's benchmarks: host-clock timing that ends
in a device sync, the reference's CSV row, the traced driver, the card's
name line and the JSON record."""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import torch

from repro_torch.core.kmeans import aa_kmeans_traced
from repro_torch.data.synthetic import make_dataset

ROOT = Path(__file__).resolve().parent.parent


def sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def timed(fn, *args, warmup: int = 1, reps: int = 3):
    """(last output, median wall time of ``reps`` calls) after ``warmup``
    untimed calls; every call ends in a device sync, so a time covers the
    work and not only its launch."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
        sync()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        sync()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return out, ts[len(ts) // 2]


def csv_row(name: str, us_per_call: float, derived: str = "") -> str:
    return f"{name},{us_per_call:.1f},{derived}"


def traced_run(x, c0, cfg, backend="dense", warmup=True):
    """``aa_kmeans_traced``, warm by default (the first launch's kernel
    build is not timed).  ``warmup=False`` when only the per-iteration
    statistics matter."""
    return aa_kmeans_traced(x, c0, cfg, backend=backend, warmup=warmup)


def card_line():
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card, or
    None where there is none."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def dataset(name: str, scale: float, seed: int, device) -> torch.Tensor:
    """A Table 1 stand-in at ``scale``, on ``device``."""
    return torch.from_numpy(make_dataset(name, scale=scale,
                                         seed=seed)).to(device)


def scale_of(name: str, scale: float, cuts) -> float:
    """The scale a dataset runs at: ``cuts`` {name: scale} overrides."""
    return (cuts or {}).get(name, scale)


# the reference's protocols run every solve to at most 1000 iterations
MAX_ITER = 1000


def record(path, bench: str, summary: dict, *, scale, cuts, backend,
           device, complete: bool, notes: str) -> None:
    """Write the benchmark's JSON record (cases, summary, scale and cuts,
    the card's nvidia-smi line)."""
    payload = {"benchmark": bench, "complete": complete,
               "card": card_line() if device.type == "cuda" else None,
               "device": str(device), "torch": torch.__version__,
               "cuda": torch.version.cuda, "backend": backend,
               "scale": scale, "cuts": dict(cuts or {}),
               "max_iter": MAX_ITER, "timing": notes,
               "summary": summary}
    Path(path).write_text(json.dumps(payload, indent=1) + "\n")


def parse_args(description: str, default_out: str):
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--scale", type=float, default=1.0,
                   help="share of each Table 1 size (default 1.0)")
    p.add_argument("--datasets", default="",
                   help="comma-separated names (default: all 20)")
    p.add_argument("--cut", action="append", default=[],
                   metavar="NAME=SCALE",
                   help="run one dataset at a smaller scale (repeatable)")
    p.add_argument("--backend", default="dense")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    p.add_argument("--out", default=str(ROOT / default_out))
    a = p.parse_args()
    a.datasets = [s for s in a.datasets.split(",") if s] or None
    a.cuts = {name: float(v) for name, v in
              (c.split("=", 1) for c in a.cut)}
    return a
