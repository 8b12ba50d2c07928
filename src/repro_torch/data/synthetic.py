"""Synthetic stand-ins for the paper's 20 benchmark datasets.

A numpy-only copy of ``repro.data.synthetic`` (the port imports nothing
of the JAX package): the same seed gives both packages the same X.

The paper evaluates on 19 UCI datasets plus the synthetic Birch grid
(Table 1).  The UCI files do not ship with the repo, so each dataset is
replaced by a synthetic generator with the *same N and d* and a cluster
structure chosen to span the regimes that matter for the algorithm's
behaviour (well-separated, overlapping, heavy-tailed, low-dimensional
dense, high-dimensional sparse-ish); the claims validated (iteration-count
reduction, acceptance rate, MSE parity with Lloyd) are properties of the
solver dynamics, not of the exact data values.

Generators are deterministic given the seed.  ``scale`` shrinks N for CI
(full sizes reproduce Table 1's N exactly at scale=1.0).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    no: int
    name: str
    n: int
    d: int
    kind: str          # gaussian | birch_grid | heavy_tail | uniform_mix


# Table 1 of the paper (No., name, N, d) with a generator regime each.
_TABLE1 = [
    (1, "UCIHARDATAXtrain", 7352, 561, "gaussian"),
    (2, "Slicelocalization", 53500, 385, "gaussian"),
    (3, "RelationNetwork", 53413, 22, "heavy_tail"),
    (4, "Letterrecognition", 20000, 16, "uniform_mix"),
    (5, "HTRU2", 17898, 8, "heavy_tail"),
    (6, "Household", 2049280, 6, "gaussian"),
    (7, "FrogsMFCCs", 7195, 21, "gaussian"),
    (8, "Eb", 45781, 2, "uniform_mix"),
    (9, "AllUsers", 78095, 8, "gaussian"),
    (10, "MiniBoone", 130064, 50, "heavy_tail"),
    (11, "Colorment", 68040, 9, "uniform_mix"),
    (12, "Conflongdemo", 164860, 3, "gaussian"),
    (13, "Birch", 100000, 2, "birch_grid"),
    (14, "Shuttle", 43500, 9, "heavy_tail"),
    (15, "Covtype", 581012, 55, "gaussian"),
    (16, "SkinNonSkin", 245057, 4, "uniform_mix"),
    (17, "Finalgeneral", 10104, 72, "gaussian"),
    (18, "ColorHistogram", 68040, 32, "heavy_tail"),
    (19, "USCensus1990", 2458285, 69, "gaussian"),
    (20, "Kddcup99", 4898431, 37, "heavy_tail"),
]

DATASETS: Dict[str, DatasetSpec] = {
    name: DatasetSpec(no, name, n, d, kind)
    for no, name, n, d, kind in _TABLE1
}


def _gaussian_mixture(rng, n, d, n_comp, spread=1.5):
    """Heavily-overlapping mixture: the slow-convergence regime for Lloyd
    (the surrogate loses accuracy whenever moving centroids re-assign
    samples, which happens constantly when clusters overlap — Sec. 2)."""
    centers = rng.standard_normal((n_comp, d)) * spread
    comp = rng.integers(0, n_comp, n)
    scales = rng.uniform(0.6, 1.8, (n_comp, 1))
    x = centers[comp] + rng.standard_normal((n, d)) * scales[comp]
    return x


def _birch_grid(rng, n, d, grid=10):
    """BIRCH1-style regular grid of Gaussian clusters (Zhang et al. 1997)."""
    axes = [np.arange(grid) * 10.0 for _ in range(min(d, 2))]
    mesh = np.stack(np.meshgrid(*axes), -1).reshape(-1, min(d, 2))
    if d > 2:
        mesh = np.concatenate(
            [mesh, np.zeros((mesh.shape[0], d - 2))], axis=1)
    comp = rng.integers(0, mesh.shape[0], n)
    return mesh[comp] + rng.standard_normal((n, d))


def _heavy_tail(rng, n, d, n_comp=20):
    centers = rng.standard_normal((n_comp, d)) * 1.5
    comp = rng.integers(0, n_comp, n)
    # Student-t-ish tails: normal / sqrt(chi2/df)
    df = 2.5
    z = rng.standard_normal((n, d))
    chi = rng.chisquare(df, (n, 1)) / df
    return centers[comp] + z / np.sqrt(chi)


def _uniform_mix(rng, n, d, n_comp=15):
    """Half uniform background + overlapping boxes: near-unstructured data,
    the classically slow case for Lloyd."""
    centers = rng.uniform(-3, 3, (n_comp, d))
    widths = rng.uniform(1.0, 4.0, (n_comp, d))
    comp = rng.integers(0, n_comp, n)
    x = centers[comp] + rng.uniform(-1, 1, (n, d)) * widths[comp]
    n_bg = n // 2
    x[:n_bg] = rng.uniform(-5, 5, (n_bg, d))
    return x


_GEN = {
    "gaussian": _gaussian_mixture,
    "birch_grid": _birch_grid,
    "heavy_tail": _heavy_tail,
    "uniform_mix": _uniform_mix,
}


def make_dataset(name: str, *, scale: float = 1.0, seed: int = 0,
                 dtype=np.float32) -> np.ndarray:
    """Generate dataset ``name`` at ``scale`` of its Table-1 size."""
    spec = DATASETS[name]
    n = max(64, int(spec.n * scale))
    rng = np.random.default_rng(seed + spec.no * 1000)
    if spec.kind == "gaussian":
        x = _gaussian_mixture(rng, n, spec.d, n_comp=25)
    else:
        x = _GEN[spec.kind](rng, n, spec.d)
    # Match the paper's preprocessing style: features roughly standardised.
    x = (x - x.mean(0)) / np.maximum(x.std(0), 1e-6)
    return x.astype(dtype)


def dataset_components(name: str, *, scale: float = 1.0,
                       seed: int = 0) -> np.ndarray:
    """The mixture component of every row of ``make_dataset(name, scale=,
    seed=)`` (N,) int64, for the "gaussian" datasets: the generator's
    draws replayed up to the component ids.  Sorting rows by it lays X
    out cluster by cluster (the "ordered" layout of
    benchmarks/kernels_bench.py::bounds_workload)."""
    spec = DATASETS[name]
    if spec.kind != "gaussian":
        raise ValueError(f"{name} is not a gaussian mixture ({spec.kind})")
    n = max(64, int(spec.n * scale))
    rng = np.random.default_rng(seed + spec.no * 1000)
    rng.standard_normal((25, spec.d))                 # the centers
    return rng.integers(0, 25, n)


def make_blobs(n: int, d: int, k: int, *, seed: int = 0, spread: float = 5.0,
               dtype=np.float32) -> np.ndarray:
    """Simple separated blobs — used by unit tests."""
    rng = np.random.default_rng(seed)
    return _gaussian_mixture(rng, n, d, k, spread).astype(dtype)
