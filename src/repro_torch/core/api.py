"""Estimator API (counterpart of ``repro.core.api``, lines 54-118 and
310-512).

    from repro_torch.core import AAKMeans
    model = AAKMeans(n_clusters=10, backend="fused").fit(x)   # on CUDA
    labels = model.predict(x_new)

``backend`` names the engine: "fused" (one kernel pass per step),
"pallas" (the assignment kernel, then the update kernel), "fused_bounds"
(the fused pass skipping centroid groups by carried bounds) or "dense"
(plain PyTorch, the oracle).

``fit`` seeds R = n_init restarts, solves them together with the batched
driver and keeps the best; ``predict`` / ``transform`` run in fixed-shape
chunks into host (numpy) arrays.  Still to be ported: the mesh, metrics
sinks, the hierarchical fit, the serving index and save/load — the
constructor has no fields for them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core.anderson import AAConfig
from repro_torch.core.init_schemes import batched_init
from repro_torch.core.kmeans import (KMeansConfig, KMeansResult,
                                     aa_kmeans_batched, resolve_backend,
                                     select_best)
from repro_torch.core.lloyd import pairwise_sqdist
from repro_torch.device import resolve_device
from repro_torch.kernels.tiles import pad_rows

PREDICT_CHUNK = 16384


class NotFittedError(RuntimeError):
    """Inference was requested on an estimator with no fitted state."""


def _as_input(x, device: torch.device) -> torch.Tensor:
    """X as a float32 tensor on ``device``.  float64 input narrows to
    float32, as ``jnp.asarray`` does in the reference; other dtypes are
    not ported yet."""
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = np.array(x)       # torch refuses to share read-only memory
    x = torch.as_tensor(x)
    if x.dtype == torch.float64:
        x = x.to(torch.float32)
    if x.dtype != torch.float32:
        raise TypeError(f"X must be float32 (bf16 is still to be ported); "
                        f"got {x.dtype}")
    return x.to(device).contiguous()


def _chunked_rows_apply(model, x, fn, out_dtype, out_cols=None,
                        chunk_size=None) -> np.ndarray:
    """Run ``fn(x_chunk, centroids) -> per-row output`` chunk by chunk
    into a host (numpy) array.  Every chunk has EXACTLY ``chunk_size``
    rows — the tail is padded with copies of its last row and the padding
    sliced off — so the kernel behind ``fn`` always sees one shape."""
    step = chunk_size or PREDICT_CHUNK
    c = model.centroids_
    n = x.shape[0]
    out = np.empty((n,) if out_cols is None else (n, out_cols), out_dtype)
    for i in range(0, n, step):
        xc = _as_input(x[i:i + step], c.device)
        m = xc.shape[0]
        out[i:i + m] = fn(pad_rows(xc, step), c)[:m].cpu().numpy()
    return out


@dataclasses.dataclass
class AAKMeans:
    n_clusters: int
    init: str = "kmeans++"
    n_init: int = 1
    max_iter: int = 500
    accelerated: bool = True
    m0: int = 2
    mbar: int = 30
    dynamic_m: bool = True
    eps1: float = 0.02
    eps2: float = 0.5
    ridge: float = 1e-12
    seed: int = 0
    # "dense" | "fused" | "pallas" | "fused_bounds" or a Backend instance
    # (e.g. get_backend("fused_bounds", group_size=64))
    backend: object = "dense"
    # None means CUDA (RuntimeError without a card); "cpu" runs the
    # kernels' plain versions
    device: object = None

    # fitted state
    centroids_: Optional[torch.Tensor] = None
    labels_: Optional[torch.Tensor] = None
    energy_: Optional[float] = None
    n_iter_: Optional[int] = None
    n_accepted_: Optional[int] = None

    def _config(self) -> KMeansConfig:
        return KMeansConfig(
            k=self.n_clusters, max_iter=self.max_iter,
            accelerated=self.accelerated,
            aa=AAConfig(m0=self.m0, mbar=self.mbar,
                        dynamic_m=self.dynamic_m,
                        eps1=self.eps1, eps2=self.eps2, ridge=self.ridge))

    def fit(self, x, c0s=None) -> "AAKMeans":
        """Fit on X (N, d).  ``c0s`` (R, K, d), when given, replaces the
        seeding (R = its first axis) — how a caller hands over seeds made
        elsewhere, e.g. by the reference package."""
        dev = resolve_device(self.device)
        x = _as_input(x, dev)
        cfg = self._config()
        if c0s is None:
            gen = torch.Generator(device=dev).manual_seed(self.seed)
            c0s = batched_init(self.init, gen, x, self.n_clusters,
                               max(self.n_init, 1))
        else:
            c0s = _as_input(c0s, dev)
        best: KMeansResult = select_best(
            aa_kmeans_batched(x, c0s, cfg, backend=self.backend))
        energy = float(best.energy)
        if not math.isfinite(energy):
            # select_best skips non-finite restarts, so EVERY restart
            # degenerated (NaN rows in X, exploded iterate).
            raise FloatingPointError(
                f"all {c0s.shape[0]} restarts produced non-finite energies "
                f"(E={energy}); check X for NaN/inf rows")
        self.centroids_ = best.centroids
        self.labels_ = best.labels
        self.energy_ = energy
        self.n_iter_ = int(best.n_iter)
        self.n_accepted_ = int(best.n_accepted)
        return self

    def _assert_fitted(self):
        if self.centroids_ is None:
            raise NotFittedError(
                "this AAKMeans instance has no fitted centroids; call "
                "fit() first")

    def predict(self, x, chunk_size: Optional[int] = None) -> np.ndarray:
        """Nearest-centroid labels (N,) int32 through the backend's
        assignment (the assignment kernel for every kernel backend)."""
        self._assert_fitted()
        bk = resolve_backend(self.backend)
        return _chunked_rows_apply(
            self, x, lambda xc, c: bk.assign(xc, c).labels, np.int32,
            chunk_size=chunk_size)

    def transform(self, x, chunk_size: Optional[int] = None) -> np.ndarray:
        """Distances (N, K) to every centroid."""
        self._assert_fitted()
        return _chunked_rows_apply(
            self, x, lambda xc, c: torch.sqrt(pairwise_sqdist(xc, c)),
            np.float32, out_cols=self.n_clusters, chunk_size=chunk_size)

    @property
    def inertia_(self) -> float:
        return self.energy_
