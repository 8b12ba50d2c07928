"""Estimator API (counterpart of ``repro.core.api``, lines 54-118,
310-512 and 550-873).

    from repro_torch.core import AAKMeans, MiniBatchAAKMeans
    model = AAKMeans(n_clusters=10, backend="fused").fit(x)   # on CUDA
    labels = model.predict(x_new)
    stream = MiniBatchAAKMeans(n_clusters=10, backend="fused").fit(x)

``backend`` names the engine: "fused" (one kernel pass per step),
"pallas" (the assignment kernel, then the update kernel), "fused_bounds"
(the fused pass skipping centroid groups by carried bounds), "dense"
(plain PyTorch, the oracle), the bound engines "hamerly", "elkan" and
"yinyang" (masked dense PyTorch), or any bound engine's "<name>_reorder"
variant (the locality engine: rows sorted by label once assignments
settle, e.g. ``get_backend("fused_bounds_reorder", group_size=64)``).

``fit`` seeds R = n_init restarts, solves them together with the batched
driver and keeps the best; ``predict`` / ``transform`` run in fixed-shape
chunks into host (numpy) arrays.  ``MiniBatchAAKMeans`` is the streaming
estimator: ``fit`` over device-resident chunks, ``partial_fit`` /
``partial_fit_stream`` over host chunks.  Still to be ported: the mesh,
metrics sinks, the hierarchical fit, the serving index and save/load —
the constructors have no fields for them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.anderson import AAConfig
from repro_torch.core.init_schemes import batched_init, make_init
from repro_torch.core.kmeans import (KMeansConfig, KMeansResult,
                                     aa_kmeans_batched, aa_kmeans_minibatch,
                                     resolve_backend, select_best)
from repro_torch.core.lloyd import pairwise_sqdist
from repro_torch.core.minibatch import (MiniBatchConfig, guard_pick,
                                        minibatch_init, minibatch_iteration)
from repro_torch.data.streaming import (DeviceChunks, chunk_dataset,
                                        split_validation, stream_chunks)
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


def _predict_rows(model, x, chunk_size) -> np.ndarray:
    """Either estimator's predict: labels through its backend's assign."""
    model._assert_fitted()
    bk = resolve_backend(model.backend)
    return _chunked_rows_apply(
        model, x, lambda xc, c: bk.assign(xc, c).labels, np.int32,
        chunk_size=chunk_size)


def _transform_rows(model, x, chunk_size) -> np.ndarray:
    """Either estimator's transform: distances to every centroid."""
    model._assert_fitted()
    return _chunked_rows_apply(
        model, x, lambda xc, c: torch.sqrt(pairwise_sqdist(xc, c)),
        np.float32, out_cols=model.n_clusters, chunk_size=chunk_size)


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
    # a registry name ("dense" | "blocked" | "fused" | "pallas" |
    # "hamerly" | "elkan" | "yinyang" | "fused_bounds" | "<bound
    # engine>_reorder") or a Backend instance (e.g.
    # get_backend("fused_bounds_reorder", group_size=64))
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
        return _predict_rows(self, x, chunk_size)

    def transform(self, x, chunk_size: Optional[int] = None) -> np.ndarray:
        """Distances (N, K) to every centroid."""
        return _transform_rows(self, x, chunk_size)

    @property
    def inertia_(self) -> float:
        return self.energy_


class FitInputs(NamedTuple):
    """What ``MiniBatchAAKMeans.fit`` hands its driver."""
    chunks: DeviceChunks         # the training rows, chunked and masked
    x_val: torch.Tensor          # (V, d) the guard's validation chunk
    c0: torch.Tensor             # (K, d) the seeds
    generator: torch.Generator   # CPU generator of the epochs' chunk order


@dataclasses.dataclass
class MiniBatchAAKMeans:
    """Streaming mini-batch AA K-Means estimator.

    Two ways in, over one chunk-step state machine
    (``core/minibatch.py``):

      * ``fit(x)`` — X fits on the device: a random ``val_size``
        validation chunk is held out for the energy guard, the rest is
        chunked, and ``kmeans.aa_kmeans_minibatch`` runs every epoch with
        no sync inside its loop;
      * ``partial_fit(chunk)`` — X does not fit: feed host chunks one at a
        time (``data.streaming.host_chunk_stream``), or a whole iterator
        with its copies prefetched (``partial_fit_stream``).  The first
        call carves its validation chunk out of a uniform draw of its
        rows and seeds the centroids; each call is one chunk step.  When
        making several epochs, re-stream only the rows after the first
        chunk, so the carved validation rows stay held out.

    After ``fit``, ``centroids_`` is the final guard-picked iterate and
    ``energy_`` its validation-chunk energy (the full-X energy is never
    computed).  During a ``partial_fit`` sequence, ``centroids_`` tracks
    the running-stats fallback, ``energy_`` is the guard's pricing of the
    iterate that entered the last step (one step behind) and
    ``n_accepted_`` and ``energy_`` stay on the device, so that no step
    waits for it; ``finalize()`` reprices and applies the guard pick.
    """
    n_clusters: int
    chunk_size: int = 4096
    epochs: int = 5
    decay: float = 0.9
    val_size: int = 1024
    init: str = "kmeans++"
    accelerated: bool = True
    m0: int = 2
    mbar: int = 30
    dynamic_m: bool = True
    eps1: float = 0.02
    eps2: float = 0.5
    ridge: float = 1e-12
    seed: int = 0
    compute_labels: bool = True      # fit() labels the input like sklearn
    # a registry name or a Backend instance, as on AAKMeans
    backend: object = "dense"
    # None means CUDA (RuntimeError without a card); "cpu" runs the
    # kernels' plain versions
    device: object = None

    # fitted state
    centroids_: Optional[torch.Tensor] = None
    labels_: Optional[np.ndarray] = None
    energy_: object = None
    n_steps_: Optional[int] = None
    n_accepted_: object = None

    # streaming state (partial_fit)
    _state: object = dataclasses.field(default=None, repr=False)
    _x_val: object = dataclasses.field(default=None, repr=False)

    def _config(self, chunk_size: Optional[int] = None) -> MiniBatchConfig:
        return MiniBatchConfig(
            k=self.n_clusters, chunk_size=chunk_size or self.chunk_size,
            epochs=self.epochs, decay=self.decay,
            accelerated=self.accelerated,
            aa=AAConfig(m0=self.m0, mbar=self.mbar,
                        dynamic_m=self.dynamic_m,
                        eps1=self.eps1, eps2=self.eps2, ridge=self.ridge))

    def _val_rows(self, n: int) -> int:
        v = min(self.val_size, max(n // 4, self.n_clusters))
        if v < 1:
            raise ValueError(
                f"cannot carve a validation chunk from N={n} rows "
                f"(val_size={self.val_size})")
        return v

    def fit_inputs(self, x, chunk_size: Optional[int] = None) -> FitInputs:
        """The driver's inputs of ``fit(x)``, drawn as ``fit`` draws them:
        from a generator on the device seeded with ``seed``, the
        validation split, then ``init`` on the first max(chunk_size, 4096)
        training rows (the split shuffles them); the chunk order from a
        CPU generator seeded with ``seed``."""
        return self._fit_inputs(_as_input(x, resolve_device(self.device)),
                                self._config(chunk_size))

    def _fit_inputs(self, x: torch.Tensor, cfg: MiniBatchConfig) -> FitInputs:
        if x.shape[0] < 2 * self.n_clusters:
            raise ValueError(f"need at least {2 * self.n_clusters} rows to "
                             f"fit k={self.n_clusters}; got {x.shape[0]}")
        gen = torch.Generator(device=x.device).manual_seed(self.seed)
        x_train, x_val = split_validation(x, self._val_rows(x.shape[0]),
                                          gen)
        n_seed = min(x_train.shape[0], max(cfg.chunk_size, 4096))
        c0 = make_init(self.init)(gen, x_train[:n_seed], self.n_clusters)
        return FitInputs(chunk_dataset(x_train, cfg.chunk_size), x_val, c0,
                         torch.Generator().manual_seed(self.seed))

    def fit(self, x, chunk_size: Optional[int] = None) -> "MiniBatchAAKMeans":
        dev = resolve_device(self.device)
        x = _as_input(x, dev)
        cfg = self._config(chunk_size)
        inputs = self._fit_inputs(x, cfg)
        # a fit supersedes any partial_fit stream in progress: a later
        # partial_fit/finalize would otherwise advance the abandoned
        # stream and overwrite this fit's results
        self._state = self._x_val = None
        res = aa_kmeans_minibatch(
            inputs.chunks.chunks, inputs.chunks.weights, inputs.x_val,
            inputs.c0, cfg, backend=self.backend,
            generator=inputs.generator, device=dev)
        del inputs
        self.centroids_ = res.centroids
        self.energy_ = float(res.energy)
        self.n_steps_ = int(res.n_steps)
        self.n_accepted_ = int(res.n_accepted)
        self.labels_ = self.predict(x) if self.compute_labels else None
        return self

    # -- streaming ---------------------------------------------------------

    def partial_fit(self, chunk) -> "MiniBatchAAKMeans":
        """One chunk step; the device holds no more than this chunk and
        the validation chunk.  ``centroids_`` becomes the fresh
        running-stats iterate and ``energy_`` the guard's pricing of the
        previous one (see the class docstring; ``finalize()`` makes them
        consistent)."""
        dev = resolve_device(self.device)
        x = _as_input(chunk, dev)
        cfg = self._config()
        bk = resolve_backend(self.backend)
        if self._state is None:
            if x.shape[0] < 2 * self.n_clusters:
                raise ValueError(
                    f"the first partial_fit chunk seeds the solver and "
                    f"must have >= {2 * self.n_clusters} rows; got "
                    f"{x.shape[0]}")
            # a uniform carve, not the head: data is often stored sorted,
            # and a validation chunk of the leading cluster only would
            # bias every guard decision
            gen = torch.Generator(device=dev).manual_seed(self.seed)
            x, self._x_val = split_validation(
                x, self._val_rows(x.shape[0]), gen)
            c0 = make_init(self.init)(gen, x, self.n_clusters)
            self._state = minibatch_init(c0, cfg, bk)
        w = torch.ones((x.shape[0],), dtype=torch.float32, device=dev)
        self._state, trace = minibatch_iteration(x, w, self._x_val,
                                                 self._state, cfg, bk)
        # device scalars, not float()/int(): a sync per chunk would
        # serialise the stream (the next chunk's copy could no longer
        # overlap this step); fit() and finalize() store Python numbers
        self.centroids_ = self._state.c_au
        self.energy_ = trace.e_val
        self.n_steps_ = self._state.t
        self.n_accepted_ = self._state.n_acc
        return self

    def partial_fit_stream(self, chunks, prefetch: int = 2
                           ) -> "MiniBatchAAKMeans":
        """Consume an iterator of host chunks with their host-to-device
        copies prefetched (``data.streaming.stream_chunks``): chunk t+1's
        copy is issued while chunk t's step runs.  Equal bit for bit to
        calling ``partial_fit`` per chunk."""
        dev = resolve_device(self.device)
        for chunk in stream_chunks(iter(chunks), prefetch=prefetch,
                                   device=dev):
            self.partial_fit(chunk)
        return self

    def finalize(self) -> "MiniBatchAAKMeans":
        """The guard's pick between the accelerated candidate and the
        running-stats fallback after a partial_fit sequence (fit() applies
        it itself)."""
        if self._state is None:
            raise ValueError("no streaming state; call partial_fit first")
        c_fin, e_fin, _, _ = guard_pick(self._x_val, self._state,
                                        self._config(),
                                        resolve_backend(self.backend))
        self.centroids_ = c_fin
        self.energy_ = float(e_fin)
        return self

    # -- inference ---------------------------------------------------------

    def _assert_fitted(self):
        if self.centroids_ is None:
            raise NotFittedError(
                "this MiniBatchAAKMeans instance has no fitted centroids; "
                "call fit() or partial_fit() first")

    def predict(self, x, chunk_size: Optional[int] = None) -> np.ndarray:
        """Nearest-centroid labels (N,) int32, chunk by chunk into a host
        array through the backend's assignment."""
        return _predict_rows(self, x, chunk_size)

    def transform(self, x, chunk_size: Optional[int] = None) -> np.ndarray:
        """Distances (N, K) to every centroid."""
        return _transform_rows(self, x, chunk_size)

    @property
    def inertia_(self):
        return self.energy_
