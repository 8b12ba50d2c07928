"""Micro-batched online assignment with hot reload (counterpart of
``repro.serving.server``).

  * **bounded-queue micro-batching**: callers ``submit`` (n_i, d) row
    blocks and get a Future; one worker thread coalesces waiting requests
    (up to ``batch_size`` rows or ``flush_ms``, whichever comes first) and
    runs them as fixed-shape ``(batch_size, d)`` blocks.  Pad rows copy
    the last real row and their outputs are sliced off, so every request
    gets exactly its own rows' answers.  The queue's bound is
    back-pressure: a producer that outruns the device blocks in
    ``submit``.
  * **closure-index path**: a model with a cluster-closure index
    (``serving.closure``) is served by the candidate scan, bucketed by
    router; without one, by the exact full-K scan.
  * **hot reload**: a watcher thread polls the source (an estimator
    ``.npz``, or a directory whose writer ``manifest.json`` names the
    latest artifact) every ``poll_s``; on a changed fingerprint it loads
    and warms the new model off the serving path, then swaps the model
    reference.  The worker reads that reference once per micro-batch, so
    each batch is served by one model version, and no request is
    dropped.
  * **metrics**: per batch ``serve_latency_s``, ``queue_depth``,
    ``batch_rows``, ``batch_requests`` and ``padded_rows`` (and
    ``reload_s`` / ``reload_count`` per swap) through any
    ``log_scalars`` sink.

On CUDA, both threads work under ``torch.cuda.device`` of the model's
card and on its default stream, so a swapped-in model's tensors are ready
before the worker reads them.  Answers come back as host numpy arrays.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import queue
import threading
import time
from concurrent.futures import Future
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.core.api import NotFittedError
from repro_torch.core.backends import refuse_bf16
from repro_torch.core.lloyd import pairwise_sqdist
from repro_torch.runtime.metrics import as_metrics
from repro_torch.runtime.writer import read_manifest
from repro_torch.serving.closure import (ClosureIndex, build_closure_index,
                                         candidate_table, closure_assign,
                                         closure_sqdist)

_STOP = object()

_OPS = ("labels", "transform")


# -- runners -----------------------------------------------------------------
# The closure runners serve bucketed: the micro-batch is sorted by nearest
# router before the candidate-table gather (equal outputs, bit for bit).

def _labels_exact(xb, centroids):
    return torch.argmin(pairwise_sqdist(xb, centroids), dim=1
                        ).to(torch.int32)


def _labels_closure(xb, centroids, routers, candidates, table):
    return closure_assign(xb, centroids, routers, candidates, table,
                          bucketed=True)[0]


def _dists_exact(xb, centroids):
    return pairwise_sqdist(xb, centroids)


def _dists_closure(xb, centroids, routers, candidates, table):
    return closure_sqdist(xb, centroids, routers, candidates, table,
                          bucketed=True)


def _device_scope(dev: torch.device):
    """``torch.cuda.device(dev)`` on a card, nothing on the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


class ServingModel:
    """An immutable servable snapshot: centroids and an optional closure
    index, on the centroids' device.

    ``version`` is whatever fingerprint the loader attached (path, mtime
    and size for artifact sources): it tells tests and operators which
    model a server answers with."""

    def __init__(self, centroids: torch.Tensor,
                 index: Optional[ClosureIndex] = None, *, version=None,
                 approx: bool = True):
        refuse_bf16("the serving tier", None, centroids)
        self.centroids = torch.as_tensor(centroids)
        self.index = index
        self.version = version
        self.approx = bool(approx) and index is not None
        # the (G, C, d) candidate table, built once per model version
        self.table = candidate_table(self.centroids, index.candidates) \
            if self.approx else None

    @classmethod
    def from_estimator(cls, model, *, version=None, approx: bool = True,
                       n_candidates: Optional[int] = None
                       ) -> "ServingModel":
        """Snapshot a fitted estimator.  ``n_candidates`` builds an index
        on the spot when the model carries none; left None, an index-less
        model serves the exact path."""
        if getattr(model, "centroids_", None) is None:
            raise NotFittedError(
                "cannot serve an unfitted estimator; call fit() or load "
                "a fitted artifact first")
        refuse_bf16("the serving tier", model.backend, model.centroids_)
        index = getattr(model, "closure_index_", None)
        if index is None and n_candidates is not None:
            index = build_closure_index(model.centroids_,
                                        n_candidates=n_candidates)
        return cls(model.centroids_, index, version=version, approx=approx)

    @property
    def device(self) -> torch.device:
        return self.centroids.device

    def _rows(self, xb) -> torch.Tensor:
        # a copy: the caller's rows may be read-only, which torch refuses
        # to share
        return torch.from_numpy(np.array(xb, np.float32)).to(self.device)

    def labels(self, xb) -> np.ndarray:
        """(b,) int32 labels of one batch (host numpy out)."""
        xb = self._rows(xb)
        if self.approx:
            out = _labels_closure(xb, self.centroids, self.index.routers,
                                  self.index.candidates, self.table)
        else:
            out = _labels_exact(xb, self.centroids)
        return out.cpu().numpy()

    def dists(self, xb) -> np.ndarray:
        """(b, K) squared-distance rows of one batch (the transform
        payload).  On the closure path non-candidate columns are +inf, so
        an argmin over a row gives ``labels``."""
        xb = self._rows(xb)
        if self.approx:
            out = _dists_closure(xb, self.centroids, self.index.routers,
                                 self.index.candidates, self.table)
        else:
            out = _dists_exact(xb, self.centroids)
        return out.cpu().numpy()

    def warmup(self, batch_size: int, d: Optional[int] = None) -> None:
        """Run both ops once at the serving shape off the serving path, so
        the first batch after a load or swap pays no cuBLAS handle or
        allocator growth."""
        d = self.centroids.shape[1] if d is None else d
        zeros = np.zeros((batch_size, d), np.float32)
        with _device_scope(self.device):
            self.labels(zeros)
            self.dists(zeros)


# -- artifact source resolution ----------------------------------------------

def _resolve_artifact(source: Path) -> Optional[Path]:
    """The artifact a source path designates now: the file itself, or,
    for a directory, the file its ``manifest.json`` names as ``latest``
    (else the newest ``*.npz`` by mtime)."""
    if source.is_dir():
        m = read_manifest(source)
        if m is not None and m.get("latest"):
            p = source / m["latest"]
            if p.exists():
                return p
        snaps = list(source.glob("*.npz"))
        return max(snaps, key=lambda p: p.stat().st_mtime_ns, default=None)
    return source if source.exists() else None


def _fingerprint(path: Optional[Path]):
    if path is None:
        return None
    st = path.stat()
    return (str(path), st.st_mtime_ns, st.st_size)


@dataclasses.dataclass
class _Request:
    rows: np.ndarray
    future: Future
    op: str = "labels"


class KMeansServer:
    """Micro-batching assignment server over one servable model.

    ``source`` is a fitted estimator (static serving, on the estimator's
    own device), or a path (an estimator artifact ``.npz``, or a
    directory with a writer ``manifest.json``) loaded onto ``device``
    (None: CUDA) and watched for hot reload when ``poll_s`` is set::

        with KMeansServer("model.npz", batch_size=256, poll_s=2.0) as srv:
            labels = srv.predict(rows)          # synchronous
            fut = srv.submit(more_rows)         # a Future
    """

    def __init__(self, source, *, batch_size: int = 256,
                 approx: bool = True, n_candidates: Optional[int] = None,
                 flush_ms: float = 2.0, max_queue: int = 1024,
                 poll_s: Optional[float] = None, metrics=None, device=None):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1; got {batch_size}")
        self.batch_size = int(batch_size)
        self.approx = bool(approx)
        self.n_candidates = n_candidates
        self.flush_s = max(float(flush_ms), 0.0) / 1e3
        self.metrics = as_metrics(metrics)
        self.poll_s = poll_s
        self.device = device
        self.n_batches = 0
        self.n_requests = 0
        self.reload_count = 0
        self.last_reload_error: Optional[BaseException] = None
        self._q: queue.Queue = queue.Queue(maxsize=max(1, int(max_queue)))
        self._stop = threading.Event()
        self._worker_thread: Optional[threading.Thread] = None
        self._watcher_thread: Optional[threading.Thread] = None

        if isinstance(source, (str, Path)):
            self._source: Optional[Path] = Path(source)
            path = _resolve_artifact(self._source)
            if path is None:
                raise FileNotFoundError(
                    f"{self._source}: no servable artifact found")
            self._fp = _fingerprint(path)
            self._model = self._load(path)
        else:
            self._source = None
            self._fp = None
            self._model = ServingModel.from_estimator(
                source, version="estimator", approx=self.approx,
                n_candidates=self.n_candidates)
        self._dev = self._model.device
        self._model.warmup(self.batch_size)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "KMeansServer":
        if self._worker_thread is not None:
            return self
        self._stop.clear()
        self._worker_thread = threading.Thread(
            target=self._worker, daemon=True, name="repro-serve-worker")
        self._worker_thread.start()
        if self._source is not None and self.poll_s:
            self._watcher_thread = threading.Thread(
                target=self._watcher, daemon=True,
                name="repro-serve-watcher")
            self._watcher_thread.start()
        return self

    def stop(self) -> None:
        """Drain: every accepted request is answered before the worker
        exits.  Idempotent."""
        if self._worker_thread is None:
            return
        self._stop.set()
        self._q.put(_STOP)
        self._worker_thread.join()
        self._worker_thread = None
        if self._watcher_thread is not None:
            self._watcher_thread.join()
            self._watcher_thread = None

    def __enter__(self) -> "KMeansServer":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()

    # -- request API -------------------------------------------------------

    @property
    def version(self):
        return self._model.version

    def submit(self, rows, op: str = "labels") -> Future:
        """Queue (n, d) rows; the Future resolves to their (n,) int32
        labels (``op="labels"``) or (n, K) squared-distance rows
        (``op="transform"``).  Both ops coalesce into the same
        micro-batches.  Blocks (back-pressure) while ``max_queue``
        requests are waiting."""
        if op not in _OPS:
            raise ValueError(f"op must be one of {_OPS}; got {op!r}")
        if self._worker_thread is None:
            raise RuntimeError("server is not running; call start() or "
                               "use it as a context manager")
        rows = np.asarray(rows)
        if rows.ndim != 2:
            raise ValueError(f"submit expects (n, d) rows; got shape "
                             f"{rows.shape}")
        if rows.shape[0] == 0:
            f: Future = Future()
            k = self._model.centroids.shape[0]
            f.set_result(np.empty((0,), np.int32) if op == "labels"
                         else np.empty((0, k), np.float32))
            return f
        req = _Request(rows, Future(), op)
        self._q.put(req)
        return req.future

    def submit_transform(self, rows) -> Future:
        """``submit`` with ``op="transform"``."""
        return self.submit(rows, op="transform")

    def predict(self, rows, timeout: Optional[float] = None) -> np.ndarray:
        """Synchronous: submit and wait."""
        return self.submit(rows).result(timeout=timeout)

    def transform(self, rows, timeout: Optional[float] = None) -> np.ndarray:
        """Synchronous transform: (n, K) squared-distance rows through the
        same micro-batches (+inf at non-candidate columns on the closure
        path, as the estimator's ``approx`` transform)."""
        return self.submit_transform(rows).result(timeout=timeout)

    # -- worker ------------------------------------------------------------

    def _collect(self, first) -> list:
        """One micro-batch: the triggering request plus whatever arrives
        before ``batch_size`` rows are gathered or ``flush_s`` elapses."""
        batch, rows = [first], first.rows.shape[0]
        deadline = time.perf_counter() + self.flush_s
        while rows < self.batch_size:
            wait = deadline - time.perf_counter()
            if wait <= 0:
                break
            try:
                nxt = self._q.get(timeout=wait)
            except queue.Empty:
                break
            if nxt is _STOP:
                self._stop.set()     # drain what we have, then exit
                break
            batch.append(nxt)
            rows += nxt.rows.shape[0]
        return batch

    def _worker(self) -> None:
        with _device_scope(self._dev):
            while True:
                try:
                    item = self._q.get(timeout=0.05)
                except queue.Empty:
                    if self._stop.is_set() and self._q.empty():
                        return
                    continue
                if item is _STOP:
                    if self._q.empty():
                        return
                    continue    # stop already set; keep draining
                self._serve_batch(self._collect(item))

    def _serve_batch(self, batch: list) -> None:
        # one reference read per micro-batch: a hot reload swaps the model
        # between batches, never inside one
        model = self._model
        depth = self._q.qsize()
        t0 = time.perf_counter()
        padded = 0
        try:
            rows = np.concatenate([r.rows for r in batch]) \
                if len(batch) > 1 else batch[0].rows
            n, b = rows.shape[0], self.batch_size
            # ops can mix within a micro-batch; each block runs only the
            # runners some request in it needs
            need_labels = any(r.op == "labels" for r in batch)
            need_dists = any(r.op == "transform" for r in batch)
            k = model.centroids.shape[0]
            labels = np.empty((n,), np.int32) if need_labels else None
            dists = np.empty((n, k), np.float32) if need_dists else None
            padded = (-n) % b
            for i in range(0, n, b):
                xb = rows[i:i + b]
                m = xb.shape[0]
                if m < b:   # one block shape: pad, slice the output
                    xb = np.concatenate(
                        [xb, np.repeat(xb[-1:], b - m, axis=0)])
                if need_labels:
                    labels[i:i + m] = model.labels(xb)[:m]
                if need_dists:
                    dists[i:i + m] = model.dists(xb)[:m]
            off = 0
            for r in batch:
                m = r.rows.shape[0]
                out = labels[off:off + m] if r.op == "labels" \
                    else dists[off:off + m]
                r.future.set_result(out.copy())
                off += m
        except Exception as e:   # noqa: BLE001 — delivered per request
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(e)
        finally:
            self.n_batches += 1
            self.n_requests += len(batch)
            try:
                self.metrics.log_scalars(self.n_batches, {
                    "serve_latency_s": time.perf_counter() - t0,
                    "queue_depth": float(depth),
                    "batch_rows": float(sum(r.rows.shape[0]
                                            for r in batch)),
                    "batch_requests": float(len(batch)),
                    "padded_rows": float(padded),
                })
            except Exception:   # noqa: BLE001 — a broken sink must not
                pass            # fail requests

    # -- hot reload --------------------------------------------------------

    def _load(self, path: Path) -> ServingModel:
        # checkpoint.kmeans imports core.api, which imports this package
        # lazily: keep the import here so neither closes a cycle
        from repro_torch.checkpoint.kmeans import load_estimator
        est = load_estimator(path, device=self.device)
        return ServingModel.from_estimator(
            est, version=_fingerprint(path), approx=self.approx,
            n_candidates=self.n_candidates)

    def check_reload(self) -> bool:
        """Poll the source once; swap in a changed artifact.  -> True when
        a swap happened.  The watcher thread calls this every ``poll_s``;
        single-threaded callers may call it directly."""
        if self._source is None:
            return False
        path = _resolve_artifact(self._source)
        fp = _fingerprint(path)
        if fp is None or fp == self._fp:
            return False
        t0 = time.perf_counter()
        model = self._load(path)
        model.warmup(self.batch_size)   # off the serving path
        self._model = model             # one reference swap: between batches
        self._fp = fp
        self.reload_count += 1
        self.last_reload_error = None
        try:
            self.metrics.log_scalars(self.n_batches, {
                "reload_s": time.perf_counter() - t0,
                "reload_count": float(self.reload_count)})
        except Exception:   # noqa: BLE001 — as in _serve_batch
            pass
        return True

    def _watcher(self) -> None:
        with _device_scope(self._dev):
            while not self._stop.wait(self.poll_s):
                try:
                    self.check_reload()
                except Exception as e:   # noqa: BLE001 — keep serving
                    self.last_reload_error = e


def serve_manifest(server: KMeansServer) -> str:
    """One-line JSON status for operators and health checks."""
    return json.dumps({
        "version": list(server.version)
        if isinstance(server.version, tuple) else server.version,
        "batch_size": server.batch_size,
        "approx": server._model.approx,
        "n_batches": server.n_batches,
        "n_requests": server.n_requests,
        "reload_count": server.reload_count,
    }, sort_keys=True)
