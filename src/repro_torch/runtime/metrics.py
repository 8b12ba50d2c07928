"""Metrics sinks of the host-side runtime (counterpart of
``repro.runtime.metrics``).

Every host loop of the port (the segmented solver drivers, the
minibatch epoch driver, the traced driver, the streamed driver, the
estimators' ``partial_fit`` stream and the background checkpoint writer)
emits its diagnostics through one method:

    logger.log_scalars(step, {"energy": 1.2e6, "segment_s": 0.41, ...})

The producer never imports the consumer: anything with a
``log_scalars`` method is a sink, so a no-op sink, stdout, a JSONL file
or a user's own adapter all plug in the same way.

Sinks must tolerate calls from more than one thread: the checkpoint
writer reports its write latency from its own thread while the driver
logs its boundaries from the main one (``JsonlMetrics`` and
``CollectMetrics`` lock; the others keep no state).

Values may be Python numbers, numpy scalars or 0-d tensors; sinks
coerce them with ``_to_float``.  Reading a CUDA tensor waits for the
device, so the drivers convert their scalars themselves, in one copy per
boundary, and hand the sinks Python floats.
"""

from __future__ import annotations

import json
import sys
import threading
from typing import IO, Mapping, Optional, Protocol, runtime_checkable

import torch


@runtime_checkable
class MetricsLogger(Protocol):
    """Anything with ``log_scalars(step, scalars)`` is a metrics sink."""

    def log_scalars(self, step: int, scalars: Mapping[str, float]) -> None:
        ...


def _to_float(v) -> float:
    """A Python, numpy or 0-d tensor scalar as a float (bool -> 0.0 or
    1.0).  A tensor on the card is read once, which waits for it."""
    if isinstance(v, torch.Tensor):
        return float(v.item())
    return float(v)


class NullMetrics:
    """The default sink: drops everything, costs nothing."""

    def log_scalars(self, step, scalars) -> None:
        pass

    def close(self) -> None:
        pass


class StdoutMetrics:
    """One human-readable line per call (debugging, smoke runs)."""

    def __init__(self, prefix: str = "metrics", stream: Optional[IO] = None):
        self.prefix = prefix
        self.stream = stream if stream is not None else sys.stdout

    def log_scalars(self, step, scalars) -> None:
        body = " ".join(f"{k}={_to_float(v):.6g}"
                        for k, v in sorted(scalars.items()))
        print(f"{self.prefix} step={int(step)} {body}",
              file=self.stream, flush=True)

    def close(self) -> None:
        pass


class JsonlMetrics:
    """Append-only JSON lines: one ``{"step": t, ...}`` object per call,
    flushed per line, so a killed run loses at most the line in flight.
    Thread-safe (the writer's thread and the driver's share it)."""

    def __init__(self, path):
        self.path = path
        self._lock = threading.Lock()
        self._f = open(path, "a", encoding="utf-8")

    def log_scalars(self, step, scalars) -> None:
        rec = {"step": int(step)}
        rec.update({k: _to_float(v) for k, v in scalars.items()})
        line = json.dumps(rec, sort_keys=True)
        with self._lock:
            self._f.write(line + "\n")
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


class TeeMetrics:
    """Fan one stream of scalars out to several sinks."""

    def __init__(self, *sinks: MetricsLogger):
        self.sinks = tuple(as_metrics(s) for s in sinks)

    def log_scalars(self, step, scalars) -> None:
        for s in self.sinks:
            s.log_scalars(step, scalars)

    def close(self) -> None:
        for s in self.sinks:
            close_metrics(s)


class CollectMetrics:
    """In-memory sink: ``records`` is a list of (step, dict)."""

    def __init__(self):
        self.records = []
        self._lock = threading.Lock()

    def log_scalars(self, step, scalars) -> None:
        rec = {k: _to_float(v) for k, v in scalars.items()}
        with self._lock:
            self.records.append((int(step), rec))

    def close(self) -> None:
        pass


class EarlyStopHook(CollectMetrics):
    """A collecting sink that watches the energy and sets
    ``should_stop`` once its improvement per boundary stalls; the
    segmented drivers test ``should_stop`` after each boundary's
    ``log_scalars`` and leave their loop.

    ``metric`` names the scalars to watch, the first present one per
    call: "energy" (the single-problem driver), "energy_best" (batched)
    and "e_val" (minibatch) by default.  A stall is a boundary whose
    best-so-far value improves by less than ``rel_tol`` relative;
    ``patience`` stalls in a row, after more than ``min_records``
    boundaries, stop the driver.  Non-finite values and records without
    the metric are ignored.  ``should_stop`` never resets."""

    def __init__(self, metric=("energy", "energy_best", "e_val"),
                 rel_tol: float = 1e-3, patience: int = 2,
                 min_records: int = 1):
        super().__init__()
        self.metric = (metric,) if isinstance(metric, str) else tuple(metric)
        self.rel_tol = float(rel_tol)
        self.patience = int(patience)
        self.min_records = int(min_records)
        self.should_stop = False
        self.stopped_at: Optional[int] = None
        self._best: Optional[float] = None
        self._stall = 0
        self._seen = 0

    def log_scalars(self, step, scalars) -> None:
        super().log_scalars(step, scalars)
        val = next((scalars[m] for m in self.metric if m in scalars), None)
        if val is None:
            return
        v = _to_float(val)
        if v != v or v in (float("inf"), float("-inf")):
            return
        with self._lock:
            self._seen += 1
            if self._best is None:
                self._best = v
                return
            denom = max(abs(self._best), 1e-30)
            if (self._best - v) / denom > self.rel_tol:
                self._best, self._stall = v, 0
                return
            self._best = min(self._best, v)
            self._stall += 1
            if self._stall >= self.patience and self._seen > self.min_records:
                if not self.should_stop:
                    self.stopped_at = int(step)
                self.should_stop = True


def should_stop(metrics) -> bool:
    """True when the sink asks the driver to stop: a truthy
    ``should_stop`` attribute, searched through a ``TeeMetrics``'s
    sinks.  A sink without the attribute never stops a driver."""
    if bool(getattr(metrics, "should_stop", False)):
        return True
    sinks = getattr(metrics, "sinks", None)
    if sinks:
        return any(should_stop(s) for s in sinks)
    return False


def as_metrics(obj) -> MetricsLogger:
    """The ``metrics=`` argument of every driver as a sink: None -> the
    null sink; "null" or "stdout" -> that built-in; anything with
    ``log_scalars`` as it is."""
    if obj is None:
        return NullMetrics()
    if isinstance(obj, str):
        if obj == "null":
            return NullMetrics()
        if obj == "stdout":
            return StdoutMetrics()
        raise ValueError(f"unknown metrics sink name {obj!r}; expected "
                         f"'null' | 'stdout', a sink object, or None")
    if not hasattr(obj, "log_scalars"):
        raise TypeError(
            f"metrics= expects an object with log_scalars(step, scalars); "
            f"got {type(obj).__name__}")
    return obj


def close_metrics(obj) -> None:
    """Close a sink if it has a ``close`` (the protocol does not ask for
    one)."""
    close = getattr(obj, "close", None)
    if close is not None:
        close()
