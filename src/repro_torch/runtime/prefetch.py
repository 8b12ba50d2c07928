"""Overlapped host-to-device chunk ingest (counterpart of
``repro.runtime.prefetch``).

``prefetch_to_device`` turns an iterator of host chunks into an iterator
of device tensors with up to ``size`` copies in flight, so that the copy
of chunk t+1 runs while the consumer's step on chunk t does.  On CUDA:

  * each chunk is copied into one of ``size`` page-locked (pinned) host
    slots, allocated once per chunk shape: page-locking memory costs far
    more than the copy, so no chunk is pinned on its own;
  * the host-to-device copy is issued with ``non_blocking=True`` on a
    side stream, and an event is recorded behind it;
  * before the consumer gets the chunk, its current stream waits on that
    event, and the device tensor is marked as used by that stream
    (``record_stream``), so the caching allocator does not hand its block
    to another tensor while the consumer's work still reads it;
  * a slot is refilled only once its previous copy's event has completed
    (a wait on that event alone, not on the device).

The yielded sequence is the input sequence, in order and value, so a
prefetched run equals a synchronous one bit for bit; only the timing of
the copies changes.  With ``device="cpu"`` the chunks come back as host
tensors (the CPU build of torch cannot pin memory).

``IngestMeter`` counts the bytes and chunks and, per chunk, the host
seconds spent pulling it from the source (the gather), the host seconds
spent staging it into its pinned slot, and the copy's device time (CUDA
events on the side stream); ``scalars()`` gives its totals in the form
a metrics sink takes.
"""

from __future__ import annotations

import collections
import time
from typing import Iterable, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


def tree_nbytes(tree) -> int:
    """Payload bytes of a tree (dicts, tuples, lists, NamedTuples) of
    tensors or numpy arrays, on any device."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(tree_nbytes(v) for v in tree)
    if tree is None:
        return 0
    if isinstance(tree, torch.Tensor):
        return int(tree.nbytes)
    return int(np.asarray(tree).nbytes)


class IngestMeter:
    """Byte and wall-clock accounting of a chunk stream.

    ``add(nbytes)`` per chunk; ``gbps`` is the achieved ingest over the
    meter's lifetime (or between ``start()`` and the last ``add``).  The
    prefetcher also records, per chunk, ``fetch_s`` (host seconds to pull
    it from the source), ``stage_s`` (host seconds to copy it into its
    pinned slot; 0 on the CPU) and, on CUDA, a pair of events around its
    copy (``copy_ms()`` reads them)."""

    def __init__(self):
        self.start()

    def start(self) -> "IngestMeter":
        self._t0 = time.perf_counter()
        self._t_last = self._t0
        self.bytes = 0
        self.chunks = 0
        self.fetch_s: List[float] = []
        self.stage_s: List[float] = []
        self._copy_events: list = []
        return self

    def add(self, nbytes: int) -> None:
        self.bytes += int(nbytes)
        self.chunks += 1
        self._t_last = time.perf_counter()

    @property
    def seconds(self) -> float:
        return max(self._t_last - self._t0, 1e-12)

    @property
    def gbps(self) -> float:
        return self.bytes / self.seconds / 1e9

    def scalars(self) -> dict:
        """The totals as metrics scalars (``ingest_bytes``,
        ``ingest_chunks``, ``ingest_gbps``)."""
        return {"ingest_bytes": float(self.bytes),
                "ingest_chunks": float(self.chunks),
                "ingest_gbps": self.gbps}

    def copy_ms(self) -> List[float]:
        """Device milliseconds of each chunk's host-to-device copy (waits
        for the copies' end events); empty on the CPU."""
        return [a.elapsed_time(b) for a, b in self._copy_events]


def _pull(iterator: Iterable):
    """(chunk, host seconds it took to produce) for each chunk."""
    it = iter(iterator)
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        yield item, time.perf_counter() - t0


def _host_tensor(item) -> torch.Tensor:
    """A host chunk as a CPU tensor; float64 narrows to float32, as the
    reference's ``device_put`` does without 64-bit mode."""
    if isinstance(item, np.ndarray) and not item.flags.writeable:
        item = np.array(item)      # torch refuses to share read-only memory
    t = torch.as_tensor(item)
    if t.device.type != "cpu":
        raise ValueError(f"prefetch_to_device takes host chunks; got a "
                         f"tensor on {t.device}")
    return t.to(torch.float32) if t.dtype == torch.float64 else t


def _cpu_chunks(iterator, meter):
    for item, fetch_s in _pull(iterator):
        t = _host_tensor(item)
        if meter is not None:
            meter.fetch_s.append(fetch_s)
            meter.stage_s.append(0.0)
            meter.add(t.nbytes)
        yield t


def _handoff(out: torch.Tensor, done: torch.cuda.Event,
             dev: torch.device) -> torch.Tensor:
    """The consumer's stream waits for the copy, and the allocator keeps
    the block until that stream's work on it has run."""
    stream = torch.cuda.current_stream(dev)
    stream.wait_event(done)
    out.record_stream(stream)
    return out


def _cuda_chunks(iterator, size: int, dev: torch.device, meter):
    side = torch.cuda.Stream(dev)
    slots: list = [None] * size      # pinned host buffer of each slot
    copied: list = [None] * size     # event behind each slot's last copy
    pending = collections.deque()
    for i, (item, fetch_s) in enumerate(_pull(iterator)):
        src = _host_tensor(item)
        j = i % size
        if copied[j] is not None:
            copied[j].synchronize()   # the slot's last copy has read it
        buf = slots[j]
        if buf is None or buf.dtype != src.dtype \
                or buf.shape[1:] != src.shape[1:] \
                or buf.shape[0] < src.shape[0]:
            buf = slots[j] = torch.empty(src.shape, dtype=src.dtype,
                                         pin_memory=True)
        t0 = time.perf_counter()
        staged = buf[:src.shape[0]]
        staged.copy_(src)
        stage_s = time.perf_counter() - t0
        with torch.cuda.stream(side):
            if meter is not None:
                ev0 = torch.cuda.Event(enable_timing=True)
                ev0.record(side)
            out = staged.to(dev, non_blocking=True)
            done = torch.cuda.Event(enable_timing=meter is not None)
            done.record(side)
        copied[j] = done
        if meter is not None:
            meter.fetch_s.append(fetch_s)
            meter.stage_s.append(stage_s)
            meter._copy_events.append((ev0, done))
            meter.add(src.nbytes)
        pending.append((out, done))
        if len(pending) >= size:
            yield _handoff(*pending.popleft(), dev)
    while pending:
        yield _handoff(*pending.popleft(), dev)


def prefetch_to_device(iterator: Iterable, size: int = 2, *,
                       device=None,
                       meter: Optional[IngestMeter] = None) -> Iterator:
    """Iterate ``iterator``'s host chunks (numpy arrays or CPU tensors)
    as tensors on ``device`` (None: CUDA, RuntimeError without a card),
    with up to ``size`` host-to-device copies in flight.

    ``size=2`` is double buffering: while the consumer computes on the
    chunk just yielded, the next chunk's copy is already issued.
    ``size=1`` copies a chunk, then yields it; ``size=0`` is rejected.
    The generator holds at most ``size`` device chunks besides the one
    the consumer holds, so the device footprint is bounded by
    ``(size + 1) * chunk_bytes`` on top of the consumer's own state."""
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1; got {size}")
    dev = resolve_device(device)
    if dev.type == "cpu":
        return _cpu_chunks(iterator, meter)
    return _cuda_chunks(iterator, int(size), dev, meter)
