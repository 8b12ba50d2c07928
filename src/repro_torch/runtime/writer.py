"""Background checkpoint writer and the run directory's manifest
(counterpart of ``repro.runtime.writer``; a run directory written by
either package is read by the other).

The segmented drivers (``core/segmented.py``) snapshot their state at a
boundary and hand the file write to a thread:

  * the **snapshot is taken synchronously**: the driver copies the state
    to host tensors at the boundary and submits that copy.  The artifact
    is therefore what a synchronous write would hold, whatever the
    writer's timing; only the file I/O is deferred;
  * the **writer is one daemon thread** over a bounded queue (depth 2 by
    default), so a driver that outruns the disk waits instead of
    buffering without bound;
  * **errors propagate**: the first failed write is raised again on the
    next ``submit``, ``drain`` or ``close``; the drivers close the writer
    in a ``finally``, so a failed write fails the run;
  * **close drains**: ``close()`` writes everything queued and joins the
    thread, so every snapshot a driver reported is on disk when it
    returns, also when it returns by an exception.

``write_snapshot`` is the synchronous primitive: the artifact (an atomic
tmp + rename ``serialize.save``), then the atomically rewritten
``manifest.json``, then the deletions of retention.  In that order the
manifest never names a file about to be deleted, so a crash between the
steps leaves at worst a complete artifact the manifest does not list.
Retention keeps the newest ``keep_last_n``, every boundary whose step is
a multiple of ``keep_every_m``, and always the newest.  ``cleanup_orphans``
removes the ``*.tmp`` files a killed writer left behind.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from pathlib import Path
from typing import Optional

from repro_torch.runtime.metrics import as_metrics

# repro_torch.core.serialize is imported inside `write_snapshot`: the
# solver drivers import this module, and importing repro_torch.core from
# here would close an import cycle.

MANIFEST_NAME = "manifest.json"
MANIFEST_SCHEMA = "ckpt_manifest/v1"

_STOP = object()


def snapshot_name(step: int) -> str:
    """The artifact's file name for a boundary snapshot."""
    return f"it_{int(step):08d}.npz"


def manifest_path(ckpt_dir) -> Path:
    return Path(ckpt_dir) / MANIFEST_NAME


def read_manifest(ckpt_dir) -> Optional[dict]:
    """The run directory's manifest, or None (none yet, another schema,
    or unreadable: callers then scan the directory)."""
    p = manifest_path(ckpt_dir)
    try:
        with open(p, "r", encoding="utf-8") as f:
            m = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if not isinstance(m, dict) or m.get("schema") != MANIFEST_SCHEMA:
        return None
    return m


def _write_manifest(ckpt_dir, manifest: dict) -> None:
    """Atomic tmp + rename rewrite: a reader never sees a torn file."""
    p = manifest_path(ckpt_dir)
    tmp = p.with_name(p.name + ".tmp")
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    os.replace(tmp, p)


def cleanup_orphans(ckpt_dir) -> list:
    """Remove the ``*.tmp`` files of a killed writer (artifacts and
    manifest).  A ``.tmp`` is never a complete artifact, so removing it
    is always safe.  -> the removed paths."""
    d = Path(ckpt_dir)
    if not d.exists():
        return []
    removed = []
    for p in d.glob("*.tmp"):
        try:
            p.unlink()
            removed.append(p)
        except OSError:
            pass
    return removed


def _json_safe(v):
    try:
        json.dumps(v)
        return v
    except (TypeError, ValueError):
        return str(v)


def _apply_retention(snaps: list, keep_last_n: int, keep_every_m: int):
    """(retained, dropped) of step-sorted manifest entries.  Both knobs
    0 keeps everything; otherwise an entry stays when it is among the
    newest ``keep_last_n``, on a ``keep_every_m`` boundary (step % m ==
    0), or the newest of all (the resume point)."""
    if not snaps or (keep_last_n <= 0 and keep_every_m <= 0):
        return snaps, []
    last = {e["file"] for e in snaps[-max(keep_last_n, 1):]} \
        if keep_last_n > 0 else {snaps[-1]["file"]}
    retained, dropped = [], []
    for e in snaps:
        keep = e["file"] in last or e is snaps[-1] or \
            (keep_every_m > 0 and e["step"] % keep_every_m == 0)
        (retained if keep else dropped).append(e)
    return retained, dropped


def write_snapshot(ckpt_dir, state, *, kind: str, step: int,
                   extra: Optional[dict] = None,
                   keep_last_n: int = 0, keep_every_m: int = 0) -> Path:
    """Write one snapshot: the artifact, the manifest, the deletions of
    retention, in that order.  ``state``'s leaves may be tensors on any
    device or numpy arrays (``serialize.save`` copies them to the
    host)."""
    from repro_torch.core import serialize
    d = Path(ckpt_dir)
    d.mkdir(parents=True, exist_ok=True)
    path = serialize.save(d / snapshot_name(step), state, kind=kind,
                          extra=extra)
    entry = {"file": path.name, "step": int(step),
             "meta": {k: _json_safe(v) for k, v in (extra or {}).items()}}
    manifest = read_manifest(d)
    if manifest is None:
        manifest = {"schema": MANIFEST_SCHEMA, "snapshots": []}
    snaps = [e for e in manifest.get("snapshots", [])
             if e.get("file") != entry["file"]]
    snaps.append(entry)
    snaps.sort(key=lambda e: e["step"])
    retained, dropped = _apply_retention(snaps, int(keep_last_n),
                                         int(keep_every_m))
    manifest.update(kind=kind, latest=retained[-1]["file"],
                    snapshots=retained)
    _write_manifest(d, manifest)
    for e in dropped:
        try:
            (d / e["file"]).unlink()
        except FileNotFoundError:
            pass
    return path


class CheckpointWriter:
    """One background thread over ``write_snapshot``::

        writer = CheckpointWriter(ckpt_dir, kind=serialize.KIND_LOOP,
                                  keep_last_n=3, metrics=sink)
        try:
            for each boundary:
                writer.submit(host_copy_of_state, t, meta)
        finally:
            writer.close()      # drain and join; raises a failed write

    ``submit`` blocks only while ``queue_size`` writes are pending, and
    raises an earlier write's error at once, so a failure shows at the
    next boundary.  Each write's latency goes to ``metrics`` as
    ``checkpoint_write_s``, from the writer's thread."""

    def __init__(self, ckpt_dir, *, kind: str,
                 keep_last_n: int = 0, keep_every_m: int = 0,
                 metrics=None, queue_size: int = 2):
        self.dir = Path(ckpt_dir)
        self.kind = kind
        self.keep_last_n = int(keep_last_n)
        self.keep_every_m = int(keep_every_m)
        self.metrics = as_metrics(metrics)
        self.last_write_s: Optional[float] = None
        self.n_written = 0
        self._q: queue.Queue = queue.Queue(maxsize=max(1, int(queue_size)))
        self._error: Optional[BaseException] = None
        self._closed = False
        self.dir.mkdir(parents=True, exist_ok=True)
        cleanup_orphans(self.dir)
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="repro-torch-ckpt-writer")
        self._thread.start()

    def submit(self, state_host, step: int,
               extra: Optional[dict] = None) -> None:
        """Queue one snapshot.  ``state_host`` is already the boundary's
        state on the host: taking that copy is the snapshot, the writer
        only persists it."""
        self._check()
        if self._closed:
            raise RuntimeError("CheckpointWriter is closed")
        self._q.put((state_host, int(step), extra))

    def drain(self) -> None:
        """Wait until every queued snapshot is on disk, then raise any
        write error."""
        self._q.join()
        self._check()

    def close(self) -> None:
        """Drain, stop the thread, raise any write error.  Idempotent."""
        if not self._closed:
            self._closed = True
            self._q.put(_STOP)
            self._thread.join()
        self._check()

    def __enter__(self) -> "CheckpointWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # a clean exit raises a writer error; if the body raised, the
        # writer still drains and joins, and the body's error wins
        try:
            self.close()
        except BaseException:
            if exc_type is None:
                raise

    def _check(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is _STOP:
                    return
                if self._error is not None:
                    continue    # nothing more is written after a failure
                state, step, extra = item
                t0 = time.perf_counter()
                write_snapshot(self.dir, state, kind=self.kind, step=step,
                               extra=extra, keep_last_n=self.keep_last_n,
                               keep_every_m=self.keep_every_m)
                self.last_write_s = time.perf_counter() - t0
                self.n_written += 1
                try:
                    self.metrics.log_scalars(
                        step, {"checkpoint_write_s": self.last_write_s})
                except Exception:   # noqa: BLE001
                    pass    # a broken sink must not fail the run's writes
            except BaseException as e:   # noqa: BLE001 -- raised later
                self._error = e
            finally:
                self._q.task_done()
