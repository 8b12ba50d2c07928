"""Segmented, resumable drivers (counterpart of the segmented half of
``repro.core.kmeans``: ``_aa_kmeans_segmented`` :366,
``_aa_kmeans_batched_segmented`` :772 and
``_aa_kmeans_minibatch_segmented`` :896).

These are the loops of ``aa_kmeans``, ``aa_kmeans_batched`` and
``aa_kmeans_minibatch``.  Each stops at boundaries, where, as its
keywords ask, it

  * copies the state to host tensors (the snapshot: taken here, at the
    boundary, so the artifact never depends on the writer's timing),
  * hands the copy to a ``runtime.writer.CheckpointWriter`` thread, or
    writes it in line with ``sync_writes=True``,
  * calls ``checkpoint_cb(tree, step)`` with the tree the artifact holds,
  * emits its scalars to the ``metrics`` sink, in one read of the device,
    and leaves the loop if the sink asks it to (``should_stop``).

Called with none of those keywords, a loop runs one segment and does
none of that.  A boundary only cuts the sequence of trips, so a run
resumed from any boundary equals the uninterrupted run bit for bit.  The snapshots are
the reference's: ``KIND_LOOP`` (its unbatched ``_LoopState``: the port's
state at R = 1 with the R axis dropped, taken where ``t`` reaches the
boundary, so no rejected iteration is half done), ``KIND_BATCHED`` (the
``_BatchedState``, ``pending`` included) and ``KIND_MINIBATCH`` (the
``MiniBatchState`` in the reference's layout and a two-word ``key``), so
either package resumes the other's.

The reference's ``_no_trace`` guard, which refuses these drivers under
``jax.jit``, has no counterpart: nothing here is traced.
"""

from __future__ import annotations

import os
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import serialize
from repro_torch.core.backends import Backend
from repro_torch.core.backends.base import _tree_index, _tree_stack
from repro_torch.core.backends.bounds import extract_stats
from repro_torch.core.kmeans import (KMeansConfig, KMeansResult,
                                     _BatchedState, _check_resume_meta,
                                     _init_state, _is_active,
                                     _result_from_state, _snapshot_meta,
                                     _unbatch, batched_state_like,
                                     batched_trip, loop_state_like,
                                     minibatch_stream_like)
from repro_torch.core.minibatch import (MiniBatchConfig, MiniBatchResult,
                                        from_reference_layout, guard_pick,
                                        minibatch_init, reference_layout,
                                        run_epoch, stack_traces)
from repro_torch.runtime.metrics import as_metrics, should_stop
from repro_torch.runtime.writer import CheckpointWriter, write_snapshot


def _host_copy(tree):
    """Every leaf of ``tree`` copied to a host tensor or array (a new
    one on the CPU too, so that it never aliases the live state)."""
    _, leaves, treedef = serialize.flatten_with_paths(tree)
    return serialize.unflatten(treedef, [
        leaf.detach().to("cpu", copy=True) if isinstance(leaf, torch.Tensor)
        else np.array(leaf, copy=True) for leaf in leaves])


def _read(scalars: dict) -> dict:
    """0-d tensors as Python floats, in one copy from the device."""
    vals = torch.stack([v.to(torch.float64) for v in scalars.values()])
    return dict(zip(scalars, vals.tolist()))


class Share(NamedTuple):
    """How a mesh rank takes part in a boundary's snapshot
    (``core/distributed.py``): ``gather`` turns its shard-local tree into
    the global one (a collective, so every rank calls it), ``writes``
    says whether this rank writes it, and ``extra`` goes into the meta."""
    gather: Callable
    writes: bool
    extra: dict


class _Boundary:
    """What every boundary of a segmented driver does with its snapshot:
    the host copy, the write (a thread's, or in line) and the callback.
    Under a mesh (``share``), the snapshot is first gathered, and only
    the writing rank copies and writes it."""

    def __init__(self, checkpoint_dir, kind: str, cfg, bk: Backend,
                 checkpoint_cb: Optional[Callable], keep_last_n: int,
                 keep_every_m: int, mx, sync_writes: bool,
                 share: Optional[Share] = None):
        self.dir, self.kind, self.cfg, self.bk = checkpoint_dir, kind, cfg, bk
        self.cb = checkpoint_cb
        self.share = share
        self.keep = dict(keep_last_n=keep_last_n, keep_every_m=keep_every_m)
        self.writer = None
        if checkpoint_dir is not None and not sync_writes \
                and (share is None or share.writes):
            self.writer = CheckpointWriter(checkpoint_dir, kind=kind,
                                           metrics=mx, **self.keep)

    def snapshot(self, tree, step: int, extra=None) -> dict:
        """Write ``tree`` as the snapshot of ``step``; -> {"snapshot_s":
        the host copy's seconds} (ending in the copy's sync; under a
        mesh also "gather_s", the gather's), or {} when nothing is
        written."""
        if self.dir is None:
            return {}
        out = {}
        if self.share is not None:
            t0 = time.perf_counter()
            tree = self.share.gather(tree)
            out["gather_s"] = time.perf_counter() - t0
            extra = {**(extra or {}), **self.share.extra}
            if not self.share.writes:
                return out
        t0 = time.perf_counter()
        host = _host_copy(tree)
        copy_s = time.perf_counter() - t0
        meta = _snapshot_meta(step, self.cfg, self.bk, extra)
        if self.writer is not None:
            self.writer.submit(host, step, meta)
        else:
            write_snapshot(self.dir, host, kind=self.kind, step=step,
                           extra=meta, **self.keep)
        return {**out, "snapshot_s": copy_s}

    def callback(self, tree, step: int) -> None:
        if self.cb is not None:
            self.cb(tree, step)

    def close(self) -> None:
        """Drain and join the writer; raises a failed write."""
        if self.writer is not None:
            self.writer.close()


def _restore(path, like, kind: str, cfg, bk: Backend, device):
    """(tree, meta) of the artifact at ``path``, restored into ``like``
    on ``device``; a snapshot taken at another k or on another engine is
    refused before its leaves are read into the layout."""
    meta, by_path = serialize.load(path, expect_kind=kind)
    _check_resume_meta(meta, cfg, bk, str(path))
    return serialize.fill(by_path, like, device=device, path=path), meta


def _is_path(v) -> bool:
    return isinstance(v, (str, os.PathLike))


def _t_converged(bst: _BatchedState):
    """(t, converged) of problem 0 as host values, in one read."""
    t, conv = torch.stack([bst.inner.t[0],
                           bst.inner.converged[0].to(torch.int32)]).tolist()
    return t, bool(conv)


def aa_kmeans_segmented(x, c0, cfg: KMeansConfig, bk: Backend,
                        checkpoint_every=0, checkpoint_dir=None,
                        resume_from=None, checkpoint_cb=None,
                        keep_last_n=0, keep_every_m=0, metrics=None,
                        sync_writes=False, share=None) -> KMeansResult:
    """The loop of ``aa_kmeans``, cut every ``checkpoint_every``
    iterations (all of ``cfg.max_iter`` when 0).  It is the batched
    loop at R = 1, reading ``t`` together with the convergence flag in
    its one copy from the device per trip, and it stops a segment where
    ``t`` reaches its end, after a completed iteration (``pending``
    False), so the ``KIND_LOOP`` tree is the R = 1 state with its R axis
    dropped.  ``share`` is a mesh rank's part in the snapshots (the
    distributed fit's; see ``Share``)."""
    mx = as_metrics(metrics)
    every = int(checkpoint_every) if checkpoint_every else cfg.max_iter
    if _is_path(resume_from):
        state, _ = _restore(resume_from, loop_state_like(x, c0, cfg, bk),
                            serialize.KIND_LOOP, cfg, bk, x.device)
    else:
        state = resume_from
    if state is None:
        bst = _init_state(x, c0[None], cfg, bk)
    else:
        bst = _BatchedState(_tree_stack([state]),
                            torch.zeros((1,), dtype=torch.bool,
                                        device=x.device))
    bd = _Boundary(checkpoint_dir, serialize.KIND_LOOP, cfg, bk,
                   checkpoint_cb, keep_last_n, keep_every_m, mx,
                   sync_writes, share)
    try:
        t, conv = _t_converged(bst)
        while not conv and t < cfg.max_iter:
            seg_end = min(t + every, cfg.max_iter)
            t0 = time.perf_counter()
            while not conv and t < seg_end:
                bst = batched_trip(x, bst, cfg, bk)
                t, conv = _t_converged(bst)
            seg_s = time.perf_counter() - t0
            state = _tree_index(bst.inner, 0)
            snap = bd.snapshot(state, t)
            bd.callback(state, t)
            if metrics is None:
                continue
            bs = extract_stats(state.carry)
            mx.log_scalars(t, {**_read({
                "energy": state.e_last, "n_accepted": state.n_acc,
                "converged": state.converged,
                **({} if bs is None else {
                    "eliminated_frac": bs.eliminated_frac,
                    "skipped_frac": bs.skipped_frac})}),
                "segment_s": seg_s, **snap})
            if should_stop(mx):
                break    # an EarlyStopHook: the energy stalled
    finally:
        bd.close()
    return _unbatch(_result_from_state(bst.inner))


def aa_kmeans_batched_segmented(x, c0s, cfg: KMeansConfig, bk: Backend,
                                weights=None, checkpoint_every=0,
                                checkpoint_dir=None, resume_from=None,
                                checkpoint_cb=None, keep_last_n=0,
                                keep_every_m=0, metrics=None,
                                sync_writes=False) -> KMeansResult:
    """The loop of ``aa_kmeans_batched``, cut every ``checkpoint_every``
    trips (by default 2 * max_iter + 1, the most a solve can take), with
    one copy from the device per trip (is any restart active).  Restarts'
    iteration counts drift apart, so segments are counted in trips and
    a snapshot is named by ``trips``, an upper bound of the trips run
    that only grows; a resume from a path reads it from the meta."""
    mx = as_metrics(metrics)
    every = int(checkpoint_every) if checkpoint_every \
        else 2 * cfg.max_iter + 1
    trips = 0
    if _is_path(resume_from):
        bst, meta = _restore(resume_from,
                             batched_state_like(x, c0s, cfg, bk),
                             serialize.KIND_BATCHED, cfg, bk, x.device)
        trips = int(meta.get("t", 0))
    elif resume_from is not None:
        bst = resume_from
        trips = int(torch.max(bst.inner.t))   # names snapshots only
    else:
        bst = _init_state(x, c0s, cfg, bk, w=weights)
    bd = _Boundary(checkpoint_dir, serialize.KIND_BATCHED, cfg, bk,
                   checkpoint_cb, keep_last_n, keep_every_m, mx,
                   sync_writes)
    try:
        active = bool(torch.any(_is_active(bst.inner, cfg.max_iter)))
        while active:
            t0 = time.perf_counter()
            for _ in range(every):
                bst = batched_trip(x, bst, cfg, bk, w=weights)
                active = bool(torch.any(_is_active(bst.inner,
                                                   cfg.max_iter)))
                if not active:
                    break
            trips += every
            seg_s = time.perf_counter() - t0
            snap = bd.snapshot(bst, trips)
            bd.callback(bst, trips)
            if metrics is None:
                continue
            e = bst.inner.e_last
            mx.log_scalars(trips, {**_read({
                "energy_best": torch.min(torch.where(
                    torch.isfinite(e), e, float("inf"))),
                "n_active": torch.sum(_is_active(bst.inner, cfg.max_iter)),
                "n_accepted_total": torch.sum(bst.inner.n_acc)}),
                "segment_s": seg_s, **snap})
            if should_stop(mx):
                break
    finally:
        bd.close()
    return _result_from_state(bst.inner)


def _key_words(seed: int) -> np.ndarray:
    """A 64-bit seed as the reference's two uint32 key words (high, low):
    seed s < 2**32 gives jax.random.PRNGKey(s)'s words."""
    return np.array([seed >> 32, seed & 0xFFFFFFFF], dtype=np.uint32)


def _seed_of(key) -> int:
    hi, lo = (int(w) for w in np.asarray(key, dtype=np.uint64).reshape(2))
    return (hi << 32) | lo


def _require_fresh(generator: torch.Generator) -> None:
    """A resumed run replays the chunk orders from the generator's seed,
    which only gives this run's orders if nothing was drawn before it."""
    fresh = torch.Generator().manual_seed(generator.initial_seed())
    if not torch.equal(fresh.get_state(), generator.get_state()):
        raise ValueError(
            "aa_kmeans_minibatch with checkpoint keywords needs a "
            "generator nothing has been drawn from: its snapshots keep the "
            "seed and a resume replays the orders from it, which would not "
            "be this run's orders; pass torch.Generator().manual_seed(seed)")


def aa_kmeans_minibatch_segmented(chunks, weights, x_val, c0,
                                  cfg: MiniBatchConfig, bk: Backend,
                                  generator, return_trace: bool,
                                  checkpoint_every=0, checkpoint_dir=None,
                                  resume_from=None, checkpoint_cb=None,
                                  keep_last_n=0, keep_every_m=0,
                                  metrics=None, sync_writes=False):
    """The loop of ``aa_kmeans_minibatch``, cut at epochs: a snapshot
    every ``checkpoint_every`` epochs (and after the last) when a
    ``checkpoint_dir`` is given.

    Each epoch's chunk order is drawn from the caller's ``generator``.
    The reference's snapshot holds its jax key; the port keeps the
    generator's seed in the key's two words, so with checkpoint keywords
    the generator must be fresh (nothing drawn from it yet), and a
    resume at epoch e replays e draws from a generator reseeded with the
    snapshot's seed.  A run with checkpoints then equals the run without
    them on the same generator, and a resumed run equals both.  A reference snapshot resumes here with its key read
    as such a seed: the port's own orders, a different but valid
    trajectory (ROADMAP queue C).  ``checkpoint_cb`` gets
    ``{"state", "key", "epoch"}`` (the state in the reference's layout),
    which ``resume_from`` takes back; a resumed run's trace holds the
    epochs run since the snapshot.  Without a checkpoint keyword or a
    sink the loop never syncs with the device."""
    mx = as_metrics(metrics)
    every = max(1, int(checkpoint_every)) if checkpoint_every else 1
    dev = chunks.device
    n_chunks = chunks.shape[0]
    epoch = 0
    if resume_from is None:
        if checkpoint_every or checkpoint_dir is not None \
                or checkpoint_cb is not None:
            _require_fresh(generator)
        seed, order = generator.initial_seed(), generator
        state = minibatch_init(c0, cfg, bk)
    else:
        if _is_path(resume_from):
            meta, by_path = serialize.load(
                resume_from, expect_kind=serialize.KIND_MINIBATCH)
            _check_resume_meta(meta, cfg, bk, str(resume_from))
            like = minibatch_stream_like(c0, cfg, bk)["state"]
            state = serialize.fill(by_path, like, prefix="state/",
                                   device=dev, path=resume_from)
            key, epoch = by_path["key"].numpy(), int(meta.get("epoch", 0))
        else:
            state, key = resume_from["state"], resume_from["key"]
            epoch = int(resume_from.get("epoch", 0))
        if not isinstance(state.t, int):
            state = from_reference_layout(state)
        seed = _seed_of(key)
        order = torch.Generator().manual_seed(seed)
        for _ in range(epoch):
            torch.randperm(n_chunks, generator=order)
    key = _key_words(seed)
    bd = _Boundary(checkpoint_dir, serialize.KIND_MINIBATCH, cfg, bk,
                   checkpoint_cb, keep_last_n, keep_every_m, mx,
                   sync_writes)
    traces = []
    try:
        while epoch < cfg.epochs:
            t0 = time.perf_counter()
            perm = torch.randperm(n_chunks, generator=order)
            state, trace = run_epoch(chunks, weights, x_val, state, cfg, bk,
                                     perm.tolist())
            epoch += 1
            if return_trace:
                traces.append(trace)
            scalars = {}
            if metrics is not None:
                scalars = _read({
                    "e_val": trace.e_val[-1], "e_cand": trace.e_cand[-1],
                    "e_fallback": trace.e_fallback[-1],
                    "n_accepted_epoch": torch.sum(trace.accepted)})
                scalars["epoch_s"] = time.perf_counter() - t0
            if checkpoint_dir is not None or checkpoint_cb is not None:
                tree = {"state": reference_layout(state), "key": key}
                if epoch % every == 0 or epoch == cfg.epochs:
                    scalars.update(bd.snapshot(tree, epoch,
                                               {"epoch": epoch}))
                # the epoch rides in the payload, so that the tree fed
                # back through resume_from= does not run its epochs again
                bd.callback({**tree, "epoch": epoch}, epoch)
            if metrics is None:
                continue
            mx.log_scalars(epoch, scalars)
            if should_stop(mx):
                break
    finally:
        bd.close()
    c_fin, e_fin, _, _ = guard_pick(x_val, state, cfg, bk)
    result = MiniBatchResult(c_fin, e_fin, state.t, state.n_acc)
    if not return_trace:
        return result
    return result, stack_traces(traces) if traces else None
