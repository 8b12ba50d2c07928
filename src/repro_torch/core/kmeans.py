"""Algorithm 1 of the paper (counterpart of ``repro.core.kmeans``:
``_init_state`` :131, ``loop_state_like`` / ``_check_resume_meta`` /
``_snapshot_meta`` :271-315, ``aa_kmeans`` :415,
``_complete_batched_iteration`` :519, ``_batched_body`` :579,
``batched_state_like`` :650, ``aa_kmeans_batched`` :666-756,
``select_best`` :831, ``minibatch_stream_like`` :882,
``aa_kmeans_minibatch`` :976 and ``aa_kmeans_minibatch_streamed`` :1049,
``KMeansTrace`` / ``split_bound_phases`` / ``aa_kmeans_traced``
:1126-1245).

Three drivers over one loop body:

  * ``aa_kmeans_batched`` — R restarts or problems driven together;
  * ``aa_kmeans``         — one problem: the batched driver at R = 1, so
                            both give the same bits;
  * ``aa_kmeans_traced``  — one problem, recording per iteration what the
                            paper's Tables 2 and 3 report (energies, the
                            window size m, acceptances, bound stats, the
                            wall time).

The JAX ``lax.while_loop`` becomes a host loop with one device-to-host
sync per trip (``any(active)``).  Each trip is ONE batched backend step
for all R restarts; a restart whose accelerated iterate was rejected
sets ``pending`` and completes the iteration with the fallback step on
the next trip, so the sequence of steps, window pushes and
m-adjustments per restart is that of the sequential Algorithm 1.
Finished restarts are frozen row-wise (``_select_rows``).

Every state leaf carries the leading R axis; the completion logic that
the reference vmaps per restart is written out over that axis.

Two streaming drivers run the chunk-step state machine of
``core/minibatch.py``: ``aa_kmeans_minibatch`` over device-resident
chunks and ``aa_kmeans_minibatch_streamed`` over host chunks with the
copies prefetched.  Neither syncs with the device inside its loop
unless a metrics sink asks for per-chunk scalars.

The loops of ``aa_kmeans``, ``aa_kmeans_batched`` and
``aa_kmeans_minibatch`` live in ``core/segmented.py``: given a
checkpoint keyword or a metrics sink they stop at boundaries that
snapshot, write and emit, and with none they run one segment.  The
snapshot layouts they restore into (``loop_state_like``,
``batched_state_like``, ``minibatch_stream_like``) and the resume checks
live here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from repro_torch.core import anderson
from repro_torch.core.anderson import AAConfig, AAState
from repro_torch.core.backends import Backend, get_backend, refuse_bf16
from repro_torch.core.backends.base import _tree_index, from_lloyd_ops
from repro_torch.core.backends.bounds import extract_stats
from repro_torch.core.lloyd import DENSE_OPS, LloydOps
from repro_torch.core.locality import maybe_reorder
from repro_torch.core.minibatch import (MiniBatchConfig, MiniBatchResult,
                                        guard_pick, minibatch_init,
                                        minibatch_iteration,
                                        reference_layout,
                                        stack_traces)
from repro_torch.data.streaming import stream_chunks
from repro_torch.device import mesh_device, resolve_device
from repro_torch.runtime.metrics import as_metrics


@dataclasses.dataclass(frozen=True)
class KMeansConfig:
    k: int
    max_iter: int = 500
    aa: AAConfig = dataclasses.field(default_factory=AAConfig)
    accelerated: bool = True     # False -> plain Lloyd through the same driver


class KMeansResult(NamedTuple):
    centroids: torch.Tensor   # (R, K, d)
    labels: torch.Tensor      # (R, N)
    energy: torch.Tensor      # (R,) final E
    n_iter: torch.Tensor      # (R,) total iterations (the paper's "b")
    n_accepted: torch.Tensor  # (R,) accelerated iterates kept
    converged: torch.Tensor   # (R,) bool


class _LoopState(NamedTuple):
    c: torch.Tensor           # C^t                    (R, K, d)
    c_au: torch.Tensor        # C_AU^t = G(C^{t-1})    (R, K, d)
    p_prev: torch.Tensor      # P^{t-1}                (R, N)
    e_prev: torch.Tensor      # E^{t-1}                (R,)
    e_prev2: torch.Tensor     # E^{t-2}                (R,)
    aa: AAState
    t: torch.Tensor           # (R,) int32
    n_acc: torch.Tensor       # (R,) int32
    converged: torch.Tensor   # (R,) bool
    labels: torch.Tensor      # last P^t (valid on exit)
    e_last: torch.Tensor      # (R,)
    carry: Any                # backend carry (() or the bound contract)


class _BatchedState(NamedTuple):
    inner: _LoopState
    # (R,) True while an iteration is half done: the accelerated iterate
    # was rejected and the fallback step has not run yet.
    pending: torch.Tensor


BackendLike = Union[str, Backend, LloydOps, None]


def resolve_backend(backend: BackendLike,
                    ops: Optional[LloydOps] = None) -> Backend:
    """The (backend=, ops=) pair the solvers accept: a Backend passes
    through, a registry name is looked up, a legacy LloydOps (as backend=
    or as a non-default ops=) is adapted through ``from_lloyd_ops``;
    otherwise the dense engine."""
    if isinstance(backend, Backend):
        return backend
    if isinstance(backend, str):
        return get_backend(backend)
    if isinstance(backend, LloydOps):
        return from_lloyd_ops(backend)
    if backend is not None:
        raise TypeError(f"backend= expects a registry name, a Backend or a "
                        f"LloydOps; got {type(backend).__name__}")
    if ops is not None and ops is not DENSE_OPS:
        return from_lloyd_ops(ops)
    return get_backend("dense")


def _select_rows(mask: torch.Tensor, on_true, on_false):
    """Leaf-wise per-row select: mask (R,) against leaves (R, ...)."""
    if isinstance(on_true, torch.Tensor):
        m = mask.reshape(mask.shape + (1,) * (on_true.dim() - 1))
        return torch.where(m, on_true, on_false)
    if isinstance(on_true, tuple) and hasattr(on_true, "_fields"):
        return type(on_true)(*(_select_rows(mask, a, b)
                               for a, b in zip(on_true, on_false)))
    if isinstance(on_true, tuple):
        return tuple(_select_rows(mask, a, b)
                     for a, b in zip(on_true, on_false))
    raise TypeError(f"cannot select rows of {type(on_true).__name__}")


def _init_state(x, c0s, cfg: KMeansConfig, backend: Backend,
                w=None) -> _BatchedState:
    """Line 1 for every restart: C^1 = C_AU^1 = G(C^0), F^0 = C^1 - C^0,
    E^0 = +inf — one batched step."""
    carry = backend.batched_init_carry(x, c0s, cfg.k)
    res0, carry = backend.batched_step(x, c0s, cfg.k, carry, w=w)
    c1 = backend.centroids_from_step(x, res0, cfg.k, c0s)
    return _assemble_state(x, c1, c1 - c0s, res0.labels, res0.energy, carry,
                           cfg)


def _assemble_state(x, c1, f0, labels0, e0, carry,
                    cfg: KMeansConfig) -> _BatchedState:
    """The state before the first trip from the init step's outputs,
    ``f0`` = C^1 - C^0 (also on the meta device, where
    ``batched_state_like`` builds the snapshot layout from it)."""
    r, dev = c1.shape[0], x.device
    aa = anderson.aa_init(r, cfg.k * x.shape[-1], cfg.aa, x.dtype, dev)
    aa = anderson.aa_seed(aa, f0.reshape(r, -1), c1.reshape(r, -1))
    inf = torch.full((r,), float("inf"), dtype=e0.dtype, device=dev)
    zeros = torch.zeros((r,), dtype=torch.int32, device=dev)
    false = torch.zeros((r,), dtype=torch.bool, device=dev)
    inner = _LoopState(
        c=c1, c_au=c1, p_prev=labels0, e_prev=inf, e_prev2=inf, aa=aa,
        t=zeros, n_acc=zeros, converged=false, labels=labels0,
        e_last=e0, carry=carry)
    return _BatchedState(inner, false)


def _complete_batched_iteration(x, res, carry, bst: _BatchedState,
                                cfg: KMeansConfig, backend: Backend,
                                w=None) -> _BatchedState:
    """Everything in Algorithm 1's loop body after the backend step, for
    all R restarts at once."""
    st, pending = bst.inner, bst.pending
    k, r = cfg.k, pending.shape[0]
    c_eval = torch.where(pending[:, None, None], st.c_au, st.c)

    # Line 4 (phase A only): the revert step never checks convergence.
    # Under row weights a padding row (w = 0) never holds it up.
    if w is None:
        lab_now, lab_prev = res.labels, st.p_prev
    else:
        live = w > 0
        lab_now = torch.where(live, res.labels, 0)
        lab_prev = torch.where(live, st.p_prev, 0)
    conv_now = ~pending & backend.all_equal(lab_now, lab_prev)
    # Lines 7-11 (phase A only): m adjusts before the revert decision.
    aa_adj = anderson.adjust_m(st.aa, res.energy, st.e_prev, st.e_prev2,
                               cfg.aa)
    accepted = ~pending & (res.energy < st.e_prev)
    complete = pending | accepted

    # Lines 16-19 from the step's stats.  In phase B the window was
    # already adjusted when the iterate was rejected.
    aa_for_push = _select_rows(pending, st.aa, aa_adj)
    c_au_next = backend.centroids_from_step(x, res, k, c_eval)
    g_flat = c_au_next.reshape(r, -1)
    f_flat = g_flat - c_eval.reshape(r, -1)
    if cfg.accelerated:
        aa_pushed, c_next_flat, _, _ = anderson.aa_push_and_solve(
            aa_for_push, f_flat, g_flat, cfg.aa)
        c_next = c_next_flat.reshape(st.c.shape)
    else:
        aa_pushed, c_next = aa_for_push, c_au_next

    st_complete = _LoopState(
        c=c_next, c_au=c_au_next, p_prev=res.labels,
        e_prev=res.energy, e_prev2=st.e_prev, aa=aa_pushed,
        t=st.t + 1, n_acc=st.n_acc + accepted.to(torch.int32),
        converged=torch.zeros_like(pending), labels=res.labels,
        e_last=res.energy, carry=carry)
    st_pending = st._replace(aa=aa_adj, carry=carry)
    st_conv = st._replace(converged=torch.ones_like(pending),
                          labels=res.labels, e_last=res.energy,
                          t=st.t + 1, carry=carry)
    new_inner = _select_rows(conv_now, st_conv,
                             _select_rows(complete, st_complete, st_pending))
    return _BatchedState(new_inner, ~conv_now & ~complete)


def _batched_body(x, bst: _BatchedState, cfg: KMeansConfig,
                  backend: Backend, w=None) -> _BatchedState:
    """One backend step for the whole batch: phase A (pending False)
    steps at C^t, phase B (pending True) at the fallback C_AU^t."""
    st = bst.inner
    c_eval = torch.where(bst.pending[:, None, None], st.c_au, st.c)
    res, carry = backend.batched_step(x, c_eval, cfg.k, st.carry, w=w)
    return _complete_batched_iteration(x, res, carry, bst, cfg, backend, w)


def _is_active(state: _LoopState, max_iter: int) -> torch.Tensor:
    return ~state.converged & (state.t < max_iter)


def batched_trip(x, bst: _BatchedState, cfg: KMeansConfig,
                 backend: Backend, w=None) -> _BatchedState:
    """One trip of the batched loop: the body, with finished restarts
    frozen row-wise (a pending restart never has t == max_iter, so the
    sequential loop guard carries over as is)."""
    active = _is_active(bst.inner, cfg.max_iter)
    return _select_rows(active, _batched_body(x, bst, cfg, backend, w), bst)


def _result_from_state(state: _LoopState) -> KMeansResult:
    # The paper's "b" counts C^1 = G(C^0) plus every fully executed loop
    # body; the body that merely detects convergence is not counted.
    n_iter = state.t + torch.where(state.converged, 0, 1).to(torch.int32)
    return KMeansResult(state.c, state.labels, state.e_last, n_iter,
                        state.n_acc, state.converged)


def _check_inputs(x, c0s, weights):
    if c0s.dim() != 3:
        raise ValueError(f"c0s must be (R, K, d); got shape "
                         f"{tuple(c0s.shape)}")
    if x.dim() not in (2, 3):
        raise ValueError(f"x must be (N, d) or (R, N, d); got "
                         f"{tuple(x.shape)}")
    if x.dim() == 3 and x.shape[0] != c0s.shape[0]:
        raise ValueError(
            f"batched x has {x.shape[0]} problems but c0s has "
            f"{c0s.shape[0]} seed sets")
    if weights is not None and tuple(weights.shape) != \
            (c0s.shape[0], x.shape[-2]):
        raise ValueError(
            f"weights must be (R, N) = ({c0s.shape[0]}, {x.shape[-2]}); "
            f"got {tuple(weights.shape)}")


def aa_kmeans_batched(x: torch.Tensor, c0s: torch.Tensor,
                      cfg: KMeansConfig, backend: BackendLike = None, *,
                      weights: Optional[torch.Tensor] = None,
                      reorder=False, checkpoint_every: int = 0,
                      checkpoint_dir=None, resume_from=None,
                      checkpoint_cb: Optional[Callable] = None,
                      keep_last_n: int = 0, keep_every_m: int = 0,
                      metrics=None,
                      sync_writes: bool = False) -> KMeansResult:
    """Batched Algorithm 1: R independent solves driven together.

    ``c0s`` (R, K, d) — one seed set per restart; ``x`` (N, d) shared by
    every restart or (R, N, d) one dataset per problem.  ``weights``
    (R, N) >= 0 scales each row's contribution to its problem's stats and
    energy (w = 0 rows vanish, also from the convergence check).  A
    restart that converges (or reaches max_iter) keeps its frozen state
    while the others continue, so its trajectory is the sequential one.
    Returns a ``KMeansResult`` with a leading R axis on every leaf; use
    ``select_best`` for the winner.

    ``reorder=True`` (or a ``locality.ReorderConfig``) wraps a bound
    backend in the locality engine, with one permutation per restart:
    the engine sees each restart's rows sorted by its labels, the result
    is in original row order.

    ``checkpoint_every=s`` cuts the solve every s TRIPS (one batched
    step each; a rejected iteration spans two) and snapshots the whole
    ``_BatchedState``; ``resume_from`` takes such a snapshot's path or
    tree.  The other checkpoint and runtime keywords are those of
    ``aa_kmeans``; ``metrics`` gets ``energy_best``, ``n_active``,
    ``n_accepted_total``, ``segment_s`` and ``snapshot_s`` per segment.
    The loop is ``segmented.aa_kmeans_batched_segmented``: boundaries
    only cut its sequence of trips, so any of these keywords leaves the
    result as it is without them, bit for bit.
    """
    from repro_torch.core.segmented import aa_kmeans_batched_segmented
    _check_inputs(x, c0s, weights)
    return aa_kmeans_batched_segmented(
        x, c0s, cfg, maybe_reorder(resolve_backend(backend), reorder),
        weights, checkpoint_every, checkpoint_dir, resume_from,
        checkpoint_cb, keep_last_n, keep_every_m, metrics, sync_writes)


def select_best(results: KMeansResult, groups=None,
                n_groups: Optional[int] = None) -> KMeansResult:
    """The restart with the lowest final energy, unbatched; ties go to
    the lower index.  A non-finite energy never wins; if every restart is
    non-finite, restart 0 comes back with its NaN energy so the caller
    sees the failure.

    ``groups`` (R,) int selects per problem: restart r competes only
    within group groups[r] (the hierarchy runs G sub-problems x n_init
    seeds as one batch), and the result keeps a leading axis of
    ``n_groups`` whose row g is group g's winner, by the same rule.  A
    group whose every restart is non-finite gets its first restart, NaN
    energy and all (the reference's argmin hands such a group restart 0
    of the whole batch, another group's result: ROADMAP queue C)."""
    e = results.energy
    masked = torch.where(torch.isfinite(e), e, float("inf"))
    if groups is None:
        best = torch.argmin(masked)
        return KMeansResult(*(a[best] for a in results))
    if n_groups is None:
        raise ValueError("select_best(groups=...) needs n_groups")
    gid = torch.arange(n_groups, device=e.device)
    member = groups.to(e.device).long()[None, :] == gid[:, None]  # (G, R)
    emat = torch.where(member, masked[None, :], float("inf"))
    # argmin returns the first minimum; a row of +inf only falls back to
    # the group's first member
    best = torch.where(torch.isfinite(torch.amin(emat, dim=1)),
                       torch.argmin(emat, dim=1),
                       torch.argmax(member.to(torch.int8), dim=1))
    return KMeansResult(*(a[best] for a in results))


def aa_kmeans_minibatch(chunks: torch.Tensor, weights: torch.Tensor,
                        x_val: torch.Tensor, c0: torch.Tensor,
                        cfg: MiniBatchConfig, backend: BackendLike = None,
                        generator: Optional[torch.Generator] = None,
                        return_trace: bool = False, *, device=None,
                        checkpoint_every: int = 0, checkpoint_dir=None,
                        resume_from=None,
                        checkpoint_cb: Optional[Callable] = None,
                        keep_last_n: int = 0, keep_every_m: int = 0,
                        metrics=None, sync_writes: bool = False):
    """Streaming Algorithm 1 over device-resident chunks.

    ``chunks`` (n_chunks, B, d) with the row-weight mask ``weights``
    (n_chunks, B) (``data.streaming.chunk_dataset`` makes both),
    ``x_val`` (V, d) the validation chunk of the energy guard, ``c0``
    (K, d) the seeds.  Runs ``cfg.epochs`` epochs, each over every chunk
    in an order drawn on the host from ``generator`` (a CPU
    ``torch.Generator``; default seed 0): a chunk is a view taken with a
    host int, where a device permutation would have to be read back
    before it could index anything.  So the loop never syncs with the
    device.  The operands go to ``device`` (None: CUDA) first.

    Returns a ``MiniBatchResult`` whose centroids are the final
    guard-picked iterate; with ``return_trace=True`` also a
    ``MiniBatchTrace`` with leaves of shape (epochs, n_chunks).

    ``checkpoint_every=e`` (and the other checkpoint and runtime
    keywords of ``aa_kmeans``) snapshots the state and the chunk order's
    seed every e epochs; ``metrics`` gets scalars once per epoch.  The
    loop is ``segmented.aa_kmeans_minibatch_segmented``, which leaves
    the result as it is without these keywords, bit for bit.  With a
    checkpoint keyword it refuses a generator that has been drawn from,
    whose orders a resume could not replay.  On a mesh,
    ``distributed.make_distributed_kmeans_minibatch`` runs this driver
    on each rank's rows."""
    from repro_torch.core.segmented import aa_kmeans_minibatch_segmented
    if chunks.dim() != 3:
        raise ValueError(f"chunks must be (n_chunks, B, d); got "
                         f"{tuple(chunks.shape)}")
    if tuple(weights.shape) != tuple(chunks.shape[:2]):
        raise ValueError(f"weights {tuple(weights.shape)} must match "
                         f"chunks' leading dims {tuple(chunks.shape[:2])}")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if generator.device.type != "cpu":
        raise ValueError("the chunk order is drawn on the host: generator "
                         "must be a CPU torch.Generator")
    dev = resolve_device(device)
    chunks, weights, x_val, c0 = (t.to(dev) for t in (chunks, weights,
                                                      x_val, c0))
    return aa_kmeans_minibatch_segmented(
        chunks, weights, x_val, c0, cfg, resolve_backend(backend),
        generator, return_trace, checkpoint_every, checkpoint_dir,
        resume_from, checkpoint_cb, keep_last_n, keep_every_m, metrics,
        sync_writes)


def aa_kmeans_minibatch_streamed(source, x_val: torch.Tensor,
                                 c0: torch.Tensor, cfg: MiniBatchConfig,
                                 backend: BackendLike = None, *,
                                 chunk_size: Optional[int] = None,
                                 seed: int = 0, prefetch: int = 2,
                                 drop_remainder: bool = False,
                                 sort_chunks: bool = False, meter=None,
                                 metrics=None, return_trace: bool = False,
                                 device=None, mesh=None,
                                 data_axes=("data",)):
    """Streaming Algorithm 1 over a host-resident source, with the
    host-to-device copies prefetched (``data.streaming.stream_chunks``
    over ``runtime.prefetch``): chunk t+1's copy runs while chunk t's
    step does.

    ``source`` is a host array (chunked and shuffled per epoch by
    ``host_chunk_stream`` from ``seed``; ``chunk_size`` defaults to
    ``cfg.chunk_size``) or any iterator of host chunks (``chunk_size`` and
    ``seed`` ignored; the caller owns the order and bakes ``cfg.epochs``
    into it).  Each chunk runs one ``minibatch_iteration`` with unit row
    weights, the state machine of ``aa_kmeans_minibatch``; chunks and
    state live on ``device`` (None: CUDA).  Uniform chunk lengths
    (``drop_remainder=True`` for an array source) keep the kernels at one
    shape.

    ``sort_chunks=True`` sorts each chunk's rows by the driver's current
    centroids before the copy (stale by the prefetch depth, which shapes
    locality only, never the numbers); reading them costs a sync per
    chunk.  ``meter`` (an ``IngestMeter``) records the ingest.
    ``metrics`` gets each chunk's ``e_val`` and ``accepted``: reading them
    waits for the step, so a sink serialises the overlap this driver is
    for; without one the loop never syncs.

    With ``mesh`` (a ``DeviceMesh``; every rank calls with the same
    source, seed, ``x_val`` and ``c0``), each host chunk's rows are
    sharded over ``data_axes``: a rank copies only its block of every
    chunk (``stream_chunks(mesh=)``) and holds its block of ``x_val``,
    the engine is ``distribute``d, and each chunk step reduces its stats
    in one collective (and the guard's in another).  Chunk lengths and V
    must divide by the shard count.

    Returns a ``MiniBatchResult`` (with ``return_trace=True`` also a
    ``MiniBatchTrace`` stacked over all chunk steps)."""
    scope = contextlib.nullcontext()
    where = "host-streamed chunks (aa_kmeans_minibatch_streamed)"
    refuse_bf16(where, resolve_backend(backend), source, x_val, c0)
    if mesh is None:
        dev = resolve_device(device)
        bk = resolve_backend(backend)
    else:
        from repro_torch.core import distributed as D
        dev = mesh_device(mesh, device)
        bk = D._resolve_distributed(backend, None, 0, tuple(data_axes))
        x_val = D.local_block(x_val, mesh, tuple(data_axes))
        scope = D.mesh_scope(mesh)
    # float64 narrows to float32, as the prefetcher narrows the chunks
    x_val, c0 = (t.to(dev, torch.float32 if t.dtype == torch.float64
                      else t.dtype)
                 for t in map(torch.as_tensor, (x_val, c0)))
    state = minibatch_init(c0, cfg, bk)
    mx = None if metrics is None else as_metrics(metrics)

    def sort_by():
        return state.c.cpu().numpy()

    is_iter = hasattr(source, "__next__")
    traces = []
    with scope:
        for xc in stream_chunks(
                source, None if is_iter else (chunk_size or cfg.chunk_size),
                epochs=cfg.epochs, seed=seed, drop_remainder=drop_remainder,
                prefetch=prefetch, device=dev, meter=meter,
                sort_by=sort_by if sort_chunks else None, mesh=mesh,
                data_axes=data_axes):
            refuse_bf16(where, None, xc)
            w = torch.ones((xc.shape[0],), dtype=torch.float32, device=dev)
            state, trace = minibatch_iteration(xc, w, x_val, state, cfg, bk)
            if return_trace:
                traces.append(trace)
            if mx is not None:
                e_val, accepted = torch.stack(
                    [trace.e_val,
                     trace.accepted.to(trace.e_val.dtype)]).tolist()
                mx.log_scalars(state.t, {"e_val": e_val,
                                         "accepted": accepted})
        c_fin, e_fin, _, _ = guard_pick(x_val, state, cfg, bk)
    result = MiniBatchResult(c_fin, e_fin, state.t, state.n_acc)
    if not return_trace:
        return result
    return result, stack_traces(traces) if traces else None


def _check_single(x, c0):
    if x.dim() != 2 or c0.dim() != 2:
        raise ValueError(f"x must be (N, d) and c0 (K, d); got "
                         f"{tuple(x.shape)}, {tuple(c0.shape)}")


def _unbatch(res: KMeansResult) -> KMeansResult:
    return KMeansResult(*(a[0] for a in res))


def aa_kmeans(x: torch.Tensor, c0: torch.Tensor, cfg: KMeansConfig,
              ops: Optional[LloydOps] = None,
              backend: BackendLike = None, *,
              checkpoint_every: int = 0, checkpoint_dir=None,
              resume_from=None, checkpoint_cb: Optional[Callable] = None,
              keep_last_n: int = 0, keep_every_m: int = 0, metrics=None,
              sync_writes: bool = False, reorder=False) -> KMeansResult:
    """Algorithm 1 on one problem: x (N, d), c0 (K, d).

    ``backend`` selects the engine ("dense" | "blocked" | "fused" |
    "pallas" | "hamerly" | "elkan" | "yinyang" | "fused_bounds", a
    "<name>_reorder" variant, a Backend, or a legacy LloydOps); ``ops``
    is the legacy LloydOps injection point, adapted through the shim.
    ``reorder=True`` (or a ``locality.ReorderConfig``) wraps a bound
    backend in the locality engine (``core/locality.py``): it sees rows
    sorted by label once assignments settle, the results stay in
    original row order.
    The reference decides accept or revert inside ``lax.cond``; here the
    solve is the batched driver at R = 1, which carries that decision to
    the next trip (``pending``), so it costs one sync per trip and gives
    the same bits as ``aa_kmeans_batched(x, c0[None], ...)``.  The loop
    is ``segmented.aa_kmeans_segmented``.

    Persistence: ``checkpoint_every=s`` cuts the solve every s
    iterations and snapshots the loop state at each boundary, into
    ``checkpoint_dir`` (one ``it_<t>.npz`` artifact per boundary in the
    reference's format, a ``manifest.json``, ``keep_last_n`` /
    ``keep_every_m`` retention) and to ``checkpoint_cb(state, t)``.
    ``resume_from`` (an artifact's path, e.g.
    ``checkpoint.latest_snapshot(dir)``, or a tree the callback got)
    continues a solve; the resumed run equals the uninterrupted one bit
    for bit, because boundaries only cut the same sequence of trips.  The
    snapshot is a copy of the state to the host taken at the boundary;
    a background ``runtime.writer.CheckpointWriter`` writes the file
    (``sync_writes=True`` writes it in line).  ``metrics`` (a
    ``runtime.metrics`` sink) gets ``energy``, ``n_accepted``,
    ``converged``, ``segment_s``, the bound engines' fractions and, when
    a snapshot was written, ``snapshot_s`` per boundary, and the writer's
    ``checkpoint_write_s``."""
    from repro_torch.core.segmented import aa_kmeans_segmented
    _check_single(x, c0)
    return aa_kmeans_segmented(
        x, c0, cfg, maybe_reorder(resolve_backend(backend, ops), reorder),
        checkpoint_every, checkpoint_dir, resume_from, checkpoint_cb,
        keep_last_n, keep_every_m, metrics, sync_writes)


# -- the snapshot trees of the segmented drivers (core/segmented.py) ---------

def _meta_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def batched_state_like(x, c0s, cfg: KMeansConfig,
                       backend: BackendLike = None) -> _BatchedState:
    """``_BatchedState``'s structure, shapes and dtypes for this problem
    and engine, on the meta device: the restore target of a batched
    snapshot.  It is the init's own assembly over the engine's initial
    carry, so the snapshot's layout cannot drift from the code."""
    bk = resolve_backend(backend)
    xm, cm = _meta_like(x), _meta_like(c0s)
    r, n = c0s.shape[0], x.shape[-2]
    labels = torch.empty((r, n), dtype=torch.int32, device="meta")
    # energies are in the engine's accumulation dtype, bf16 X or not
    energy = torch.empty((r,), dtype=bk.precision.accum_dtype,
                         device="meta")
    return _assemble_state(xm, cm, cm, labels, energy,
                           bk.batched_init_carry(xm, cm, cfg.k), cfg)


def loop_state_like(x, c0, cfg: KMeansConfig,
                    backend: BackendLike = None) -> _LoopState:
    """The single-problem snapshot's layout (the reference's unbatched
    ``_LoopState``): ``batched_state_like`` at R = 1 with the R axis
    dropped from every leaf."""
    return _tree_index(batched_state_like(x, c0[None], cfg, backend).inner,
                       0)


def minibatch_stream_like(c0, cfg: MiniBatchConfig,
                          backend: BackendLike = None) -> dict:
    """The streaming snapshot's layout: ``{"state"}``, the
    ``MiniBatchState`` in the reference's layout
    (``minibatch.reference_layout``), and ``{"key"}``, two uint32 words
    (the reference's jax key; the port keeps its chunk order's seed
    there)."""
    state = minibatch_init(_meta_like(c0), cfg, resolve_backend(backend))
    return {"state": reference_layout(state),
            "key": torch.empty((2,), dtype=torch.uint32, device="meta")}


def _backend_base(name: str) -> str:
    """The engine's name without a mesh layout's "@axes" suffix, which
    must not block a restore onto another layout."""
    return name.split("@")[0]


def _check_resume_meta(meta: dict, cfg, backend: Backend, what: str):
    """Refuse a snapshot taken at another ``k`` or on another engine (a
    "+reorder" snapshot on the raw engine included): its carry, and on
    some engines the reduction order, differ, so the resumed trajectory
    would not be the one the snapshot came from."""
    if meta.get("k") is not None and meta["k"] != cfg.k:
        raise ValueError(f"{what}: snapshot was taken at k={meta['k']}, "
                         f"resuming with k={cfg.k}")
    snap_bk = meta.get("backend")
    if snap_bk and _backend_base(snap_bk) != _backend_base(backend.name):
        raise ValueError(
            f"{what}: snapshot was taken on backend {snap_bk!r} but the "
            f"resume uses {backend.name!r}; the per-backend carry (and on "
            f"some backends the reduction order) differs, so the resumed "
            f"trajectory would not match -- resume on the same engine")


def _snapshot_meta(step: int, cfg, backend: Backend,
                   extra: Optional[dict] = None) -> dict:
    return {"t": step, "k": cfg.k, "backend": backend.name,
            **(extra or {})}


def _bound_scalars(carry) -> dict:
    """{"eliminated_frac", "skipped_frac"} of a carry's BoundStats (of
    problem 0 in a batched carry), or {} for a stateless backend."""
    bs = extract_stats(carry)
    if bs is None:
        return {}
    elim, skip = torch.stack([bs.eliminated_frac.reshape(-1)[0],
                              bs.skipped_frac.reshape(-1)[0]]).tolist()
    return {"eliminated_frac": elim, "skipped_frac": skip}


class KMeansTrace(NamedTuple):
    result: KMeansResult
    energies: list          # E^t per iteration (post-revert)
    m_values: list          # m after adjustment, per iteration
    accepted: list          # bool per iteration
    wall_time_s: float
    mse: float              # final E / N — the paper's reported MSE
    # per-iteration {"eliminated_frac", "skipped_frac"} of bound backends
    # (hamerly, elkan, yinyang, fused_bounds, and their reorder
    # wrappers), read off the carry's BoundStats; () otherwise
    bound_stats: tuple = ()
    # bound_stats split at the first accepted iteration
    # (split_bound_phases); None without bound stats
    bound_phases: Optional[dict] = None


def split_bound_phases(accepted, bound_stats):
    """Split per-iteration bound stats at the first accepted iteration:
    the early iterations run on slack bounds, so their fractions sit near
    0 whatever the engine, and averaging them into the converged tail
    dilutes every reported fraction.

    Returns {} without bound stats; otherwise "pre_accept" /
    "post_accept" entries of {n_iters, <mean of each stat key>}, an empty
    phase reporting n_iters = 0 and None means."""
    bound_stats = list(bound_stats)
    if not bound_stats:
        return {}
    accepted = list(accepted)[:len(bound_stats)]
    first = next((i for i, a in enumerate(accepted) if a), len(bound_stats))
    keys = sorted(bound_stats[0])

    def phase(rows):
        out = {"n_iters": len(rows)}
        for key in keys:
            out[key] = (sum(r[key] for r in rows) / len(rows)) if rows \
                else None
        return out

    return {"pre_accept": phase(bound_stats[:first]),
            "post_accept": phase(bound_stats[first:])}


def _sync(x: torch.Tensor) -> None:
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


def _trip_scalars(st: _LoopState) -> list:
    """(t, converged, n_acc, m, e_last) of problem 0, read in one
    device-to-host copy."""
    return torch.stack([v[0].to(torch.float64) for v in (
        st.t, st.converged, st.n_acc, st.aa.m, st.e_last)]).tolist()


def aa_kmeans_traced(x: torch.Tensor, c0: torch.Tensor, cfg: KMeansConfig,
                     ops: Optional[LloydOps] = None,
                     backend: BackendLike = None,
                     warmup: bool = False, metrics=None,
                     reorder=False) -> KMeansTrace:
    """Algorithm 1 on one problem, recording the statistics of Tables 2
    and 3: per completed iteration its energy, window size and accept
    decision, read in one copy per trip of the same loop ``aa_kmeans``
    runs, so the trajectory is its own; a bound backend's stats take a
    second copy per iteration.

    ``warmup=True`` runs the init step and one trip first, so the first
    launch's kernel build is not timed.  ``wall_time_s`` ends in
    ``torch.cuda.synchronize()`` on CUDA.  The headline times of the
    tables come from untraced runs; these reads are stats.  ``reorder=``
    enables the locality engine as in ``aa_kmeans``.  ``metrics`` (a
    ``runtime.metrics`` sink) gets each iteration's ``energy``, ``m``,
    ``accepted`` and bound fractions, the values the trace collects."""
    _check_single(x, c0)
    bk = maybe_reorder(resolve_backend(backend, ops), reorder)
    mx = as_metrics(metrics)
    c0s = c0[None]
    if warmup:
        batched_trip(x, _init_state(x, c0s, cfg, bk), cfg, bk)
        _sync(x)
    t0 = time.perf_counter()
    bst = _init_state(x, c0s, cfg, bk)
    energies, m_vals, acc, bstats = [], [], [], []
    t_done, n_acc = 0, 0
    while True:
        vals = _trip_scalars(bst.inner)
        t, converged = int(vals[0]), bool(vals[1])
        if t > t_done and not converged:
            # an iteration completed on the last trip
            energies.append(vals[4])
            m_vals.append(int(vals[3]))
            acc.append(int(vals[2]) > n_acc)
            scalars = _bound_scalars(bst.inner.carry)
            if scalars:
                bstats.append(scalars)
            mx.log_scalars(len(energies), {
                "energy": energies[-1], "m": float(m_vals[-1]),
                "accepted": float(acc[-1]), **scalars})
        t_done, n_acc = t, int(vals[2])
        if converged or t >= cfg.max_iter:
            break
        bst = batched_trip(x, bst, cfg, bk)
    _sync(x)
    wall = time.perf_counter() - t0
    result = _unbatch(_result_from_state(bst.inner))
    mse = float(result.energy) / x.shape[0]
    return KMeansTrace(result, energies, m_vals, acc, wall, mse,
                       tuple(bstats), split_bound_phases(acc, bstats))
