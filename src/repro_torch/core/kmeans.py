"""Algorithm 1 of the paper (counterpart of ``repro.core.kmeans``:
``_init_state`` :131, ``aa_kmeans`` :415, ``_complete_batched_iteration``
:519, ``_batched_body`` :579, the non-segmented ``aa_kmeans_batched``
:666-756, ``select_best`` :831, ``KMeansTrace`` / ``split_bound_phases``
/ ``aa_kmeans_traced`` :1126-1245).

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
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, NamedTuple, Optional, Union

import torch

from repro_torch.core import anderson
from repro_torch.core.anderson import AAConfig, AAState
from repro_torch.core.backends import Backend, get_backend
from repro_torch.core.backends.base import from_lloyd_ops
from repro_torch.core.backends.bounds import extract_stats
from repro_torch.core.lloyd import DENSE_OPS, LloydOps


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
    k, r = cfg.k, c0s.shape[0]
    carry = backend.batched_init_carry(x, c0s, k)
    res0, carry = backend.batched_step(x, c0s, k, carry, w=w)
    c1 = backend.centroids_from_step(x, res0, k, c0s)
    aa = anderson.aa_init(r, k * x.shape[-1], cfg.aa, x.dtype, x.device)
    aa = anderson.aa_seed(aa, (c1 - c0s).reshape(r, -1), c1.reshape(r, -1))
    inf = torch.full((r,), float("inf"), dtype=res0.energy.dtype,
                     device=x.device)
    zeros = torch.zeros((r,), dtype=torch.int32, device=x.device)
    false = torch.zeros((r,), dtype=torch.bool, device=x.device)
    inner = _LoopState(
        c=c1, c_au=c1, p_prev=res0.labels, e_prev=inf, e_prev2=inf, aa=aa,
        t=zeros, n_acc=zeros, converged=false, labels=res0.labels,
        e_last=res0.energy, carry=carry)
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
                      weights: Optional[torch.Tensor] = None
                      ) -> KMeansResult:
    """Batched Algorithm 1: R independent solves driven together.

    ``c0s`` (R, K, d) — one seed set per restart; ``x`` (N, d) shared by
    every restart or (R, N, d) one dataset per problem.  ``weights``
    (R, N) >= 0 scales each row's contribution to its problem's stats and
    energy (w = 0 rows vanish, also from the convergence check).  A
    restart that converges (or reaches max_iter) keeps its frozen state
    while the others continue, so its trajectory is the sequential one.
    Returns a ``KMeansResult`` with a leading R axis on every leaf; use
    ``select_best`` for the winner.
    """
    _check_inputs(x, c0s, weights)
    bk = resolve_backend(backend)
    bst = _init_state(x, c0s, cfg, bk, w=weights)
    while bool(torch.any(_is_active(bst.inner, cfg.max_iter))):
        bst = batched_trip(x, bst, cfg, bk, w=weights)
    return _result_from_state(bst.inner)


def select_best(results: KMeansResult) -> KMeansResult:
    """The restart with the lowest final energy, unbatched; ties go to
    the lower index.  A non-finite energy never wins; if every restart is
    non-finite, restart 0 comes back with its NaN energy so the caller
    sees the failure."""
    e = results.energy
    masked = torch.where(torch.isfinite(e), e, float("inf"))
    best = torch.argmin(masked)
    return KMeansResult(*(a[best] for a in results))


def _check_single(x, c0):
    if x.dim() != 2 or c0.dim() != 2:
        raise ValueError(f"x must be (N, d) and c0 (K, d); got "
                         f"{tuple(x.shape)}, {tuple(c0.shape)}")


def _unbatch(res: KMeansResult) -> KMeansResult:
    return KMeansResult(*(a[0] for a in res))


def aa_kmeans(x: torch.Tensor, c0: torch.Tensor, cfg: KMeansConfig,
              ops: Optional[LloydOps] = None,
              backend: BackendLike = None) -> KMeansResult:
    """Algorithm 1 on one problem: x (N, d), c0 (K, d).

    ``backend`` selects the engine ("dense" | "blocked" | "fused" |
    "pallas" | "fused_bounds", a Backend, or a legacy LloydOps); ``ops``
    is the legacy LloydOps injection point, adapted through the shim.
    The reference decides accept or revert inside ``lax.cond``; here the
    solve is the batched driver at R = 1, which carries that decision to
    the next trip (``pending``), so it costs one sync per trip and gives
    the same bits as ``aa_kmeans_batched(x, c0[None], ...)``.  The
    checkpoint, metrics and reorder keywords of the reference are not
    ported yet."""
    _check_single(x, c0)
    return _unbatch(aa_kmeans_batched(x, c0[None], cfg,
                                      resolve_backend(backend, ops)))


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
    # (fused_bounds), read off the carry's BoundStats; () otherwise
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
                     warmup: bool = False) -> KMeansTrace:
    """Algorithm 1 on one problem, recording the statistics of Tables 2
    and 3: per completed iteration its energy, window size and accept
    decision, read in one copy per trip of the same loop ``aa_kmeans``
    runs, so the trajectory is its own; a bound backend's stats take a
    second copy per iteration.

    ``warmup=True`` runs the init step and one trip first, so the first
    launch's kernel build is not timed.  ``wall_time_s`` ends in
    ``torch.cuda.synchronize()`` on CUDA.  The headline times of the
    tables come from untraced runs; these reads are stats."""
    _check_single(x, c0)
    bk = resolve_backend(backend, ops)
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
