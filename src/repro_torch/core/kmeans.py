"""Algorithm 1 of the paper, batched over R restarts or problems
(counterpart of ``repro.core.kmeans``: ``_init_state`` :131,
``_complete_batched_iteration`` :519, ``_batched_body`` :579, the
non-segmented ``aa_kmeans_batched`` :666-756, ``select_best`` :831).

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
from typing import Any, NamedTuple, Optional, Union

import torch

from repro_torch.core import anderson
from repro_torch.core.anderson import AAConfig, AAState
from repro_torch.core.backends import Backend, get_backend


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


BackendLike = Union[str, Backend, None]


def resolve_backend(backend: BackendLike) -> Backend:
    """A Backend passes through, a registry name is looked up, None is
    the dense engine."""
    if isinstance(backend, Backend):
        return backend
    if isinstance(backend, str):
        return get_backend(backend)
    if backend is None:
        return get_backend("dense")
    raise TypeError(f"backend= expects a registry name or a Backend; got "
                    f"{type(backend).__name__}")


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
    carry = backend.init_carry(x, c0s, k)
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
