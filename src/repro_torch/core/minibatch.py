"""Streaming mini-batch Anderson-accelerated K-Means (counterpart of
``repro.core.minibatch``).

Algorithm 1 over chunked data: each step reads one chunk, folds its
weighted cluster statistics into exponentially decayed running sums, and
takes the running mean as the fixed-point image G(C):

    S_t = decay * S_{t-1} + s,   W_t = decay * W_{t-1} + n,   G(C^t) = S_t / W_t

(a cluster with W = 0 keeps its centroid).  The energy guard prices the
accelerated candidate C^t and the fallback C_AU^t on one held-out
validation chunk, in ONE batched backend step over R = 2 centroid sets
(one launch of the fused kernel with a shared X), and keeps the
candidate only if it is strictly better there; the same validation
energies drive the paper's dynamic m.  The first step seeds the Anderson
window from chunk 0's stats and emits the plain mini-batch iterate.

The Anderson window is ``core/anderson.py``'s batched window at R = 1.
A step never waits for the device: the seed-or-push branch is decided
by the step count, which the state keeps on the host (``t`` is a Python
int, where the reference keeps an int32 array), and the accept test is a
``torch.where`` on the device.

The epoch driver lives in ``kmeans.aa_kmeans_minibatch``; this module
holds the per-chunk state machine that the estimator's ``partial_fit``
and the benchmarks drive one step or one epoch at a time.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import torch

from repro_torch.core import anderson
from repro_torch.core.anderson import AAConfig, AAState
from repro_torch.core.backends import Backend


@dataclasses.dataclass(frozen=True)
class MiniBatchConfig:
    k: int
    chunk_size: int = 4096     # rows per chunk (the data layer pads the tail)
    epochs: int = 5            # passes over the chunked data (fit path)
    decay: float = 0.9         # running-stat decay per chunk step
    aa: AAConfig = dataclasses.field(default_factory=AAConfig)
    accelerated: bool = True   # False -> plain mini-batch Lloyd


class MiniBatchState(NamedTuple):
    """Loop state carried across chunk steps."""
    c: torch.Tensor        # C^t — current (possibly accelerated) candidate
    c_au: torch.Tensor     # C_AU^t — fallback from the running stats
    sums: torch.Tensor     # decayed running cluster sums (K, d)
    counts: torch.Tensor   # decayed running cluster weights (K,)
    e_prev: torch.Tensor   # () validation energy of the previous kept iterate
    e_prev2: torch.Tensor  # () ... and the one before (dynamic-m ratio)
    aa: AAState            # one window: every leaf has a leading axis of 1
    t: int                 # chunk steps taken (held on the host)
    n_acc: torch.Tensor    # () int32 steps whose candidate was kept


class MiniBatchTrace(NamedTuple):
    """Per-chunk-step diagnostics (stacked by the epoch driver)."""
    e_val: torch.Tensor       # validation energy of the kept iterate
    e_cand: torch.Tensor      # ... of the accelerated candidate
    e_fallback: torch.Tensor  # ... of the running-stats fallback
    accepted: torch.Tensor    # guard decision


class MiniBatchResult(NamedTuple):
    centroids: torch.Tensor   # (K, d) — the guard-picked final iterate
    energy: torch.Tensor      # () validation-chunk energy of `centroids`
    n_steps: int              # chunk steps executed
    n_accepted: torch.Tensor  # () int32 accelerated candidates kept


def minibatch_init(c0: torch.Tensor, cfg: MiniBatchConfig,
                   backend: Backend) -> MiniBatchState:
    """The state before the first chunk, on c0's device.  The running
    statistics and energies accumulate in the engine's accumulation dtype,
    floored at f32 (a bf16 running count would freeze at 256,
    ``repro/core/minibatch.py:100-102``); the centroids and the Anderson
    window keep c0's dtype."""
    k, d = c0.shape
    acc = dict(dtype=backend.precision.accum_dtype, device=c0.device)
    inf = torch.full((), float("inf"), **acc)
    return MiniBatchState(
        c=c0, c_au=c0, sums=torch.zeros((k, d), **acc),
        counts=torch.zeros((k,), **acc), e_prev=inf, e_prev2=inf,
        aa=anderson.aa_init(1, k * d, cfg.aa, c0.dtype, c0.device),
        t=0, n_acc=torch.zeros((), dtype=torch.int32, device=c0.device))


def reference_layout(state: MiniBatchState) -> MiniBatchState:
    """The state as the reference lays it out (and persists it): one
    Anderson window with no leading axis, and the step count ``t`` as a
    () int32 tensor."""
    return state._replace(
        aa=AAState(*(leaf[0] for leaf in state.aa)),
        t=torch.tensor(state.t, dtype=torch.int32, device=state.c.device))


def from_reference_layout(state: MiniBatchState) -> MiniBatchState:
    """The inverse of ``reference_layout``: the window gains the port's
    leading axis of 1 and ``t`` becomes a host int (one read of the
    device)."""
    return state._replace(aa=AAState(*(leaf[None] for leaf in state.aa)),
                          t=int(state.t))


def _centroids_from_running(sums, counts, c_prev, eps: float = 1e-6):
    """G(C) from the decayed running stats.  Unlike
    ``lloyd.update_from_sums`` (whose max(counts, 1) divide assumes
    integer-like counts), decayed weights below 1 still divide exactly."""
    safe = torch.clamp_min(counts, eps)[:, None]
    mean = (sums / safe).to(c_prev.dtype)
    return torch.where(counts[:, None] > eps, mean, c_prev)


def guard_pick(x_val, state: MiniBatchState, cfg: MiniBatchConfig,
               backend: Backend):
    """The validation-chunk energy guard (Algorithm 1 lines 12-14,
    adapted): one batched step over R = 2 centroid sets prices the
    accelerated candidate and the fallback; the candidate is kept only if
    strictly better.  -> (kept_c, kept_energy, accepted, (e_cand,
    e_fallback)), all on the device."""
    cands = torch.stack([state.c, state.c_au])
    vres, _ = backend.batched_step(
        x_val, cands, cfg.k, backend.batched_init_carry(x_val, cands, cfg.k))
    e_c, e_au = vres.energy[0], vres.energy[1]
    accepted = e_c < e_au
    c_t = torch.where(accepted, state.c, state.c_au)
    e_t = torch.where(accepted, e_c, e_au)
    return c_t, e_t, accepted, (e_c, e_au)


def minibatch_iteration(x_chunk, w, x_val, state: MiniBatchState,
                        cfg: MiniBatchConfig, backend: Backend):
    """One chunk step of streaming Algorithm 1, as
    ``repro.core.minibatch.minibatch_iteration``: guard (accept/revert),
    m-adjustment, one weighted pass over the chunk, running-stat update,
    Anderson push and solve.  ``w`` (B,) weights the chunk's rows.
    Returns (new_state, MiniBatchTrace)."""
    k = cfg.k
    if cfg.accelerated:
        # lines 7-14: m-adjustment, then accept/revert, on val energies
        c_t, e_t, accepted, (e_c, e_au) = guard_pick(x_val, state, cfg,
                                                     backend)
        aa_adj = anderson.adjust_m(state.aa, e_c.reshape(1),
                                   state.e_prev.reshape(1),
                                   state.e_prev2.reshape(1), cfg.aa)
    else:
        # plain mini-batch Lloyd: c == c_au always, so price one iterate
        vres, _ = backend.step(x_val, state.c_au, k,
                               backend.init_carry(x_val, state.c_au, k))
        c_t, e_t = state.c_au, vres.energy
        e_c = e_au = vres.energy
        accepted = torch.zeros((), dtype=torch.bool, device=e_t.device)
        aa_adj = state.aa

    # line 16, mini-batch form: one weighted pass over the chunk at the
    # kept iterate; its stats decay into the running sums.  The carry is
    # chunk-local, re-initialised because the rows are fresh.
    res, _ = backend.minibatch_step(x_chunk, c_t, k, w,
                                    backend.init_carry(x_chunk, c_t, k))
    sums = cfg.decay * state.sums + res.sums
    counts = cfg.decay * state.counts + res.counts
    c_au_next = _centroids_from_running(sums, counts, c_t)

    # lines 17-19 across chunks; the first step seeds the window.  The
    # branch is taken on the host-held step count, so no step reads the
    # device; a select over the whole window instead would copy two
    # (mbar, D) buffers and waste a solve on every chunk.
    g_flat = c_au_next.reshape(1, -1)
    f_flat = g_flat - c_t.reshape(1, -1)
    if not cfg.accelerated:
        aa_next, c_next = aa_adj, c_au_next
    elif state.t == 0:
        aa_next, c_next = anderson.aa_seed(aa_adj, f_flat, g_flat), c_au_next
    else:
        aa_next, c_next_flat, _, _ = anderson.aa_push_and_solve(
            aa_adj, f_flat, g_flat, cfg.aa)
        c_next = c_next_flat.reshape(c_t.shape)

    new_state = MiniBatchState(
        c=c_next, c_au=c_au_next, sums=sums, counts=counts,
        e_prev=e_t, e_prev2=state.e_prev, aa=aa_next, t=state.t + 1,
        n_acc=state.n_acc + accepted.to(torch.int32))
    return new_state, MiniBatchTrace(e_val=e_t, e_cand=e_c, e_fallback=e_au,
                                     accepted=accepted)


def stack_traces(traces: Sequence[MiniBatchTrace]) -> MiniBatchTrace:
    """Per-step traces stacked on a new leading axis (on the device)."""
    return MiniBatchTrace(*(torch.stack(list(v)) for v in zip(*traces)))


def run_epoch(chunks, weights, x_val, state: MiniBatchState,
              cfg: MiniBatchConfig, backend: Backend, perm):
    """One pass over every chunk in the order ``perm`` (host ints: a
    list, a numpy array or a CPU tensor — the reference draws it from a
    key inside the function).  ``chunks`` (n_chunks, B, d) and
    ``weights`` (n_chunks, B) are ``data.streaming.chunk_dataset``'s
    layout; each step takes a view of one chunk, no permuted copy of X.
    Returns (state, MiniBatchTrace with a leading n_chunks axis)."""
    order = perm.tolist() if isinstance(perm, torch.Tensor) else perm
    traces = []
    for i in order:
        i = int(i)
        state, tr = minibatch_iteration(chunks[i], weights[i], x_val, state,
                                        cfg, backend)
        traces.append(tr)
    return state, stack_traces(traces)
