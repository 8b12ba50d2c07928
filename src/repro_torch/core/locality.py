"""Cluster-sorted row reordering, the locality engine (counterpart of
``repro.core.locality``).

Tile-granular work elimination (the ``fused_bounds`` kernel's skip test,
the elkan/yinyang group bounds) pays only when neighbouring rows share
owners.  The wrapper sorts rows by their current label once assignments
settle, runs the bound engine on the permuted rows and inverts the
permutation on the way out, so the caller sees original-order results.

The permutation lives in the backend carry:

    carry = (perm, inv, labels_sort, t, n_sorts, inner_carry)

    perm        (N,) i32  sorted slot j holds original row perm[j]
    inv         (N,) i32  original row i sits at sorted slot inv[i]
    labels_sort (N,) i32  original-order labels at the last sort (zeros
                          before the first, so the first eligible step
                          sorts)
    t           ()   i32  steps taken (the warm-up gate)
    n_sorts     ()   i32  sorts performed
    inner_carry           the wrapped engine's bound carry
                          (``backends/bounds.py``), rows in sorted order

each with a leading R axis in the batched driver, t and n_sorts (R,).

Exactness: every per-row quantity of the bound engines (labels, bounds,
min_sqdist) depends on its own row only, so permuting the rows permutes
those outputs.  The wrapper gathers labels and min_sqdist back to
original order and recomputes the sums and counts there with the inner
engine's ``stats_fn`` (for hamerly, elkan and yinyang their step's own
``lloyd.cluster_sums``, so a wrapped solve equals the raw one on every
leaf; for ``fused_bounds`` the update kernel), and the energy as
``torch.sum`` of the original-order min_sqdist.  The reference recomputes
the stats with ``lloyd.cluster_sums`` for every engine; on the card that
dense one-hot sum is about 30 times the update kernel's time at K = 1000
(NVIDIA H100 80GB HBM3, 700 W).

The sort is a stable sort by label, which is unique, so ``torch.sort(...,
stable=True)`` gives the reference's counting sort's ``perm`` and ``inv``
(its one-hot rank pass would take K sequential launches at full size).
The re-sort decision stays on the device: the re-sort is computed every
step for every restart and taken per restart with ``torch.where`` (the
reference's ``lax.cond`` under ``vmap``), so the driver's one host sync
per trip stays the only one.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.core.backends.base import (Backend, StepResult,
                                            _tree_index, _tree_stack)


@dataclasses.dataclass(frozen=True)
class ReorderConfig:
    """Churn-triggered re-sort policy.

    warmup          — steps before the first sort may fire (the early
                      steps churn heavily; the default skips the init
                      step and one full scan).
    churn_threshold — re-sort when the share of rows whose label changed
                      since the LAST sort exceeds this.  0 re-sorts on
                      any change; >= 1 never re-sorts.
    sort_tile       — the reference's label-tile width of its rank pass;
                      accepted so both take the same options, unused by a
                      stable sort.
    """
    warmup: int = 2
    churn_threshold: float = 0.15
    sort_tile: Optional[int] = None


DEFAULT_REORDER = ReorderConfig()


# ---------------------------------------------------------------------------
# Stable sort by label
# ---------------------------------------------------------------------------


def _stable_order(labels: torch.Tensor):
    """(sorted labels, perm int64, inv int64) of a stable sort along the
    last axis."""
    srt, perm = torch.sort(labels, dim=-1, stable=True)
    ar = torch.arange(labels.shape[-1], device=labels.device)
    inv = torch.empty_like(perm).scatter_(-1, perm, ar.expand_as(perm))
    return srt, perm, inv


def counting_sort_perm(labels: torch.Tensor, k: int, *, sort_tile=None):
    """Rows sorted by label, stably; -> (perm, inv) int32: sorted slot j
    holds original row perm[j], original row i lands at slot inv[i].
    Equal to ``np.argsort(labels, kind="stable")``.  ``labels`` (N,) or
    (R, N) (one sort per row); ``k`` and ``sort_tile`` keep the
    reference's signature and have no effect."""
    _, perm, inv = _stable_order(labels)
    return perm.to(torch.int32), inv.to(torch.int32)


def label_ranks(labels: torch.Tensor, k: int, *,
                sort_tile=None) -> torch.Tensor:
    """Within-label stable ranks: rank[i] = #{j < i : labels[j] ==
    labels[i]} (int32): a row's sorted slot less the first slot of its
    label.  ``k`` and ``sort_tile`` keep the reference's signature and
    have no effect."""
    srt, _, inv = _stable_order(labels)
    first = torch.searchsorted(srt, labels, side="left")
    return (inv - first).to(torch.int32)


def counting_sort_perm_segmented(labels: torch.Tensor, k: int,
                                 offsets: torch.Tensor, out_size: int, *,
                                 sort_tile=None):
    """Stable sort by label into caller-given segments: label-l rows go to
    consecutive slots from ``offsets[l]`` in an output of ``out_size``
    slots.  -> (perm, inv, counts):

        perm   (out_size,) i32 — slot j holds original row perm[j], or the
               sentinel N for an unfilled slot;
        inv    (N,) i32 — original row i lands at slot inv[i];
        counts (k,) i32 — rows per label.

    The caller guarantees each segment's room; a row whose slot falls at
    or past ``out_size`` is dropped from ``perm``, as the reference's
    out-of-bounds scatter drops it.  ``sort_tile`` keeps the reference's
    signature and has no effect."""
    n = labels.shape[0]
    lab = labels.long()
    counts = torch.bincount(lab, minlength=k).to(torch.int32)
    inv = offsets.to(torch.int32)[lab] + label_ranks(labels, k)
    keep = inv < out_size
    perm = torch.full((out_size,), n, dtype=torch.int32,
                      device=labels.device)
    perm[inv[keep].long()] = torch.arange(
        n, dtype=torch.int32, device=labels.device)[keep]
    return perm, inv, counts


def churn_frac(labels_new: torch.Tensor,
               labels_ref: torch.Tensor) -> torch.Tensor:
    """Share of rows whose label differs between two assignments (along
    the last axis)."""
    return torch.mean((labels_new != labels_ref).to(torch.float32), dim=-1)


def _gather_rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a's rows reordered by idx along the row axis: idx (N,) or (R, N)
    over a leaf of the same leading shape, (N,) / (R, N) or with a
    trailing axis, (N, G) / (R, N, G).  Row j of the result is row
    idx[j] of a."""
    idx = idx.long()
    extra = a.dim() - idx.dim()
    if extra:
        idx = idx.reshape(idx.shape + (1,) * extra).expand(
            *idx.shape, *a.shape[idx.dim():])
    return torch.gather(a, idx.dim() - 1 - extra, idx)


def permute_bound_carry(carry, idx: torch.Tensor):
    """Re-gather the per-row leaves of a ``bounds.py`` carry by ``idx``:
    idx[j] is the OLD slot whose state lands at new slot j.  c_last and
    the BoundStats hold no rows and pass through."""
    labels, upper, lower, c_last, stats = carry
    return (_gather_rows(labels, idx), _gather_rows(upper, idx),
            _gather_rows(lower, idx), c_last, stats)


# ---------------------------------------------------------------------------
# Reorder carry accessors
# ---------------------------------------------------------------------------


def permutation(carry) -> torch.Tensor:
    return carry[0]


def sort_count(carry) -> torch.Tensor:
    return carry[4]


def inner_carry(carry):
    return carry[5]


# ---------------------------------------------------------------------------
# The wrapper backend
# ---------------------------------------------------------------------------


def resort(carry, k: int, config: ReorderConfig = DEFAULT_REORDER):
    """A batched reorder carry (leading R axis) after one step's sort
    decision: where a restart is past the warm-up and its labels churned
    more than the threshold since its last sort, its rows are sorted by
    their current labels and its inner carry re-gathered to match.  The
    sort is computed for every restart and taken per restart, with no
    host sync."""
    perm, inv, labels_sort, t, n_sorts, ic = carry
    labels_prev = _gather_rows(ic[0], inv)              # original order
    do_sort = (t >= int(config.warmup)) & (churn_frac(
        labels_prev, labels_sort) > float(config.churn_threshold))
    perm_new, inv_new = counting_sort_perm(labels_prev, k)
    # new slot j holds original row perm_new[j], whose carry state sits at
    # old slot inv[perm_new[j]]; a restart that does not sort keeps its
    # order (the identity)
    sel = do_sort[:, None]
    idx = torch.where(sel, _gather_rows(inv, perm_new),
                      torch.arange(perm.shape[-1], dtype=torch.int32,
                                   device=perm.device))
    return (torch.where(sel, perm_new, perm), torch.where(sel, inv_new, inv),
            torch.where(sel, labels_prev, labels_sort), t,
            n_sorts + do_sort.to(torch.int32), permute_bound_carry(ic, idx))


def sorted_rows(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """X gathered into sorted order per restart: perm (R, N) over x
    (N, d) shared or (R, N, d) per problem -> (R, N, d)."""
    perm = perm.long()
    return _gather_rows(x, perm) if x.dim() == 3 else x[perm]


def _require_bound_carry(carry, n: int, lead=()) -> None:
    rows = tuple(lead) + (n,)
    ok = isinstance(carry, tuple) and len(carry) == 5 and all(
        isinstance(carry[i], torch.Tensor)
        and tuple(carry[i].shape[:len(rows)]) == rows for i in range(3))
    if not ok:
        raise TypeError(
            "reorder_backend wraps bound-carrying backends only: the inner "
            "carry must be the (labels, upper, lower, c_last, stats) "
            "contract of backends/bounds.py with per-row leaves "
            f"(got {type(carry).__name__})")


@functools.lru_cache(maxsize=None)
def reorder_backend(inner: Backend,
                    config: ReorderConfig = DEFAULT_REORDER) -> Backend:
    """Wrap a bound-carrying backend with churn-triggered row reordering:
    the same step contract and original-order outputs, the inner engine
    seeing rows sorted by label.  Cached per (inner, config), so the
    registry and the drivers get one instance per option set.

    Compose it INSIDE ``distribute``, ``distribute(reorder_backend(b),
    axes)``, so the sort stays shard-local and the wrapper's shard-local
    stats are the ones reduced; a distributed inner engine is refused.
    The wrapper carries the inner engine's ``Precision`` (the inner step
    casts the gathered rows; the gather works in X's own dtype), and its
    stats come from the original-order X through the inner ``stats_fn``,
    which does not cast (``repro/core/locality.py:250``, ``:339``)."""
    if inner.axes:
        raise ValueError(
            f"{inner.name} is already distributed; wrap the local backend "
            "first — distribute(reorder_backend(b), axes) — so the "
            "permutation stays shard-local")

    def init_carry_fn(x, c, k):
        lead = tuple(c.shape[:-2])
        n = x.shape[-2]
        ic = inner.batched_init_carry(x, c, k) if lead \
            else inner.init_carry(x, c, k)
        _require_bound_carry(ic, n, lead)
        ar = torch.arange(n, dtype=torch.int32, device=x.device).expand(
            lead + (n,)).contiguous()
        zero = torch.zeros(lead, dtype=torch.int32, device=x.device)
        return (ar, ar.clone(), torch.zeros_like(ar), zero, zero.clone(),
                ic)

    def _post(x, k, carry, res_p, ic_new):
        """Back to original order: labels and min_sqdist gathered, the
        stats and energy recomputed there per restart (the inner engine's
        ``stats_fn``; the energy summed as the CPU engines sum theirs)."""
        perm, inv, labels_sort, t, n_sorts, _ = carry
        labels = _gather_rows(res_p.labels, inv)
        mind = _gather_rows(res_p.min_sqdist, inv)
        outs = [inner.stats_fn(x[i] if x.dim() == 3 else x, labels[i], k)
                for i in range(labels.shape[0])]
        res = StepResult(labels, mind, torch.stack([o[0] for o in outs]),
                         torch.stack([o[1] for o in outs]),
                         torch.stack([torch.sum(m) for m in mind]))
        return res, (perm, inv, labels_sort, t + 1, n_sorts, ic_new)

    def batched_step_fn(x, cs, k, carries, w=None):
        if w is not None:
            raise TypeError(
                "reorder_backend has no weighted batched path: it "
                "recomputes unweighted stats in original row order; use "
                "the unwrapped backend for weighted batched solves")
        carries = resort(carries, k, config)
        res_p, ic = inner.batched_step(sorted_rows(x, carries[0]), cs, k,
                                       carries[5])
        return _post(x, k, carries, res_p, ic)

    def step_fn(x, c, k, carry):
        res, carry = batched_step_fn(x, c[None], k, _tree_stack([carry]))
        return _tree_index(res, 0), _tree_index(carry, 0)

    # no minibatch_step_fn: the generic weighted fallback (step_fn, then
    # the weighted sums of the original-order rows and labels) is exact
    return Backend(name=f"{inner.name}+reorder",
                   step_fn=step_fn,
                   batched_step_fn=batched_step_fn,
                   stats_fn=inner.stats_fn,
                   assign_fn=inner.assign_fn,
                   energy_fn=inner.energy_fn,
                   all_equal_fn=inner.all_equal_fn,
                   reduce_scalar=inner.reduce_scalar,
                   init_carry_fn=init_carry_fn,
                   finalize_fn=inner.finalize_fn,
                   precision=inner.precision)


def maybe_reorder(backend: Backend, reorder) -> Backend:
    """The drivers' switch: False leaves the backend as it is, True wraps
    it with the default policy, a ReorderConfig with that policy."""
    if not reorder:
        return backend
    cfg = reorder if isinstance(reorder, ReorderConfig) else DEFAULT_REORDER
    return reorder_backend(backend, cfg)
