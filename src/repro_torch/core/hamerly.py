"""Hamerly-bound Lloyd baseline (counterpart of ``repro.core.hamerly``):
the standalone API over the bound math of ``backends/hamerly.py``.

    hamerly_init / hamerly_step / hamerly_kmeans

``hamerly_step`` runs the backend's step on a zero-drift carry (c_last =
the current centroids: this driver drifts the bounds itself, after the
update, as Hamerly's own loop does), then updates the centroids and
drifts the bounds with ``hamerly_drift``.  Every iteration assigns as
plain Lloyd does, so ``hamerly_kmeans`` takes ``lloyd_kmeans``'s
iterations to the same labels.  The reference's ``lax.while_loop``
becomes a host loop with one device-to-host sync per iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.backends.bounds import BoundStats
from repro_torch.core.backends.hamerly import (_full_scan, hamerly_backend,
                                               hamerly_drift)
from repro_torch.core.lloyd import update_from_sums

_BACKEND = hamerly_backend()


class HamerlyState(NamedTuple):
    labels: torch.Tensor     # (N,)
    upper: torch.Tensor      # (N,) upper bound on dist(x, c_label)
    lower: torch.Tensor      # (N,) lower bound on dist(x, second closest)
    c: torch.Tensor          # (K, d)


def hamerly_init(x, c0) -> HamerlyState:
    lab, u, l2 = _full_scan(x, c0)
    return HamerlyState(lab, u, l2, c0)


def hamerly_step(x, state: HamerlyState, k: int):
    """One Lloyd iteration with Hamerly bounds; -> (new state, rows whose
    label changed, share of rows that scanned every centroid)."""
    carry = (state.labels, state.upper, state.lower,
             state.c.to(torch.float32), BoundStats.zeros(device=x.device))
    res, carry = _BACKEND.step(x, state.c, k, carry)
    labels, upper, lower, _, stats = carry
    changed = torch.sum((labels != state.labels).to(torch.int32))
    # the step's stats are lloyd.cluster_sums of these labels: reuse them
    # rather than pay the one-hot pass twice (eager code has no DCE)
    c_new = update_from_sums(res.sums, res.counts,
                             state.c.to(res.sums.dtype)).to(state.c.dtype)
    upper, lower = hamerly_drift(labels, upper, lower, c_new, state.c)
    return (HamerlyState(labels, upper, lower, c_new), changed,
            1.0 - stats.eliminated_frac)


def hamerly_kmeans(x: torch.Tensor, c0: torch.Tensor, k: int,
                   max_iter: int = 500):
    """Lloyd with Hamerly bounds, run to convergence; -> (C, labels,
    energy, n_iter, mean_scan_fraction).  The first step re-derives the
    labels of C0 (nothing changes), so convergence is "no label changed
    after a centroid update" from the second step on."""
    st = hamerly_init(x, c0)
    t, fsum = 0, torch.zeros((), device=x.device)
    while t < max_iter:
        st, changed, frac = hamerly_step(x, st, k)
        t, fsum = t + 1, fsum + frac
        if t >= 2 and int(changed) == 0:
            break
    diff = x - st.c[st.labels.long()]
    return (st.c, st.labels, torch.sum(diff * diff), t,
            fsum / max(t, 1))
