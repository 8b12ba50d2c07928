"""Hamerly-bound engine, "hamerly" (counterpart of
``repro.core.backends.hamerly``, lines 48-125): the paper's CPU
assignment strategy as a Backend.

The carry is the contract of ``backends/bounds.py`` with ``lower`` (N,):
one bound on the SECOND-closest centroid (exclusive of the assigned one)
instead of the group family's (N, G) inclusive bounds.  Drift
maintenance needs only the per-centroid move between consecutive steps,
so it holds across Lloyd updates, accepted Anderson jumps and reverts:

    u_i += |c_new[a_i] - c_old[a_i]|,   l_i -= max_j |c_new[j] - c_old[j]|

The exact distance to the assigned centroid is recomputed every step, so
min_sqdist and the energy the accept test reads are exact.  As in the
reference this is masked dense code: the full scan is computed for every
row and applied where the bounds cannot settle the row.  A ``Precision``
policy rounds X and C to its compute dtype before the f32 bound
arithmetic; the stats come from the original X in f32.
"""

from __future__ import annotations

import torch

from repro_torch.core import lloyd
from repro_torch.core.backends.base import (DEFAULT_PRECISION, Backend,
                                            Precision, StepResult)
from repro_torch.core.backends.bounds import (BoundStats, centroid_drift,
                                              cpu_engine_stats)
from repro_torch.core.lloyd import pairwise_sqdist


def _full_scan(x, c):
    """(label, closest distance, second-closest distance) per row by two
    masked minima, the first index winning ties as in argmin.  The minima
    are taken over the squared distances, as ``lloyd.assign`` takes them,
    and rooted after: the reference roots first, and sqrt maps two
    squared distances an ulp apart to one value, where the first index
    then wins over the nearer centroid."""
    sq = pairwise_sqdist(x, c)
    d1, lab = torch.min(sq, dim=1)
    others = sq.masked_fill(
        torch.arange(c.shape[0], device=x.device)[None, :] == lab[:, None],
        float("inf"))
    return (lab.to(torch.int32), torch.sqrt(d1),
            torch.sqrt(torch.amin(others, dim=1)))


def hamerly_drift(labels, upper, lower, c_new, c_old):
    """The bounds after a centroid move: u += |dc_a|, l -= max |dc|."""
    drift = centroid_drift(c_new, c_old)
    return upper + drift[labels.long()], lower - torch.amax(drift)


def hamerly_backend(precision: Precision = DEFAULT_PRECISION) -> Backend:
    def init_carry_fn(x, c, k):
        n = x.shape[0]
        # upper = +inf forces a full scan on the first step
        return (torch.zeros((n,), dtype=torch.int32, device=x.device),
                torch.full((n,), float("inf"), device=x.device),
                torch.zeros((n,), device=x.device), c.to(torch.float32),
                BoundStats.zeros(device=x.device))

    def step_fn(x, c, k, carry):
        labels0, upper, lower, c_last, _ = carry
        # the policy rounds X and C to the compute dtype; the bound
        # arithmetic then runs in f32, since the bounds must stay monotone
        # under the drift updates (repro/core/backends/hamerly.py:88-94)
        xf = precision.compute_cast(x).to(torch.float32)
        cf = precision.compute_cast(c).to(torch.float32)
        upper, lower = hamerly_drift(labels0, upper, lower, cf, c_last)
        cc = torch.sqrt(pairwise_sqdist(cf, cf)).masked_fill(
            torch.eye(k, dtype=torch.bool, device=cf.device), float("inf"))
        s_half = 0.5 * torch.amin(cc, dim=1)                      # (K,)
        lab0 = labels0.long()
        d_assigned = torch.sqrt(torch.sum((xf - cf[lab0]) ** 2, dim=-1))
        needs = d_assigned > torch.maximum(s_half[lab0], lower)
        lab_f, u_f, l_f = _full_scan(xf, cf)
        labels = torch.where(needs, lab_f, labels0)
        upper_n = torch.where(needs, u_f, d_assigned)
        lower_n = torch.where(needs, l_f, lower)
        elim = 1.0 - torch.mean(needs.to(torch.float32))
        stats = BoundStats(elim, elim)      # one group: a row is the unit
        mind = upper_n * upper_n
        sums, counts = cpu_engine_stats(x, labels, k)
        res = StepResult(labels, mind, sums, counts, torch.sum(mind))
        return res, (labels, upper_n, lower_n, cf, stats)

    return Backend(name="hamerly", step_fn=step_fn,
                   stats_fn=cpu_engine_stats, assign_fn=lloyd.assign,
                   init_carry_fn=init_carry_fn, precision=precision)
