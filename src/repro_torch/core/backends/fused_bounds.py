"""The tile-skipping fused engine, "fused_bounds" (counterpart of
``repro.core.backends.pallas.fused_bounds_backend``, lines 205-273).

The fused step carrying the bound contract of ``backends/bounds.py``.
Before each step the carry's bounds follow the centroids' drift since
the last step (valid across Lloyd updates, accepted Anderson jumps and
reverts alike) and go to the kernel squared: lb^2 = max(lower, 0)^2 per
(row, group), ub^2 = upper^2 per row.  The kernel
(``kernels/fused_lloyd.py`` with ``bounds=``) skips every (row tile,
group) cell where no row of the tile can improve, and hands back the
step with the squared group minima, from which the next carry follows:
upper = sqrt(min distance), lower = sqrt(group min), c_last = C.
``assign`` is the assignment kernel and ``stats_fn`` the update kernel.
Under a ``Precision`` policy X and C are cast to the compute dtype for the
kernel; the bound algebra and the carry's c_last stay f32, on the cast C
(``repro/core/backends/pallas.py:240-243``).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.backends import bounds
from repro_torch.core.backends.base import (DEFAULT_PRECISION, Backend,
                                            Precision, StepResult)
from repro_torch.core.backends.bounds import BoundStats
from repro_torch.core.backends.fused import kernel_assign
from repro_torch.kernels.fused_lloyd import fused_lloyd
from repro_torch.kernels.update import update


def engine_group_size(k: int, group_size: Optional[int] = None) -> int:
    """Centroids per group of ``fused_bounds_backend(group_size=)`` at
    K = k: the reference's "tile" policy, rounded up to GROUP_ROUND."""
    return bounds.round_up(bounds.resolve_group_size(k, group_size),
                           bounds.GROUP_ROUND)


def squared_bounds(carry, c, k: int, gs: int):
    """The kernel's bounds for a step at centroids c: the carry's bounds
    moved by each centroid's drift since c_last, then squared (lb^2 =
    max(lower, 0)^2, ub^2 = upper^2).  -> (lab0, lb_sq, ub_sq)."""
    labels0, upper, lower, c_last, _ = carry
    g, gs = bounds.group_layout(k, gs)
    upper, lower = bounds.drift_update(
        labels0, upper, lower, bounds.centroid_drift(c, c_last), g, gs)
    return (labels0, torch.square(torch.clamp_min(lower, 0.0)),
            torch.square(upper))


def fused_bounds_backend(precision: Precision = DEFAULT_PRECISION,
                         group_size: Optional[int] = None) -> Backend:
    """The fused kernel consuming group lower bounds to skip centroid
    groups.  Groups follow the reference's "tile" policy (one group for
    K <= 512, so the default skips little); an explicit ``group_size`` is
    rounded up to ``bounds.GROUP_ROUND`` as the reference rounds it to
    its f32 sublane, so both packages keep the same G."""

    def gs_of(k):
        return engine_group_size(k, group_size)

    def init_carry_fn(x, c, k):
        return bounds.init_carry(x, c, k, gs_of(k))

    def run(x, c, k, carry, w=None):
        gs = gs_of(k)
        cc = precision.compute_cast(c)
        cf = cc.to(torch.float32)
        labels, mind, sums, counts, energy, gmin_sq, skipped = fused_lloyd(
            precision.compute_cast(x), cc, w,
            bounds=squared_bounds(carry, cf, k, gs), gs=gs)
        carry = (labels, torch.sqrt(mind), torch.sqrt(gmin_sq), cf,
                 BoundStats(skipped, skipped))
        return StepResult(labels, mind, sums, counts, energy), carry

    def step_fn(x, c, k, carry):
        return run(x, c, k, carry)

    def batched_step_fn(x, cs, k, carries, w=None):
        return run(x, cs, k, carries, w)

    def minibatch_step_fn(x, c, k, w, carry):
        return run(x, c, k, carry, w)

    return Backend(name="fused_bounds",
                   step_fn=step_fn,
                   batched_step_fn=batched_step_fn,
                   minibatch_step_fn=minibatch_step_fn,
                   stats_fn=update,
                   assign_fn=kernel_assign,
                   init_carry_fn=init_carry_fn,
                   precision=precision)
