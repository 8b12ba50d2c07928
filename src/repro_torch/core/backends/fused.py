"""The single-pass kernel backend (counterpart of
``repro.core.backends.pallas.fused_backend``, lines 161-198).

Every step slot is one launch of the fused Lloyd kernel
(``kernels/fused_lloyd.py``): distances, argmin, weighted cluster stats
and energy in one pass over X, R centroid sets per launch for the batched
slot.  ``assign`` (predict) is the assignment kernel
(``kernels/assignment.py``) and ``stats_fn`` the update kernel
(``kernels/update.py``).  On CPU tensors they run their plain versions,
which is how the tests run this backend.
"""

from __future__ import annotations

from repro_torch.core.backends.base import (DEFAULT_PRECISION, Backend,
                                            Precision, StepResult)
from repro_torch.core.lloyd import AssignResult
from repro_torch.kernels.assignment import assignment
from repro_torch.kernels.fused_lloyd import fused_lloyd
from repro_torch.kernels.update import update


def kernel_assign(x, c):
    """Backend.assign of every kernel engine: the assignment kernel."""
    return AssignResult(*assignment(x, c))


def _step_fn(x, c, k, carry):
    return StepResult(*fused_lloyd(x, c)), carry


def _batched_step_fn(x, cs, k, carries, w=None):
    return StepResult(*fused_lloyd(x, cs, w)), carries


def _minibatch_step_fn(x, c, k, w, carry):
    return StepResult(*fused_lloyd(x, c, w)), carry


def fused_backend(precision: Precision = DEFAULT_PRECISION) -> Backend:
    return Backend(name="fused",
                   step_fn=_step_fn,
                   batched_step_fn=_batched_step_fn,
                   minibatch_step_fn=_minibatch_step_fn,
                   stats_fn=update,
                   assign_fn=kernel_assign,
                   precision=precision)
