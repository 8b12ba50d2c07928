"""The fused kernel backend (counterpart of
``repro.core.backends.pallas.fused_backend``, lines 161-198).

Every step slot is one launch of the fused Lloyd kernel
(``kernels/fused_lloyd.py``): distances, argmin, weighted cluster stats
and energy in one call, R centroid sets per launch for the batched
slot.  ``assign`` (predict) is the assignment kernel
(``kernels/assignment.py``) and ``stats_fn`` the update kernel
(``kernels/update.py``).  On CPU tensors they run their plain versions,
which is how the tests run this backend.  Under a ``Precision`` policy
every slot casts X and C to the compute dtype and launches the kernel on
them: bf16 X and C read as they are, the cross terms as bf16 products on
the tensor cores summed in f32 (the reference's MXU ``dot_general``), the
norms, distances and stats in f32; ``assign`` and ``stats_fn`` do not
cast, as in the reference (``repro/core/backends/pallas.py:76-84``,
``:161-198``).
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


def fused_backend(precision: Precision = DEFAULT_PRECISION) -> Backend:
    cast = precision.compute_cast

    def step_fn(x, c, k, carry):
        return StepResult(*fused_lloyd(cast(x), cast(c))), carry

    def batched_step_fn(x, cs, k, carries, w=None):
        return StepResult(*fused_lloyd(cast(x), cast(cs), w)), carries

    def minibatch_step_fn(x, c, k, w, carry):
        return StepResult(*fused_lloyd(cast(x), cast(c), w)), carry

    return Backend(name="fused",
                   step_fn=step_fn,
                   batched_step_fn=batched_step_fn,
                   minibatch_step_fn=minibatch_step_fn,
                   stats_fn=update,
                   assign_fn=kernel_assign,
                   precision=precision)
