"""The two-kernel engine, registered as "pallas" (counterpart of
``repro.core.backends.pallas.pallas_backend``, lines 102-154).

Each step is the assignment kernel (``kernels/assignment.py``: labels and
min distances) followed by the update kernel (``kernels/update.py``:
weighted cluster sums and counts of those labels), two passes over X.
The batched slot runs R centroid sets per launch of each; per-problem
weights go through the minibatch slot one problem at a time, as the
reference's vmap does.  Under a ``Precision`` policy X and C are cast to
the compute dtype first, and the update kernel reads the same cast X
(one X stream in one dtype, as the reference's engine reads it); the
outputs are f32, the accumulation dtype.  Kept beside ``fused`` as the
decomposed engine and an independent check on it.  On CPU tensors both
kernels run their plain versions.
"""

from __future__ import annotations

import torch

from repro_torch.core.backends.base import (DEFAULT_PRECISION, Backend,
                                            Precision, StepResult)
from repro_torch.core.backends.fused import kernel_assign
from repro_torch.kernels.assignment import assignment
from repro_torch.kernels.update import update


def pallas_backend(precision: Precision = DEFAULT_PRECISION) -> Backend:
    cast = precision.compute_cast

    def step_fn(x, c, k, carry):
        xc = cast(x)
        labels, mind = assignment(xc, cast(c))
        sums, counts = update(xc, labels, k)
        return StepResult(labels, mind, sums, counts,
                          torch.sum(mind)), carry

    def minibatch_step_fn(x, c, k, w, carry):
        xc = cast(x)
        labels, mind = assignment(xc, cast(c))
        sums, counts = update(xc, labels, k, w)
        return StepResult(labels, mind, sums, counts,
                          torch.sum(mind * w.to(mind.dtype))), carry

    def batched_step_fn(x, cs, k, carries, w=None):
        if w is not None:
            # the update kernel takes one (N,) weight vector
            steps = [minibatch_step_fn(x[i] if x.dim() == 3 else x, cs[i],
                                       k, w[i], ())[0]
                     for i in range(cs.shape[0])]
            return StepResult(*(torch.stack(f) for f in zip(*steps))), \
                carries
        xc = cast(x)
        labels, mind = assignment(xc, cast(cs))
        sums, counts = update(xc, labels, k)
        return StepResult(labels, mind, sums, counts,
                          torch.sum(mind, dim=-1)), carries

    return Backend(name="pallas",
                   step_fn=step_fn,
                   batched_step_fn=batched_step_fn,
                   minibatch_step_fn=minibatch_step_fn,
                   stats_fn=update,
                   assign_fn=kernel_assign,
                   precision=precision)
