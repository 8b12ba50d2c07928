"""The two-kernel engine, registered as "pallas" (counterpart of
``repro.core.backends.pallas.pallas_backend``, lines 102-154).

Each step is the assignment kernel (``kernels/assignment.py``: labels and
min distances) followed by the update kernel (``kernels/update.py``:
weighted cluster sums and counts of those labels), two passes over X.
The batched slot runs R centroid sets per launch of each; per-problem
weights go through the minibatch slot one problem at a time, as the
reference's vmap does.  Kept beside ``fused`` as the decomposed engine
and an independent check on it.  On CPU tensors both kernels run their
plain versions.
"""

from __future__ import annotations

import torch

from repro_torch.core.backends.base import (DEFAULT_PRECISION, Backend,
                                            Precision, StepResult)
from repro_torch.core.backends.fused import kernel_assign
from repro_torch.kernels.assignment import assignment
from repro_torch.kernels.update import update


def _step_fn(x, c, k, carry):
    labels, mind = assignment(x, c)
    sums, counts = update(x, labels, k)
    return StepResult(labels, mind, sums, counts, torch.sum(mind)), carry


def _minibatch_step_fn(x, c, k, w, carry):
    labels, mind = assignment(x, c)
    sums, counts = update(x, labels, k, w)
    return StepResult(labels, mind, sums, counts,
                      torch.sum(mind * w)), carry


def _batched_step_fn(x, cs, k, carries, w=None):
    if w is not None:
        # the update kernel takes one (N,) weight vector
        steps = [_minibatch_step_fn(x[i] if x.dim() == 3 else x, cs[i], k,
                                    w[i], ())[0]
                 for i in range(cs.shape[0])]
        return StepResult(*(torch.stack(f) for f in zip(*steps))), carries
    labels, mind = assignment(x, cs)
    sums, counts = update(x, labels, k)
    return StepResult(labels, mind, sums, counts,
                      torch.sum(mind, dim=-1)), carries


def pallas_backend(precision: Precision = DEFAULT_PRECISION) -> Backend:
    return Backend(name="pallas",
                   step_fn=_step_fn,
                   batched_step_fn=_batched_step_fn,
                   minibatch_step_fn=_minibatch_step_fn,
                   stats_fn=update,
                   assign_fn=kernel_assign,
                   precision=precision)
