"""The dense and row-blocked backends: plain PyTorch reference semantics
(counterpart of ``repro.core.backends.dense``).

``dense`` is the oracle the fused engine is held against, on the CPU and
on the card: the |x|^2 - 2 x.c + |c|^2 distance expansion plus
segment-sum stats, and for the batched slot one (R, N, K) distance block
and a one-hot matmul for the stats.  ``blocked`` evaluates the distances
``block_n`` rows at a time so the (N, K) block never materialises whole;
it sets no batched slot, so the batched driver runs it through
``Backend.batched_step``'s per-restart fallback.
"""

from __future__ import annotations

import torch

from repro_torch.core import lloyd
from repro_torch.core.backends.base import (DEFAULT_PRECISION, Backend,
                                            Precision, StepResult)
from repro_torch.core.lloyd import AssignResult


def _blocked_assign(x, c, block_n: int) -> AssignResult:
    """Row-blocked assignment for any N: ``lloyd.assign`` blocks only when
    block_n divides N, so a remainder runs as a tail block of its own."""
    n = x.shape[0]
    rem = n % block_n if block_n else 0
    if rem and n > block_n:
        main = lloyd.assign(x[:n - rem], c, block_n=block_n)
        tail = lloyd.assign(x[n - rem:], c)
        return AssignResult(torch.cat([main.labels, tail.labels]),
                            torch.cat([main.min_sqdist, tail.min_sqdist]))
    return lloyd.assign(x, c, block_n=block_n)


def _step(block_n: int = 0):
    def step_fn(x, c, k, carry):
        res = _blocked_assign(x, c, block_n)
        sums, counts = lloyd.cluster_sums(x, res.labels, k)
        return StepResult(res.labels, res.min_sqdist, sums, counts,
                          torch.sum(res.min_sqdist)), carry
    return step_fn


def _minibatch_step(block_n: int = 0):
    """Natively weighted: the row weights fold into sums/counts/energy in
    the same pass."""
    def minibatch_step_fn(x, c, k, w, carry):
        res = _blocked_assign(x, c, block_n)
        wa = w.to(torch.float32)
        sums, counts = lloyd.weighted_cluster_sums(x, res.labels, wa, k)
        return StepResult(res.labels, res.min_sqdist, sums, counts,
                          torch.sum(res.min_sqdist * wa)), carry
    return minibatch_step_fn


def _batched_step(x, cs, k, carries, w=None):
    """All R centroid sets at once: one batched distance block reading the
    shared X, stats as a one-hot matmul (matmul reduction order, so sums
    may differ from the sequential segment sum in the last ulp).  Peak
    memory is two (R, N, K) f32 blocks."""
    c_sq = torch.sum(cs * cs, dim=-1)                          # (R, K)
    x_sq = torch.sum(x * x, dim=-1)                            # (N,)|(R, N)
    if x.dim() == 2:
        cross = torch.einsum("nd,rkd->rnk", x, cs)
        x_term = x_sq[None, :, None]
    else:
        cross = torch.einsum("rnd,rkd->rnk", x, cs)
        x_term = x_sq[:, :, None]
    d2 = torch.clamp_min(x_term - 2.0 * cross + c_sq[:, None, :], 0.0)
    mind, labels = torch.min(d2, dim=-1)
    labels = labels.to(torch.int32)
    del d2, cross
    onehot = torch.nn.functional.one_hot(labels.long(), k).to(torch.float32)
    if w is not None:
        onehot = onehot * w.to(torch.float32)[:, :, None]
    if x.dim() == 2:
        sums = torch.einsum("rnk,nd->rkd", onehot, x)
    else:
        sums = torch.einsum("rnk,rnd->rkd", onehot, x)
    counts = torch.sum(onehot, dim=1)
    energy = torch.sum(mind if w is None else mind * w.to(mind.dtype),
                       dim=-1)
    return StepResult(labels, mind, sums, counts, energy), carries


def dense_backend(precision: Precision = DEFAULT_PRECISION) -> Backend:
    return Backend(name="dense",
                   step_fn=_step(),
                   batched_step_fn=_batched_step,
                   minibatch_step_fn=_minibatch_step(),
                   stats_fn=lloyd.cluster_sums,
                   assign_fn=lloyd.assign,
                   precision=precision)


def blocked_backend(block_n: int = 4096,
                    precision: Precision = DEFAULT_PRECISION) -> Backend:
    def assign_fn(x, c):
        return _blocked_assign(x, c, block_n)

    return Backend(name=f"blocked{block_n}",
                   step_fn=_step(block_n),
                   minibatch_step_fn=_minibatch_step(block_n),
                   stats_fn=lloyd.cluster_sums,
                   assign_fn=assign_fn,
                   precision=precision)
