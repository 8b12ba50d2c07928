"""The dense and row-blocked backends: plain PyTorch reference semantics
(counterpart of ``repro.core.backends.dense``).

``dense`` is the oracle the fused engine is held against, on the CPU and
on the card: the |x|^2 - 2 x.c + |c|^2 distance expansion plus
segment-sum stats, and for the batched slot one (R, N, K) distance block
and a one-hot matmul for the stats.  ``blocked`` evaluates the distances
``block_n`` rows at a time so the (N, K) block never materialises whole;
it sets no batched slot, so the batched driver runs it through
``Backend.batched_step``'s per-restart fallback.  Both apply the
``Precision`` policy: distances in the compute dtype, stats and energy
in the accumulation dtype (>= f32) from the original X.
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


def _stats(precision: Precision):
    def stats_fn(x, labels, k):
        return lloyd.cluster_sums(x.to(precision.accum_dtype), labels, k)
    return stats_fn


def _step(precision: Precision, block_n: int = 0):
    """Distances on the compute-cast X and C, in the compute dtype as
    ``lloyd.pairwise_sqdist`` computes them; min_sqdist, stats and energy
    in the accumulation dtype, the stats from the ORIGINAL X
    (``repro/core/backends/dense.py:40-57``)."""
    def step_fn(x, c, k, carry):
        res = _blocked_assign(precision.compute_cast(x),
                              precision.compute_cast(c), block_n)
        acc = precision.accum_dtype
        mind = res.min_sqdist.to(acc)
        sums, counts = lloyd.cluster_sums(x.to(acc), res.labels, k)
        return StepResult(res.labels, mind, sums, counts,
                          torch.sum(mind)), carry
    return step_fn


def _minibatch_step(precision: Precision, block_n: int = 0):
    """Natively weighted: the row weights fold into sums/counts/energy in
    the same pass."""
    def minibatch_step_fn(x, c, k, w, carry):
        res = _blocked_assign(precision.compute_cast(x),
                              precision.compute_cast(c), block_n)
        acc = precision.accum_dtype
        wa = w.to(acc)
        mind = res.min_sqdist.to(acc)
        sums, counts = lloyd.weighted_cluster_sums(x.to(acc), res.labels,
                                                   wa, k)
        return StepResult(res.labels, mind, sums, counts,
                          torch.sum(mind * wa)), carry
    return minibatch_step_fn


def _batched_step(precision: Precision):
    """All R centroid sets at once: one batched distance block (in the
    compute dtype) reading the shared X, stats as a one-hot matmul in the
    accumulation dtype over the original X (matmul reduction order, so
    sums may differ from the sequential segment sum in the last ulp).
    Peak memory is two (R, N, K) blocks."""
    def batched_step_fn(x, cs, k, carries, w=None):
        xc = precision.compute_cast(x)
        cc = precision.compute_cast(cs)
        acc = precision.accum_dtype
        # bf16 distances as lloyd.pairwise_sqdist gives them: evaluated
        # in f32 on the bf16 values, rounded once
        low = torch.promote_types(xc.dtype, cc.dtype) == torch.bfloat16
        if low:
            xc, cc = xc.float(), cc.float()
        c_sq = torch.sum(cc * cc, dim=-1)                      # (R, K)
        x_sq = torch.sum(xc * xc, dim=-1)                      # (N,)|(R, N)
        if x.dim() == 2:
            cross = torch.einsum("nd,rkd->rnk", xc, cc)
            x_term = x_sq[None, :, None]
        else:
            cross = torch.einsum("rnd,rkd->rnk", xc, cc)
            x_term = x_sq[:, :, None]
        d2 = torch.clamp_min(x_term - 2.0 * cross + c_sq[:, None, :], 0.0)
        if low:
            d2 = d2.to(torch.bfloat16)
        mind, labels = torch.min(d2, dim=-1)
        labels = labels.to(torch.int32)
        mind = mind.to(acc)
        del d2, cross
        onehot = torch.nn.functional.one_hot(labels.long(), k).to(acc)
        if w is not None:
            onehot = onehot * w.to(acc)[:, :, None]
        xa = x.to(acc)
        if x.dim() == 2:
            sums = torch.einsum("rnk,nd->rkd", onehot, xa)
        else:
            sums = torch.einsum("rnk,rnd->rkd", onehot, xa)
        counts = torch.sum(onehot, dim=1)
        energy = torch.sum(mind if w is None else mind * w.to(acc), dim=-1)
        return StepResult(labels, mind, sums, counts, energy), carries
    return batched_step_fn


def dense_backend(precision: Precision = DEFAULT_PRECISION) -> Backend:
    return Backend(name="dense",
                   step_fn=_step(precision),
                   batched_step_fn=_batched_step(precision),
                   minibatch_step_fn=_minibatch_step(precision),
                   stats_fn=_stats(precision),
                   assign_fn=lloyd.assign,
                   precision=precision)


def blocked_backend(block_n: int = 4096,
                    precision: Precision = DEFAULT_PRECISION) -> Backend:
    def assign_fn(x, c):
        return _blocked_assign(x, c, block_n)

    return Backend(name=f"blocked{block_n}",
                   step_fn=_step(precision, block_n),
                   minibatch_step_fn=_minibatch_step(precision, block_n),
                   stats_fn=_stats(precision),
                   assign_fn=assign_fn,
                   precision=precision)
