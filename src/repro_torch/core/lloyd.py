"""Lloyd's algorithm primitives: the fixed-point map G = Update o Assign
(counterpart of ``repro.core.lloyd``, lines 47-165).

Plain functions on tensors.  Distances use the expansion
|x|^2 - 2 x.c + |c|^2, clamped at 0; statistics accumulate in at least
f32; an empty cluster keeps its previous centroid.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class AssignResult(NamedTuple):
    labels: torch.Tensor      # (N,) int32 — index of the closest centroid
    min_sqdist: torch.Tensor  # (N,) float — squared distance to it


def pairwise_sqdist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distances between rows of x (N, d) and c (K, d),
    clamped at 0 against cancellation (NaN passes through)."""
    x_sq = torch.sum(x * x, dim=-1, keepdim=True)
    c_sq = torch.sum(c * c, dim=-1)
    return torch.clamp_min(x_sq - 2.0 * (x @ c.T) + c_sq[None, :], 0.0)


def assign(x: torch.Tensor, c: torch.Tensor) -> AssignResult:
    """Assignment step (Eq. 3): nearest centroid, lowest index on ties."""
    mind, labels = torch.min(pairwise_sqdist(x, c), dim=-1)
    return AssignResult(labels.to(torch.int32), mind)


def _accum_dtype(*dtypes: torch.dtype) -> torch.dtype:
    """Statistics accumulate in AT LEAST f32: a bf16 count stops at 256
    (256 + 1 rounds back to 256), freezing any larger cluster.  f64
    inputs keep f64."""
    out = torch.float32
    for dt in dtypes:
        out = torch.promote_types(out, dt)
    return out


def weighted_cluster_sums(x: torch.Tensor, labels: torch.Tensor,
                          w: torch.Tensor, k: int):
    """Weighted per-cluster sums (K, d) and weight totals (K,); a row
    contributes w times (w = 0 drops it)."""
    acc = _accum_dtype(x.dtype, w.dtype)
    wa = w.to(acc)
    idx = labels.long()
    sums = torch.zeros(k, x.shape[1], dtype=acc, device=x.device)
    sums.index_add_(0, idx, x.to(acc) * wa[:, None])
    counts = torch.zeros(k, dtype=acc, device=x.device)
    counts.index_add_(0, idx, wa)
    return sums, counts


def cluster_sums(x: torch.Tensor, labels: torch.Tensor, k: int):
    """Per-cluster sums (K, d) and counts (K,), accumulated in >= f32."""
    acc = _accum_dtype(x.dtype)
    return weighted_cluster_sums(
        x, labels, torch.ones(x.shape[0], dtype=acc, device=x.device), k)


def update_from_sums(sums: torch.Tensor, counts: torch.Tensor,
                     c_prev: torch.Tensor) -> torch.Tensor:
    """Update step (Eq. 4) from partial sums; any leading batch axes.
    Empty clusters keep their previous centroid."""
    safe = torch.clamp_min(counts, 1.0)[..., None]
    return torch.where(counts[..., None] > 0, sums / safe, c_prev)


def energy(x: torch.Tensor, c: torch.Tensor,
           labels: torch.Tensor) -> torch.Tensor:
    """K-Means energy (Eq. 1) of a fixed assignment."""
    diff = x - c[labels.long()]
    return torch.sum(diff * diff)
