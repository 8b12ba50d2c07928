"""Plain PyTorch oracles for the kernels (counterpart of
``repro.kernels.ref``).

Each function is the semantic specification its kernel is held against:
distances max(|x|^2 - 2 x.c + |c|^2, 0) in f32, the lowest index winning
a tie, stats as weighted segment sums.  They run on any device; nothing
on the port's CUDA path calls them.
"""

from __future__ import annotations

from typing import Optional

import torch


def assignment_ref(x: torch.Tensor, c: torch.Tensor):
    """Nearest centroid.  x (N, d), c (K, d) ->
    (labels (N,) int32, min_sqdist (N,) f32)."""
    x = x.float()
    c = c.float()
    x_sq = torch.sum(x * x, dim=-1, keepdim=True)
    c_sq = torch.sum(c * c, dim=-1)
    d = torch.clamp_min(x_sq - 2.0 * (x @ c.T) + c_sq[None, :], 0.0)
    mind, labels = torch.min(d, dim=-1)   # first index on ties, NaN wins
    return labels.to(torch.int32), mind


def update_ref(x: torch.Tensor, labels: torch.Tensor, k: int,
               w: Optional[torch.Tensor] = None):
    """Per-cluster sums and counts, optionally row-weighted by w (N,).
    -> (sums (K, d) f32, counts (K,) f32)."""
    x = x.float()
    w = torch.ones(x.shape[0], dtype=torch.float32, device=x.device) \
        if w is None else w.float()
    idx = labels.long()
    sums = torch.zeros(k, x.shape[1], dtype=torch.float32, device=x.device)
    sums.index_add_(0, idx, x * w[:, None])
    counts = torch.zeros(k, dtype=torch.float32, device=x.device)
    counts.index_add_(0, idx, w)
    return sums, counts


def fused_lloyd_ref(x: torch.Tensor, c: torch.Tensor):
    """One fused Lloyd pass: assignment + cluster sums + counts + energy.
    -> (labels, min_sqdist, sums, counts, energy)."""
    labels, mind = assignment_ref(x, c)
    sums, counts = update_ref(x, labels, c.shape[0])
    return labels, mind, sums, counts, torch.sum(mind)


def minibatch_ref(x: torch.Tensor, c: torch.Tensor, w: torch.Tensor):
    """Weighted pass: row weights w (N,) scale each row's contribution to
    sums/counts/energy; labels and min_sqdist stay per-row and unweighted.
    -> (labels, min_sqdist, sums, counts, energy)."""
    labels, mind = assignment_ref(x, c)
    w = w.float()
    sums, counts = update_ref(x, labels, c.shape[0], w)
    return labels, mind, sums, counts, torch.sum(mind * w)
