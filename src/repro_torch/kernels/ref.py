"""Plain PyTorch oracles for the kernels (counterpart of
``repro.kernels.ref``).

Each function is the semantic specification its kernel is held against:
distances max(|x|^2 - 2 x.c + |c|^2, 0) in f32, the lowest index winning
a tie (the standing label, where a bound seeds the min), stats as weighted
segment sums.  They run on any device; nothing
on the port's CUDA path calls them.
"""

from __future__ import annotations

from typing import Optional

import torch


def _sqdist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    x = x.float()
    c = c.float()
    x_sq = torch.sum(x * x, dim=-1, keepdim=True)
    c_sq = torch.sum(c * c, dim=-1)
    return torch.clamp_min(x_sq - 2.0 * (x @ c.T) + c_sq[None, :], 0.0)


def assignment_ref(x: torch.Tensor, c: torch.Tensor):
    """Nearest centroid.  x (N, d), c (K, d) ->
    (labels (N,) int32, min_sqdist (N,) f32)."""
    d = _sqdist(x, c)
    mind, labels = torch.min(d, dim=-1)   # first index on ties, NaN wins
    return labels.to(torch.int32), mind


def update_ref(x: torch.Tensor, labels: torch.Tensor, k: int,
               w: Optional[torch.Tensor] = None):
    """Per-cluster sums and counts, optionally row-weighted by w (N,).
    A label outside [0, K) lands nowhere, as the TPU kernel's padding
    rows (label -1) do.  -> (sums (K, d) f32, counts (K,) f32)."""
    x = x.float()
    w = torch.ones(x.shape[0], dtype=torch.float32, device=x.device) \
        if w is None else w.float()
    idx = labels.long()
    keep = (idx >= 0) & (idx < k)
    idx, x, w = idx[keep], x[keep], w[keep]
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


def computed_cells(lb_sq: torch.Tensor, ub_sq: torch.Tensor,
                   tile_rows: int) -> torch.Tensor:
    """The skip test of the bounded pass: (N, G) True where the row's
    (tile, group) cell is computed, i.e. where any row of its
    ``tile_rows``-row tile has lb_sq[row, g] <= ub_sq[row]."""
    n, g = lb_sq.shape
    n_tiles = -(-n // tile_rows)
    fits = lb_sq <= ub_sq[:, None]
    fits = torch.cat([fits, fits.new_zeros(n_tiles * tile_rows - n, g)])
    need = fits.reshape(n_tiles, tile_rows, g).any(dim=1)
    return need.repeat_interleave(tile_rows, dim=0)[:n]


def fused_bounds_ref(x: torch.Tensor, c: torch.Tensor,
                     w: Optional[torch.Tensor], lab0: torch.Tensor,
                     lb_sq: torch.Tensor, ub_sq: torch.Tensor, gs: int,
                     tile_rows: int):
    """One fused pass that skips (row tile, centroid group) cells: the
    function of the TPU kernel ``_fused_bounds_kernel`` at ``tile_rows``-row
    tiles and groups of ``gs`` contiguous centroids.

    x (N, d), c (K, d), w None or (N,); lab0 (N,) the standing labels,
    lb_sq (N, G) squared lower bounds per group (G = ceil(K / gs)), ub_sq
    (N,) squared upper bounds.  Group g of a tile is computed when any row
    of the tile has lb_sq[row, g] <= ub_sq[row]; only the centroids of
    computed groups compete.  The running min starts at (ub_sq, lab0) and
    the seed keeps a tie (NaN first, value, not-seed, index).  gmin_sq is a
    computed group's min over its own centroids and a skipped group's
    lb_sq, passed through.  -> (labels, min_sqdist, sums, counts, energy,
    gmin_sq (N, G), skipped_frac () f32 of the tile x group cells)."""
    n, k = x.shape[0], c.shape[0]
    g = -(-k // gs)
    n_tiles = -(-n // tile_rows)
    need = computed_cells(lb_sq, ub_sq, tile_rows)            # (N, G)

    dist = _sqdist(x, c)
    gid = torch.arange(k, device=x.device) // gs
    val, idx = torch.min(torch.where(need[:, gid], dist, float("inf")),
                         dim=-1)
    seed = ub_sq.float()
    take = (torch.isnan(val) & ~torch.isnan(seed)) | (val < seed)
    labels = torch.where(take, idx.to(torch.int32), lab0.to(torch.int32))
    mind = torch.where(take, val, seed)

    pad = torch.full((n, g * gs - k), float("inf"), device=x.device)
    group_min = torch.cat([dist, pad], dim=1).reshape(n, g, gs).amin(dim=-1)
    gmin_sq = torch.where(need, group_min, lb_sq.float())
    skipped = torch.tensor(int((~need[::tile_rows]).sum()),
                           dtype=torch.float32)
    skipped_frac = skipped / torch.tensor(n_tiles * g, dtype=torch.float32)

    sums, counts = update_ref(x, labels, k, w)
    energy = torch.sum(mind) if w is None else torch.sum(mind * w.float())
    return (labels, mind, sums, counts, energy, gmin_sq,
            skipped_frac.to(x.device))
