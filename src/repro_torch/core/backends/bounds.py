"""The carry contract of the bound-based engines (counterpart of
``repro.core.backends.bounds``, lines 59-164; the elkan/yinyang step
``make_group_bound_backend`` is still to be ported).

    carry = (labels, upper, lower, c_last, BoundStats)

    labels : (N,)    int32  assignment the bounds are valid for
    upper  : (N,)    f32    u_i >= d(x_i, c_{labels_i})       (Euclidean)
    lower  : (N, G)  f32    l_{i,g} <= min_{j in group g} d(x_i, c_j)
    c_last : (K, d)  f32    centroids the step last saw (drift anchor)
    stats  : BoundStats     share of the work the bounds removed

each with a leading R axis in the batched driver, which keeps one carry
for all R restarts (the reference vmaps per restart).  The lower bounds
are inclusive: l_{i,g} bounds the min over ALL centroids of group g, the
assigned one included, so the owner group always has l_g <= d(x, c_a)
<= u and a skip test ``l_g <= u`` never skips it.  Groups are contiguous
ranges of ``gs`` centroids, group g covering [g*gs, (g+1)*gs).

Drift maintenance, valid for any centroid move (Lloyd update, accepted
Anderson jump, revert) by the triangle inequality:

    u_i  += |c_new[a_i] - c_old[a_i]|
    l_g  -= max_{j in g} |c_new[j] - c_old[j]|
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

# The "tile" group policy of the reference (repro/core/backends/bounds.py
# :98-107): groups of min(GROUP_TILE_MAX, round_up(K, GROUP_ROUND))
# centroids, the TPU kernel's default k tile.  Group-policy constants,
# not the CUDA tile: with them the default G, and so the carry, is the
# same in both packages.
GROUP_TILE_MAX = 512
GROUP_ROUND = 8


class BoundStats(NamedTuple):
    """Per-step work-elimination fractions, carried so the driver can
    observe bound efficacy without extra passes.

    eliminated_frac : f32 — rows settled without scanning a group beyond
        the owner's (the kernel engine loses row granularity and reports
        skipped_frac here too).
    skipped_frac    : f32 — share of (row tile, group) cells skipped.
    (each () per problem, (R,) in the batched driver)"""
    eliminated_frac: torch.Tensor
    skipped_frac: torch.Tensor

    @classmethod
    def zeros(cls, lead=(), device=None) -> "BoundStats":
        z = torch.zeros(lead, dtype=torch.float32, device=device)
        return cls(z, z)


def extract_stats(carry) -> Optional[BoundStats]:
    """The BoundStats node of a backend carry, or None for stateless
    backends; found at any nesting of tuples."""
    if isinstance(carry, BoundStats):
        return carry
    if isinstance(carry, tuple):
        for node in carry:
            found = extract_stats(node)
            if found is not None:
                return found
    return None


def round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def resolve_group_size(k: int, group_size: Optional[int]) -> int:
    """Centroids per group.  An explicit ``group_size`` wins (clipped to
    [1, K]); otherwise the reference's "tile" policy, min(GROUP_TILE_MAX,
    round_up(K, GROUP_ROUND))."""
    if group_size is not None:
        return max(1, min(int(group_size), k))
    return min(GROUP_TILE_MAX, round_up(k, GROUP_ROUND))


def group_layout(k: int, gs: int) -> Tuple[int, int]:
    """(n_groups, group_size) for contiguous groups of ``gs`` centroids."""
    return -(-k // gs), gs


def group_ids(k: int, gs: int, device=None) -> torch.Tensor:
    return (torch.arange(k, device=device) // gs).to(torch.int32)


def group_max(v: torch.Tensor, g: int, gs: int) -> torch.Tensor:
    """(..., K) -> (..., G) max over each contiguous group (padded with 0,
    which never raises a drift max since drifts are >= 0)."""
    vp = torch.nn.functional.pad(v, (0, g * gs - v.shape[-1]))
    return torch.amax(vp.reshape(*v.shape[:-1], g, gs), dim=-1)


def group_min(d: torch.Tensor, g: int, gs: int) -> torch.Tensor:
    """(..., N, K) -> (..., N, G) min over each contiguous group (padded
    with +inf)."""
    dp = torch.nn.functional.pad(d, (0, g * gs - d.shape[-1]),
                                 value=float("inf"))
    return torch.amin(dp.reshape(*d.shape[:-1], g, gs), dim=-1)


def centroid_drift(c_new: torch.Tensor, c_old: torch.Tensor
                   ) -> torch.Tensor:
    """Per-centroid Euclidean move |c_new[j] - c_old[j]|, the only input
    the bound update needs, whatever moved C."""
    return torch.sqrt(torch.sum((c_new - c_old) ** 2, dim=-1))


def drift_update(labels, upper, lower, drift, g: int, gs: int):
    """Triangle-inequality bound update for an arbitrary centroid move;
    labels/upper (..., N), lower (..., N, G), drift (..., K)."""
    upper = upper + torch.gather(drift, -1, labels.long())
    lower = lower - group_max(drift, g, gs)[..., None, :]
    return upper, lower


def init_carry(x: torch.Tensor, c: torch.Tensor, k: int, gs: int):
    """upper = +inf forces a full scan on the first step (no valid bounds
    yet); lower = 0 is trivially valid.  c (K, d) gives the carry of one
    problem, c (R, K, d) a leading R axis on every leaf."""
    lead = tuple(c.shape[:-2])
    n = x.shape[-2]
    g, _ = group_layout(k, gs)
    dev = x.device
    return (torch.zeros(lead + (n,), dtype=torch.int32, device=dev),
            torch.full(lead + (n,), float("inf"), device=dev),
            torch.zeros(lead + (n, g), device=dev),
            c.to(torch.float32),
            BoundStats.zeros(lead, dev))
