"""The carry contract of the bound-based engines and the group-filtered
step of elkan and yinyang (counterpart of ``repro.core.backends.bounds``).

    carry = (labels, upper, lower, c_last, BoundStats)

    labels : (N,)    int32  assignment the bounds are valid for
    upper  : (N,)    f32    u_i >= d(x_i, c_{labels_i})       (Euclidean)
    lower  : (N, G)  f32    l_{i,g} <= min_{j in group g} d(x_i, c_j)
             — or (N,) for hamerly, where l_i bounds the SECOND-closest
    c_last : (K, d)  f32    centroids the step last saw (drift anchor)
    stats  : BoundStats     share of the work the bounds removed

each with a leading R axis in the batched driver, which keeps one carry
for all R restarts (the reference vmaps per restart; the CPU engines,
which set only ``step_fn``, get it from ``Backend.batched_step``'s
per-restart fallback).  The lower bounds
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

from repro_torch.core import lloyd
from repro_torch.core.backends.base import (DEFAULT_PRECISION, Backend,
                                            Precision, StepResult)
from repro_torch.core.lloyd import pairwise_sqdist

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


def resolve_group_size(k: int, group_size: Optional[int],
                       policy: str = "tile") -> int:
    """Centroids per group.  An explicit ``group_size`` wins (clipped to
    [1, K]); otherwise "tile" gives min(GROUP_TILE_MAX, round_up(K,
    GROUP_ROUND)) and "yinyang" the classic t = ceil(K/10) groups."""
    if group_size is not None:
        return max(1, min(int(group_size), k))
    if policy == "tile":
        return min(GROUP_TILE_MAX, round_up(k, GROUP_ROUND))
    if policy == "yinyang":
        g = max(1, -(-k // 10))
        return -(-k // g)
    raise ValueError(f"unknown group-size policy {policy!r}")


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


def cpu_engine_stats(x, labels, k):
    """Per-cluster sums and counts of the CPU bound engines (hamerly,
    elkan, yinyang): their step's stats and their ``stats_fn``, so the
    locality engine's recomputation gives the step's bits.  From the
    original X in f32, the accumulation dtype of every ``Precision``."""
    return lloyd.cluster_sums(x.to(torch.float32), labels, k)


def make_group_bound_backend(name: str, precision: Precision,
                             group_size: Optional[int], policy: str,
                             center_gate: bool) -> Backend:
    """The group-filtered bound step shared by elkan and yinyang
    (reference ``bounds.py:171-259``).

    Both scan only the groups whose lower bound could beat the exact
    distance to the assigned centroid; elkan also prices the K x K
    centre-centre matrix for the global gate (d(x, c_a) <= s(a), half the
    distance from c_a to its nearest other centroid: no centroid can beat
    a, skip every group).  Masked dense code, as in the reference: the
    distances are computed for all (row, centroid) pairs and applied under
    the need mask, and a skipped group keeps its drift-updated bound,
    never the dense group minimum, so the trajectory is that of an engine
    that really skips."""

    def gs_of(k):
        return resolve_group_size(k, group_size, policy)

    def init_carry_fn(x, c, k):
        return init_carry(x, c, k, gs_of(k))

    def step_fn(x, c, k, carry):
        labels0, upper, lower, c_last, _ = carry
        g, gs = group_layout(k, gs_of(k))
        # as in hamerly: inputs rounded to the compute dtype, the bound
        # arithmetic in f32 (repro/core/backends/bounds.py:200-205)
        xf = precision.compute_cast(x).to(torch.float32)
        cf = precision.compute_cast(c).to(torch.float32)
        upper, lower = drift_update(labels0, upper, lower,
                                    centroid_drift(cf, c_last), g, gs)
        lab0 = labels0.long()
        sq = pairwise_sqdist(xf, cf)
        d = torch.sqrt(sq)                                       # (N, K)
        d_a = torch.gather(d, 1, lab0[:, None])[:, 0]
        need_g = lower <= d_a[:, None]                           # (N, G)
        if center_gate:
            cc = torch.sqrt(pairwise_sqdist(cf, cf))
            eye = torch.eye(k, dtype=torch.bool, device=cf.device)
            s_half = 0.5 * torch.amin(cc.masked_fill(eye, float("inf")),
                                      dim=1)
            need_g = need_g & ~(d_a <= s_half[lab0])[:, None]
        cols = torch.arange(k, device=x.device)
        cand = need_g[:, group_ids(k, gs, x.device).long()] \
            | (cols[None, :] == lab0[:, None])
        # the argmin over the squared distances, as lloyd.assign takes it
        # (sqrt would tie two squares an ulp apart), first index on ties
        u_sq, labels = torch.min(torch.where(cand, sq, float("inf")), dim=1)
        u_new = torch.sqrt(u_sq)
        labels = labels.to(torch.int32)
        # scanned groups get the exact (inclusive) group min; skipped
        # groups keep the drift-updated bound
        lower_new = torch.where(need_g, group_min(d, g, gs), lower)
        nonowner = torch.arange(g, device=x.device)[None, :] \
            != (labels0 // gs)[:, None]
        eliminated = ~torch.any(need_g & nonowner, dim=1)
        stats = BoundStats(torch.mean(eliminated.to(torch.float32)),
                           1.0 - torch.mean(need_g.to(torch.float32)))
        mind = u_new * u_new
        sums, counts = cpu_engine_stats(x, labels, k)
        res = StepResult(labels, mind, sums, counts, torch.sum(mind))
        return res, (labels, u_new, lower_new, cf, stats)

    return Backend(name=name, step_fn=step_fn, stats_fn=cpu_engine_stats,
                   assign_fn=lloyd.assign, init_carry_fn=init_carry_fn,
                   precision=precision)
