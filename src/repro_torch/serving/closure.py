"""Cluster-closure candidate index for sublinear-in-K assignment
(counterpart of ``repro.serving.closure``).

The fitted centroids are clustered into G groups; each group's mean is a
**router**, and each router's **closure** is the list of the C centroids
nearest to it, nearest first.  A query prices the G routers, follows the
nearest one and takes the *exact* argmin over that router's C
candidates:

    cost per row:  O(G·d + C·d)   instead of   O(K·d)

The only approximation is the candidate restriction: a row mislabels only
when its true centroid is absent from its router's closure.

The index is built once from the (K, d) codebook; the query functions
take it as flat tensors, so a server holding one ``candidate_table`` per
model version swaps models by reference.  Everything here is plain
torch on the centroids' device.

Two departures from the reference, neither changing a result:

  * the first routers are drawn from a CPU ``torch.Generator`` seeded
    with ``seed`` (``torch.randperm``), where the reference draws them
    with ``jax.random.choice``; ``_build_from_routers`` takes the first
    router indices, so a caller can hand the reference's over;
  * the cross term of the candidate scan is an elementwise product summed
    over d, so each row's distances have the same bits whatever its
    position in the batch and whatever the batch's size (a batched
    matmul may pick another algorithm per batch count); bucketed and
    plain scans are therefore equal bit for bit.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core import lloyd
from repro_torch.core.backends import bounds, refuse_bf16
from repro_torch.core.locality import counting_sort_perm
from repro_torch.core.lloyd import pairwise_sqdist


class ClosureIndex(NamedTuple):
    """The servable candidate index.

    routers    : (G, d) float — group-mean entry points.
    candidates : (G, C) int32 — for each router, the indices of the C
                 centroids nearest to it, nearest first (so a prefix
                 ``candidates[:, :c]`` is itself a valid, smaller index).
    n_valid    : optional (G,) int32 — adaptive per-router candidate
                 counts (``build_closure_index(adaptive=True)``): router
                 g scans only ``candidates[g, :n_valid[g]]``; columns past
                 it are masked to +inf at query time.  None means all C
                 columns are live.
    """
    routers: torch.Tensor
    candidates: torch.Tensor
    n_valid: Optional[torch.Tensor] = None

    @property
    def n_groups(self) -> int:
        return self.routers.shape[0]

    @property
    def n_candidates(self) -> int:
        return self.candidates.shape[1]

    def shrink(self, n_candidates: int) -> "ClosureIndex":
        """A cheaper index over the same routers: candidate lists are
        sorted nearest-first, so truncation is the smaller closure.  An
        adaptive index clamps its per-router counts to the new width."""
        n_valid = None if self.n_valid is None \
            else torch.clamp_max(self.n_valid, n_candidates)
        return ClosureIndex(self.routers,
                            self.candidates[:, :n_candidates], n_valid)


def default_n_groups(k: int) -> int:
    """4√K routers: routing is one (N, G) product while the candidate
    scan pays a per-row gather, so a bigger G buys a smaller C at equal
    recall."""
    return max(1, min(4 * int(math.isqrt(max(k, 1))), k))


def default_n_candidates(k: int) -> int:
    """Candidate lists sized like the bound engines' centroid groups
    (``bounds.resolve_group_size``)."""
    return min(k, bounds.resolve_group_size(k, None, policy="tile"))


def _nearest_first(d2: torch.Tensor, width: int) -> torch.Tensor:
    """(G, width) int32 column indices of each row of ``d2`` in ascending
    order, the lower index first on equal values (the order of the
    reference's ``lax.top_k(-d2, width)``; ``torch.topk`` promises none
    on ties)."""
    order = torch.sort(d2, dim=1, stable=True).indices
    return order[:, :width].to(torch.int32)


def build_closure_index(centroids: torch.Tensor,
                        n_candidates: Optional[int] = None,
                        n_groups: Optional[int] = None, *,
                        n_iter: int = 10, seed: int = 0,
                        adaptive: bool = False) -> ClosureIndex:
    """Build the index from the fitted centroids (K, d) alone.

    Routers come from ``n_iter`` plain Lloyd iterations clustering the K
    centroids into ``n_groups`` groups (empty groups keep their router);
    each router's closure is the ``n_candidates`` centroids nearest to
    it, nearest first.  The first routers are ``n_groups`` distinct
    centroids drawn from a CPU generator seeded with ``seed``, so the
    build is deterministic in ``seed``.

    ``adaptive=True`` gives each router a live candidate count
    proportional to its radius (the distance to its farthest member
    centroid), with ``n_candidates`` as the mean count, clamped to
    [1, K]; the candidate matrix is as wide as the largest count and
    ``n_valid`` holds the counts.  A uniform build returns
    ``n_valid=None``."""
    refuse_bf16("the serving index", None, centroids)
    k = centroids.shape[0]
    g = n_groups if n_groups is not None else default_n_groups(k)
    g = max(1, min(int(g), k))
    gen = torch.Generator().manual_seed(int(seed))
    first = torch.randperm(k, generator=gen)[:g]
    return _build_from_routers(centroids, first.to(centroids.device),
                               n_candidates, n_iter=n_iter,
                               adaptive=adaptive)


def _build_from_routers(centroids: torch.Tensor, first: torch.Tensor,
                        n_candidates: Optional[int], *, n_iter: int,
                        adaptive: bool) -> ClosureIndex:
    """The build from the first routers' centroid indices ``first`` (G,)
    on: the codebook's Lloyd iterations, then the closures."""
    c = centroids
    k, g = c.shape[0], first.shape[0]
    n_cand = n_candidates if n_candidates is not None \
        else default_n_candidates(k)
    n_cand = max(1, min(int(n_cand), k))
    routers = c[first.long()]
    for _ in range(max(int(n_iter), 0)):
        labels = torch.argmin(pairwise_sqdist(c, routers), dim=1)
        sums, counts = lloyd.cluster_sums(c, labels, g)
        routers = lloyd.update_from_sums(sums, counts,
                                         routers.to(sums.dtype)).to(c.dtype)
    d2 = pairwise_sqdist(routers, c)                            # (G, K)
    if not adaptive:
        return ClosureIndex(routers, _nearest_first(d2, n_cand))
    # radius of router g: the distance to its farthest owned centroid; a
    # router that owns none scans the mean count
    owner = torch.argmin(d2, dim=0)                             # (K,)
    mine = owner[None, :] == torch.arange(g, device=c.device)[:, None]
    radius = torch.sqrt(torch.amax(torch.where(mine, d2, 0.0), dim=1))
    has = torch.any(mine, dim=1)
    mean_r = torch.sum(torch.where(has, radius, 0.0)) \
        / torch.clamp_min(torch.sum(has), 1)
    radius = torch.where(has, radius, mean_r)
    share = radius / torch.clamp_min(mean_r, 1e-30)
    n_valid = torch.clamp(torch.round(n_cand * share), 1, k).to(torch.int32)
    c_max = int(torch.max(n_valid))          # one host read per build
    return ClosureIndex(routers, _nearest_first(d2, c_max), n_valid)


def hierarchy_closure_index(centroids: torch.Tensor, routers: torch.Tensor,
                            group_offsets: torch.Tensor) -> ClosureIndex:
    """The serving index of a two-level (hierarchical) fit: the
    super-centroids are the routers and group g's candidates are its own
    codebook rows [offsets[g], offsets[g+1]), reordered nearest-first so
    the ``shrink`` prefix contract holds.  Mixed group sizes raise
    ValueError."""
    off = group_offsets.to(torch.int32)
    g = routers.shape[0]
    sizes = off[1:] - off[:-1]
    if bool(torch.any(sizes != sizes[0])):
        raise ValueError(
            "hierarchy_closure_index needs uniform group sizes (the "
            "hierarchy engine emits them); got offsets with mixed strides")
    k_sub = int(sizes[0])
    ids = off[:-1, None] + torch.arange(k_sub, dtype=torch.int32,
                                        device=off.device)[None, :]
    table = centroids[ids.reshape(-1).long()].reshape(g, k_sub, -1)
    d2 = torch.sum((table - routers[:, None, :]) ** 2, dim=-1)  # (G, k_sub)
    order = torch.sort(d2, dim=1, stable=True).indices
    return ClosureIndex(routers, torch.gather(ids, 1, order).to(torch.int32))


# -- query-time functions ----------------------------------------------------
#
# The candidate table (G, C, d) is gathered once per model version (or
# per inference call) and each row then reads ONE contiguous (C, d) block
# by its router id, instead of a scattered per-row centroid gather.


def candidate_table(centroids: torch.Tensor,
                    candidates: torch.Tensor) -> torch.Tensor:
    """(G, C, d) centroid rows of every router's closure: the operand the
    query functions scan.  Build it once per model version."""
    refuse_bf16("the serving index", None, centroids)
    g, c = candidates.shape
    return centroids[candidates.reshape(-1).long()].reshape(g, c, -1)


def _routed_sqdist(x, g, table, n_valid=None):
    """Exact squared distances (N, C) from each row to its router's
    candidate block; ``n_valid`` (G,) masks each row's columns past its
    router's live count to +inf.  Every term is row-local: the cross term
    is an elementwise product summed over d, whose bits do not depend on
    the row's position or the batch's size."""
    gl = g.long()
    cc = table[gl]                                       # (N, C, d) rows
    x_sq = torch.sum(x * x, dim=-1, keepdim=True)                # (N, 1)
    c_sq = torch.sum(table * table, dim=-1)[gl]                  # (N, C)
    cross = torch.sum(x[:, None, :] * cc, dim=-1)                # (N, C)
    d2 = torch.clamp_min(x_sq - 2.0 * cross + c_sq, 0.0)
    if n_valid is None:
        return d2
    cols = torch.arange(table.shape[1], dtype=torch.int32,
                        device=x.device)[None, :]
    return torch.where(cols < n_valid[gl][:, None], d2, math.inf)


def _candidate_sqdist(x, routers, table, bucketed=False, n_valid=None):
    """Route, block-gather, exact distances to the candidates.
    -> (g (N,) int64, d2 (N, C)).

    ``bucketed=True`` sorts the rows stably by router id before the block
    gather (``locality.counting_sort_perm``) and puts them back on the
    way out, so rows sharing a router read the same (C, d) block back to
    back.  All per-row math is row-local, so the outputs equal the plain
    path's bit for bit."""
    g = torch.argmin(pairwise_sqdist(x, routers), dim=1)          # (N,)
    if bucketed:
        perm, inv = counting_sort_perm(g, routers.shape[0])
        perm, inv = perm.long(), inv.long()
        d2s = _routed_sqdist(x[perm], g[perm], table, n_valid=n_valid)
        return g, d2s[inv]
    return g, _routed_sqdist(x, g, table, n_valid=n_valid)


def closure_assign(x, centroids, routers, candidates, table=None,
                   bucketed=False, n_valid=None):
    """Approximate assignment: the exact argmin over the nearest router's
    candidate list.  -> (labels (N,) int32, min_sqdist (N,)).

    A row whose true centroid is in its router's closure gets the
    full-scan label.  ``table`` is the ``candidate_table`` (built here
    when None); ``bucketed`` sorts the batch by router id (equal outputs,
    bit for bit); ``n_valid`` is an adaptive index's per-router live
    count: a masked column prices +inf and never wins."""
    refuse_bf16("the serving index", None, x, centroids)
    if table is None:
        table = candidate_table(centroids, candidates)
    g, d2 = _candidate_sqdist(x, routers, table, bucketed=bucketed,
                              n_valid=n_valid)
    j = torch.argmin(d2, dim=1)[:, None]
    labels = torch.gather(candidates[g], 1, j.to(torch.int64))[:, 0]
    return labels.to(torch.int32), torch.gather(d2, 1, j)[:, 0]


def closure_sqdist(x, centroids, routers, candidates, table=None,
                   fill=math.inf, bucketed=False, n_valid=None):
    """Approximate transform support: (N, K) squared distances, exact at
    each row's candidate centroids and ``fill`` (+inf by default)
    elsewhere, so an argmin over a row reproduces ``closure_assign``.
    ``bucketed`` / ``n_valid`` as there; a masked adaptive column holds
    ``fill``, like a non-candidate."""
    refuse_bf16("the serving index", None, x, centroids)
    k = centroids.shape[0]
    if table is None:
        table = candidate_table(centroids, candidates)
    g, d2 = _candidate_sqdist(x, routers, table, bucketed=bucketed,
                              n_valid=n_valid)
    if n_valid is not None:
        d2 = torch.where(torch.isinf(d2), fill, d2)
    out = torch.full((d2.shape[0], k), fill, dtype=d2.dtype,
                     device=d2.device)
    return out.scatter_(1, candidates[g].long(), d2)
