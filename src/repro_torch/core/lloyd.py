"""Lloyd's algorithm primitives: the fixed-point map G = Update o Assign
(counterpart of ``repro.core.lloyd``).

Plain functions on tensors.  Distances use the expansion
|x|^2 - 2 x.c + |c|^2, clamped at 0; statistics accumulate in at least
f32; an empty cluster keeps its previous centroid.  ``LloydOps`` is the
legacy assign/update container the solvers still accept (adapted through
``backends.base.from_lloyd_ops``), and ``lloyd_kmeans`` the plain Lloyd
baseline of the paper's Table 3.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

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


def assign(x: torch.Tensor, c: torch.Tensor, *,
           block_n: int = 0) -> AssignResult:
    """Assignment step (Eq. 3): nearest centroid, lowest index on ties.

    ``block_n > 0`` evaluates the distances ``block_n`` rows at a time, so
    the (N, K) block never materialises whole; as in the reference it
    engages only when ``block_n`` divides N (``backends.dense`` handles a
    remainder)."""
    n = x.shape[0]
    if block_n and n > block_n and n % block_n == 0:
        parts = [assign(x[i:i + block_n], c) for i in range(0, n, block_n)]
        return AssignResult(torch.cat([p.labels for p in parts]),
                            torch.cat([p.min_sqdist for p in parts]))
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


# the deterministic segment sum's one-hot block: at most this many
# (row, cluster) cells a chunk (64 MB of f32)
ONEHOT_CELLS = 1 << 24


def onehot_segment_sums(vals: torch.Tensor, idx: torch.Tensor, k: int):
    """(K, C) segment sums of vals (N, C) by idx (N,) as one-hot matmuls
    over row chunks, added in chunk order, so every run gives the same
    bits (``index_add_`` on CUDA adds by float atomics in an order that
    changes from run to run: on an H100, ``lloyd_kmeans`` from one seed
    set took 637, 819 and 951 iterations in three runs at K = 100 on the
    USCensus1990 stand-in)."""
    out = torch.zeros(k, vals.shape[1], dtype=vals.dtype, device=vals.device)
    step = max(1, ONEHOT_CELLS // k)
    for i in range(0, vals.shape[0], step):
        rows = idx[i:i + step, None]
        onehot = torch.zeros((rows.shape[0], k), dtype=vals.dtype,
                             device=vals.device).scatter_(1, rows, 1.0)
        out += onehot.T @ vals[i:i + step]
    return out


def weighted_cluster_sums(x: torch.Tensor, labels: torch.Tensor,
                          w: torch.Tensor, k: int):
    """Weighted per-cluster sums (K, d) and weight totals (K,); a row
    contributes w times (w = 0 drops it).  Through
    ``onehot_segment_sums``, so the stats repeat bit for bit."""
    acc = _accum_dtype(x.dtype, w.dtype)
    wa = w.to(acc)
    both = onehot_segment_sums(torch.cat([x.to(acc) * wa[:, None],
                                          wa[:, None]], dim=1),
                               labels.long(), k)
    return both[:, :-1], both[:, -1]


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


def update(x: torch.Tensor, labels: torch.Tensor, k: int,
           c_prev: torch.Tensor) -> torch.Tensor:
    """Update step (Eq. 4): each centroid becomes the mean of its rows,
    formed in >= f32 and cast back to the centroid dtype."""
    sums, counts = cluster_sums(x, labels, k)
    return update_from_sums(sums, counts,
                            c_prev.to(sums.dtype)).to(c_prev.dtype)


def energy(x: torch.Tensor, c: torch.Tensor,
           labels: torch.Tensor) -> torch.Tensor:
    """K-Means energy (Eq. 1) of a fixed assignment."""
    diff = x - c[labels.long()]
    return torch.sum(diff * diff)


def energy_from_mindist(min_sqdist: torch.Tensor) -> torch.Tensor:
    return torch.sum(min_sqdist)


def _all_equal(a, b):
    return torch.all(a == b)


def _identity(s):
    return s


@dataclasses.dataclass(frozen=True)
class LloydOps:
    """The legacy dependency-injection container (superseded by
    ``backends.Backend``, whose single-pass step the solvers run).  A
    LloydOps passed to a solver is adapted through
    ``backends.base.from_lloyd_ops`` at the legacy two-pass cost.

    assign_fn(x, c)            -> AssignResult
    update_fn(x, labels, k, c) -> new centroids (K, d)
    energy_fn(x, c, labels)    -> scalar energy
    all_equal_fn(a, b)         -> scalar bool (assignments identical)
    reduce_scalar(s)           -> s reduced across shards (identity here)
    """
    assign_fn: Callable = assign
    update_fn: Callable = update
    energy_fn: Callable = energy
    all_equal_fn: Callable = _all_equal
    reduce_scalar: Callable = _identity

    def g_map(self, x: torch.Tensor, c: torch.Tensor, k: int):
        """One application of G = Update o Assign; -> (G(c), AssignResult)."""
        res = self.assign_fn(x, c)
        return self.update_fn(x, res.labels, k, c), res


DENSE_OPS = LloydOps()


def lloyd_iteration(x: torch.Tensor, c: torch.Tensor, k: int,
                    ops: LloydOps = DENSE_OPS):
    """One classical Lloyd iteration; -> (C', labels, E(P, C))."""
    c_new, res = ops.g_map(x, c, k)
    return c_new, res.labels, energy_from_mindist(res.min_sqdist)


def lloyd_kmeans(x: torch.Tensor, c0: torch.Tensor, k: int,
                 max_iter: int = 500):
    """Plain Lloyd run to assignment convergence: the unaccelerated
    baseline of the paper's Table 3.  -> (C, labels, energy, n_iter).

    The reference's ``lax.while_loop`` becomes a host loop with one
    device-to-host sync per iteration (the ``converged`` flag); the
    iteration count follows the reference's: the update + assignment
    bodies run, the last of which finds the labels unchanged."""
    res = assign(x, c0)
    c, labels, e = c0, res.labels, energy_from_mindist(res.min_sqdist)
    t = 0
    converged = False
    while not converged and t < max_iter:
        c = update(x, labels, k, c)
        res = assign(x, c)
        converged = bool(torch.all(res.labels == labels))
        labels, e = res.labels, energy_from_mindist(res.min_sqdist)
        t += 1
    return c, labels, e, t
