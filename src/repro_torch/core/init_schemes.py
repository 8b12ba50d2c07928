"""Centroid seeding (counterpart of ``repro.core.init_schemes``): uniform
random rows, K-Means++, AFK-MC^2, Bradley-Fayyad refinement and CLARANS,
the seedings of the paper's Table 3, each on an explicit
``torch.Generator`` that lives on x's device.

The draws are not JAX's threefry bits: the same seed gives other
centroids than the reference.  Tests that compare trajectories hand the
reference's seeds over as numpy; the seedings themselves are held to
their invariants.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.kmeans import KMeansConfig, aa_kmeans
from repro_torch.core.lloyd import pairwise_sqdist


def _validate_seeding(x: torch.Tensor, k: int, scheme: str) -> None:
    """Reject degenerate requests with a clear error (shape-only)."""
    if x.dim() < 2:
        raise ValueError(
            f"{scheme}: x must be (N, d); got shape {tuple(x.shape)}")
    n = x.shape[0]
    if k < 1:
        raise ValueError(f"{scheme}: need at least one cluster; got k={k}")
    if k > n:
        raise ValueError(
            f"{scheme}: cannot seed k={k} centroids from only n={n} "
            f"samples; need k <= n")


def _draw(p: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """One index drawn with probability ∝ p (p >= 0).  The clamp mirrors
    the reference's log(max(p, 1e-38)): an all-zero p draws uniformly.
    A non-finite p (NaN rows in X) counts as 0 — torch.multinomial would
    refuse it — and the solve then surfaces those rows as a non-finite
    energy.  torch.multinomial takes at most 2**24 categories, which
    covers the largest dataset of the paper's Table 1 (N = 4,898,431)."""
    p = torch.nan_to_num(p, nan=0.0, posinf=0.0)
    return torch.multinomial(torch.clamp_min(p, 1e-38), 1, generator=gen)


def random_init(gen: torch.Generator, x: torch.Tensor, k: int,
                w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K distinct rows of X, uniformly (p ∝ w when given — a zero-weight
    padding row is never picked)."""
    _validate_seeding(x, k, "random_init")
    if w is None:
        idx = torch.randperm(x.shape[0], generator=gen,
                             device=x.device)[:k]
    else:
        idx = torch.multinomial(w.float(), k, replacement=False,
                                generator=gen)
    return x[idx]


def kmeanspp_init(gen: torch.Generator, x: torch.Tensor, k: int,
                  w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K-Means++: D^2-weighted sequential sampling.  ``w`` (N,) >= 0 makes
    it segment-aware: the first pick draws p ∝ w, every later one
    p ∝ w·D^2 (falling back to w when every live row is already a
    centroid), so a zero-weight row is never seeded.  No host sync: every
    draw stays on x's device."""
    _validate_seeding(x, k, "kmeanspp_init")
    n = x.shape[0]
    if w is None:
        first = torch.randint(n, (1,), generator=gen, device=x.device)
    else:
        w = w.float()
        first = _draw(w / torch.clamp_min(torch.sum(w), 1e-30), gen)
    picks = [x[first]]
    mind = torch.sum((x - picks[0]) ** 2, dim=-1)
    for _ in range(k - 1):
        if w is None:
            score = mind
        else:
            s = mind * w
            score = torch.where(torch.sum(s) > 0, s, w)
        idx = _draw(score / torch.clamp_min(torch.sum(score), 1e-30), gen)
        c_new = x[idx]
        picks.append(c_new)
        mind = torch.minimum(mind, torch.sum((x - c_new) ** 2, dim=-1))
    return torch.cat(picks)


def afkmc2_init(gen: torch.Generator, x: torch.Tensor, k: int,
                chain_length: int = 100) -> torch.Tensor:
    """Assumption-free K-MC^2 (Bachem et al. 2016): an MCMC approximation
    of K-Means++ with the D^2 + uniform proposal
    q = 0.5 d(x, c_0)^2 / sum + 0.5 / n.

    Each centre's chain draws its ``chain_length`` candidates at once, by
    inverting the proposal's f64 CDF (made once: q does not change), takes
    their distances to the centres so far in one op, and walks the
    Metropolis-Hastings chain over those scalars on the host (one copy
    per centre); X stays on its device.  ``torch.multinomial`` with
    replacement would scan q anew in f32 per centre, and on CUDA that
    scan's rounding varies from run to run, and so do its draws."""
    _validate_seeding(x, k, "afkmc2_init")
    n = x.shape[0]
    first = torch.randint(n, (1,), generator=gen, device=x.device)
    centers = x[first]
    d0 = torch.sum((x - centers) ** 2, dim=-1)
    q = 0.5 * d0 / torch.clamp_min(torch.sum(d0), 1e-30) + 0.5 / n
    cdf = torch.cumsum(q.double(), dim=0)
    for _ in range(k - 1):
        u = torch.rand((chain_length,), generator=gen, device=x.device,
                       dtype=torch.float64)
        cand = torch.searchsorted(cdf, u * cdf[-1],
                                  right=True).clamp_max(n - 1)
        us = torch.rand((chain_length,), generator=gen, device=x.device)
        mind = torch.min(torch.sum(
            (x[cand][:, None, :] - centers[None]) ** 2, dim=-1), dim=1)[0]
        val = mind / q[cand]
        vals, us_h, cand_h = torch.stack([val.double(), us.double(),
                                          cand.double()]).tolist()
        cur, cur_val = cand_h[0], vals[0]
        for t in range(1, chain_length):
            if us_h[t] < vals[t] / max(cur_val, 1e-30):
                cur, cur_val = cand_h[t], vals[t]
        centers = torch.cat([centers, x[int(cur)][None]])
    return centers


def bf_init(gen: torch.Generator, x: torch.Tensor, k: int,
            n_subsets: int = 10, subset_frac: float = 0.1,
            max_iter: int = 20) -> torch.Tensor:
    """Bradley & Fayyad 1998 refinement: plain Lloyd on J random
    subsamples, then on the union of the J solutions seeded from each in
    turn; the solution of lowest energy over the union wins."""
    _validate_seeding(x, k, "bf_init")
    n = x.shape[0]
    subset = min(max(k * 2, int(n * subset_frac)), n)
    cfg = KMeansConfig(k=k, max_iter=max_iter, accelerated=False)
    cms = []
    for _ in range(n_subsets):
        idx = torch.randperm(n, generator=gen, device=x.device)[:subset]
        xs = x[idx]
        cms.append(aa_kmeans(xs, random_init(gen, xs, k), cfg).centroids)
    cm_all = torch.cat(cms)
    fits = [aa_kmeans(cm_all, cj, cfg) for cj in cms]
    best = int(torch.argmin(torch.stack([f.energy for f in fits])))
    return fits[best].centroids


# swap trials of the last clarans_init call (one cost read on the host
# each), so that a caller can read its seeding time per trial
clarans_trials = 0


def clarans_init(gen: torch.Generator, x: torch.Tensor, k: int,
                 num_local: int = 2, max_neighbor: int = 32,
                 sample_n: int = 2048) -> torch.Tensor:
    """Simplified CLARANS (Ng & Han 1994) k-medoids seeding, as Newling &
    Fleuret 2017 use it for K-Means: randomised medoid-swap local search
    on a subsample, ``num_local`` restarts, each ending after
    ``max_neighbor`` rejected swaps in a row.

    Each trial reads its cost on the host (one sync per swap), so the
    trial's (slot, candidate) ints come from a CPU generator seeded from
    ``gen``; the medoids stay on x's device.  Counts its trials in
    ``clarans_trials``."""
    global clarans_trials
    _validate_seeding(x, k, "clarans_init")
    if num_local < 1:
        raise ValueError(
            f"clarans_init: num_local must be >= 1 (got {num_local}); "
            f"zero local searches would yield no medoid set at all")
    n = x.shape[0]
    if n > sample_n:
        xs = x[torch.randperm(n, generator=gen, device=x.device)[:sample_n]]
    else:
        xs = x
    seed = int(torch.randint(2 ** 62, (1,), generator=gen, device=x.device))
    host = torch.Generator().manual_seed(seed)

    def cost_of(medoids):
        return float(torch.sum(torch.min(pairwise_sqdist(xs, medoids),
                                         dim=-1)[0]))

    best_medoids, best_cost = None, float("inf")
    clarans_trials = 0
    for _ in range(num_local):
        medoids = random_init(gen, xs, k)
        cost = cost_of(medoids)
        stall = 0
        while stall < max_neighbor:
            slot = int(torch.randint(k, (1,), generator=host))
            cand = int(torch.randint(xs.shape[0], (1,), generator=host))
            trial = medoids.clone()
            trial[slot] = xs[cand]
            tcost = cost_of(trial)
            clarans_trials += 1
            if tcost < cost:
                medoids, cost, stall = trial, tcost, 0
            else:
                stall += 1
        if cost < best_cost:
            best_medoids, best_cost = medoids, cost
    return best_medoids


INIT_SCHEMES = {
    "random": random_init,
    "kmeans++": kmeanspp_init,
    "afk-mc2": afkmc2_init,
    "bf": bf_init,
    "clarans": clarans_init,
}
# the schemes that take row weights
WEIGHTED_INITS = frozenset({"random", "kmeans++"})


def make_init(name: str):
    if name not in INIT_SCHEMES:
        raise ValueError(f"unknown init scheme {name!r}; "
                         f"choose from {sorted(INIT_SCHEMES)}")
    return INIT_SCHEMES[name]


def batched_init(name: str, gen: torch.Generator, x: torch.Tensor, k: int,
                 r: int, weights: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Seed R restarts -> (R, K, d), drawn one after another from ``gen``.
    ``x`` is (N, d) shared or (R, N, d) one dataset per problem;
    ``weights`` (R, N) >= 0 makes the seeding segment-aware (random and
    kmeans++ only, as in the reference)."""
    fn = make_init(name)
    if x.dim() == 3 and x.shape[0] != r:
        raise ValueError(
            f"batched x has {x.shape[0]} problems but {r} restarts")
    if weights is not None and name not in WEIGHTED_INITS:
        raise ValueError(
            f"batched_init(weights=...) supports the weighted schemes "
            f"'random' and 'kmeans++' only; got {name!r}")
    kw = [{} if weights is None else {"w": weights[i]} for i in range(r)]
    return torch.stack([fn(gen, x[i] if x.dim() == 3 else x, k, **kw[i])
                        for i in range(r)])
