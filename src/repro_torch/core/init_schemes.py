"""Centroid seeding (counterpart of ``repro.core.init_schemes``, lines
25-95 and 248-287): uniform random rows and K-Means++, on an explicit
``torch.Generator``.

The draws are not JAX's threefry bits: the same seed gives other
centroids than the reference.  Tests that compare trajectories hand the
reference's seeds over as numpy.  afk-mc2, bf and clarans are still to be
ported.
"""

from __future__ import annotations

from typing import Optional

import torch


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


INIT_SCHEMES = {
    "random": random_init,
    "kmeans++": kmeanspp_init,
}


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
    ``weights`` (R, N) >= 0 makes the seeding segment-aware."""
    fn = make_init(name)
    if x.dim() == 3 and x.shape[0] != r:
        raise ValueError(
            f"batched x has {x.shape[0]} problems but {r} restarts")
    return torch.stack([
        fn(gen, x[i] if x.dim() == 3 else x, k,
           None if weights is None else weights[i])
        for i in range(r)])
