"""Two-level (k²-means) Anderson-accelerated K-Means (counterpart of
``repro.core.hierarchy``: ``HierarchyResult`` :74, ``default_n_groups``
:88, ``_partition`` :108, ``_flatten`` :133, ``_routers_of`` :149,
``hierarchy_state_like`` :161, ``_solve_groups`` :183,
``_check_hier_meta`` :194, ``aa_kmeans_hierarchical`` :204).

Flat Algorithm 1 at K clusters pays O(N·K·d) per pass.  The hierarchy
clusters X into G ≈ √K super-clusters (the routers), then solves an
independent K/G-cluster problem inside each super-cluster, so a pass
costs about N·(G + K/G)·d.  All G sub-problems run as ONE
``aa_kmeans_batched`` call:

  * the partition lays each super-cluster's rows into its own padded
    stripe of a (G, N_max, d) tensor (``locality.
    counting_sort_perm_segmented`` against the offsets arange(G)·N_max);
  * padding rows weigh 0, so they vanish from the stats, the energy and
    the per-problem convergence test, and the weighted seeding never
    picks one;
  * best-of-n_init is per group: ``kmeans.select_best(groups=)``.

Reassignment rounds then move rows whose nearest router changed, rebuild
the partition and re-solve every group warm from its centroids.  A
best-snapshot guard makes the result monotone: a round that raises the
total energy is never returned.  The result is a group-major (K, d)
codebook, labels in original row order, and (routers, group offsets),
which ``serving.closure.hierarchy_closure_index`` turns into a serving
index with no more clustering.

Departures from the reference, neither changing what a given seed set
computes:

  * the seeds come from a ``torch.Generator`` on X's device seeded with
    ``seed`` (the super-solve's kmeans++ first, then the sub-problems'),
    where the reference folds jax keys; ``_aa_kmeans_hierarchical``
    takes the super seeds as given, so a caller can hand the
    reference's over (ROADMAP queue C);
  * the routers' row sums are the engine's own deterministic segment sum
    (``Backend.stats_fn``: the update kernel on the kernel engines), never
    a float-atomic scatter, so a run repeats bit for bit and resumes.

The round loop is a state -> state function: a round-granular snapshot
(``KIND_HIERARCHY``, the reference's leaves and meta) resumes a run bit
for bit, from either package's file.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import NamedTuple, Optional

import torch

from repro_torch.core import serialize
from repro_torch.core.backends import refuse_bf16
from repro_torch.core.init_schemes import batched_init, kmeanspp_init
from repro_torch.core.kmeans import (BackendLike, KMeansConfig,
                                     KMeansResult, aa_kmeans,
                                     aa_kmeans_batched, resolve_backend,
                                     select_best)
from repro_torch.core.lloyd import update_from_sums
from repro_torch.core.locality import counting_sort_perm_segmented
from repro_torch.runtime.metrics import as_metrics
from repro_torch.runtime.metrics import should_stop as _metrics_stop
from repro_torch.runtime.writer import write_snapshot

KIND_HIERARCHY = serialize.KIND_HIERARCHY


class HierarchyResult(NamedTuple):
    """The flattened two-level solve: codebook and original-row-order
    labels, plus the routing that produced them."""

    centroids: torch.Tensor      # (K, d) codebook, group-major
    labels: torch.Tensor         # (N,) int32 global labels, original order
    energy: torch.Tensor         # () f32 total energy (sum of sub_energies)
    routers: torch.Tensor        # (G, d) super-centroids
    group_offsets: torch.Tensor  # (G+1,) int32; g owns [off[g], off[g+1])
    labels_super: torch.Tensor   # (N,) int32 super-cluster of each row
    sub_energies: torch.Tensor   # (G,) f32 per-group masked energies
    n_rounds: int                # reassignment rounds executed


def default_n_groups(k: int) -> int:
    """The divisor of ``k`` nearest √k, where the per-row routing work
    G + K/G is least; a prime ``k`` gives G = 1 (the flat solve)."""
    if k <= 0:
        raise ValueError(f"k must be positive; got {k}")
    root = math.sqrt(k)
    best = 1
    for g in range(1, int(root) + 1):
        if k % g == 0:
            for cand in (g, k // g):
                if abs(cand - root) < abs(best - root):
                    best = cand
    return best


def _ceil_to(v: int, m: int) -> int:
    return -(-v // m) * m


def _partition(x, labels_super, g: int, k_sub: int, pad_multiple: int,
               sort_tile=None):
    """Stripe rows by super-cluster into (G, N_max, d) with weights.

    N_max is the largest group's population rounded up to
    ``pad_multiple``, at least k_sub (every sub-problem offers k_sub seed
    rows) and at most N (but never below the largest group).  One host
    read (the largest population).  -> ``(xg, wg, perm, n_max)``: ``wg``
    is 1 on live rows and 0 on padding, ``perm`` (G·N_max,) the source
    row of each slot, N on padding."""
    n, d = x.shape
    counts = torch.bincount(labels_super.long(), minlength=g)
    counts_max = int(torch.max(counts))
    n_max = min(max(_ceil_to(counts_max, pad_multiple), k_sub), n)
    n_max = max(n_max, counts_max)
    offsets = torch.arange(g, dtype=torch.int32,
                           device=x.device) * n_max
    perm, _, _ = counting_sort_perm_segmented(labels_super, g, offsets,
                                              g * n_max, sort_tile=sort_tile)
    # padding slots (perm == N) gather the appended zero row
    x_pad = torch.cat([x, torch.zeros((1, d), dtype=x.dtype,
                                      device=x.device)])
    xg = torch.index_select(x_pad, 0, perm.long()).reshape(g, n_max, d)
    wg = (perm < n).to(x.dtype).reshape(g, n_max)
    return xg, wg, perm, n_max


def _flatten(best: KMeansResult, perm, g: int, k_sub: int, n: int,
             n_max: int):
    """The (G, ...) winners as a global codebook, labels in original row
    order, per-group energies and their sum.  A row's global label is
    g·k_sub + its local label.  The inverse scatter sends every padding
    slot to index N of an (N+1,) buffer, the one repeated index, whose
    value is undefined and sliced off."""
    d = best.centroids.shape[-1]
    codebook = best.centroids.reshape(g * k_sub, d)
    gid = torch.arange(g, dtype=torch.int32,
                       device=perm.device).repeat_interleave(n_max)
    codes = gid * k_sub + best.labels.reshape(-1).to(torch.int32)
    labels = torch.zeros((n + 1,), dtype=torch.int32, device=perm.device)
    labels[perm.long()] = codes
    sub_e = best.energy.to(torch.float32)
    return codebook, labels[:n], sub_e, torch.sum(sub_e)


def _routers_of(x, labels_super, g: int, prev, bk):
    """Per-super-cluster row means by the engine's segment sum (the
    update kernel on the kernel engines: a fixed order, so the routers
    repeat bit for bit); an emptied group keeps its previous router
    instead of collapsing to the origin."""
    sums, cnt = bk.stats_fn(x, labels_super, g)
    return update_from_sums(sums, cnt, prev.to(sums.dtype)).to(x.dtype)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def hierarchy_state_like(x, k: int, n_groups: int) -> dict:
    """The round snapshot's layout on the meta device, from the problem's
    shape (the restore target of a ``KIND_HIERARCHY`` artifact)."""
    n, d = x.shape
    g = int(n_groups)
    k_sub = k // g
    f32, i32 = torch.float32, torch.int32
    return {
        "labels_super": _meta((n,), i32),
        "c_subs": _meta((g, k_sub, d), x.dtype),
        "routers": _meta((g, d), x.dtype),
        "best_centroids": _meta((k, d), x.dtype),
        "best_labels": _meta((n,), i32),
        "best_labels_super": _meta((n,), i32),
        "best_routers": _meta((g, d), x.dtype),
        "best_sub_e": _meta((g,), f32),
        "best_energy": _meta((), f32),
    }


def _solve_groups(xg, wg, c0s, sub_cfg, bk, g: int, n_init: int):
    """All G sub-problems (x n_init seeds) as ONE batched solve, reduced
    to per-group winners."""
    if n_init > 1:
        xg = xg.repeat_interleave(n_init, dim=0)
        wg = wg.repeat_interleave(n_init, dim=0)
    res = aa_kmeans_batched(xg, c0s, sub_cfg, backend=bk, weights=wg)
    groups = torch.arange(g, device=xg.device).repeat_interleave(n_init)
    return select_best(res, groups=groups, n_groups=g)


def _check_hier_meta(meta: dict, k: int, g: int, what: str):
    for name, want in (("k", k), ("n_groups", g)):
        got = meta.get(name)
        if got is not None and int(got) != int(want):
            raise ValueError(
                f"{what}: snapshot was taken at {name}={got}, this run "
                f"uses {name}={want}; resume must target the same "
                f"hierarchy configuration")


def aa_kmeans_hierarchical(x: torch.Tensor, k: int,
                           cfg: Optional[KMeansConfig] = None,
                           backend: BackendLike = None, *,
                           n_groups: Optional[int] = None,
                           n_init: int = 1,
                           init: str = "kmeans++",
                           seed: int = 0,
                           n_reassign: int = 2,
                           super_max_iter: int = 50,
                           pad_multiple: int = 256,
                           sort_tile=None,
                           c0s: Optional[torch.Tensor] = None,
                           metrics=None,
                           checkpoint_dir=None,
                           resume_from=None,
                           keep_last_n: int = 0,
                           keep_every_m: int = 0) -> HierarchyResult:
    """Two-level Anderson-accelerated K-Means on x (N, d), on x's device.

    ``cfg`` configures the sub-problems (its ``k`` must be ``k``; the
    engine derives the K/G sub-config); ``backend`` serves the
    super-solve, the batched sub-solves and the reassignment.
    ``n_groups`` defaults to ``default_n_groups(k)`` and must divide k;
    ``n_init`` seeds per sub-problem compete through per-group
    ``select_best`` (the warm rounds keep one).  The seeds are drawn from
    a ``torch.Generator`` on x's device seeded with ``seed``: kmeans++
    for the G routers, then ``init`` for the sub-problems, on their padded
    rows with the padding weighted 0.  ``c0s`` replaces the sub-problems'
    seeds: (n_init, K, d) when G = 1, else (G·n_init, K/G, d).
    ``sort_tile`` keeps the reference's signature and has no effect.

    G = 1 is the flat batched solve: no weights, no rounds, and the
    result's leaves equal ``select_best(aa_kmeans_batched(x, c0s, cfg))``
    bit for bit.

    ``n_reassign`` rounds follow the first solve: routers as the
    super-clusters' row means, each row moved to its nearest router, the
    partition rebuilt and every group re-solved warm.  The loop stops
    early when no row moves or the ``metrics`` sink asks it to
    (``EarlyStopHook``); the sink gets each round's ``energy``,
    ``energy_best``, ``moved_frac``, ``n_max``, ``round_s`` and, with a
    ``checkpoint_dir``, ``snapshot_s``.  The result is the round of
    lowest total energy.

    ``checkpoint_dir`` writes the round state (``KIND_HIERARCHY``) after
    every round, through ``runtime.writer.write_snapshot`` with
    ``keep_last_n`` / ``keep_every_m`` retention; ``resume_from`` (an
    artifact's path, or a (state dict, meta) pair with meta["round"])
    replays the remaining rounds bit for bit."""
    return _aa_kmeans_hierarchical(
        x, k, cfg, backend, n_groups=n_groups, n_init=n_init, init=init,
        seed=seed, n_reassign=n_reassign, super_max_iter=super_max_iter,
        pad_multiple=pad_multiple, sort_tile=sort_tile, c0s=c0s,
        metrics=metrics, checkpoint_dir=checkpoint_dir,
        resume_from=resume_from, keep_last_n=keep_last_n,
        keep_every_m=keep_every_m)


def _aa_kmeans_hierarchical(x, k, cfg=None, backend=None, *, n_groups=None,
                            n_init=1, init="kmeans++", seed=0, n_reassign=2,
                            super_max_iter=50, pad_multiple=256,
                            sort_tile=None, c0s=None, metrics=None,
                            checkpoint_dir=None, resume_from=None,
                            keep_last_n=0, keep_every_m=0,
                            c0_super: Optional[torch.Tensor] = None
                            ) -> HierarchyResult:
    """``aa_kmeans_hierarchical`` with the super-solve's seeds
    ``c0_super`` (G, d) given (None: drawn from the generator), so that
    with ``c0s`` a caller hands over every seed of the solve."""
    refuse_bf16("the two-level solve (hierarchical=)", backend, x)
    x = torch.as_tensor(x)
    if x.dim() != 2:
        raise ValueError(f"x must be (N, d); got shape {tuple(x.shape)}")
    n, d = x.shape
    if cfg is None:
        cfg = KMeansConfig(k=k)
    if cfg.k != k:
        raise ValueError(f"cfg.k={cfg.k} disagrees with k={k}")
    if not 0 < k <= n:
        raise ValueError(f"need 0 < k <= N; got k={k}, N={n}")
    g = int(n_groups) if n_groups else default_n_groups(k)
    if g < 1 or k % g != 0:
        raise ValueError(
            f"n_groups={g} must be a positive divisor of k={k} (a uniform "
            f"k_sub keeps the batched solve one program); "
            f"default_n_groups(k) picks the divisor nearest √k")
    k_sub = k // g
    bk = resolve_backend(backend)
    mx = as_metrics(metrics)
    sub_cfg = dataclasses.replace(cfg, k=k_sub)
    gen = torch.Generator(device=x.device).manual_seed(int(seed))
    i32 = torch.int32

    # -- G = 1: the flat batched solve ---------------------------------------
    if g == 1:
        if checkpoint_dir is not None or resume_from is not None:
            raise ValueError(
                "G=1 is the flat batched solve, which has its own "
                "checkpoint kind: call aa_kmeans_batched with "
                "checkpoint_dir/resume_from directly")
        if c0s is None:
            c0s = batched_init(init, gen, x, k, n_init)
        best = select_best(aa_kmeans_batched(x, c0s, cfg, backend=bk,
                                             metrics=metrics))
        energy = best.energy.to(torch.float32)
        return HierarchyResult(
            centroids=best.centroids, labels=best.labels.to(i32),
            energy=energy,
            routers=torch.mean(x, dim=0, dtype=torch.float32
                               ).to(x.dtype)[None],
            group_offsets=torch.tensor([0, k], dtype=i32, device=x.device),
            labels_super=torch.zeros((n,), dtype=i32, device=x.device),
            sub_energies=energy[None], n_rounds=0)

    # -- resume, or the cold round 0 -----------------------------------------
    state = None
    start_round = 0
    if resume_from is not None:
        if isinstance(resume_from, (str, bytes, os.PathLike)):
            state, meta = serialize.restore(
                resume_from, hierarchy_state_like(x, k, g),
                expect_kind=KIND_HIERARCHY, device=x.device)
            _check_hier_meta(meta, k, g, str(resume_from))
            start_round = int(meta.get("round", meta.get("t", 0))) + 1
        else:
            state, meta = resume_from
            _check_hier_meta(meta, k, g, "resume_from")
            start_round = int(meta["round"]) + 1
        state = {name: torch.as_tensor(a).to(x.device)
                 for name, a in state.items()}

    def snapshot(state, r) -> dict:
        if checkpoint_dir is None:
            return {}
        t0 = time.perf_counter()
        write_snapshot(checkpoint_dir, state, kind=KIND_HIERARCHY, step=r,
                       extra={"round": r, "k": k, "n_groups": g,
                              "k_sub": k_sub, "backend": bk.name},
                       keep_last_n=keep_last_n, keep_every_m=keep_every_m)
        return {"snapshot_s": time.perf_counter() - t0}

    last_round = start_round - 1
    if state is None:
        t0 = time.perf_counter()
        super_cfg = dataclasses.replace(cfg, k=g, max_iter=super_max_iter)
        if c0_super is None:
            c0_super = kmeanspp_init(gen, x, g)
        sup = aa_kmeans(x, c0_super, super_cfg, backend=bk)
        labels_super = sup.labels.to(i32)
        routers = sup.centroids

        xg, wg, perm, n_max = _partition(x, labels_super, g, k_sub,
                                         pad_multiple, sort_tile)
        if c0s is None:
            x_rep = xg if n_init == 1 else xg.repeat_interleave(n_init, 0)
            w_rep = wg if n_init == 1 else wg.repeat_interleave(n_init, 0)
            c0s = batched_init(init, gen, x_rep, k_sub, g * n_init,
                               weights=w_rep)
        elif tuple(c0s.shape) != (g * n_init, k_sub, d):
            raise ValueError(
                f"c0s must be (G*n_init, K/G, d) = ({g * n_init}, {k_sub}, "
                f"{d}); got {tuple(c0s.shape)}")
        best = _solve_groups(xg, wg, c0s, sub_cfg, bk, g, n_init)
        del xg, wg
        codebook, labels, sub_e, total = _flatten(best, perm, g, k_sub, n,
                                                  n_max)
        state = {
            "labels_super": labels_super,
            "c_subs": best.centroids,
            "routers": routers,
            "best_centroids": codebook,
            "best_labels": labels,
            "best_labels_super": labels_super,
            "best_routers": routers,
            "best_sub_e": sub_e,
            "best_energy": total.to(torch.float32),
        }
        last_round = 0
        round_s = time.perf_counter() - t0
        mx.log_scalars(0, {"energy": total,
                           "energy_best": state["best_energy"],
                           "moved_frac": 1.0, "n_max": n_max,
                           "round_s": round_s, **snapshot(state, 0)})
        start_round = 1
        if _metrics_stop(mx):
            n_reassign = 0

    # -- nearest-router reassignment rounds ----------------------------------
    for r in range(start_round, n_reassign + 1):
        t0 = time.perf_counter()
        routers = _routers_of(x, state["labels_super"], g, state["routers"],
                              bk)
        ls_new = bk.assign(x, routers).labels.to(i32)
        moved = int(torch.sum(ls_new != state["labels_super"]))
        if moved == 0:
            break
        xg, wg, perm, n_max = _partition(x, ls_new, g, k_sub, pad_multiple,
                                         sort_tile)
        best = _solve_groups(xg, wg, state["c_subs"], sub_cfg, bk, g,
                             n_init=1)
        del xg, wg
        codebook, labels, sub_e, total = _flatten(best, perm, g, k_sub, n,
                                                  n_max)
        total32 = total.to(torch.float32)
        improved = bool(total32 <= state["best_energy"])
        state = dict(state, labels_super=ls_new, c_subs=best.centroids,
                     routers=routers)
        if improved:
            state.update(best_centroids=codebook, best_labels=labels,
                         best_labels_super=ls_new, best_routers=routers,
                         best_sub_e=sub_e, best_energy=total32)
        last_round = r
        round_s = time.perf_counter() - t0
        mx.log_scalars(r, {"energy": total,
                           "energy_best": state["best_energy"],
                           "moved_frac": moved / n, "n_max": n_max,
                           "round_s": round_s, **snapshot(state, r)})
        if _metrics_stop(mx):
            break

    return HierarchyResult(
        centroids=state["best_centroids"],
        labels=state["best_labels"],
        energy=state["best_energy"],
        routers=state["best_routers"],
        group_offsets=torch.arange(g + 1, dtype=i32,
                                   device=x.device) * k_sub,
        labels_super=state["best_labels_super"],
        sub_energies=state["best_sub_e"],
        n_rounds=max(last_round, 0))
