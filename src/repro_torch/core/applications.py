"""LM-stack applications of the solver (counterpart of
``repro.core.applications``).

1. ``kv_codebook`` / ``kv_codebooks_batched`` / ``compress_kv_cache``:
   K-Means codebooks over cached K/V vectors, for serving-time cache
   compression (int codes plus a (k, hd) codebook instead of the raw
   vectors).  Same-shape sets (the K and V caches, or many layers')
   solve as ONE batched Algorithm 1 (``kmeans.aa_kmeans_batched``).
2. ``kv_codebook_hierarchical``: the same for codebooks too large to
   solve flat, through ``hierarchy.aa_kmeans_hierarchical``.
3. ``embedding_codebook``: product quantisation of an embedding table,
   every sub-block clustered in one batch.

The engines are the reference's: ``kv_codebook``, ``compress_kv_cache``
and ``embedding_codebook`` solve on the dense engine; the batched and
hierarchical codebooks take ``backend=``.  Each runs on its input's
device; an input that is not a tensor goes to CUDA first.  Inputs are
solved in float32, bf16 ones too, as in the reference; a bf16-policy
``backend=`` is refused (ROADMAP.md queue B, "bf16 paths refused").

Seeds come from a ``torch.Generator`` on that device seeded with
``key`` (None: 0), where the reference takes a jax key.  The same key gives other seeds than the reference's; each
function has a private counterpart that takes the seeds as given.  The
reference's module-level jit cache has no counterpart: nothing here is
traced.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.backends import refuse_bf16
from repro_torch.core.init_schemes import batched_init, kmeanspp_init
from repro_torch.core.kmeans import (KMeansConfig, aa_kmeans,
                                     aa_kmeans_batched)
from repro_torch.device import resolve_device


def _as_f32(v) -> torch.Tensor:
    """A tensor stays on its device; anything else goes to CUDA."""
    if not isinstance(v, torch.Tensor):
        v = torch.as_tensor(v, device=resolve_device(None))
    return v.to(torch.float32)


def _generator(key, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        0 if key is None else int(key))


def kv_codebook(vectors, k: int, *, key=None, max_iter: int = 60):
    """Cluster (N, d) vectors; -> (codebook (k, d), codes (N,), the
    ``KMeansResult``)."""
    v32 = _as_f32(vectors)
    c0 = kmeanspp_init(_generator(key, v32.device), v32, k)
    return _codebook_from_seeds(v32, c0, max_iter)


def _codebook_from_seeds(v32, c0, max_iter: int):
    res = aa_kmeans(v32, c0, KMeansConfig(k=c0.shape[0], max_iter=max_iter))
    return res.centroids, res.labels, res


def kv_codebooks_batched(vectors, k: int, *, key=None, max_iter: int = 60,
                         backend=None):
    """Cluster B same-shape vector sets (B, N, d) in one batched solve,
    each seeded by kmeans++ in turn from ``key``'s generator;
    convergence is per problem.  -> (codebooks (B, k, d), codes (B, N),
    the ``KMeansResult``), each leaf with a leading problem axis."""
    v32 = _as_f32(vectors)
    if v32.dim() != 3:
        raise ValueError(f"kv_codebooks_batched expects (B, N, d); got "
                         f"{tuple(v32.shape)}")
    c0s = batched_init("kmeans++", _generator(key, v32.device), v32, k,
                       v32.shape[0])
    return _codebooks_from_seeds(v32, c0s, max_iter, backend)


def _codebooks_from_seeds(v32, c0s, max_iter: int, backend=None):
    refuse_bf16("the codebook applications", backend)
    res = aa_kmeans_batched(
        v32, c0s, KMeansConfig(k=c0s.shape[1], max_iter=max_iter),
        backend=backend)
    return res.centroids, res.labels, res


def kv_codebook_hierarchical(vectors, k: int, *, seed: int = 0,
                             max_iter: int = 60, n_groups=None,
                             n_reassign: int = 1, backend=None):
    """``kv_codebook`` for codebooks too large to solve flat (K = 2^16
    and beyond): ``aa_kmeans_hierarchical`` with G ≈ √K super-clusters,
    all sub-problems one batched solve.  -> (codebook (k, d), codes (N,)
    as global codebook rows in original order, so ``codebook[codes]``
    reconstructs, the ``HierarchyResult``), whose routing gives a free
    serving index (``serving.closure.hierarchy_closure_index``)."""
    return _hierarchical_codebook(vectors, k, seed=seed, max_iter=max_iter,
                                  n_groups=n_groups, n_reassign=n_reassign,
                                  backend=backend)


def _hierarchical_codebook(vectors, k: int, *, seed: int = 0,
                           max_iter: int = 60, n_groups=None,
                           n_reassign: int = 1, backend=None,
                           c0_super=None, c0s=None):
    from repro_torch.core.hierarchy import _aa_kmeans_hierarchical
    res = _aa_kmeans_hierarchical(
        _as_f32(vectors), k, KMeansConfig(k=k, max_iter=max_iter), backend,
        n_groups=n_groups, n_reassign=n_reassign, seed=seed, c0s=c0s,
        c0_super=c0_super)
    return res.centroids, res.labels, res


def compress_kv_cache(cache: dict, k: int,
                      valid_len: int) -> Tuple[dict, float]:
    """Replace the K/V caches (``cache["k"]``, ``cache["v"]``, each
    (..., T, Hkv, hd)) with their codebook reconstruction over the valid
    prefix of ``valid_len`` positions.  -> (the new cache, the mean over
    the tensors of the relative L2 reconstruction error).  K and V of one
    shape solve as one batched problem; differing shapes each alone."""
    return _compress_kv_cache(cache, k, valid_len)


def _compress_kv_cache(cache: dict, k: int, valid_len: int,
                       seeds=None) -> Tuple[dict, float]:
    """``compress_kv_cache`` with ``seeds`` given: (B, k, hd) for the
    batched solve, or {name: (k, hd)} when the shapes differ; None draws
    them as ``compress_kv_cache`` does."""
    names = [n for n in ("k", "v") if n in cache]
    new_cache = dict(cache)
    if not names:
        return new_cache, 0.0

    def flatten(x):
        # x: (..., T, Hkv, hd) -> the valid prefix's vectors
        return x[..., :valid_len, :, :].reshape(-1, x.shape[-1])

    if len({tuple(cache[n].shape) for n in names}) == 1:
        # the common (MHA/GQA) layout: one batched solve for K and V
        stacked = _as_f32(torch.stack([flatten(cache[n]) for n in names]))
        if seeds is None:
            cbs, codes, _ = kv_codebooks_batched(stacked, k)
        else:
            cbs, codes, _ = _codebooks_from_seeds(stacked, seeds, 60)
        solved = {n: (cbs[i], codes[i]) for i, n in enumerate(names)}
    else:
        # asymmetric caches (e.g. MLA-style head dims) cannot share one
        solved = {}
        for n in names:
            if seeds is None:
                cb, cd, _ = kv_codebook(flatten(cache[n]), k)
            else:
                cb, cd, _ = _codebook_from_seeds(
                    _as_f32(flatten(cache[n])), seeds[n], 60)
            solved[n] = (cb, cd)

    errs = []
    for n in names:
        x = cache[n]
        cb, cd = solved[n]
        lead, (hkv, hd) = x.shape[:-3], x.shape[-2:]
        valid = x[..., :valid_len, :, :]
        rec = cb[cd.long()].reshape(*lead, valid_len, hkv, hd).to(x.dtype)
        errs.append(torch.linalg.norm((rec - valid).to(torch.float32))
                    / torch.clamp_min(torch.linalg.norm(
                        valid.to(torch.float32)), 1e-9))
        out = x.clone()
        out[..., :valid_len, :, :] = rec
        new_cache[n] = out
    return new_cache, float(torch.mean(torch.stack(errs)))


def embedding_codebook(table, k: int, n_subspaces: int = 4, key=None,
                       max_iter: int = 60):
    """Product quantisation of an embedding table (V, d): the d columns
    in ``n_subspaces`` blocks, each block's V rows one clustering
    problem of one batched solve.  -> (codebooks (n_sub, k, d/n_sub),
    codes (V, n_sub), relative L2 reconstruction error)."""
    blocks = _subspace_blocks(table, n_subspaces)
    c0s = batched_init("kmeans++", _generator(key, blocks.device), blocks,
                       k, n_subspaces)
    return _embedding_from_seeds(blocks, c0s, max_iter)


def _subspace_blocks(table, n_subspaces: int) -> torch.Tensor:
    """(n_sub, V, d/n_sub): one clustering problem per subspace."""
    t32 = _as_f32(table)
    v, d = t32.shape
    if d % n_subspaces:
        raise ValueError(f"d={d} is not a multiple of n_subspaces="
                         f"{n_subspaces}")
    return t32.reshape(v, n_subspaces, d // n_subspaces).transpose(0, 1) \
        .contiguous()


def _embedding_from_seeds(blocks, c0s, max_iter: int):
    n_sub = blocks.shape[0]
    cbs, codes_b, _ = _codebooks_from_seeds(blocks, c0s, max_iter)
    codes = codes_b.T                                       # (V, n_sub)
    rec = torch.stack([cbs[j][codes[:, j].long()] for j in range(n_sub)],
                      dim=1)
    t32 = blocks.transpose(0, 1)
    err = float(torch.linalg.norm(rec - t32)
                / torch.clamp_min(torch.linalg.norm(t32), 1e-9))
    return cbs, codes, err
