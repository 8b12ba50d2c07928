"""The port's LM-stack applications (``core/applications.py``) against
the JAX package's: KV-cache codebooks (single, batched, hierarchical),
``compress_kv_cache`` and ``embedding_codebook``.

Inputs are numpy from a seed, at small Llama-like shapes (a few heads of
a narrow head dim).  The port runs on the CPU.  The two packages draw
other seeds from one key, so each comparison hands the reference's
seeds (from its own kmeans++ and keys: ``PRNGKey(0)`` by default) to the
port's private solve from given seeds; the public functions are held to
their shapes, their errors and their defaults' engines.

Tolerances: codes and labels exact, codebooks within 1e-5 (absolute, the
vectors are O(1)), errors within 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import applications as japp
from repro.core.init_schemes import kmeanspp_init as jkmeanspp
from repro_torch.core import applications as app
from repro_torch.core import get_backend
from repro_torch.core.hierarchy import default_n_groups

from test_torch_hierarchy import _ref_seeds, _smooth

torch.set_num_threads(2)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got, want, what, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _cache(b=1, t=64, hkv=2, hd=16, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {n: rng.normal(size=(b, t, hkv, hd)).astype(dtype)
            for n in ("k", "v")}


def _ref_c0s(v32, k, key=None):
    """The reference's per-problem kmeans++ seeds of
    ``kv_codebooks_batched`` (vmapped over split(key, B))."""
    key = key if key is not None else jax.random.PRNGKey(0)
    keys = jax.random.split(key, v32.shape[0])
    return np.asarray(jax.vmap(lambda kk, vv: jkmeanspp(kk, vv, k))(
        keys, jnp.asarray(v32)))


def test_kv_codebook_from_reference_seeds():
    v = _cache()["k"].reshape(-1, 16)
    cb_j, codes_j, res_j = japp.kv_codebook(jnp.asarray(v), 12)
    c0 = jkmeanspp(jax.random.PRNGKey(0), jnp.asarray(v), 12)
    cb, codes, res = app._codebook_from_seeds(_t(v), _t(c0), 60)
    assert np.array_equal(codes.numpy(), np.asarray(codes_j))
    _close(cb, cb_j, "codebook")
    assert int(res.n_iter) == int(res_j.n_iter)
    # the public function: its own seeds, the same shapes
    cb, codes, res = app.kv_codebook(_t(v), 12)
    assert cb.shape == (12, 16) and codes.shape == (v.shape[0],)
    assert codes.dtype == torch.int32 and bool(torch.isfinite(res.energy))


@pytest.mark.parametrize("backend", ["dense", "fused"])
def test_kv_codebooks_batched_from_reference_seeds(backend):
    c = _cache(t=48, hkv=4, hd=8, seed=1)
    stacked = np.stack([c[n].reshape(-1, 8) for n in ("k", "v")])
    cbs_j, codes_j, _ = japp.kv_codebooks_batched(jnp.asarray(stacked), 10,
                                                  backend="dense")
    c0s = _ref_c0s(stacked, 10)
    cbs, codes, res = app._codebooks_from_seeds(_t(stacked), _t(c0s), 60,
                                                backend)
    assert np.array_equal(codes.numpy(), np.asarray(codes_j))
    _close(cbs, cbs_j, "codebooks")
    cbs, codes, res = app.kv_codebooks_batched(_t(stacked), 10,
                                               backend=backend, key=3)
    assert cbs.shape == (2, 10, 8) and codes.shape == (2, 192)
    assert res.energy.shape == (2,)
    with pytest.raises(ValueError, match=r"\(B, N, d\)"):
        app.kv_codebooks_batched(_t(stacked[0]), 10)


def test_kv_codebooks_key_seeds_the_generator():
    """``key`` None is seed 0; another seed draws other seeds."""
    v = _t(_cache(t=32, seed=2)["k"].reshape(1, -1, 16))
    a = app.kv_codebooks_batched(v, 6)[0]
    b = app.kv_codebooks_batched(v, 6, key=0)[0]
    c = app.kv_codebooks_batched(v, 6, key=1)[0]
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("backend", ["dense", "fused"])
def test_kv_codebook_hierarchical_from_reference_seeds(backend):
    v = _smooth(2048, 8, seed=3)
    k = 64
    g = default_n_groups(k)
    c0_super, c0s = _ref_seeds(v, k, g, 0, super_max_iter=50)
    cb_j, codes_j, res_j = japp.kv_codebook_hierarchical(jnp.asarray(v), k,
                                                         max_iter=30)
    cb, codes, res = app._hierarchical_codebook(
        _t(v), k, max_iter=30, backend=backend, c0_super=_t(c0_super),
        c0s=_t(c0s))
    assert np.array_equal(codes.numpy(), np.asarray(codes_j))
    _close(cb, cb_j, "codebook")
    _close(res.energy, res_j.energy, "energy", atol=0)
    assert res.n_rounds == res_j.n_rounds
    # the public function: reconstruction is codebook[codes]
    cb, codes, res = app.kv_codebook_hierarchical(_t(v), k, backend=backend,
                                                  n_groups=4)
    assert res.routers.shape == (4, 8) and cb.shape == (k, 8)
    e = float(torch.sum((_t(v) - cb[codes.long()]) ** 2))
    assert e == pytest.approx(float(res.energy), rel=1e-5)


def test_compress_kv_cache_from_reference_seeds():
    cache = _cache(b=2, t=40, hkv=2, hd=16, seed=4)
    valid = 32
    new_j, err_j = japp.compress_kv_cache(
        {n: jnp.asarray(a) for n, a in cache.items()}, 16, valid)
    stacked = np.stack([cache[n][:, :valid].reshape(-1, 16)
                        for n in ("k", "v")])
    c0s = _ref_c0s(stacked, 16)
    new, err = app._compress_kv_cache({n: _t(a) for n, a in cache.items()},
                                      16, valid, seeds=_t(c0s))
    assert err == pytest.approx(err_j, rel=1e-5)
    for n in ("k", "v"):
        _close(new[n], new_j[n], n)
        # past the valid prefix, the cache is untouched
        assert np.array_equal(new[n][:, valid:].numpy(), cache[n][:, valid:])
    # the public function: the dense engine's solve on its own seeds
    new, err = app.compress_kv_cache({n: _t(a) for n, a in cache.items()},
                                     16, valid)
    assert 0.0 < err < 1.0 and new["k"].shape == cache["k"].shape
    assert app.compress_kv_cache({}, 16, valid) == ({}, 0.0)


def test_compress_kv_cache_asymmetric_from_reference_seeds():
    """K and V of different head dims each solve alone."""
    rng = np.random.default_rng(5)
    cache = {"k": rng.normal(size=(1, 24, 2, 16)).astype(np.float32),
             "v": rng.normal(size=(1, 24, 2, 8)).astype(np.float32)}
    new_j, err_j = japp.compress_kv_cache(
        {n: jnp.asarray(a) for n, a in cache.items()}, 8, 24)
    seeds = {n: _t(jkmeanspp(jax.random.PRNGKey(0),
                             jnp.asarray(a.reshape(-1, a.shape[-1])), 8))
             for n, a in cache.items()}
    new, err = app._compress_kv_cache({n: _t(a) for n, a in cache.items()},
                                      8, 24, seeds=seeds)
    assert err == pytest.approx(err_j, rel=1e-5)
    for n in ("k", "v"):
        _close(new[n], new_j[n], n)


def test_embedding_codebook_from_reference_seeds():
    rng = np.random.default_rng(6)
    table = rng.normal(size=(600, 32)).astype(np.float32)
    cbs_j, codes_j, err_j = japp.embedding_codebook(jnp.asarray(table), 16,
                                                    n_subspaces=4)
    blocks = app._subspace_blocks(_t(table), 4)
    c0s = _ref_c0s(blocks.numpy(), 16)
    cbs, codes, err = app._embedding_from_seeds(blocks, _t(c0s), 60)
    assert np.array_equal(codes.numpy(), np.asarray(codes_j))
    _close(cbs, cbs_j, "codebooks")
    assert err == pytest.approx(err_j, rel=1e-5)
    cbs, codes, err = app.embedding_codebook(_t(table), 16, n_subspaces=4)
    assert cbs.shape == (4, 16, 8) and codes.shape == (600, 4)
    assert 0.0 < err < 1.0
    with pytest.raises(ValueError, match="n_subspaces"):
        app.embedding_codebook(_t(table), 16, n_subspaces=5)


def test_default_engines_are_the_references():
    """kv_codebook, compress_kv_cache and embedding_codebook pass no
    backend: the dense engine, whose result a dense solve from the same
    seeds reproduces bit for bit."""
    v = _t(_cache(seed=7)["k"].reshape(-1, 16))
    cb, codes, _ = app.kv_codebook(v, 8, key=1)
    c0 = app.kmeanspp_init(torch.Generator().manual_seed(1), v, 8)
    res = app.aa_kmeans(v, c0, app.KMeansConfig(k=8, max_iter=60),
                        backend=get_backend("dense"))
    assert torch.equal(cb, res.centroids) and torch.equal(codes, res.labels)
