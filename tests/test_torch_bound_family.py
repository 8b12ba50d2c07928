"""The port's CPU bound engines (``hamerly``, ``elkan``, ``yinyang``), the
group-size policies and the Hamerly baseline against the JAX package's.

Inputs are numpy from a seed, handed to both packages; the reference
runs live.

* ``resolve_group_size`` with both policies equals the reference's for
  K in 1..300.
* One engine step from identical inputs (the reference's carry carried
  across, the same centroids) through the jump-and-revert move sequence
  of tests/test_bounds.py: labels exact, min_sqdist and the carry's
  bounds within 1e-5 relative (atol 1e-5: both sides' f32 matmuls), the
  BoundStats within 1e-6; the port's carry holds the bound invariants
  against f64 distances (slack 1e-3, as tests/test_bounds.py).
* elkan's labels equal the f32 oracle's on Hypothesis-drawn problems
  (tests/test_bounds.py:155); on two centroids whose squared distances
  sqrt maps to one value, every engine picks the nearer one, as Lloyd's
  assignment does (the reference's engines pick the first).
* Solves: ``aa_kmeans`` on each engine against the reference's: labels
  and counts exact, energies within rtol 1e-5; ``hamerly_kmeans`` against
  the reference's (labels and n_iter exact, mean_scan_fraction within
  1e-6) and against the port's ``lloyd_kmeans`` (labels exact); the
  traced driver reports BoundStats per iteration, none for ``dense``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypothesis_compat import given, settings, st
from repro.core import lloyd as jlloyd
from repro.core.backends import bounds as jbounds
from repro.core.backends import get_backend as jget_backend
from repro.core.hamerly import hamerly_kmeans as jhamerly_kmeans
from repro.core.kmeans import KMeansConfig as JKMeansConfig
from repro.core.kmeans import aa_kmeans as jaa_kmeans
from repro.core.kmeans import aa_kmeans_traced as jaa_kmeans_traced
from repro_torch.core import get_backend, hamerly_kmeans, lloyd, lloyd_kmeans
from repro_torch.core.backends import bounds
from repro_torch.core.kmeans import (KMeansConfig, aa_kmeans,
                                     aa_kmeans_traced)
from repro_torch.core.lloyd import pairwise_sqdist
from repro_torch.interop import _carry
from test_torch_driver import _assert_result_close, _problem, _t

torch.set_num_threads(2)

ATOL = 1e-3      # carry slack for f32 sqrt/drift round-off

# (engine, options) — elkan with finer groups than its one default group
ENGINES = [("hamerly", {}), ("elkan", {}), ("elkan", {"group_size": 4}),
           ("yinyang", {}), ("yinyang", {"group_size": 5})]
IDS = ["hamerly", "elkan", "elkan-gs4", "yinyang", "yinyang-gs5"]


def _policy(name):
    return "yinyang" if name == "yinyang" else "tile"


@pytest.mark.parametrize("policy", ["tile", "yinyang"])
@pytest.mark.parametrize("group_size", [None, 1, 3, 8, 24, 500])
def test_resolve_group_size_matches_jax(policy, group_size):
    for k in range(1, 301):
        assert bounds.resolve_group_size(k, group_size, policy) == \
            jbounds.resolve_group_size(k, group_size, policy), k


def test_resolve_group_size_rejects_unknown_policy():
    with pytest.raises(ValueError, match="policy"):
        bounds.resolve_group_size(10, None, "nope")


def _moves(x, c0, k, rng):
    """Centroids of each step: two Lloyd updates, an accepted-AA-like
    jump, an exact revert, then Lloyd (numpy, f64 means cast to f32)."""
    c, c_pre = c0, None
    for i in range(7):
        yield c
        if i == 2:
            c_pre = c
            c = c + rng.normal(size=c.shape).astype(np.float32)
        elif i == 3:
            c = c_pre
        else:
            lab = np.argmin(((x[:, None] - c[None]) ** 2).sum(-1), axis=1)
            c = np.stack([x[lab == j].mean(0) if (lab == j).any() else c[j]
                          for j in range(k)]).astype(np.float32)


def _check_invariants(name, carry, x, c, k, gs):
    labels, upper, lower = carry[0], carry[1], carry[2]
    d = torch.sqrt(pairwise_sqdist(x.double(), c.double()))
    d_a = d[torch.arange(d.shape[0]), labels.long()]
    assert bool((upper.double() >= d_a - ATOL).all()), f"{name}: upper"
    if lower.dim() == 1:                   # hamerly: the second-closest
        others = d.clone()
        others[torch.arange(d.shape[0]), labels.long()] = float("inf")
        assert bool((lower.double() <= others.min(1).values + ATOL).all())
    else:
        g, _ = bounds.group_layout(k, gs)
        assert bool((lower.double() <= bounds.group_min(d, g, gs)
                     + ATOL).all()), f"{name}: group lower bound"


@pytest.mark.parametrize("name,opts", ENGINES, ids=IDS)
def test_one_step_matches_jax(name, opts):
    """Each step of the move sequence from the reference's carry: the two
    steps agree, and the port's carry holds its bounds."""
    rng = np.random.default_rng(0)
    n, d, k = 257, 7, 13
    x = (rng.normal(size=(n, d)) * 3.0).astype(np.float32)
    c0 = rng.normal(size=(k, d)).astype(np.float32)
    jbk, bk = jget_backend(name, **opts), get_backend(name, **opts)
    gs = bounds.resolve_group_size(k, opts.get("group_size"),
                                   _policy(name))
    xt = torch.from_numpy(x)
    jcarry = jbk.init_carry(jnp.asarray(x), jnp.asarray(c0), k)
    port_init = bk.init_carry(xt, torch.from_numpy(c0), k)
    for got, want in zip(port_init[:4], jcarry[:4]):
        assert torch.equal(got, torch.from_numpy(np.array(want)))
    eliminated = []
    for c in _moves(x, c0, k, np.random.default_rng(42)):
        res, carry = bk.step(xt, torch.from_numpy(c), k,
                             _carry(jax.device_get(jcarry), "cpu"))
        jres, jcarry = jbk.step(jnp.asarray(x), jnp.asarray(c), k, jcarry)
        np.testing.assert_array_equal(res.labels.numpy(),
                                      np.asarray(jres.labels))
        np.testing.assert_array_equal(carry[0].numpy(),
                                      np.asarray(jcarry[0]))
        for got, want in ((res.min_sqdist, jres.min_sqdist),
                          (carry[1], jcarry[1]), (carry[2], jcarry[2])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(res.sums.numpy(), np.asarray(jres.sums),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(res.counts.numpy(),
                                      np.asarray(jres.counts))
        for got, want in zip(carry[4], jcarry[4]):
            np.testing.assert_allclose(float(got), float(want), atol=1e-6)
        _check_invariants(name, carry, xt, torch.from_numpy(c), k, gs)
        eliminated.append(float(carry[4].eliminated_frac))
    # the bounds settle some rows after the first step
    assert 0.0 < max(eliminated[1:]) <= 1.0


def test_hamerly_lower_is_per_row_and_group_family_per_group():
    x = torch.zeros(50, 3)
    c = torch.randn(12, 3, generator=torch.Generator().manual_seed(0))
    assert get_backend("hamerly").init_carry(x, c, 12)[2].shape == (50,)
    assert get_backend("elkan", group_size=5).init_carry(
        x, c, 12)[2].shape == (50, 3)
    # yinyang's default: t = ceil(12 / 10) = 2 groups of 6
    assert get_backend("yinyang").init_carry(x, c, 12)[2].shape == (50, 2)


# x = 0 and two centroids whose f32 squared distances, 2.2500005 and
# 2.2500002, are adjacent floats that sqrt maps to one value, 1.5000001;
# the farther one comes first
TIE_X = np.zeros((1, 2), np.float32)
TIE_C = np.array([[1.4256408214569092, 0.4664210081100464],
                  [-1.4377208948135376, 0.427736759185791]], np.float32)


@pytest.mark.parametrize("name", ["hamerly", "elkan", "yinyang"])
def test_argmin_is_taken_over_squared_distances(name):
    """The engines pick the nearer centroid, as both packages' Lloyd
    assignment does.  The reference's engines root the distances before
    the argmin and pick the first index of the tie (ROADMAP queue C)."""
    x, c = torch.from_numpy(TIE_X), torch.from_numpy(TIE_C)
    bk = get_backend(name)
    res, _ = bk.step(x, c, 2, bk.init_carry(x, c, 2))
    assert res.labels.tolist() == [1]
    assert torch.equal(res.labels, lloyd.assign(x, c).labels)
    jx, jc = jnp.asarray(TIE_X), jnp.asarray(TIE_C)
    assert np.asarray(jlloyd.assign(jx, jc).labels).tolist() == [1]
    jbk = jget_backend(name)
    jres, _ = jbk.step(jx, jc, 2, jbk.init_carry(jx, jc, 2))
    assert np.asarray(jres.labels).tolist() == [0]


@given(seed=st.integers(0, 2**16))
@settings(max_examples=15, deadline=None)
def test_elkan_labels_match_oracle_property(seed):
    """Hypothesis-drawn shapes and centroids: elkan's labels equal the f32
    oracle's through a jump, a revert and Lloyd steps."""
    rng = np.random.default_rng(seed)
    n, d, k = int(rng.integers(16, 200)), int(rng.integers(2, 12)), \
        int(rng.integers(2, 24))
    x = torch.from_numpy((rng.normal(size=(n, d)) * 2.0).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(k, d)).astype(np.float32))
    bk = get_backend("elkan", group_size=max(1, k // 3))
    carry = bk.init_carry(x, c, k)
    c_pre = c
    for step_i in range(4):
        res, carry = bk.step(x, c, k, carry)
        oracle = torch.argmin(pairwise_sqdist(x, c), dim=1).to(torch.int32)
        assert torch.equal(res.labels, oracle)
        if step_i == 0:
            c_pre = c
            c = c + 0.5 * torch.from_numpy(
                rng.normal(size=tuple(c.shape)).astype(np.float32))
        elif step_i == 1:
            c = c_pre
        else:
            c = bk.centroids_from_step(x, res, k, c)


@pytest.mark.parametrize("name,opts", ENGINES, ids=IDS)
def test_solve_matches_jax(name, opts):
    x, c0, k = _problem(n=1500, d=6, k=8, seed=1)
    cfg, jcfg = KMeansConfig(k=k, max_iter=60), JKMeansConfig(k=k,
                                                              max_iter=60)
    got = aa_kmeans(*_t(x, c0), cfg, backend=get_backend(name, **opts))
    want = jaa_kmeans(jnp.asarray(x), jnp.asarray(c0), jcfg,
                      backend=jget_backend(name, **opts))
    _assert_result_close(got, want)


@pytest.mark.parametrize("seed", [0, 3])
def test_hamerly_kmeans_matches_jax_and_lloyd(seed):
    x, c0, k = _problem(n=1200, d=5, k=9, seed=seed, spread=3.0)
    c, lab, e, n_iter, frac = hamerly_kmeans(*_t(x, c0), k, max_iter=80)
    jc, jlab, je, jn, jfrac = jhamerly_kmeans(jnp.asarray(x),
                                             jnp.asarray(c0), k, 80)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))
    assert n_iter == int(jn)
    np.testing.assert_allclose(float(frac), float(jfrac), atol=1e-6)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(e), float(je), rtol=1e-5)
    assert 0.0 < float(frac) < 1.0
    # the baseline's step i assigns at update i - 1's centroids, Lloyd's
    # iteration j at update j's: both converge on the same labels, the
    # baseline one step later
    _, llab, _, l_iter = lloyd_kmeans(*_t(x, c0), k, max_iter=80)
    assert l_iter < 80 and n_iter == l_iter + 1
    assert torch.equal(lab, llab)


@pytest.mark.parametrize("name", ["hamerly", "elkan", "yinyang", "dense"])
def test_traced_driver_reports_bound_stats(name):
    x, c0, k = _problem(n=200, d=5, k=8, seed=9)
    tr = aa_kmeans_traced(*_t(x, c0), KMeansConfig(k=k, max_iter=12),
                          backend=name)
    jtr = jaa_kmeans_traced(jnp.asarray(x), jnp.asarray(c0),
                            JKMeansConfig(k=k, max_iter=12), backend=name)
    assert tr.accepted == jtr.accepted
    if name == "dense":
        assert list(tr.bound_stats) == []
        return
    assert len(tr.bound_stats) == len(tr.energies)
    for rec, jrec in zip(tr.bound_stats, jtr.bound_stats):
        assert set(rec) == {"eliminated_frac", "skipped_frac"}
        for key in rec:
            np.testing.assert_allclose(rec[key], jrec[key], atol=1e-6)
    assert tr.bound_stats[-1]["eliminated_frac"] >= \
        tr.bound_stats[0]["eliminated_frac"]
