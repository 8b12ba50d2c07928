"""The port's numerics core against the JAX package: Lloyd primitives,
the Anderson window, seeding, and the backends' step slots.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: integer outputs (labels, window sizes, heads) exact; f32
distances 2e-5 and sums 1e-4 (the reduction-order tolerances of
tests/test_kernels_v2.py); the Anderson solve 1e-5 relative (the same
unpivoted elimination in both, differing only in the gram's matmul
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import anderson as janderson
from repro.core import lloyd as jlloyd
from repro.core.backends import get_backend as jget_backend
from repro.core.init_schemes import kmeanspp_init as jkmeanspp
from repro_torch.core import anderson, lloyd
from repro_torch.core.backends import Precision, backend_names, get_backend
from repro_torch.core.init_schemes import (batched_init, kmeanspp_init,
                                           random_init)

torch.set_num_threads(2)


def _data(n=300, d=6, k=7, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d), dtype=np.float32),
            rng.standard_normal((k, d), dtype=np.float32))


# -- lloyd -------------------------------------------------------------------

def test_pairwise_sqdist_matches_jax_and_clamps():
    x, c = _data()
    c[0] = x[3]                              # an exact hit: 0 after clamp
    got = lloyd.pairwise_sqdist(torch.from_numpy(x), torch.from_numpy(c))
    want = jlloyd.pairwise_sqdist(jnp.asarray(x), jnp.asarray(c))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    assert float(got.min()) >= 0.0 and float(got[3, 0]) == 0.0


def test_assign_and_stats_match_jax():
    x, c = _data(seed=1)
    res = lloyd.assign(torch.from_numpy(x), torch.from_numpy(c))
    jres = jlloyd.assign(jnp.asarray(x), jnp.asarray(c))
    np.testing.assert_array_equal(res.labels.numpy(), np.asarray(jres.labels))
    w = np.random.default_rng(2).uniform(0, 2, x.shape[0]).astype(np.float32)
    sums, counts = lloyd.weighted_cluster_sums(
        torch.from_numpy(x), res.labels, torch.from_numpy(w), 7)
    jsums, jcounts = jlloyd.weighted_cluster_sums(
        jnp.asarray(x), jres.labels, jnp.asarray(w), 7)
    np.testing.assert_allclose(sums.numpy(), np.asarray(jsums), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(counts.numpy(), np.asarray(jcounts),
                               rtol=1e-5)
    usums, ucounts = lloyd.cluster_sums(torch.from_numpy(x), res.labels, 7)
    jusums, jucounts = jlloyd.cluster_sums(jnp.asarray(x), jres.labels, 7)
    np.testing.assert_allclose(usums.numpy(), np.asarray(jusums), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(ucounts.numpy(), np.asarray(jucounts))
    e = lloyd.energy(torch.from_numpy(x), torch.from_numpy(c), res.labels)
    je = jlloyd.energy(jnp.asarray(x), jnp.asarray(c), jres.labels)
    np.testing.assert_allclose(float(e), float(je), rtol=1e-5)


def test_update_from_sums_keeps_empty_clusters():
    sums = np.array([[2.0, 4.0], [0.0, 0.0], [3.0, 3.0]], np.float32)
    counts = np.array([2.0, 0.0, 3.0], np.float32)
    prev = np.array([[9.0, 9.0], [7.0, 8.0], [9.0, 9.0]], np.float32)
    got = lloyd.update_from_sums(*map(torch.from_numpy, (sums, counts, prev)))
    want = jlloyd.update_from_sums(*map(jnp.asarray, (sums, counts, prev)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[1].numpy(), [7.0, 8.0])


def test_stats_accumulate_in_at_least_f32():
    assert lloyd._accum_dtype(torch.bfloat16) == torch.float32
    assert lloyd._accum_dtype(torch.float64) == torch.float64


# -- anderson ----------------------------------------------------------------

# (e_curr, e_prev, e_prev2): growth, shrink, first iterations (inf), a zero
# previous decrease both ways, a rejected (increasing) energy
ENERGIES = [(10.0, 20.0, 40.0), (19.9, 20.0, 40.0), (10.0, 20.0, np.inf),
            (10.0, np.inf, np.inf), (10.0, 20.0, 20.0), (20.0, 20.0, 20.0),
            (25.0, 20.0, 40.0), (15.0, 20.0, 30.0)]


@pytest.mark.parametrize("dynamic_m", [True, False])
def test_adjust_m_matches_jax(dynamic_m):
    cfg = anderson.AAConfig(m0=2, mbar=3, dynamic_m=dynamic_m)
    jcfg = janderson.AAConfig(m0=2, mbar=3, dynamic_m=dynamic_m)
    e = np.array(ENERGIES, np.float32)
    for m0 in (0, 2, 3):
        st = anderson.aa_init(len(e), 4, cfg)._replace(
            m=torch.full((len(e),), m0, dtype=torch.int32))
        got = anderson.adjust_m(st, *(torch.from_numpy(e[:, i])
                                      for i in range(3)), cfg)
        for row, (ec, ep, ep2) in enumerate(e):
            jst = janderson.aa_init(4, jcfg)._replace(
                m=jnp.array(m0, jnp.int32))
            want = janderson.adjust_m(jst, jnp.float32(ec), jnp.float32(ep),
                                      jnp.float32(ep2), jcfg)
            assert int(got.m[row]) == int(want.m), (m0, ec, ep, ep2)


def _well_conditioned_systems(n_active):
    """Three (30, 30) systems: an SPD block on n_active columns, identity
    on the rest."""
    rng = np.random.default_rng(n_active)
    n = 30
    grams, rhss = [], []
    for _ in range(3):
        a = rng.standard_normal((n_active, 40))
        gram = np.eye(n)
        gram[:n_active, :n_active] = a @ a.T + 1e-3 * np.eye(n_active)
        grams.append(gram)
        rhss.append(rng.standard_normal(n))
    return np.array(grams, np.float32), np.array(rhss, np.float32)


def _rank_deficient_system(m_active, d_flat, seed=0, mbar=12):
    """One window system built as ``aa_push_and_solve`` builds it (active
    columns' normal equations, relative ridge 1e-12, identity on the
    inactive rest), the way tests/test_properties.py builds it.  With
    d_flat 1 the Gram block of m_active columns has rank 1 < m: the cases
    Hypothesis pinned against the reference's solve (seed 0), where the
    unpivoted elimination and linalg.solve part and either may give NaN;
    d_flat 4 and 11 are their full-rank neighbours.  The port must give
    the reference's bits, NaN included."""
    rng = np.random.default_rng(seed)
    d_f = rng.standard_normal((mbar, d_flat)).astype(np.float32)
    f = rng.standard_normal((d_flat,)).astype(np.float32)
    active = np.arange(mbar) < m_active
    a_mask = np.where(active[:, None], d_f, np.float32(0))
    gram = (jnp.asarray(a_mask) @ jnp.asarray(a_mask).T)
    rhs = jnp.asarray(a_mask) @ jnp.asarray(f)
    lam = 1e-12 * (jnp.trace(gram) + 1.0)
    eye = jnp.eye(mbar, dtype=jnp.float32)
    gram = jnp.where(jnp.asarray(active[:, None] & active[None, :]), gram,
                     0.0) + eye * jnp.where(jnp.asarray(active), lam, 1.0)
    return np.array(gram)[None], np.array(rhs)[None]


@pytest.mark.parametrize("case", [
    pytest.param(("well", 1), id="1"),
    pytest.param(("well", 5), id="5"),
    pytest.param(("well", 30), id="30"),
    *[pytest.param(("rank-deficient", m, d), id=f"rank-deficient-m{m}-d{d}")
      for m in (2, 3) for d in (1, 4, 11)]])
def test_spd_solve_matches_jax(case):
    """Well-conditioned systems within 1e-5 (the same elimination, the
    inputs' rounding apart); the rank-deficient ones bit for bit, NaN
    where the reference gives NaN."""
    if case[0] == "well":
        grams, rhss = _well_conditioned_systems(case[1])
    else:
        grams, rhss = _rank_deficient_system(*case[1:])
    got = anderson._spd_solve(torch.from_numpy(grams), torch.from_numpy(rhss))
    for i in range(grams.shape[0]):
        want = np.asarray(janderson._spd_solve(jnp.asarray(grams[i]),
                                               jnp.asarray(rhss[i])))
        if case[0] == "well":
            np.testing.assert_allclose(got[i].numpy(), want, rtol=1e-5,
                                       atol=1e-5)
        else:
            np.testing.assert_array_equal(got[i].numpy(), want)


def test_aa_push_and_solve_matches_jax():
    """Eight pushes into R = 2 windows of mbar = 4 (so the circular
    buffer wraps), with m moving; every state leaf and iterate compared."""
    r, dim = 2, 12
    cfg = anderson.AAConfig(m0=2, mbar=4)
    jcfg = janderson.AAConfig(m0=2, mbar=4)
    rng = np.random.default_rng(3)
    f0 = rng.standard_normal((r, dim)).astype(np.float32)
    g0 = rng.standard_normal((r, dim)).astype(np.float32)
    st = anderson.aa_seed(anderson.aa_init(r, dim, cfg),
                          torch.from_numpy(f0), torch.from_numpy(g0))
    jst = jax.vmap(lambda f, g: janderson.aa_seed(
        janderson.aa_init(dim, jcfg), f, g))(jnp.asarray(f0), jnp.asarray(g0))
    push = jax.vmap(lambda s, f, g: janderson.aa_push_and_solve(s, f, g,
                                                                jcfg))
    for step in range(8):
        m = np.array([step % 5, (step + 2) % 5], np.int32)
        st = st._replace(m=torch.from_numpy(m))
        jst = jst._replace(m=jnp.asarray(m))
        # a contracting sequence, as Lloyd's map gives near a fixed point
        f = (rng.standard_normal((r, dim)) * 0.7 ** step).astype(np.float32)
        g = (g0 + np.cumsum(f, axis=0)).astype(np.float32)
        st, c_next, theta, m_t = anderson.aa_push_and_solve(
            st, torch.from_numpy(f), torch.from_numpy(g), cfg)
        jst, jc_next, jtheta, jm_t = push(jst, jnp.asarray(f), jnp.asarray(g))
        np.testing.assert_array_equal(m_t.numpy(), np.asarray(jm_t))
        for name in ("ncols", "head", "m"):
            np.testing.assert_array_equal(getattr(st, name).numpy(),
                                          np.asarray(getattr(jst, name)))
        for name in ("dF", "dG", "f_prev", "g_prev"):
            np.testing.assert_allclose(getattr(st, name).numpy(),
                                       np.asarray(getattr(jst, name)),
                                       rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(theta.numpy(), np.asarray(jtheta),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(c_next.numpy(), np.asarray(jc_next),
                                   rtol=1e-5, atol=1e-5)


def test_push_leaves_the_input_state_unchanged():
    cfg = anderson.AAConfig(m0=2, mbar=3)
    st = anderson.aa_init(2, 5, cfg)
    snapshot = [t.clone() for t in st]
    anderson.aa_push_and_solve(st, torch.ones(2, 5), torch.ones(2, 5), cfg)
    assert all(torch.equal(a, b) for a, b in zip(st, snapshot))


# -- seeding -----------------------------------------------------------------

@pytest.mark.parametrize("fn", [random_init, kmeanspp_init])
@pytest.mark.parametrize("shape,k", [((10,), 2), ((10, 3), 0),
                                     ((10, 3), 11)])
def test_validate_seeding_errors_match_jax(fn, shape, k):
    x = np.zeros(shape, np.float32)
    with pytest.raises(ValueError) as got:
        fn(torch.Generator().manual_seed(0), torch.from_numpy(x), k)
    with pytest.raises(ValueError) as want:
        jkmeanspp(jax.random.PRNGKey(0), jnp.asarray(x), k)
    name = fn.__name__
    assert str(got.value) == str(want.value).replace("kmeanspp_init", name)


@pytest.mark.parametrize("fn", [random_init, kmeanspp_init])
def test_seeds_are_distinct_rows(fn):
    x, _ = _data(n=200, d=3, seed=4)
    c = fn(torch.Generator().manual_seed(0), torch.from_numpy(x), 12)
    rows = {tuple(r) for r in x.tolist()}
    assert c.shape == (12, 3)
    assert all(tuple(r) in rows for r in c.tolist())
    assert len({tuple(r) for r in c.tolist()}) == 12


@pytest.mark.parametrize("fn", [random_init, kmeanspp_init])
def test_weighted_seeding_never_picks_zero_weight_rows(fn):
    x, _ = _data(n=100, d=2, seed=5)
    w = np.zeros(100, np.float32)
    w[::4] = 1.0
    c = fn(torch.Generator().manual_seed(1), torch.from_numpy(x), 10,
           w=torch.from_numpy(w))
    live = {tuple(r) for r in x[::4].tolist()}
    assert all(tuple(r) in live for r in c.tolist())


def test_kmeanspp_spreads_seeds_like_jax():
    """D^2 sampling, statistically: on well-separated blobs K-Means++ puts
    one seed in (almost) every blob in both packages."""
    rng = np.random.default_rng(6)
    centers = rng.uniform(-50, 50, (8, 2))
    x = (centers[rng.integers(0, 8, 800)]
         + rng.standard_normal((800, 2))).astype(np.float32)

    def blobs_hit(c):
        return len(set(np.argmin(((c[:, None] - centers) ** 2).sum(-1), 1)))

    ours = [blobs_hit(kmeanspp_init(torch.Generator().manual_seed(s),
                                    torch.from_numpy(x), 8).numpy())
            for s in range(10)]
    theirs = [blobs_hit(np.asarray(jkmeanspp(jax.random.PRNGKey(s),
                                             jnp.asarray(x), 8)))
              for s in range(10)]
    assert np.mean(ours) >= 7.0 and np.mean(theirs) >= 7.0


def test_batched_init_shapes_and_reproducibility():
    x, _ = _data(n=150, d=4, seed=7)
    xt = torch.from_numpy(x)
    a = batched_init("kmeans++", torch.Generator().manual_seed(3), xt, 5, 3)
    b = batched_init("kmeans++", torch.Generator().manual_seed(3), xt, 5, 3)
    assert a.shape == (3, 5, 4) and torch.equal(a, b)
    per = batched_init("random", torch.Generator().manual_seed(3),
                       xt.expand(2, 150, 4), 5, 2,
                       weights=torch.ones(2, 150))
    assert per.shape == (2, 5, 4)
    with pytest.raises(ValueError):
        batched_init("no-such-scheme", torch.Generator(), xt, 5, 1)
    with pytest.raises(ValueError):
        batched_init("random", torch.Generator(), xt.expand(2, 150, 4), 5, 3)


# -- backends ----------------------------------------------------------------

def _check_step(got, want, weighted=False):
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.min_sqdist.numpy(),
                               np.asarray(want.min_sqdist), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(got.sums.numpy(), np.asarray(want.sums),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.counts.numpy(), np.asarray(want.counts),
                               rtol=1e-5 if weighted else 0, atol=1e-5)
    np.testing.assert_allclose(got.energy.numpy(), np.asarray(want.energy),
                               rtol=1e-5)


@pytest.mark.parametrize("name", ["dense", "fused"])
def test_step_slots_match_jax_dense(name):
    x, c = _data(n=257, d=9, k=11, seed=8)
    rng = np.random.default_rng(9)
    w = rng.uniform(0, 2, 257).astype(np.float32)
    cs = rng.standard_normal((3, 11, 9)).astype(np.float32)
    xs = rng.standard_normal((3, 257, 9)).astype(np.float32)
    ws = rng.uniform(0, 2, (3, 257)).astype(np.float32)
    bk, jbk = get_backend(name), jget_backend("dense")
    t, j = torch.from_numpy, jnp.asarray
    _check_step(bk.step(t(x), t(c), 11)[0], jbk.step(j(x), j(c), 11)[0])
    _check_step(bk.minibatch_step(t(x), t(c), 11, t(w))[0],
                jbk.minibatch_step(j(x), j(c), 11, j(w))[0], weighted=True)
    carries = ((),) * 3
    _check_step(bk.batched_step(t(x), t(cs), 11, ())[0],
                jbk.batched_step(j(x), j(cs), 11, carries)[0])
    _check_step(bk.batched_step(t(xs), t(cs), 11, (), w=t(ws))[0],
                jbk.batched_step(j(xs), j(cs), 11, carries, x_batched=True,
                                 w=j(ws))[0], weighted=True)
    lab = bk.assign(t(x), t(c)).labels
    np.testing.assert_array_equal(lab.numpy(),
                                  np.asarray(jbk.assign(j(x), j(c)).labels))


def test_registry_and_precision():
    assert backend_names() == (
        "blocked", "dense", "elkan", "elkan_reorder", "fused", "fused_bounds",
        "fused_bounds_reorder", "hamerly", "hamerly_reorder", "pallas",
        "yinyang", "yinyang_reorder")
    assert get_backend("fused") is get_backend("fused")
    with pytest.raises(KeyError):
        get_backend("no_such_engine")
    bf16 = Precision(compute=torch.bfloat16, accum=torch.bfloat16)
    assert bf16.compute_cast(torch.ones(2)).dtype == torch.bfloat16
    assert bf16.accum_dtype == torch.float32         # floored at f32
    assert Precision().compute_cast(torch.ones(2)).dtype == torch.float32
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Precision(compute=torch.float16)
