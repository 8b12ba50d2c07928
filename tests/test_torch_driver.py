"""The port's single-problem path against the JAX package's: the
drivers ``aa_kmeans`` / ``aa_kmeans_traced``, the Lloyd baseline
(``lloyd_kmeans``, ``lloyd_iteration``, ``LloydOps``), the Backend's
fallback slots and derived ops, ``from_lloyd_ops``, ``instrument`` and
``kernels.ops``.

Inputs are numpy from a seed, handed to both packages, with ``c0`` from
the reference's K-Means++ (its threefry draws cannot be matched).  The
port runs on the CPU, so its kernel engines run their plain versions;
the reference runs its Pallas engines in interpret mode (N <= 2000
there).  Tolerances: labels, iteration and acceptance counts, window
sizes and acceptance flags exact; centroids and energies within rtol
1e-5 (atol 1e-5 on centroids near 0), the reduction-order tolerance of
the port's other tests.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lloyd as jlloyd
from repro.core.anderson import AAConfig as JAAConfig
from repro.core.backends import get_backend as jget_backend
from repro.core.init_schemes import kmeanspp_init as jkmeanspp
from repro.core.kmeans import KMeansConfig as JKMeansConfig
from repro.core.kmeans import aa_kmeans as jaa_kmeans
from repro.core.kmeans import aa_kmeans_traced as jaa_kmeans_traced
from repro.core.kmeans import split_bound_phases as jsplit_bound_phases
from repro.data.synthetic import make_blobs, make_dataset
from repro.kernels import ops as jops
from repro_torch.core import AAConfig, get_backend, lloyd
from repro_torch.core.backends import from_lloyd_ops, instrument
from repro_torch.core.kmeans import (KMeansConfig, aa_kmeans,
                                     aa_kmeans_batched, aa_kmeans_traced,
                                     split_bound_phases)
from repro_torch.core.lloyd import (DENSE_OPS, LloydOps, lloyd_iteration,
                                    lloyd_kmeans)
from repro_torch.kernels import ops

torch.set_num_threads(2)

# (backend, options): "blocked" with a block that leaves a tail block
ENGINES = [("dense", {}), ("blocked", {"block_n": 512}), ("pallas", {}),
           ("fused", {})]


def _problem(n=2000, d=6, k=8, seed=0, spread=5.0):
    """(x, c0, k): blobs and the reference's K-Means++ seeds.  At seed 0
    the solve rejects 4 of 15 accelerated iterates; the blobs are far
    enough apart that the packages' reduction orders never flip an
    accept test (on overlapping blobs they do, and AA then amplifies the
    difference: tests/test_torch_kmeans.py)."""
    x = make_blobs(n, d, k, seed=seed, spread=spread)
    c0 = np.array(jkmeanspp(jax.random.PRNGKey(seed), jnp.asarray(x), k))
    return x, c0, k


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _assert_result_close(got, want, exact_iters=True):
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))
    if exact_iters:
        assert int(got.n_iter) == int(want.n_iter)
        assert int(got.n_accepted) == int(want.n_accepted)
        assert bool(got.converged) == bool(want.converged)
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(got.energy), float(want.energy),
                               rtol=1e-5)


# -- the single-problem drivers ----------------------------------------------

@pytest.mark.parametrize("name,opts", ENGINES,
                         ids=[e[0] for e in ENGINES])
def test_aa_kmeans_matches_jax(name, opts):
    x, c0, k = _problem()
    got = aa_kmeans(*_t(x, c0), KMeansConfig(k=k),
                    backend=get_backend(name, **opts))
    want = jaa_kmeans(jnp.asarray(x), jnp.asarray(c0), JKMeansConfig(k=k),
                      backend=jget_backend(name, **opts))
    assert 0 < int(got.n_accepted) < int(got.n_iter) - 1
    _assert_result_close(got, want)


@pytest.mark.parametrize("name", ["dense", "blocked", "fused",
                                  "fused_bounds"])
def test_aa_kmeans_is_the_batched_driver_at_r_1(name):
    x, c0, k = _problem(seed=1)
    xt, c0t = _t(x, c0)
    cfg = KMeansConfig(k=k)
    one = aa_kmeans(xt, c0t, cfg, backend=name)
    batched = aa_kmeans_batched(xt, c0t[None], cfg, backend=name)
    for a, b in zip(one, batched):
        assert torch.equal(a, b[0])


@pytest.mark.parametrize("name", ["dense", "blocked", "fused_bounds"])
def test_pass_count_matches_acceptance_trace(name):
    """One pass over X for the init, one per accepted iteration, two per
    rejected one, one that detects convergence; the blocked engine's
    batched slot is the per-restart fallback, counted once per pass."""
    x, c0, k = _problem()
    passes = []
    bk = instrument(get_backend(name), lambda: passes.append(1))
    tr = aa_kmeans_traced(*_t(x, c0), KMeansConfig(k=k, max_iter=300),
                          backend=bk)
    assert bool(tr.result.converged)
    assert len(passes) == 1 + sum(1 if a else 2 for a in tr.accepted) + 1
    assert not all(tr.accepted) and any(tr.accepted)


def test_instrument_keeps_unset_slots_unset():
    bk = instrument(get_backend("blocked"), lambda: None)
    assert bk.batched_step_fn is None and bk.minibatch_step_fn is not None
    assert bk.name == "blocked4096+count"


def _recording(name):
    """(port engine, reference engine, port steps, reference steps): the
    engines append every step's (centroids, labels, energy) as numpy
    (the reference's through an ordered debug callback, so a step under
    jit or inside lax.cond records when it runs)."""
    steps, jsteps = [], []
    bk, jbk = get_backend(name), jget_backend(name)

    def batched(x, cs, k, carries, w=None):
        res, carries = bk.batched_step_fn(x, cs, k, carries, w=w)
        steps.append((cs[0].numpy().copy(), res.labels[0].numpy().copy(),
                      float(res.energy[0])))
        return res, carries

    def jstep(x, c, k, carry):
        res, carry = jbk.step_fn(x, c, k, carry)
        jax.debug.callback(lambda *a: jsteps.append(
            (np.array(a[0]), np.array(a[1]), float(a[2]))),
            c, res.labels, res.energy, ordered=True)
        return res, carry

    return (dataclasses.replace(bk, batched_step_fn=batched),
            dataclasses.replace(jbk, step_fn=jstep), steps, jsteps)


def _iterates(steps, accepted, converged):
    """Each traced iterate's step: the last of its iteration (a reverted
    iterate takes two), counted from the end of ``steps``, before which
    only the driver's warm-up steps lie."""
    per = [1 if a else 2 for a in accepted]
    n = 1 + sum(per) + int(converged)
    assert len(steps) >= n
    run = steps[len(steps) - n:]
    return [run[i] for i in np.cumsum(per)]


def _f64_energy(x, c, labels):
    return float(np.sum((x.astype(np.float64)
                         - c.astype(np.float64)[labels]) ** 2))


def _traced_pair(name, dynamic, backends=None):
    """``backends``: (port engine, reference engine) in place of the
    registry's ``name``."""
    x, c0, k = _problem()
    cfg = KMeansConfig(k=k, aa=AAConfig(m0=2, dynamic_m=dynamic))
    jcfg = JKMeansConfig(k=k, aa=JAAConfig(m0=2, dynamic_m=dynamic))
    bk, jbk = backends or (name, name)
    got = aa_kmeans_traced(*_t(x, c0), cfg, backend=bk, warmup=True)
    want = jaa_kmeans_traced(jnp.asarray(x), jnp.asarray(c0), jcfg,
                             backend=jbk)
    assert got.m_values == want.m_values
    assert got.accepted == want.accepted
    assert not all(got.accepted)
    _assert_result_close(got.result, want.result)
    np.testing.assert_allclose(got.mse, want.mse, rtol=1e-5)
    assert got.wall_time_s > 0 and got.bound_stats == () \
        and got.bound_phases == {}
    # the traced loop is the untraced one
    plain = aa_kmeans(*_t(x, c0), cfg, backend=name)
    assert int(plain.n_iter) == int(got.result.n_iter)
    assert int(plain.n_accepted) == sum(got.accepted)
    return got, want


@pytest.mark.parametrize("name", ["dense", "fused"])
def test_traced_matches_jax(name):
    """The paper's dynamic m: every iteration's energy within 1e-5."""
    got, want = _traced_pair(name, True)
    np.testing.assert_allclose(got.energies, want.energies, rtol=1e-5)


@pytest.mark.parametrize("name", ["dense", "fused"])
def test_traced_fixed_m_matches_jax(name):
    """Fixed m = 2: the same windows and decisions, and every iteration's
    energy within 1e-5 of the exact (f64) energy of its own centroids and
    labels, on both sides; the reference's step on each of the port's
    iterates gives the port's labels and, within 1e-5, its energy.  The
    two trajectories' energies are not compared iterate by iterate: right
    after the window fills, its solve amplifies the stats' reduction-order
    difference into centroids up to 1.2e-4 apart (on fused, the
    reference's interpret-mode kernel against the port's plain version),
    whose exact energies differ by 1.10e-05 at one iterate."""
    x, _, k = _problem()
    bk, jbk, steps, jsteps = _recording(name)
    got, want = _traced_pair(name, False, backends=(bk, jbk))
    its = _iterates(steps, got.accepted, got.result.converged)
    jits = _iterates(jsteps, want.accepted, want.result.converged)
    assert len(jits) == len(want.energies) and len(jsteps) \
        == 1 + sum(1 if a else 2 for a in want.accepted) + 1
    for trace, iterates in ((got, its), (want, jits)):
        assert [e for _, _, e in iterates] == list(trace.energies)
        np.testing.assert_allclose(
            trace.energies, [_f64_energy(x, c, lab) for c, lab, _ in
                             iterates], rtol=1e-5)
    jref = jget_backend(name)
    jstep = jax.jit(jref.step, static_argnums=2)
    for c, lab, e in its:
        jc = jnp.asarray(c)
        res, _ = jstep(jnp.asarray(x), jc, k,
                       jref.init_carry(jnp.asarray(x), jc, k))
        np.testing.assert_array_equal(lab, np.asarray(res.labels))
        np.testing.assert_allclose(e, float(res.energy), rtol=1e-5)


def test_traced_bound_backend_reports_bound_stats():
    x, c0, k = _problem(n=1500, seed=4)
    got = aa_kmeans_traced(*_t(x, c0), KMeansConfig(k=k),
                           backend="fused_bounds")
    want = jaa_kmeans_traced(jnp.asarray(x), jnp.asarray(c0),
                             JKMeansConfig(k=k), backend="fused_bounds")
    assert got.accepted == want.accepted and got.m_values == want.m_values
    assert len(got.bound_stats) == len(got.energies) > 0
    assert all(set(b) == {"eliminated_frac", "skipped_frac"}
               and 0.0 <= b["skipped_frac"] <= 1.0 for b in got.bound_stats)
    assert got.bound_phases == split_bound_phases(got.accepted,
                                                  got.bound_stats)
    assert sum(p["n_iters"] for p in got.bound_phases.values()) \
        == len(got.energies)


@pytest.mark.parametrize("accepted,stats", [
    ([False, False, True, True, False], [0.0, 0.1, 0.5, 0.7, 0.6]),
    ([True, False], [0.2, 0.3]),
    ([False, False], [0.0, 0.0]),
    ([], [])])
def test_split_bound_phases_matches_jax(accepted, stats):
    rows = [{"eliminated_frac": s / 2, "skipped_frac": s} for s in stats]
    assert split_bound_phases(accepted, rows) == \
        jsplit_bound_phases(accepted, rows)


# -- the Lloyd baseline ------------------------------------------------------

@pytest.mark.parametrize("seed,max_iter", [(0, 500), (5, 500), (6, 3)])
def test_lloyd_kmeans_matches_jax(seed, max_iter):
    x, c0, k = _problem(seed=seed)
    c, labels, e, it = lloyd_kmeans(*_t(x, c0), k, max_iter)
    jc, jlabels, je, jit = jlloyd.lloyd_kmeans(jnp.asarray(x),
                                               jnp.asarray(c0), k, max_iter)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    assert it == int(jit)
    np.testing.assert_allclose(float(e), float(je), rtol=1e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5)


def test_lloyd_column_through_the_driver_is_lloyd():
    """The benches' same-engine Lloyd column: the driver with
    accelerated=False takes Lloyd's iterations to Lloyd's fixed point."""
    x, c0, k = _problem(seed=7)
    xt, c0t = _t(x, c0)
    c, labels, e, it = lloyd_kmeans(xt, c0t, k)
    res = aa_kmeans(xt, c0t, KMeansConfig(k=k, accelerated=False),
                    backend="fused")
    assert int(res.n_iter) == it
    assert torch.equal(res.labels, labels)
    np.testing.assert_allclose(res.centroids.numpy(), c.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("which", ["dense", "pallas"])
def test_lloyd_iteration_matches_jax(which):
    x, c0, k = _problem(n=1200, seed=8)
    ops_t = DENSE_OPS if which == "dense" else ops.pallas_lloyd_ops()
    ops_j = jlloyd.DENSE_OPS if which == "dense" else jops.pallas_lloyd_ops()
    c1, lab, e = lloyd_iteration(*_t(x, c0), k, ops=ops_t)
    jc1, jlab, je = jlloyd.lloyd_iteration(jnp.asarray(x), jnp.asarray(c0),
                                           k, ops=ops_j)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))
    np.testing.assert_allclose(c1.numpy(), np.asarray(jc1), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(e), float(je), rtol=1e-5)


def test_assign_blocks_match_the_whole():
    x, c0, _ = _problem(n=2048, seed=9)
    xt, ct = _t(x, c0)
    whole = lloyd.assign(xt, ct)
    for block_n in (256, 300):      # 300 does not divide N: unblocked
        part = lloyd.assign(xt, ct, block_n=block_n)
        assert torch.equal(part.labels, whole.labels)
        np.testing.assert_allclose(part.min_sqdist.numpy(),
                                   whole.min_sqdist.numpy(), rtol=1e-6)
    jpart = jlloyd.assign(jnp.asarray(x), jnp.asarray(c0), block_n=256)
    np.testing.assert_array_equal(whole.labels.numpy(),
                                  np.asarray(jpart.labels))


@pytest.mark.parametrize("cells", [1 << 24, 700])
def test_onehot_segment_sums_match_index_add(cells, monkeypatch):
    """The cluster stats' segment sum, one-hot matmuls over row chunks
    (700 cells: chunks of 100 rows at K = 7), against index_add_, within
    the stats' 1e-4."""
    monkeypatch.setattr(lloyd, "ONEHOT_CELLS", cells)
    x, _, cs, ws, k = _stack_problem()
    lab = lloyd.assign(x, cs[0]).labels
    sums, counts = lloyd.weighted_cluster_sums(x, lab, ws[0], k)
    want_s = torch.zeros(k, x.shape[1]).index_add_(0, lab.long(),
                                                   x * ws[0][:, None])
    want_n = torch.zeros(k).index_add_(0, lab.long(), ws[0])
    np.testing.assert_allclose(sums.numpy(), want_s.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(counts.numpy(), want_n.numpy(), rtol=1e-5)


# -- the Backend's fallbacks and derived ops ---------------------------------

def _stack_problem(r=3, n=1000, d=5, k=7, seed=10):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d), dtype=np.float32)
    xs = rng.standard_normal((r, n, d), dtype=np.float32)
    cs = rng.standard_normal((r, k, d), dtype=np.float32)
    ws = rng.uniform(0, 2, (r, n)).astype(np.float32)
    ws[:, :100] = 0.0
    return _t(x, xs, cs, ws) + [k]


def _assert_steps_equal(a, b):
    for name, u, v in zip(a._fields, a, b):
        assert torch.equal(u, v), name


@pytest.mark.parametrize("name", ["blocked", "fused_bounds"])
def test_batched_fallback_is_the_per_restart_step(name):
    """An engine without a batched slot runs ``step`` per restart and
    stacks the results and carries (a bound carry keeps its NamedTuple
    type); fused_bounds with its slot taken away equals its native
    batched step."""
    x, _, cs, _, k = _stack_problem()
    native = get_backend(name)
    bk = dataclasses.replace(native, batched_step_fn=None)
    carries = bk.batched_init_carry(x, cs, k)
    res, carries_out = bk.batched_step(x, cs, k, carries)
    for i in range(cs.shape[0]):
        want, carry_i = bk.step(x, cs[i], k, bk.init_carry(x, cs[i], k))
        _assert_steps_equal(type(res)(*(f[i] for f in res)), want)
        if name == "fused_bounds":
            assert type(carries_out[4]) is type(carry_i[4])
            for u, v in zip(carries_out[:4], carry_i[:4]):
                assert torch.equal(u[i], v)
    if name == "fused_bounds":
        res_n, _ = native.batched_step(x, cs, k, native.init_carry(x, cs, k))
        _assert_steps_equal(res, res_n)


def test_weighted_batched_fallback_is_the_per_problem_minibatch_step():
    _, xs, cs, ws, k = _stack_problem()
    bk = get_backend("blocked", block_n=256)
    res, _ = bk.batched_step(xs, cs, k, (), w=ws)
    for i in range(cs.shape[0]):
        want, _ = bk.minibatch_step(xs[i], cs[i], k, ws[i])
        _assert_steps_equal(type(res)(*(f[i] for f in res)), want)


def test_minibatch_fallback_matches_the_native_weighted_step():
    x, _, cs, ws, k = _stack_problem()
    dense = get_backend("dense")
    bk = dataclasses.replace(dense, minibatch_step_fn=None)
    got, _ = bk.minibatch_step(x, cs[0], k, ws[0])
    want, _ = dense.minibatch_step(x, cs[0], k, ws[0])
    assert torch.equal(got.labels, want.labels)
    for u, v in zip(got[1:], want[1:]):
        np.testing.assert_allclose(u.numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-5)
    jwant, _ = jget_backend("dense").minibatch_step(
        jnp.asarray(x.numpy()), jnp.asarray(cs[0].numpy()), k,
        jnp.asarray(ws[0].numpy()))
    np.testing.assert_allclose(float(got.energy), float(jwant.energy),
                               rtol=1e-5)


def test_energy_and_g_map_match_jax():
    x, c0, k = _problem(n=800, seed=11)
    xt, ct = _t(x, c0)
    jx, jc = jnp.asarray(x), jnp.asarray(c0)
    for name in ("dense", "blocked", "fused"):
        bk, jbk = get_backend(name), jget_backend(name)
        lab = bk.assign(xt, ct).labels
        np.testing.assert_allclose(
            float(bk.energy(xt, ct, lab)),
            float(jbk.energy(jx, jc, jnp.asarray(lab.numpy()))), rtol=1e-5)
        g, res = bk.g_map(xt, ct, k)
        jg, jres = jbk.g_map(jx, jc, k)
        np.testing.assert_array_equal(res.labels.numpy(),
                                      np.asarray(jres.labels))
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                                   atol=1e-5)
        assert bk.reduce_scalar(res.energy) is res.energy


@pytest.mark.parametrize("how", ["ops=", "backend=", "pallas ops"])
def test_from_lloyd_ops_runs_the_solvers(how):
    """A legacy LloydOps, as ``ops=`` or ``backend=``, gives the dense
    engine's solve; the adapter is memoised per container and the
    batched driver runs its unbatched functions row by row."""
    x, c0, k = _problem(seed=12)
    xt, c0t = _t(x, c0)
    cfg = KMeansConfig(k=k)
    legacy = ops.pallas_lloyd_ops() if how == "pallas ops" else \
        LloydOps(assign_fn=lloyd.assign)
    assert from_lloyd_ops(legacy) is from_lloyd_ops(legacy)
    assert from_lloyd_ops(legacy).name == "lloyd-ops-shim"
    got = aa_kmeans(xt, c0t, cfg, ops=legacy) if how == "ops=" else \
        aa_kmeans(xt, c0t, cfg, backend=legacy)
    want = aa_kmeans(xt, c0t, cfg, backend="dense")
    _assert_result_close(got, want)
    c0s = torch.stack([c0t, c0t.flip(0)])
    got_b = aa_kmeans_batched(xt, c0s, cfg, backend=from_lloyd_ops(legacy))
    want_b = aa_kmeans_batched(xt, c0s, cfg, backend="dense")
    assert torch.equal(got_b.labels, want_b.labels)
    assert torch.equal(got_b.n_iter, want_b.n_iter)
    np.testing.assert_allclose(got_b.energy.numpy(), want_b.energy.numpy(),
                               rtol=1e-5)


def test_default_ops_mean_the_dense_engine():
    from repro_torch.core.kmeans import resolve_backend
    assert resolve_backend(None, DENSE_OPS) is get_backend("dense")
    assert resolve_backend(None) is get_backend("dense")
    with pytest.raises(TypeError):
        resolve_backend(3)


def test_single_problem_shapes_are_checked():
    x, c0, k = _problem(n=200)
    xt, c0t = _t(x, c0)
    with pytest.raises(ValueError):
        aa_kmeans(xt, c0t[None], KMeansConfig(k=k))
    with pytest.raises(ValueError):
        aa_kmeans_traced(xt[None], c0t, KMeansConfig(k=k))


# -- kernels.ops ---------------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [True, False])
def test_kernel_ops_match_jax(use_pallas):
    x = make_dataset("Colorment", scale=0.01)
    rng = np.random.default_rng(13)
    c = x[rng.choice(x.shape[0], 9, replace=False)]
    w = rng.uniform(0, 2, x.shape[0]).astype(np.float32)
    xt, ct, wt = _t(x, c, w)
    jx, jc, jw = jnp.asarray(x), jnp.asarray(c), jnp.asarray(w)
    lab, mind = ops.assignment(xt, ct, use_pallas=use_pallas)
    jlab, jmind = jops.assignment(jx, jc, use_pallas=False)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))
    np.testing.assert_allclose(mind.numpy(), np.asarray(jmind), rtol=2e-5,
                               atol=2e-5)
    sums, counts = ops.cluster_update(xt, lab, 9, w=wt,
                                      use_pallas=use_pallas)
    jsums, jcounts = jops.cluster_update(jx, jlab, 9, w=jw,
                                         use_pallas=False)
    np.testing.assert_allclose(sums.numpy(), np.asarray(jsums), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(counts.numpy(), np.asarray(jcounts),
                               rtol=1e-5)
    step = ops.fused_lloyd_step(xt, ct, w=wt, use_pallas=use_pallas)
    jstep = jops.fused_lloyd_step(jx, jc, w=jw, use_pallas=False)
    np.testing.assert_array_equal(step[0].numpy(), np.asarray(jstep[0]))
    np.testing.assert_allclose(float(step[4]), float(jstep[4]), rtol=1e-5)
    c_next, lab2, e = ops.fused_step(xt, ct, use_pallas=use_pallas)
    jc_next, jlab2, je = jops.fused_step(jx, jc, use_pallas=False)
    np.testing.assert_array_equal(lab2.numpy(), np.asarray(jlab2))
    np.testing.assert_allclose(c_next.numpy(), np.asarray(jc_next),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(e), float(je), rtol=1e-5)
