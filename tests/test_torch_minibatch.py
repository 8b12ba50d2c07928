"""The port's streaming mini-batch solver against the JAX package's:
``core/minibatch.py`` (one chunk step from a carried state, the guard,
the decayed-stats map, an epoch), the device-resident driver
``aa_kmeans_minibatch`` and the estimator ``MiniBatchAAKMeans``.

Inputs are numpy from a seed, handed to both packages, with ``c0`` from
the reference's K-Means++.  The port runs on the CPU, so its kernel
engines run their plain versions; the reference runs its Pallas engines
as its own tests do on the CPU (interpret mode).  A mid-stream state of
the reference crosses into the port through
``interop.minibatch_state_from_numpy``.

Tolerances: labels, accept decisions, window sizes and step counts
exact; centroids, running sums and counts, and energies within 1e-5
relative (the decayed update ``decay * S + s`` may be contracted into an
FMA by XLA where eager torch rounds twice, and the stats are summed in
another order).  The port against itself (prefetched against per-chunk
steps, a driver against its own composition, repeated fits) is bit for
bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backends as JB
from repro.core.init_schemes import kmeanspp_init as jkmeanspp
from repro.core.kmeans import aa_kmeans_minibatch as jaa_kmeans_minibatch
from repro.core.minibatch import MiniBatchConfig as JMiniBatchConfig
from repro.core.minibatch import _centroids_from_running as jcentroids
from repro.core.minibatch import guard_pick as jguard_pick
from repro.core.minibatch import minibatch_init as jminibatch_init
from repro.core.minibatch import minibatch_iteration as jminibatch_iteration
from repro.core.minibatch import run_epoch as jrun_epoch
from repro.data.streaming import chunk_dataset as jchunk_dataset
from repro.data.synthetic import make_blobs
from repro_torch.core import (MiniBatchAAKMeans, MiniBatchConfig,
                              NotFittedError, get_backend)
from repro_torch.core.kmeans import aa_kmeans_minibatch
from repro_torch.core.minibatch import (_centroids_from_running, guard_pick,
                                        minibatch_init, minibatch_iteration,
                                        run_epoch)
from repro_torch.data.streaming import chunk_dataset
from repro_torch.interop import minibatch_state_from_numpy

torch.set_num_threads(2)

K, D, B, V = 8, 8, 512, 256
RTOL = 1e-5
ENGINES = ("dense", "fused", "pallas")
# steps of the reference's dense trajectory (below) by what the guard
# decides there: the seed step, a clear rejection, a clear acceptance
SEED_STEP, REJECTED_STEP, ACCEPTED_STEP = 0, 3, 5


@pytest.fixture(scope="module")
def problem():
    """(x_train, x_val, c0, states): blobs split into train and
    validation rows, the reference's K-Means++ seeds, and the reference's
    dense states before each of its first seven chunk steps (numpy
    leaves).  At seed 0 the guard rejects steps 0-3 (0 and 1 are ties:
    c == c_au after the seed step) and accepts 4-6, step 3 by 1.2 % and
    step 5 by 0.18 % of the validation energy."""
    x = make_blobs(4000, D, K, seed=0, spread=3.0)
    x_val, x_train = x[:V], x[V:]
    c0 = np.array(jkmeanspp(jax.random.PRNGKey(0),
                            jnp.asarray(x_train[:2048]), K))
    cfg = JMiniBatchConfig(k=K, chunk_size=B)
    bk = JB.get_backend("dense")
    st = jminibatch_init(jnp.asarray(c0), cfg, bk)
    states = []
    for i in range(7):
        states.append(jax.device_get(st))
        st, _ = jminibatch_iteration(jnp.asarray(x_train[i * B:(i + 1) * B]),
                                     jnp.ones(B), jnp.asarray(x_val), st,
                                     cfg, bk)
    return x_train, x_val, c0, states


def _close(got: torch.Tensor, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=RTOL, err_msg=what)


def _assert_state_close(got, want):
    for f in ("c", "c_au", "sums", "counts", "e_prev", "e_prev2"):
        _close(getattr(got, f), getattr(want, f), f)
    assert got.t == int(want.t)
    assert int(got.n_acc) == int(want.n_acc)
    assert int(got.aa.m[0]) == int(want.aa.m)
    assert int(got.aa.ncols[0]) == int(want.aa.ncols)
    assert int(got.aa.head[0]) == int(want.aa.head)
    for f in ("dF", "dG", "f_prev", "g_prev"):
        _close(getattr(got.aa, f)[0], getattr(want.aa, f), f"aa.{f}")


def _assert_trace_close(got, want):
    np.testing.assert_array_equal(got.accepted.numpy(),
                                  np.asarray(want.accepted))
    for f in ("e_val", "e_cand", "e_fallback"):
        _close(getattr(got, f), getattr(want, f), f)


def _t(a):
    return torch.from_numpy(np.array(a))


# -- one chunk step ----------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("step", [SEED_STEP, REJECTED_STEP, ACCEPTED_STEP],
                         ids=["seed", "rejected", "accepted"])
def test_minibatch_iteration_matches_jax(problem, engine, step):
    x_train, x_val, _, states = problem
    xc = x_train[step * B:(step + 1) * B]
    jst, jtr = jminibatch_iteration(
        jnp.asarray(xc), jnp.ones(B), jnp.asarray(x_val),
        jax.tree_util.tree_map(jnp.asarray, states[step]),
        JMiniBatchConfig(k=K, chunk_size=B), JB.get_backend(engine))
    assert bool(jtr.accepted) == (step == ACCEPTED_STEP)
    pst, ptr = minibatch_iteration(
        _t(xc), torch.ones(B), _t(x_val),
        minibatch_state_from_numpy(states[step], device="cpu"),
        MiniBatchConfig(k=K, chunk_size=B), get_backend(engine))
    _assert_state_close(pst, jst)
    _assert_trace_close(ptr, jtr)


@pytest.mark.parametrize("engine", ("dense", "fused"))
def test_plain_minibatch_lloyd_step_matches_jax(problem, engine):
    """accelerated=False: one R = 1 pricing of c_au, never accepted, the
    window untouched."""
    x_train, x_val, c0, _ = problem
    jcfg = JMiniBatchConfig(k=K, chunk_size=B, accelerated=False)
    cfg = MiniBatchConfig(k=K, chunk_size=B, accelerated=False)
    jbk = JB.get_backend(engine)
    jst = jminibatch_init(jnp.asarray(c0), jcfg, jbk)
    pst = minibatch_init(_t(c0), cfg, get_backend(engine))
    for i in range(2):
        xc = x_train[i * B:(i + 1) * B]
        jst, jtr = jminibatch_iteration(jnp.asarray(xc), jnp.ones(B),
                                        jnp.asarray(x_val), jst, jcfg, jbk)
        pst, ptr = minibatch_iteration(_t(xc), torch.ones(B), _t(x_val),
                                       pst, cfg, get_backend(engine))
        _assert_state_close(pst, jst)
        _assert_trace_close(ptr, jtr)
        assert not bool(ptr.accepted)
        torch.testing.assert_close(pst.c, pst.c_au, rtol=0, atol=0)


@pytest.mark.parametrize("engine", ENGINES)
def test_guard_pick_matches_jax(problem, engine):
    """The R = 2 guard at a state where the candidate wins and at one
    where the fallback does."""
    _, x_val, _, states = problem
    cfg = JMiniBatchConfig(k=K, chunk_size=B)
    for step in (REJECTED_STEP, ACCEPTED_STEP):
        jc, je, jacc, (jec, jeau) = jguard_pick(
            jnp.asarray(x_val),
            jax.tree_util.tree_map(jnp.asarray, states[step]), cfg,
            JB.get_backend(engine))
        pc, pe, pacc, (pec, peau) = guard_pick(
            _t(x_val), minibatch_state_from_numpy(states[step], device="cpu"),
            MiniBatchConfig(k=K, chunk_size=B), get_backend(engine))
        assert bool(pacc) == bool(jacc) == (step == ACCEPTED_STEP)
        _close(pc, jc, "kept centroids")
        for got, want in ((pe, je), (pec, jec), (peau, jeau)):
            _close(got, want, "energy")


def test_centroids_from_running_decayed_and_unseen():
    """Decayed weights below 1 divide exactly; a cluster never seen
    (W = 0) and one below eps keep their previous centroid."""
    rng = np.random.default_rng(3)
    sums = rng.normal(size=(5, 4)).astype(np.float32)
    counts = np.float32([0.3, 0.0, 2.5, 1e-7, 0.9 ** 40])
    sums[1] = 0.0
    c_prev = rng.normal(size=(5, 4)).astype(np.float32)
    got = _centroids_from_running(_t(sums), _t(counts), _t(c_prev))
    want = jcentroids(jnp.asarray(sums), jnp.asarray(counts),
                      jnp.asarray(c_prev))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_array_equal(got.numpy()[[1, 3]], c_prev[[1, 3]])
    np.testing.assert_allclose(got.numpy()[0], sums[0] / np.float32(0.3),
                               rtol=1e-6)


def test_decayed_stats_keep_unseen_clusters_fixed():
    """A cluster no chunk touches holds its centroid exactly through
    eight steps of decay 0.5 (the reference's own regression)."""
    k, d = 4, 3
    cfg = MiniBatchConfig(k=k, chunk_size=32, decay=0.5)
    c0 = torch.tensor([[0, 0, 0], [10, 0, 0], [0, 10, 0], [50, 50, 50]],
                      dtype=torch.float32)
    rng = np.random.default_rng(0)
    xv = _t(rng.normal(0, 0.1, (16, d)).astype(np.float32))
    bk = get_backend("dense")
    state = minibatch_init(c0, cfg, bk)
    for _ in range(8):
        xc = np.concatenate([rng.normal(0, .1, (10, d)),
                             rng.normal([10, 0, 0], .1, (11, d)),
                             rng.normal([0, 10, 0], .1, (11, d))])
        state, _ = minibatch_iteration(_t(xc.astype(np.float32)),
                                       torch.ones(32), xv, state, cfg, bk)
        np.testing.assert_array_equal(state.c_au[3].numpy(),
                                      np.float32([50, 50, 50]))


# -- padding -------------------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
def test_padded_chunk_step_matches_jax_and_truncated(problem, engine):
    """The padded tail chunk (copies of the last row at weight 0) through
    ``minibatch_step``: labels exact and the rest at 1e-5 against the
    reference; against the truncated chunk at unit weights, the real
    rows' labels and distances equal bit for bit, stats and energy
    within 1e-6."""
    x_train, _, c0, _ = problem
    dc = chunk_dataset(_t(x_train), B)
    jdc = jchunk_dataset(jnp.asarray(x_train), B)
    m = dc.n - (dc.chunks.shape[0] - 1) * B
    assert 0 < m < B
    xc, w = dc.chunks[-1], dc.weights[-1]
    bk = get_backend(engine)
    got, _ = bk.minibatch_step(xc, _t(c0), K, w, ())
    want, _ = JB.get_backend(engine).minibatch_step(
        jdc.chunks[-1], jnp.asarray(c0), K, jdc.weights[-1], ())
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    for f in ("min_sqdist", "sums", "counts", "energy"):
        _close(getattr(got, f), getattr(want, f), f)
    trunc, _ = bk.minibatch_step(xc[:m].contiguous(), _t(c0), K,
                                 torch.ones(m), ())
    assert torch.equal(got.labels[:m], trunc.labels)
    assert torch.equal(got.min_sqdist[:m], trunc.min_sqdist)
    for f in ("sums", "counts", "energy"):
        torch.testing.assert_close(getattr(got, f), getattr(trunc, f),
                                   rtol=1e-6, atol=1e-6)


# -- epochs and the driver -----------------------------------------------------

@pytest.mark.parametrize("engine", ("dense", "fused"))
def test_run_epoch_with_the_reference_permutation(problem, engine):
    x_train, x_val, c0, _ = problem
    jcfg = JMiniBatchConfig(k=K, chunk_size=B)
    jbk = JB.get_backend(engine)
    jdc = jchunk_dataset(jnp.asarray(x_train), B)
    key = jax.random.PRNGKey(11)
    jst, jtr = jrun_epoch(jdc.chunks, jdc.weights, jnp.asarray(x_val),
                          jminibatch_init(jnp.asarray(c0), jcfg, jbk), jcfg,
                          jbk, key)
    perm = np.asarray(jax.random.permutation(key, jdc.chunks.shape[0]))
    cfg = MiniBatchConfig(k=K, chunk_size=B)
    bk = get_backend(engine)
    dc = chunk_dataset(_t(x_train), B)
    pst, ptr = run_epoch(dc.chunks, dc.weights, _t(x_val),
                         minibatch_init(_t(c0), cfg, bk), cfg, bk, perm)
    assert ptr.accepted.shape == (dc.chunks.shape[0],)
    _assert_state_close(pst, jst)
    _assert_trace_close(ptr, jtr)


def test_aa_kmeans_minibatch_two_epochs_matches_jax(problem):
    """The reference's driver against the port's run_epoch composed with
    the reference's per-epoch permutations (its key-split sequence
    redone here); the port's driver against its own composition from its
    generator, bit for bit."""
    x_train, x_val, c0, _ = problem
    jcfg = JMiniBatchConfig(k=K, chunk_size=B, epochs=2)
    jdc = jchunk_dataset(jnp.asarray(x_train), B)
    key = jax.random.PRNGKey(5)
    jres, jtr = jaa_kmeans_minibatch(jdc.chunks, jdc.weights,
                                     jnp.asarray(x_val), jnp.asarray(c0),
                                     jcfg, backend="dense", key=key,
                                     return_trace=True)
    cfg = MiniBatchConfig(k=K, chunk_size=B, epochs=2)
    bk = get_backend("dense")
    dc = chunk_dataset(_t(x_train), B)
    xv = _t(x_val)
    state = minibatch_init(_t(c0), cfg, bk)
    k2 = key
    accepted = []
    for _ in range(cfg.epochs):
        k2, sub = jax.random.split(k2)
        perm = np.asarray(jax.random.permutation(sub, dc.chunks.shape[0]))
        state, tr = run_epoch(dc.chunks, dc.weights, xv, state, cfg, bk,
                              perm)
        accepted.append(tr.accepted.numpy())
    c_fin, e_fin, _, _ = guard_pick(xv, state, cfg, bk)
    np.testing.assert_array_equal(np.stack(accepted),
                                  np.asarray(jtr.accepted))
    _close(c_fin, jres.centroids, "centroids")
    _close(e_fin, jres.energy, "energy")
    assert state.t == int(jres.n_steps) == 2 * dc.chunks.shape[0]
    assert int(state.n_acc) == int(jres.n_accepted)

    res, tr = aa_kmeans_minibatch(
        dc.chunks, dc.weights, xv, _t(c0), cfg, backend=bk,
        generator=torch.Generator().manual_seed(7), return_trace=True,
        device="cpu")
    assert tr.accepted.shape == (2, dc.chunks.shape[0])
    gen = torch.Generator().manual_seed(7)
    state = minibatch_init(_t(c0), cfg, bk)
    for _ in range(cfg.epochs):
        perm = torch.randperm(dc.chunks.shape[0], generator=gen)
        state, _ = run_epoch(dc.chunks, dc.weights, xv, state, cfg, bk, perm)
    c_own, e_own, _, _ = guard_pick(xv, state, cfg, bk)
    assert torch.equal(res.centroids, c_own) and torch.equal(res.energy,
                                                             e_own)
    assert res.n_steps == state.t and torch.equal(res.n_accepted,
                                                  state.n_acc)


def test_aa_kmeans_minibatch_validates_its_inputs(problem):
    x_train, x_val, c0, _ = problem
    dc = chunk_dataset(_t(x_train), B)
    cfg = MiniBatchConfig(k=K, chunk_size=B, epochs=1)
    with pytest.raises(ValueError, match="n_chunks, B, d"):
        aa_kmeans_minibatch(dc.chunks[0], dc.weights, _t(x_val), _t(c0),
                            cfg, device="cpu")
    with pytest.raises(ValueError, match="weights"):
        aa_kmeans_minibatch(dc.chunks, dc.weights[:, :-1], _t(x_val),
                            _t(c0), cfg, device="cpu")


# -- the estimator -------------------------------------------------------------

def _estimator(**kw):
    opts = dict(n_clusters=K, chunk_size=B, epochs=2, val_size=V, seed=0,
                device="cpu")
    opts.update(kw)
    return MiniBatchAAKMeans(**opts)


@pytest.mark.parametrize("engine", ("dense", "fused"))
def test_estimator_fit_is_its_driver_and_labels_its_predict(problem, engine):
    x = np.concatenate([problem[1], problem[0]])
    m = _estimator(backend=engine).fit(x)
    n_chunks = -(-(x.shape[0] - V) // B)
    assert m.n_steps_ == 2 * n_chunks
    assert isinstance(m.energy_, float) and m.energy_ == m.inertia_ > 0
    assert m.centroids_.shape == (K, D)
    np.testing.assert_array_equal(m.labels_, m.predict(x, chunk_size=1111))
    assert m.labels_.dtype == np.int32 and m.labels_.shape == (x.shape[0],)
    assert m.transform(x[:100]).shape == (100, K)
    # the fit is aa_kmeans_minibatch on fit_inputs, bit for bit
    inp = m.fit_inputs(x)
    res = aa_kmeans_minibatch(inp.chunks.chunks, inp.chunks.weights,
                              inp.x_val, inp.c0, m._config(),
                              backend=engine, generator=inp.generator,
                              device="cpu")
    assert torch.equal(res.centroids, m.centroids_)
    assert float(res.energy) == m.energy_
    assert int(res.n_accepted) == m.n_accepted_


def test_estimator_fit_is_deterministic(problem):
    x = problem[0]
    a = _estimator().fit(x)
    b = _estimator().fit(x)
    c = _estimator(seed=1).fit(x)
    assert torch.equal(a.centroids_, b.centroids_)
    assert a.energy_ == b.energy_ and a.n_accepted_ == b.n_accepted_
    np.testing.assert_array_equal(a.labels_, b.labels_)
    assert not torch.equal(a.centroids_, c.centroids_)


def _host_chunks(x, n=4, rows=600):
    return [x[i * rows:(i + 1) * rows] for i in range(n)]


@pytest.mark.parametrize("prefetch", (1, 2))
def test_partial_fit_stream_equals_partial_fit_per_chunk(problem, prefetch):
    chunks = _host_chunks(problem[0])
    a = _estimator(backend="fused")
    for ch in chunks:
        a.partial_fit(ch)
    b = _estimator(backend="fused").partial_fit_stream(iter(chunks),
                                                       prefetch=prefetch)
    assert a.n_steps_ == b.n_steps_ == len(chunks)
    assert torch.equal(a.centroids_, b.centroids_)
    assert torch.equal(a.energy_, b.energy_)
    assert torch.equal(a.n_accepted_, b.n_accepted_)
    for f in ("c", "sums", "counts", "e_prev"):
        assert torch.equal(getattr(a._state, f), getattr(b._state, f)), f
    assert torch.equal(a._x_val, b._x_val)


def test_partial_fit_then_finalize(problem):
    """During the stream centroids_ is the fallback; finalize applies the
    guard: the kept iterate's validation energy is the lower of the
    two."""
    m = _estimator()
    for ch in _host_chunks(problem[0]):
        m.partial_fit(ch)
    # the first chunk's 600 rows give min(val_size, 600 // 4) of them
    assert m._x_val.shape == (150, D)
    assert torch.equal(m.centroids_, m._state.c_au)
    assert isinstance(m.energy_, torch.Tensor)
    m.finalize()
    assert isinstance(m.energy_, float)
    bk = get_backend("dense")
    e = [float(bk.step(m._x_val, c, K)[0].energy)
         for c in (m._state.c, m._state.c_au)]
    assert m.energy_ == pytest.approx(min(e), rel=1e-6)
    assert m.predict(problem[0][:50]).shape == (50,)


def test_first_partial_fit_chunk_must_seed(problem):
    m = _estimator()
    with pytest.raises(ValueError, match=r"must have >= 16 rows"):
        m.partial_fit(problem[0][:10])
    with pytest.raises(ValueError, match="call partial_fit first"):
        m.finalize()
    with pytest.raises(NotFittedError):
        m.predict(problem[0][:10])
    with pytest.raises(ValueError, match="need at least 16 rows"):
        m.fit(problem[0][:10])


def test_fit_supersedes_a_partial_fit_stream(problem):
    x = problem[0]
    m = _estimator()
    m.partial_fit(x[:600])
    m.fit(x)
    assert m._state is None and m._x_val is None
    with pytest.raises(ValueError, match="call partial_fit first"):
        m.finalize()
    ref = _estimator().fit(x)
    assert torch.equal(m.centroids_, ref.centroids_)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(problem,
                                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x_train, x_val, c0, _ = problem
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MiniBatchAAKMeans(n_clusters=K).fit(x_train)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MiniBatchAAKMeans(n_clusters=K).partial_fit(x_train[:600])
    dc = chunk_dataset(_t(x_train), B)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        aa_kmeans_minibatch(dc.chunks, dc.weights, _t(x_val), _t(c0),
                            MiniBatchConfig(k=K, chunk_size=B))


def test_config_fields_mirror_the_reference():
    """The estimator's parameters are the reference's, the mesh ones
    included, plus ``device``."""
    from repro.core.api import MiniBatchAAKMeans as JMiniBatchAAKMeans
    params = {f.name for f in dataclasses.fields(MiniBatchAAKMeans)
              if not f.name.endswith("_") and not f.name.startswith("_")}
    jparams = {f.name for f in dataclasses.fields(JMiniBatchAAKMeans)
               if not f.name.endswith("_") and not f.name.startswith("_")}
    assert params == jparams | {"device"}
    assert {f.name for f in dataclasses.fields(MiniBatchConfig)} == \
        {f.name for f in dataclasses.fields(JMiniBatchConfig)}
