"""The port's serving tier against the JAX package's: the cluster-closure
index (``serving/closure.py``), ``predict`` / ``transform(approx=)``,
``build_serving_index`` and the index's persistence on both estimators,
and ``KMeansServer`` (micro-batching, hot reload, ``serve_manifest``).

Inputs are numpy from a seed.  The port runs on the CPU; the reference
as its own tests run it.  The two packages' kmeans++ draws differ, so
fits are not compared: the port's estimators get the reference's
centroids through ``interop.estimator_from_arrays``, and the closure
functions the reference's own index arrays.

Tolerances: candidate tables, candidate lists, ``n_valid`` and labels
exact; routers built from the same first routers within 1e-5 (a few
Lloyd iterations on the codebook in another summation order); squared
distances within 1e-6 of |x|^2 + |c|^2, the scale at which the two
packages' f32 expansions |x|^2 - 2x.c + |c|^2 agree (they round the
cross term differently, so a small distance may differ far more than
1e-6 of itself); +inf at the same columns.  Inside the port, bucketed
and plain scans are equal bit for bit.
"""

import json
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.api import AAKMeans as JAAKMeans
from repro.core.api import MiniBatchAAKMeans as JMiniBatchAAKMeans
from repro.data.synthetic import make_blobs
from repro.serving import closure as jclosure
from repro.serving.server import serve_manifest as jserve_manifest
from repro_torch.core import AAKMeans, MiniBatchAAKMeans, NotFittedError
from repro_torch.interop import estimator_from_arrays, estimator_kwargs
from repro_torch.runtime.metrics import CollectMetrics
from repro_torch.serving import (ClosureIndex, KMeansServer, ServingModel,
                                 build_closure_index, candidate_table,
                                 closure_assign, closure_sqdist,
                                 default_n_candidates, default_n_groups,
                                 hierarchy_closure_index, serve_manifest)
from repro_torch.serving.closure import _build_from_routers

torch.set_num_threads(2)

K, D = 32, 8
TIMEOUT = 30


@pytest.fixture(scope="module")
def fitted():
    """The reference's blobs and its fitted centroids."""
    x = make_blobs(4000, D, K, seed=0, spread=6.0)
    jm = JAAKMeans(n_clusters=K, seed=1).fit(x)
    return x, np.asarray(jm.centroids_)


def _port(c, **params):
    """A fitted port AAKMeans on the CPU with the centroids ``c``."""
    return estimator_from_arrays({"n_clusters": c.shape[0], **params},
                                 {"centroids_": c}, device="cpu")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _port_index(jidx) -> ClosureIndex:
    return ClosureIndex(_t(jidx.routers), _t(jidx.candidates),
                        None if jidx.n_valid is None else _t(jidx.n_valid))


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(f"u{a.dtype.itemsize}") if a.dtype.kind == "f" else a


def _scale(x, c):
    """(N, K) |x|^2 + |c|^2 in f64."""
    x, c = np.asarray(x, np.float64), np.asarray(c, np.float64)
    return (x * x).sum(1)[:, None] + (c * c).sum(1)[None, :]


def _assert_sqdist_close(got, want, x, c):
    """(N, K) squared distances: +inf at the same columns, the finite
    ones within 1e-6 of |x|^2 + |c|^2."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    gap = np.abs(got[fin] - want[fin])
    assert np.all(gap <= 1e-6 * _scale(x, c)[fin])


def _assert_min_close(got, want, x, c, labels):
    """Per-row squared distances to ``labels`` within 1e-6 of
    |x|^2 + |c_label|^2."""
    scale = _scale(x, c)[np.arange(len(labels)), labels]
    gap = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.all(gap <= 1e-6 * scale), float((gap / scale).max())


# -- the closure functions against the reference's ----------------------------

# (bucketed, adaptive, shrink to)
_CLOSURE_CASES = {
    "plain": (False, False, None),
    "bucketed": (True, False, None),
    "shrunk": (False, False, 4),
    "adaptive": (False, True, None),
    "adaptive-bucketed": (True, True, None),
    "adaptive-shrunk": (True, True, 3),
}


@pytest.mark.parametrize("case", list(_CLOSURE_CASES))
def test_closure_functions_match_reference(fitted, case):
    """On the reference's own index: the table exact, labels exact,
    distances at the stated tolerance, +inf at the same columns; in the
    port the bucketed scan equals the plain one bit for bit."""
    bucketed, adaptive, shrink = _CLOSURE_CASES[case]
    x, c = fitted
    x = x[:1500]
    jidx = jclosure.build_closure_index(jnp.asarray(c), n_candidates=8,
                                        n_groups=6, adaptive=adaptive)
    if shrink:
        jidx = jidx.shrink(shrink)
    idx = _port_index(jidx)
    tc, tx = _t(c), _t(x)
    jtab = jclosure.candidate_table(jnp.asarray(c), jidx.candidates)
    tab = candidate_table(tc, idx.candidates)
    np.testing.assert_array_equal(_bits(tab), _bits(jtab))
    jl, jd = jclosure.closure_assign(jnp.asarray(x), jnp.asarray(c),
                                     jidx.routers, jidx.candidates, jtab,
                                     bucketed=bucketed, n_valid=jidx.n_valid)
    tl, td = closure_assign(tx, tc, idx.routers, idx.candidates, tab,
                            bucketed=bucketed, n_valid=idx.n_valid)
    assert tl.dtype == torch.int32
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    _assert_min_close(td, jd, x, c, tl.numpy())
    js = jclosure.closure_sqdist(jnp.asarray(x), jnp.asarray(c),
                                 jidx.routers, jidx.candidates, jtab,
                                 bucketed=bucketed, n_valid=jidx.n_valid)
    ts = closure_sqdist(tx, tc, idx.routers, idx.candidates, tab,
                        bucketed=bucketed, n_valid=idx.n_valid)
    _assert_sqdist_close(ts, js, x, c)
    # the other scan in the port: the same bits
    ol, od = closure_assign(tx, tc, idx.routers, idx.candidates, tab,
                            bucketed=not bucketed, n_valid=idx.n_valid)
    assert torch.equal(ol, tl) and torch.equal(_t(_bits(od)), _t(_bits(td)))
    os_ = closure_sqdist(tx, tc, idx.routers, idx.candidates, tab,
                         bucketed=not bucketed, n_valid=idx.n_valid)
    np.testing.assert_array_equal(_bits(os_), _bits(ts))


@pytest.mark.parametrize("n", [1, 7, 256, 1000])
def test_scan_rows_do_not_depend_on_the_batch(fitted, n):
    """A row's candidate distances have the same bits alone, in a short
    batch, at any position and in the whole 4000-row batch: the cross
    term is an elementwise product summed over d."""
    x, c = fitted
    model = _port(c).build_serving_index(n_candidates=16)
    idx = model.closure_index_
    tc, tx = _t(c), _t(x)
    tab = candidate_table(tc, idx.candidates)
    want = closure_sqdist(tx, tc, idx.routers, idx.candidates, tab)
    for off in (0, 333, 4000 - n):
        got = closure_sqdist(tx[off:off + n], tc, idx.routers,
                             idx.candidates, tab, bucketed=True)
        np.testing.assert_array_equal(_bits(got), _bits(want[off:off + n]))


# -- the build -------------------------------------------------------------------

# (n_candidates, n_groups, adaptive, seed)
_BUILD_CASES = {
    "uniform-defaults": (None, None, False, 0),
    "uniform-8x4": (8, 4, False, 3),
    "adaptive-12x4": (12, 4, True, 0),
    "adaptive-defaults": (None, None, True, 5),
}


@pytest.mark.parametrize("case", list(_BUILD_CASES))
def test_build_from_reference_first_routers(fitted, case):
    """From the reference's first routers (its jax.random draw, handed
    over): routers within 1e-5, candidate lists and n_valid equal."""
    n_cand, n_groups, adaptive, seed = _BUILD_CASES[case]
    _, c = fitted
    g = n_groups if n_groups is not None else default_n_groups(K)
    first = np.asarray(jax.random.choice(jax.random.PRNGKey(seed), K, (g,),
                                         replace=False))
    jidx = jclosure.build_closure_index(jnp.asarray(c), n_candidates=n_cand,
                                        n_groups=n_groups, seed=seed,
                                        adaptive=adaptive)
    idx = _build_from_routers(_t(c), _t(first), n_cand, n_iter=10,
                              adaptive=adaptive)
    np.testing.assert_allclose(idx.routers.numpy(), np.asarray(jidx.routers),
                               rtol=1e-5, atol=1e-5)
    assert idx.candidates.dtype == torch.int32
    np.testing.assert_array_equal(idx.candidates.numpy(),
                                  np.asarray(jidx.candidates))
    if adaptive:
        np.testing.assert_array_equal(idx.n_valid.numpy(),
                                      np.asarray(jidx.n_valid))
    else:
        assert idx.n_valid is None and jidx.n_valid is None


def test_build_draws_first_routers_from_a_cpu_generator(fitted):
    _, c = fitted
    idx = build_closure_index(_t(c), n_candidates=8, n_groups=5, seed=7)
    first = torch.randperm(K, generator=torch.Generator().manual_seed(7))[:5]
    again = _build_from_routers(_t(c), first, 8, n_iter=10, adaptive=False)
    assert torch.equal(idx.routers, again.routers)
    assert torch.equal(idx.candidates, again.candidates)
    assert (default_n_groups(1000), default_n_candidates(1000)) == (124, 512)
    assert (default_n_groups(K), default_n_candidates(K)) == \
        (jclosure.default_n_groups(K), jclosure.default_n_candidates(K))


def test_hierarchy_closure_index_matches_reference():
    """Equal candidate lists, ties (duplicated centroids) in the lower
    index first."""
    rng = np.random.default_rng(4)
    g, k_sub = 6, 6
    c = rng.standard_normal((g * k_sub, 5)).astype(np.float32)
    c[7] = c[9]                       # two equal distances in group 1
    c[30] = c[35]
    routers = c.reshape(g, k_sub, 5).mean(axis=1)
    off = np.arange(g + 1, dtype=np.int32) * k_sub
    jidx = jclosure.hierarchy_closure_index(jnp.asarray(c),
                                            jnp.asarray(routers),
                                            jnp.asarray(off))
    idx = hierarchy_closure_index(_t(c), _t(routers), _t(off))
    assert idx.candidates.dtype == torch.int32 and idx.n_valid is None
    np.testing.assert_array_equal(idx.candidates.numpy(),
                                  np.asarray(jidx.candidates))
    assert torch.equal(idx.routers, _t(routers))


def test_hierarchy_closure_index_refuses_mixed_strides():
    c = torch.zeros((10, 3))
    with pytest.raises(ValueError, match="mixed strides"):
        hierarchy_closure_index(c, torch.zeros((2, 3)),
                                torch.tensor([0, 4, 10], dtype=torch.int32))


# -- the reference's own tests, on the port -----------------------------------

def test_closure_index_recall_bounds(fitted):
    """C = K reproduces the exact labels; recall is monotone in C (prefix
    closures) and high at C = 8 of K = 32 on blobs."""
    x, c = fitted
    model = _port(c)
    exact = model.predict(x)
    model.build_serving_index(n_candidates=K)
    np.testing.assert_array_equal(model.predict(x, approx=True), exact)
    idx = model.closure_index_
    recalls = []
    for cc in (4, 8, 16, 32):
        small = idx.shrink(cc)
        labels, _ = closure_assign(_t(x), model.centroids_, small.routers,
                                   small.candidates)
        recalls.append(float(np.mean(labels.numpy() == exact)))
    assert recalls == sorted(recalls)
    assert recalls[1] >= 0.9
    cand = idx.candidates.numpy()
    assert cand.min() >= 0 and cand.max() < K


def test_closure_assign_distances_exact_for_hits(fitted):
    x, c = fitted
    model = _port(c).build_serving_index(n_candidates=16)
    idx = model.closure_index_
    labels, d2 = closure_assign(_t(x[:256]), model.centroids_, idx.routers,
                                idx.candidates)
    full = model.transform(x[:256]) ** 2
    hits = labels.numpy() == np.argmin(full, axis=1)
    assert hits.mean() > 0.8
    np.testing.assert_allclose(d2.numpy()[hits], full.min(axis=1)[hits],
                               rtol=1e-4, atol=1e-3)


def test_closure_transform_inf_off_candidates(fitted):
    x, c = fitted
    model = _port(c).build_serving_index(n_candidates=8)
    t = model.transform(x[:64], approx=True)
    assert t.shape == (64, K)
    finite = np.isfinite(t)
    assert (finite.sum(axis=1) <= 8).all() and (finite.sum(axis=1) >= 1).all()
    np.testing.assert_array_equal(np.argmin(t, axis=1),
                                  model.predict(x[:64], approx=True))


def test_index_roundtrips_through_save_load(fitted, tmp_path):
    x, c = fitted
    model = _port(c).build_serving_index(n_candidates=16)
    p = model.save(tmp_path / "m")
    loaded = AAKMeans.load(p, device="cpu")
    assert torch.equal(loaded.closure_routers_, model.closure_routers_)
    assert torch.equal(loaded.closure_candidates_, model.closure_candidates_)
    assert loaded.closure_candidates_.dtype == torch.int32
    np.testing.assert_array_equal(loaded.predict(x[:500], approx=True),
                                  model.predict(x[:500], approx=True))


def test_fit_builds_and_refit_invalidates_index():
    x = make_blobs(1200, 6, 8, seed=3, spread=5.0)
    m = AAKMeans(n_clusters=8, seed=0, serving_index=4, device="cpu").fit(x)
    assert m.closure_index_ is not None
    assert m.closure_index_.n_candidates == 4
    first = m.closure_routers_.clone()
    m.fit(x + 10.0)                     # refit: rebuilt, never stale
    assert m.closure_index_ is not None
    assert not torch.allclose(m.closure_routers_, first)
    m.serving_index = None
    m.fit(x)                            # no index asked for: none kept
    assert m.closure_index_ is None
    m = AAKMeans(n_clusters=8, serving_index=True, device="cpu").fit(x)
    assert m.closure_index_.n_candidates == default_n_candidates(8)


def test_adaptive_index_counts_and_label_validity(fitted):
    """Counts in [1, C]; every label comes from the nearest router's live
    prefix; distances finite."""
    x, c = fitted
    tc = _t(c)
    idx = build_closure_index(tc, n_candidates=8, n_groups=4, adaptive=True)
    n_valid = idx.n_valid.numpy()
    assert n_valid.shape == (4,)
    assert n_valid.min() >= 1 and n_valid.max() <= idx.candidates.shape[1]
    labels, d2 = closure_assign(_t(x), tc, idx.routers, idx.candidates,
                                n_valid=idx.n_valid)
    g = np.argmin(((x[:, None, :] - idx.routers.numpy()) ** 2).sum(-1),
                  axis=1)
    cand = idx.candidates.numpy()
    labels = labels.numpy()
    assert all(labels[i] in cand[g[i], :n_valid[g[i]]] for i in range(len(x)))
    assert torch.isfinite(d2).all()


def test_adaptive_shrink_clamps_and_uniform_contract_unchanged(fitted):
    x, c = fitted
    tc = _t(c)
    idx = build_closure_index(tc, n_candidates=8, n_groups=4, adaptive=True)
    small = idx.shrink(3)
    assert small.candidates.shape[1] == 3
    assert 1 <= int(small.n_valid.min()) and int(small.n_valid.max()) <= 3
    labels, _ = closure_assign(_t(x[:256]), tc, small.routers,
                               small.candidates, n_valid=small.n_valid)
    assert int(labels.min()) >= 0 and int(labels.max()) < K
    uni = build_closure_index(tc, n_candidates=8, n_groups=4)
    assert uni.n_valid is None and uni.shrink(3).n_valid is None


def test_adaptive_recall_tracks_uniform(fitted):
    x, c = fitted
    tc, tx = _t(c), _t(x)
    exact = _port(c).predict(x)
    uni = build_closure_index(tc, n_candidates=12, n_groups=4)
    ada = build_closure_index(tc, n_candidates=12, n_groups=4, adaptive=True)
    ru = np.mean(closure_assign(tx, tc, uni.routers, uni.candidates
                                )[0].numpy() == exact)
    ra = np.mean(closure_assign(tx, tc, ada.routers, ada.candidates,
                                n_valid=ada.n_valid)[0].numpy() == exact)
    assert ra >= ru - 0.1
    assert ra >= 0.7


def test_adaptive_sqdist_masked_columns_filled(fitted):
    x, c = fitted
    tc, tx = _t(c), _t(x[:64])
    ada = build_closure_index(tc, n_candidates=8, n_groups=4, adaptive=True)
    t = closure_sqdist(tx, tc, ada.routers, ada.candidates,
                       n_valid=ada.n_valid)
    finite = torch.isfinite(t).sum(dim=1)
    assert (finite >= 1).all() and (finite <= ada.candidates.shape[1]).all()
    labels, _ = closure_assign(tx, tc, ada.routers, ada.candidates,
                               n_valid=ada.n_valid)
    assert torch.equal(torch.argmin(t, dim=1).to(torch.int32), labels)
    t0 = closure_sqdist(tx, tc, ada.routers, ada.candidates, fill=0.0,
                        n_valid=ada.n_valid)
    assert torch.equal(torch.where(torch.isinf(t), 0.0, t), t0)


def test_legacy_artifact_without_index_falls_back(fitted, tmp_path):
    """approx=True on an index-less artifact serves the exact scan."""
    x, c = fitted
    p = _port(c).save(tmp_path / "legacy")
    loaded = AAKMeans.load(p, device="cpu")
    assert loaded.closure_index_ is None
    np.testing.assert_array_equal(loaded.predict(x[:300], approx=True),
                                  loaded.predict(x[:300]))
    np.testing.assert_array_equal(loaded.transform(x[:300], approx=True),
                                  loaded.transform(x[:300]))


def test_minibatch_estimator_serving_index(tmp_path):
    """The streaming estimator's index: C = K is exact, it survives
    save/load, and fit, partial_fit and finalize drop it."""
    x = make_blobs(3000, 6, 10, seed=5, spread=5.0)
    m = MiniBatchAAKMeans(n_clusters=10, chunk_size=512, epochs=2, seed=0,
                          device="cpu").fit(x)
    m.build_serving_index(n_candidates=10)
    exact = m.predict(x[:400])
    np.testing.assert_array_equal(m.predict(x[:400], approx=True), exact)
    loaded = MiniBatchAAKMeans.load(m.save(tmp_path / "mb"), device="cpu")
    assert loaded.closure_index_ is not None
    np.testing.assert_array_equal(loaded.predict(x[:400], approx=True),
                                  exact)
    m.fit(x)
    assert m.closure_index_ is None
    for step in (lambda: m.partial_fit(x[:1024]), m.finalize):
        m.build_serving_index(n_candidates=4)
        step()
        assert m.closure_index_ is None


def test_serving_model_requires_fitted():
    with pytest.raises(NotFittedError):
        ServingModel.from_estimator(AAKMeans(n_clusters=3, device="cpu"))


def test_server_padded_microbatch_parity(fitted):
    """Every request size, below, at and above the batch size, gets
    exactly the estimator's approx labels."""
    x, c = fitted
    model = _port(c).build_serving_index(n_candidates=16)
    want = model.predict(x, approx=True)
    sizes = [1, 7, 63, 64, 65, 200, 17]
    with KMeansServer(model, batch_size=64, flush_ms=1.0) as srv:
        futs, off = [], 0
        for s in sizes:
            futs.append((off, s, srv.submit(x[off:off + s])))
            off += s
        for start, s, f in futs:
            got = f.result(timeout=TIMEOUT)
            assert got.dtype == np.int32 and got.shape == (s,)
            np.testing.assert_array_equal(got, want[start:start + s])
        assert srv.n_requests == len(sizes)
    srv2 = KMeansServer(model, batch_size=8).start()
    try:
        assert srv2.submit(x[:0]).result(timeout=5).shape == (0,)
    finally:
        srv2.stop()
    assert srv2._worker_thread is None


def test_server_exact_fallback_without_index(fitted):
    x, c = fitted
    model = _port(c)
    with KMeansServer(model, batch_size=32) as srv:
        assert not srv._model.approx
        np.testing.assert_array_equal(srv.predict(x[:100], timeout=TIMEOUT),
                                      model.predict(x[:100]))


def test_server_builds_index_for_legacy_source(fitted, tmp_path):
    """n_candidates= builds an index for an index-less artifact."""
    x, c = fitted
    fresh = _port(c)
    p = fresh.save(tmp_path / "legacy")
    with KMeansServer(p, batch_size=32, n_candidates=K,
                      device="cpu") as srv:
        assert srv._model.approx
        np.testing.assert_array_equal(srv.predict(x[:100], timeout=TIMEOUT),
                                      fresh.predict(x[:100]))


def test_server_hot_reload_no_dropped_requests(tmp_path):
    """Swap the artifact under traffic: the watcher picks the new version
    up between batches, every request is answered, and answers after the
    swap are the new model's."""
    x = make_blobs(2000, 6, 8, seed=7, spread=6.0)
    m1 = AAKMeans(n_clusters=8, seed=0, serving_index=8,
                  device="cpu").fit(x)
    p = tmp_path / "model.npz"
    m1.save(p)
    errors, results = [], []
    stop = threading.Event()
    with KMeansServer(p, batch_size=32, poll_s=0.02, flush_ms=0.5,
                      device="cpu") as srv:
        v1 = srv.version

        def traffic():
            i = 0
            while not stop.is_set():
                try:
                    results.append(srv.predict(x[i % 1500:i % 1500 + 11],
                                               timeout=TIMEOUT))
                except Exception as e:     # noqa: BLE001 — recorded
                    errors.append(e)
                i += 17
        t = threading.Thread(target=traffic)
        t.start()
        try:
            time.sleep(0.1)
            m2 = AAKMeans(n_clusters=8, seed=3, init="random",
                          serving_index=8, device="cpu").fit(x * -1.0 + 5.0)
            m2.save(p)
            deadline = time.time() + 10
            while srv.reload_count == 0 and time.time() < deadline:
                time.sleep(0.02)
        finally:
            stop.set()
            t.join(timeout=TIMEOUT)
        assert not t.is_alive()
        assert srv.reload_count >= 1 and srv.version != v1
        assert not errors and results
        assert all(r.shape == (11,) for r in results)
        np.testing.assert_array_equal(srv.predict(x[:128], timeout=TIMEOUT),
                                      m2.predict(x[:128], approx=True))
        assert json.loads(serve_manifest(srv))["reload_count"] == 1


def _write_manifest(d, name, step):
    (d / "manifest.json").write_text(json.dumps(
        {"schema": "ckpt_manifest/v1", "latest": name,
         "snapshots": [{"file": name, "step": step}]}))


def test_server_reload_from_manifest_dir(fitted, tmp_path):
    """A directory source follows its writer manifest's ``latest``."""
    x, c = fitted
    d = tmp_path / "run"
    d.mkdir()
    model = _port(c).build_serving_index(n_candidates=16)
    model.save(d / "v1.npz")
    _write_manifest(d, "v1.npz", 1)
    with KMeansServer(d, batch_size=32, poll_s=0.02, device="cpu") as srv:
        np.testing.assert_array_equal(srv.predict(x[:64], timeout=TIMEOUT),
                                      model.predict(x[:64], approx=True))
        m2 = AAKMeans(n_clusters=K, seed=9, init="random", serving_index=16,
                      max_iter=20, device="cpu").fit(x + 2.0)
        m2.save(d / "v2.npz")
        _write_manifest(d, "v2.npz", 2)
        deadline = time.time() + 10
        while srv.reload_count == 0 and time.time() < deadline:
            time.sleep(0.02)
        assert srv.reload_count >= 1
        np.testing.assert_array_equal(srv.predict(x[:64], timeout=TIMEOUT),
                                      m2.predict(x[:64], approx=True))


def test_server_metrics_per_batch(fitted):
    x, c = fitted
    sink = CollectMetrics()
    with KMeansServer(_port(c), batch_size=16, metrics=sink) as srv:
        srv.predict(x[:40], timeout=TIMEOUT)   # 16 + 16 + 8: 8 padded
    assert sink.records, "no batch metrics emitted"
    rec = sink.records[0][1]
    assert {"serve_latency_s", "queue_depth", "batch_rows",
            "batch_requests", "padded_rows"} <= set(rec)
    assert sum(r["batch_rows"] for _, r in sink.records) == 40
    assert sum(r["padded_rows"] for _, r in sink.records) == 8


def test_closure_bucketed_parity(fitted):
    """The router-bucketed scan equals the plain one bit for bit."""
    x, c = fitted
    model = _port(c).build_serving_index(n_candidates=16)
    idx = model.closure_index_
    tc = model.centroids_
    tab = candidate_table(tc, idx.candidates)
    xq = _t(x[:512])
    l0, d0 = closure_assign(xq, tc, idx.routers, idx.candidates, tab)
    l1, d1 = closure_assign(xq, tc, idx.routers, idx.candidates, tab,
                            bucketed=True)
    assert torch.equal(l0, l1)
    np.testing.assert_array_equal(_bits(d0), _bits(d1))
    s0 = closure_sqdist(xq, tc, idx.routers, idx.candidates, tab)
    s1 = closure_sqdist(xq, tc, idx.routers, idx.candidates, tab,
                        bucketed=True)
    np.testing.assert_array_equal(_bits(s0), _bits(s1))


@pytest.mark.parametrize("approx", [False, True])
def test_server_transform_micro_batched(fitted, approx):
    """Transforms ride the same padded micro-batches as labels: equal to
    the model's own runner block by block, argmin-consistent with the
    labels, mixed ops served, empty requests op-shaped."""
    x, c = fitted
    model = _port(c).build_serving_index(n_candidates=16)
    with KMeansServer(model, batch_size=64, approx=approx,
                      flush_ms=1.0) as srv:
        q = x[:150]
        lab = srv.predict(q, timeout=TIMEOUT)
        dist = srv.transform(q, timeout=TIMEOUT)
        assert dist.shape == (150, K) and dist.dtype == np.float32
        direct = np.empty_like(dist)
        for i in range(0, 150, 64):
            xb = q[i:i + 64]
            m = xb.shape[0]
            if m < 64:
                xb = np.concatenate([xb, np.repeat(xb[-1:], 64 - m, axis=0)])
            direct[i:i + m] = srv._model.dists(xb)[:m]
        np.testing.assert_array_equal(_bits(dist), _bits(direct))
        np.testing.assert_array_equal(
            np.argmin(dist, axis=1).astype(np.int32), lab)
        f1 = srv.submit(q[:50], op="labels")
        f2 = srv.submit_transform(q[50:120])
        f3 = srv.submit(q[120:150])
        np.testing.assert_array_equal(f1.result(TIMEOUT), lab[:50])
        np.testing.assert_array_equal(_bits(f2.result(TIMEOUT)),
                                      _bits(dist[50:120]))
        np.testing.assert_array_equal(f3.result(TIMEOUT), lab[120:150])
        assert srv.submit(q[:0]).result(5).shape == (0,)
        assert srv.submit_transform(q[:0]).result(5).shape == (0, K)
        with pytest.raises(ValueError, match="op"):
            srv.submit(q[:4], op="energies")


def test_server_under_many_producers(fitted):
    """Eight producers with a short switch interval: every request gets
    its own rows' labels, and the counters add up."""
    x, c = fitted
    model = _port(c).build_serving_index(n_candidates=16)
    want = model.predict(x, approx=True)
    rng = np.random.default_rng(11)
    jobs = [[(int(s), int(n)) for s, n in zip(rng.integers(0, 3900, 25),
                                              rng.integers(1, 100, 25))]
            for _ in range(8)]
    bad = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with KMeansServer(model, batch_size=64, flush_ms=0.5,
                          max_queue=4) as srv:
            def produce(job):
                for s, n in job:
                    got = srv.predict(x[s:s + n], timeout=TIMEOUT)
                    if not np.array_equal(got, want[s:s + n]):
                        bad.append((s, n))
            threads = [threading.Thread(target=produce, args=(j,))
                       for j in jobs]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=TIMEOUT)
            assert not any(t.is_alive() for t in threads)
            assert srv.n_requests == 8 * 25
    finally:
        sys.setswitchinterval(old)
    assert not bad


def test_server_delivers_errors_per_request(fitted):
    """A batch that fails resolves each of its Futures with the error, and
    the server goes on serving."""
    x, c = fitted
    with KMeansServer(_port(c), batch_size=16) as srv:
        bad = srv.submit(np.zeros((3, D + 1), np.float32))
        with pytest.raises(RuntimeError):
            bad.result(timeout=TIMEOUT)
        assert srv.predict(x[:5], timeout=TIMEOUT).shape == (5,)


# -- across the packages ----------------------------------------------------------

def _reference_model(kind, x, c):
    """A reference estimator of ``kind`` with an index of 8 candidates."""
    if kind == "aa":
        jm = JAAKMeans(n_clusters=K, seed=1)
        jm.centroids_ = jnp.asarray(c)
    else:
        jm = JMiniBatchAAKMeans(n_clusters=K, chunk_size=512, epochs=1,
                                seed=0).fit(x[:2000])
    return jm.build_serving_index(n_candidates=8, n_groups=6)


@pytest.mark.parametrize("kind", ["aa", "mb"])
def test_reference_artifact_with_index_loads_in_the_port(fitted, tmp_path,
                                                         kind):
    x, c = fitted
    jm = _reference_model(kind, x, c)
    p = jm.save(tmp_path / "ref")
    cls = AAKMeans if kind == "aa" else MiniBatchAAKMeans
    tm = cls.load(p, device="cpu")
    np.testing.assert_array_equal(_bits(tm.closure_routers_),
                                  _bits(jm.closure_routers_))
    np.testing.assert_array_equal(tm.closure_candidates_.numpy(),
                                  np.asarray(jm.closure_candidates_))
    np.testing.assert_array_equal(tm.predict(x, approx=True),
                                  jm.predict(x, approx=True))
    _assert_sqdist_close(tm.transform(x[:300], approx=True) ** 2,
                         jm.transform(x[:300], approx=True) ** 2, x[:300],
                         np.asarray(jm.centroids_))
    if kind == "aa":     # the same state handed over as arrays
        ta = estimator_from_arrays(
            {"n_clusters": K}, {name: np.asarray(getattr(jm, name)) for name
                                in ("centroids_", "closure_routers_",
                                    "closure_candidates_")}, device="cpu")
        assert ta.closure_candidates_.dtype == torch.int32
        np.testing.assert_array_equal(ta.predict(x, approx=True),
                                      jm.predict(x, approx=True))


@pytest.mark.parametrize("kind", ["aa", "mb"])
def test_port_artifact_with_index_loads_in_the_reference(fitted, tmp_path,
                                                         kind):
    x, c = fitted
    if kind == "aa":
        tm = _port(c, serving_index=8).build_serving_index(n_candidates=8)
    else:
        tm = MiniBatchAAKMeans(n_clusters=K, chunk_size=512, epochs=1,
                               device="cpu").fit(x[:2000])
        tm.build_serving_index(n_candidates=8, n_groups=6)
    p = tm.save(tmp_path / "port")
    jm = (JAAKMeans if kind == "aa" else JMiniBatchAAKMeans).load(p)
    np.testing.assert_array_equal(_bits(jm.closure_routers_),
                                  _bits(tm.closure_routers_))
    np.testing.assert_array_equal(np.asarray(jm.closure_candidates_),
                                  tm.closure_candidates_.numpy())
    if kind == "aa":
        assert jm.serving_index == 8
    np.testing.assert_array_equal(jm.predict(x, approx=True),
                                  tm.predict(x, approx=True))


def test_server_hot_reloads_a_reference_artifact(fitted, tmp_path):
    """A port server watching a run directory swaps in an artifact the
    reference wrote and answers with the reference's approx labels."""
    x, c = fitted
    d = tmp_path / "run"
    d.mkdir()
    _port(c).build_serving_index(n_candidates=16).save(d / "v1.npz")
    _write_manifest(d, "v1.npz", 1)
    with KMeansServer(d, batch_size=64, poll_s=0.02, device="cpu") as srv:
        jm = JAAKMeans(n_clusters=K, seed=2, init="random",
                       max_iter=20).fit(x * 0.5 - 1.0)
        jm.build_serving_index(n_candidates=8)
        jm.save(d / "v2.npz")
        _write_manifest(d, "v2.npz", 2)
        deadline = time.time() + 10
        while srv.reload_count == 0 and time.time() < deadline:
            time.sleep(0.02)
        assert srv.reload_count == 1 and srv.last_reload_error is None
        assert srv._model.approx
        np.testing.assert_array_equal(srv.predict(x, timeout=TIMEOUT),
                                      jm.predict(x, approx=True))


def test_serve_manifest_has_the_reference_keys(fitted):
    """The reference's serve_manifest, run on the port's server, writes
    the same line."""
    x, c = fitted
    with KMeansServer(_port(c).build_serving_index(), batch_size=16) as srv:
        srv.predict(x[:20], timeout=TIMEOUT)
        line = serve_manifest(srv)
        assert line == jserve_manifest(srv)
    assert json.loads(line) == {
        "version": "estimator", "batch_size": 16, "approx": True,
        "n_batches": srv.n_batches, "n_requests": 1, "reload_count": 0}


def test_estimator_kwargs_keep_the_serving_index(fitted, tmp_path):
    """``serving_index`` crosses as a constructor field (no longer
    dropped); a loaded model rebuilds its index at its next fit."""
    x, c = fitted
    kw = estimator_kwargs(AAKMeans, {"n_clusters": 3, "serving_index": 4,
                                     "mesh": None, "hierarchical": False})
    assert kw["serving_index"] == 4 and "mesh" not in kw
    jm = JAAKMeans(n_clusters=8, max_iter=10, serving_index=True).fit(
        x[:1000])
    tm = AAKMeans.load(jm.save(tmp_path / "ref"), device="cpu")
    assert tm.serving_index is True
    assert tm.closure_index_ is not None      # the reference built one
    tm.fit(x[:1000])
    assert tm.closure_index_.n_candidates == default_n_candidates(8)
    with pytest.raises(ValueError, match="serving_index"):
        estimator_kwargs(MiniBatchAAKMeans, {"n_clusters": 3,
                                             "serving_index": 4})
