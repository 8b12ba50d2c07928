"""The port's two-level solve (``core/hierarchy.py``), per-group
``select_best`` and ``AAKMeans(hierarchical=)`` against the JAX
package's, and against themselves.

Inputs are numpy from a seed (the reference's smooth-density manifold,
the k²-means regime).  The port runs on the CPU (its kernel engines run
their plain versions); the reference on its dense engine, and once on
its fused engine in interpret mode.  The two packages draw other seeds
from one ``seed``, so a solve held to the reference gets the reference's
seeds: its super-solve's kmeans++ from ``fold_in(PRNGKey(seed), 0)`` and
its sub-problems' from ``fold_in(PRNGKey(seed), 1)``, computed here with
the reference's own functions, through ``_aa_kmeans_hierarchical``'s
``c0_super`` and ``c0s``.

Tolerances: labels, ``labels_super``, offsets, round counts, partitions
and selections exact; centroids, routers and energies within 1e-5
relative (1e-5 absolute for centroids near 0); the routers of one
assignment within 1e-6; the port against itself bit for bit (G = 1
against the flat solve, resumed against uninterrupted), and padded
against unpadded with equal labels, centroids and energy within 1e-6.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import serialize as jserialize
from repro.core import hierarchy as jh
from repro.core.api import AAKMeans as JAAKMeans
from repro.core.init_schemes import batched_init as jbatched_init
from repro.core.init_schemes import kmeanspp_init as jkmeanspp
from repro.core.kmeans import KMeansConfig as JKMeansConfig
from repro.core.kmeans import KMeansResult as JKMeansResult
from repro.core.kmeans import aa_kmeans as jaa_kmeans
from repro.core.kmeans import select_best as jselect_best
from repro_torch.checkpoint import load_estimator
from repro_torch.core import (AAKMeans, HierarchyResult, KMeansConfig,
                              KMeansResult, aa_kmeans_batched,
                              aa_kmeans_hierarchical, select_best, serialize)
from repro_torch.core.hierarchy import (_aa_kmeans_hierarchical,
                                        _check_hier_meta, _flatten,
                                        _partition, _routers_of,
                                        default_n_groups,
                                        hierarchy_state_like)
from repro_torch.core.backends import get_backend
from repro_torch.core.init_schemes import batched_init
from repro_torch.interop import estimator_from_arrays, estimator_kwargs
from repro_torch.runtime.metrics import CollectMetrics, EarlyStopHook
from repro_torch.runtime.writer import read_manifest
from repro_torch.serving import hierarchy_closure_index

torch.set_num_threads(2)


def _smooth(n=2048, d=8, seed=1) -> np.ndarray:
    """The reference's smooth-density manifold (tests/test_hierarchy.py)."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, 3))
    basis = rng.normal(size=(3, d)) / np.sqrt(3)
    return (np.tanh(z @ basis)
            + 0.05 * rng.normal(size=(n, d))).astype(np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(a) -> np.ndarray:
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _ref_seeds(x, k, g, seed, *, super_max_iter=50, n_init=1,
               pad_multiple=256, init="kmeans++", backend="dense"):
    """The seeds the reference's aa_kmeans_hierarchical draws for
    (x, k, g, seed): (c0_super (G, d), c0s (G·n_init, K/G, d)), numpy."""
    xj = jnp.asarray(x)
    root = jax.random.PRNGKey(seed)
    c0_super = jkmeanspp(jax.random.fold_in(root, 0), xj, g)
    sup = jaa_kmeans(xj, c0_super, JKMeansConfig(k=g,
                                                 max_iter=super_max_iter),
                     backend=backend)
    xg, wg, _, _ = jh._partition(xj, sup.labels.astype(jnp.int32), g,
                                 k // g, pad_multiple, None)
    keys = jax.random.split(jax.random.fold_in(root, 1), g * n_init)
    c0s = jbatched_init(init, keys, jnp.repeat(xg, n_init, axis=0), k // g,
                        weights=jnp.repeat(wg, n_init, axis=0))
    return np.asarray(c0_super), np.asarray(c0s)


def _close(got, want, what, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol,
                               err_msg=what)


def _assert_matches(res: HierarchyResult, jres, atol=1e-5):
    """The port's HierarchyResult against the reference's."""
    assert np.array_equal(_np(res.labels), _np(jres.labels))
    assert np.array_equal(_np(res.labels_super), _np(jres.labels_super))
    assert np.array_equal(_np(res.group_offsets), _np(jres.group_offsets))
    assert res.n_rounds == jres.n_rounds
    _close(res.centroids, jres.centroids, "centroids", atol=atol)
    _close(res.routers, jres.routers, "routers", atol=atol)
    _close(res.energy, jres.energy, "energy", atol=0)
    _close(res.sub_energies, jres.sub_energies, "sub_energies", atol=0)


def _bitwise(a, b):
    for f, u, v in zip(a._fields, a, b):
        if isinstance(u, torch.Tensor):
            assert torch.equal(u, v), f
        else:
            assert u == v, f


# -- default_n_groups and select_best(groups=) -------------------------------

@pytest.mark.parametrize("lo", [1, 51, 101, 151])
def test_default_n_groups_matches_reference(lo):
    for k in range(lo, lo + 50):
        assert default_n_groups(k) == jh.default_n_groups(k), k
    assert default_n_groups(65536) == 256 and default_n_groups(1000) == 25
    assert default_n_groups(4096) == 64 and default_n_groups(7) == 1
    with pytest.raises(ValueError):
        default_n_groups(0)


def _results(energy, r, k=3, d=2, n=5):
    """A KMeansResult of R restarts whose leaves name their restart."""
    e = np.asarray(energy, np.float32)
    idx = np.arange(r)
    fields = (np.broadcast_to(idx[:, None, None], (r, k, d)).astype(
        np.float32), np.broadcast_to(idx[:, None], (r, n)).astype(np.int32),
              e, idx.astype(np.int32), 2 * idx.astype(np.int32),
              idx % 2 == 0)
    return (KMeansResult(*(_t(f) for f in fields)),
            JKMeansResult(*(jnp.asarray(f) for f in fields)))


def test_select_best_groups_ties_and_nan():
    """Per-group winners equal the reference's, ties to the lower index;
    a group of NaNs only keeps its own first restart and its NaN (the
    reference gives it restart 0 of the batch: ROADMAP queue C)."""
    e = [3.0, 1.0, 1.0, 2.0, np.nan, 5.0, 4.0, 4.0, np.nan, np.inf]
    groups = np.asarray([0, 0, 0, 1, 1, 1, 2, 2, 3, 3], np.int32)
    res, jres = _results(e, len(e))
    best = select_best(res, groups=_t(groups), n_groups=4)
    jbest = jselect_best(jres, groups=jnp.asarray(groups), n_groups=4)
    assert best.n_iter.tolist() == [1, 3, 6, 8]
    for f, a, b in zip(KMeansResult._fields, best, jbest):
        assert np.array_equal(_np(a)[:3], np.asarray(b)[:3]), f
    assert np.isnan(float(best.energy[3]))
    assert int(jbest.n_iter[3]) == 0       # the reference's fault
    # without groups: unchanged; every group its own restart
    assert int(select_best(res).n_iter) == 1
    every = select_best(res, groups=torch.arange(10), n_groups=10)
    assert every.n_iter.tolist() == list(range(10))
    with pytest.raises(ValueError, match="n_groups"):
        select_best(res, groups=_t(groups))


def test_select_best_groups_all_nan_batch():
    res, _ = _results([np.nan] * 4, 4)
    best = select_best(res, groups=_t(np.asarray([1, 0, 1, 0])),
                       n_groups=2)
    assert best.n_iter.tolist() == [1, 0]
    assert bool(torch.isnan(best.energy).all())
    assert int(select_best(res).n_iter) == 0


# -- the pieces: partition, flatten, routers ---------------------------------

@pytest.mark.parametrize("pad_multiple", [1, 64, 256])
def test_partition_and_flatten_match_reference(pad_multiple):
    x = _smooth(1000, 5, seed=2)
    rng = np.random.default_rng(3)
    ls = rng.integers(0, 6, size=1000).astype(np.int32)
    ls[ls == 4] = 5                          # group 4 empty
    xg, wg, perm, n_max = _partition(_t(x), _t(ls), 6, 8, pad_multiple)
    jxg, jwg, jperm, jn_max = jh._partition(jnp.asarray(x), jnp.asarray(ls),
                                            6, 8, pad_multiple, None)
    assert n_max == jn_max
    for a, b in ((xg, jxg), (wg, jwg), (perm, jperm)):
        assert np.array_equal(_np(a), np.asarray(b))
    # flatten a fake per-group result: local labels, energies per group
    g, k_sub = 6, 8
    labels = rng.integers(0, k_sub, size=(g, n_max)).astype(np.int32)
    cents = rng.normal(size=(g, k_sub, 5)).astype(np.float32)
    energy = rng.random(g).astype(np.float32)
    zeros = np.zeros(g, np.int32)
    best = KMeansResult(_t(cents), _t(labels), _t(energy), _t(zeros),
                        _t(zeros), _t(zeros.astype(bool)))
    jbest = JKMeansResult(*(jnp.asarray(_np(a)) for a in best))
    got = _flatten(best, perm, g, k_sub, 1000, n_max)
    want = jh._flatten(jbest, jperm, g, k_sub, 1000, n_max)
    for a, b in zip(got[:3], want[:3]):
        assert np.array_equal(_np(a), np.asarray(b))
    _close(got[3], want[3], "total", atol=0)
    # labels are in original row order, inside each row's group
    assert np.array_equal(_np(got[1]) // k_sub, ls)


@pytest.mark.parametrize("engine", ["dense", "fused", "fused_bounds"])
def test_routers_of_matches_reference(engine):
    x = _smooth(1500, 6, seed=4)
    rng = np.random.default_rng(5)
    ls = rng.integers(0, 5, size=1500).astype(np.int32)
    ls[ls == 2] = 3                           # group 2 emptied
    prev = rng.normal(size=(5, 6)).astype(np.float32)
    got = _routers_of(_t(x), _t(ls), 5, _t(prev), get_backend(engine))
    want = jh._routers_of(jnp.asarray(x), jnp.asarray(ls), 5,
                          jnp.asarray(prev))
    _close(got, want, "routers", rtol=1e-6, atol=1e-6)
    assert np.array_equal(_np(got[2]), prev[2])   # kept, not the origin


# -- the whole solve against the reference -----------------------------------

@pytest.mark.parametrize("engine", ["dense", "fused", "fused_bounds"])
def test_solve_from_reference_seeds(engine):
    """Round 0 and two reassignment rounds (a crude super-solve makes
    rows move) from the reference's seeds, against the reference's dense
    solve."""
    x = _smooth(2048, 8, seed=2)
    kw = dict(n_groups=8, n_reassign=2, super_max_iter=1, seed=3)
    c0_super, c0s = _ref_seeds(x, 64, 8, 3, super_max_iter=1)
    jres = jh.aa_kmeans_hierarchical(jnp.asarray(x), 64,
                                     JKMeansConfig(k=64, max_iter=25),
                                     backend="dense", **kw)
    res = _aa_kmeans_hierarchical(_t(x), 64, KMeansConfig(k=64, max_iter=25),
                                  engine, c0_super=_t(c0_super), c0s=_t(c0s),
                                  **kw)
    assert jres.n_rounds == 2
    _assert_matches(res, jres)


def test_solve_against_reference_fused_interpret():
    """One small case against the reference's own fused engine (its
    Pallas kernel in interpret mode), n_init 2 through the per-group
    selection."""
    x = _smooth(600, 4, seed=6)
    kw = dict(n_groups=4, n_reassign=1, super_max_iter=2, seed=1, n_init=2)
    c0_super, c0s = _ref_seeds(x, 16, 4, 1, super_max_iter=2, n_init=2,
                               backend="fused")
    jres = jh.aa_kmeans_hierarchical(jnp.asarray(x), 16,
                                     JKMeansConfig(k=16, max_iter=10),
                                     backend="fused", **kw)
    res = _aa_kmeans_hierarchical(_t(x), 16, KMeansConfig(k=16, max_iter=10),
                                  "fused", c0_super=_t(c0_super),
                                  c0s=_t(c0s), **kw)
    _assert_matches(res, jres)


def test_g1_is_the_flat_batched_solve_bit_for_bit():
    x = _t(_smooth(1024, 6, seed=7))
    cfg = KMeansConfig(k=12, max_iter=30)
    c0s = batched_init("kmeans++", torch.Generator().manual_seed(5), x, 12,
                       3)
    for engine in ("dense", "fused"):
        res = aa_kmeans_hierarchical(x, 12, cfg, engine, n_groups=1,
                                     c0s=c0s)
        flat = select_best(aa_kmeans_batched(x, c0s, cfg, backend=engine))
        assert torch.equal(res.centroids, flat.centroids)
        assert torch.equal(res.labels, flat.labels)
        assert torch.equal(res.energy, flat.energy)
        assert torch.equal(res.sub_energies, flat.energy[None])
        assert res.group_offsets.tolist() == [0, 12] and res.n_rounds == 0
        assert torch.equal(res.labels_super, torch.zeros(1024,
                                                         dtype=torch.int32))
    # drawn seeds: those of the flat estimator at the same seed
    res = aa_kmeans_hierarchical(x, 12, cfg, n_groups=1, n_init=2, seed=4)
    m = AAKMeans(n_clusters=12, max_iter=30, n_init=2, seed=4,
                 device="cpu").fit(x)
    assert torch.equal(res.centroids, m.centroids_)
    assert float(res.energy) == m.energy_
    # and the reference's G = 1 from the same seeds
    jres = jh.aa_kmeans_hierarchical(
        jnp.asarray(_np(x)), 12, JKMeansConfig(k=12, max_iter=30),
        backend="dense", n_groups=1, c0s=jnp.asarray(_np(c0s)))
    res = aa_kmeans_hierarchical(x, 12, cfg, "dense", n_groups=1, c0s=c0s)
    _assert_matches(res, jres)


@pytest.mark.parametrize("engine", ["dense", "fused"])
def test_padded_equals_unpadded(engine):
    """One group solved padded inside a G = 2 batch (weight-0 rows, the
    other group beside it) against the same rows alone, from the same
    seeds: labels and iteration counts equal, centroids and energy
    within 1e-6 (not bit for bit: the padded length changes the
    reduction order of the stats' product and of the energy's sum)."""
    x = _t(_smooth(900, 5, seed=8))
    lab = torch.zeros(900, dtype=torch.int32)
    lab[600:] = 1                              # groups of 600 and 300 rows
    xg, wg, perm, n_max = _partition(x, lab, 2, 6, 64)
    assert n_max == 640 and float(wg[1].sum()) == 300
    c0s = batched_init("kmeans++", torch.Generator().manual_seed(2), xg, 6,
                       2, weights=wg)
    cfg = KMeansConfig(k=6, max_iter=40)
    both = aa_kmeans_batched(xg, c0s, cfg, backend=engine, weights=wg)
    alone = aa_kmeans_batched(x[600:], c0s[1:], cfg, backend=engine)
    assert torch.equal(both.labels[1, :300], alone.labels[0])
    assert torch.equal(both.n_iter[1:], alone.n_iter)
    _close(both.centroids[1:], alone.centroids, "centroids", 1e-6, 1e-6)
    _close(both.energy[1:], alone.energy, "energy", 1e-6, 0)


# -- the round loop's invariants ---------------------------------------------

def test_rounds_monotone_labels_in_order_and_sums():
    x = _smooth(2048, 8, seed=2)
    mx = CollectMetrics()
    res = aa_kmeans_hierarchical(_t(x), 64, KMeansConfig(k=64, max_iter=25),
                                 "dense", n_groups=8, n_reassign=3,
                                 super_max_iter=1, metrics=mx, seed=0)
    eb = [r["energy_best"] for _, r in mx.records]
    assert len(eb) >= 2
    assert all(a >= b for a, b in zip(eb, eb[1:]))
    assert float(res.energy) == eb[-1]
    assert {"energy", "moved_frac", "n_max", "round_s"} <= set(
        mx.records[-1][1])
    # labels index the group-major codebook in original row order
    lab = res.labels.long()
    assert torch.equal(lab // 8, res.labels_super.long())
    e = float(torch.sum((_t(x) - res.centroids[lab]) ** 2))
    assert e == pytest.approx(float(res.energy), rel=1e-5)
    assert float(res.energy) == pytest.approx(
        float(res.sub_energies.sum()), rel=1e-6)


def test_early_stop_hook_halts_rounds():
    x = _t(_smooth(1024, 6, seed=6))
    hook = EarlyStopHook(rel_tol=10.0, patience=1, min_records=1)
    res = aa_kmeans_hierarchical(x, 32, KMeansConfig(k=32, max_iter=20),
                                 "dense", n_groups=4, n_reassign=5,
                                 super_max_iter=1, metrics=hook, seed=6)
    assert hook.should_stop and res.n_rounds < 5
    assert len(hook.records) == res.n_rounds + 1


# -- resume and snapshots ----------------------------------------------------

def _snaps(d):
    return sorted(glob.glob(os.path.join(d, "it_*.npz")))


@pytest.mark.parametrize("engine", ["dense", "fused"])
def test_resume_bit_for_bit(tmp_path, engine):
    x = _t(_smooth(1024, 6, seed=7))
    cfg = KMeansConfig(k=32, max_iter=20)
    kw = dict(n_groups=4, n_reassign=3, super_max_iter=1, seed=7)
    plain = aa_kmeans_hierarchical(x, 32, cfg, engine, **kw)
    mx = CollectMetrics()
    full = aa_kmeans_hierarchical(x, 32, cfg, engine, checkpoint_dir=tmp_path,
                                  metrics=mx, **kw)
    _bitwise(full, plain)
    snaps = _snaps(tmp_path)
    assert len(snaps) == full.n_rounds + 1 >= 3
    assert all(r["snapshot_s"] > 0 for _, r in mx.records)
    m = read_manifest(tmp_path)
    assert m["kind"] == serialize.KIND_HIERARCHY
    assert m["snapshots"][0]["meta"] == {"round": 0, "k": 32, "n_groups": 4,
                                         "k_sub": 8, "backend": engine}
    for snap in snaps[:2]:
        _bitwise(aa_kmeans_hierarchical(x, 32, cfg, engine,
                                        resume_from=snap, **kw), full)
    # a (state, meta) pair
    state, meta = serialize.restore(snaps[0], hierarchy_state_like(x, 32, 4),
                                    expect_kind=serialize.KIND_HIERARCHY,
                                    device="cpu")
    _bitwise(aa_kmeans_hierarchical(x, 32, cfg, engine,
                                    resume_from=(state, meta), **kw), full)


def test_retention(tmp_path):
    x = _t(_smooth(1024, 6, seed=7))
    aa_kmeans_hierarchical(x, 32, KMeansConfig(k=32, max_iter=20), "dense",
                           n_groups=4, n_reassign=3, super_max_iter=1,
                           seed=7, checkpoint_dir=tmp_path, keep_last_n=1)
    assert [os.path.basename(p) for p in _snaps(tmp_path)] == \
        [read_manifest(tmp_path)["latest"]]


def test_snapshots_cross_both_ways(tmp_path):
    """A port round snapshot restores in the reference and resumes there
    to the port's result; a reference one restores and resumes in the
    port to the reference's; the leaves are ``hierarchy_state_like``'s
    and the meta names are the reference's."""
    x = _smooth(1024, 6, seed=9)
    kw = dict(n_groups=4, n_reassign=2, super_max_iter=1, seed=9)
    c0_super, c0s = _ref_seeds(x, 32, 4, 9, super_max_iter=1)
    port = _aa_kmeans_hierarchical(
        _t(x), 32, KMeansConfig(k=32, max_iter=20), "dense",
        c0_super=_t(c0_super), c0s=_t(c0s),
        checkpoint_dir=tmp_path / "port", **kw)
    jref = jh.aa_kmeans_hierarchical(
        jnp.asarray(x), 32, JKMeansConfig(k=32, max_iter=20),
        backend="dense", checkpoint_dir=str(tmp_path / "ref"), **kw)
    _assert_matches(port, jref)
    port_snap = _snaps(tmp_path / "port")[0]
    ref_snap = _snaps(tmp_path / "ref")[0]
    jstate, jmeta = jserialize.restore(
        port_snap, jh.hierarchy_state_like(jnp.asarray(x), 32, 4),
        expect_kind=jserialize.KIND_HIERARCHY)
    state, meta = serialize.restore(ref_snap, hierarchy_state_like(
        _t(x), 32, 4), expect_kind=serialize.KIND_HIERARCHY, device="cpu")
    for m in (jmeta, meta):
        assert {m[key] for key in ("round", "k", "n_groups", "k_sub",
                                   "backend")} >= {0, 32, 4, 8, "dense"}
    assert sorted(jstate) == sorted(state) == sorted(
        hierarchy_state_like(_t(x), 32, 4))
    jres = jh.aa_kmeans_hierarchical(
        jnp.asarray(x), 32, JKMeansConfig(k=32, max_iter=20),
        backend="dense", resume_from=port_snap, **kw)
    res = aa_kmeans_hierarchical(_t(x), 32, KMeansConfig(k=32, max_iter=20),
                                 "dense", resume_from=ref_snap, **kw)
    _assert_matches(res, jref)
    _assert_matches(port, jres)


# -- refusals ----------------------------------------------------------------

def test_refusals(tmp_path):
    x = _t(_smooth(512, 4, seed=8))
    cfg = KMeansConfig(k=16, max_iter=10)
    with pytest.raises(ValueError, match="divisor"):
        aa_kmeans_hierarchical(x, 16, cfg, n_groups=5)
    with pytest.raises(ValueError, match="aa_kmeans_batched"):
        aa_kmeans_hierarchical(x, 16, cfg, n_groups=1,
                               checkpoint_dir=tmp_path)
    with pytest.raises(ValueError, match="aa_kmeans_batched"):
        aa_kmeans_hierarchical(x, 16, cfg, n_groups=1, resume_from="x.npz")
    with pytest.raises(ValueError, match="disagrees"):
        aa_kmeans_hierarchical(x, 8, cfg)
    with pytest.raises(ValueError, match=r"\(N, d\)"):
        aa_kmeans_hierarchical(x[None], 16, cfg)
    with pytest.raises(ValueError, match="c0s must be"):
        aa_kmeans_hierarchical(x, 16, cfg, n_groups=4,
                               c0s=torch.zeros(4, 3, 4))
    aa_kmeans_hierarchical(x, 16, cfg, "dense", n_groups=4, n_reassign=1,
                           checkpoint_dir=tmp_path, seed=8)
    snap = _snaps(tmp_path)[0]
    for k, g in ((16, 2), (32, 4), (8, 4)):
        with pytest.raises(ValueError, match="n_groups|k=|shape mismatch"):
            aa_kmeans_hierarchical(x, k, KMeansConfig(k=k, max_iter=10),
                                   "dense", n_groups=g, resume_from=snap)
    state, meta = serialize.restore(snap, hierarchy_state_like(x, 16, 4),
                                    device="cpu")
    for name, val in (("k", 32), ("n_groups", 2)):
        with pytest.raises(ValueError, match=f"{name}="):
            _check_hier_meta(dict(meta, **{name: val}), 16, 4, "snap")


# -- the estimator ------------------------------------------------------------

@pytest.mark.parametrize("hierarchical", [True, {"n_groups": 8,
                                                 "n_reassign": 1}])
def test_estimator_fit_save_load(tmp_path, hierarchical):
    x = _smooth(2048, 8, seed=10)
    m = AAKMeans(n_clusters=64, max_iter=25, seed=2, serving_index=True,
                 hierarchical=hierarchical, device="cpu").fit(x)
    assert m.hier_routers_.shape == (8, 8)
    assert m.hier_offsets_.tolist() == list(range(0, 72, 8))
    assert m.n_accepted_ is None and m.n_iter_ >= 0
    assert m.labels_.shape == (2048,)
    # the free index: each group's codebook rows, nearest-first
    idx = hierarchy_closure_index(m.centroids_, m.hier_routers_,
                                  m.hier_offsets_)
    assert torch.equal(m.closure_candidates_, idx.candidates)
    assert torch.equal(m.closure_routers_, m.hier_routers_)
    p = m.save(tmp_path / "model")
    for m2 in (AAKMeans.load(p, device="cpu"),
               load_estimator(p, device="cpu")):
        assert m2.hierarchical == hierarchical
        for f in ("centroids_", "labels_", "hier_routers_", "hier_offsets_",
                  "closure_routers_", "closure_candidates_"):
            assert torch.equal(getattr(m2, f), getattr(m, f)), f
        assert (m2.energy_, m2.n_iter_, m2.n_accepted_) == \
            (m.energy_, m.n_iter_, None)
        assert np.array_equal(m2.predict(x), m.predict(x))
    la = m.predict(x, approx=True)
    assert float((la == _np(m.labels_)).mean()) > 0.95
    # a flat refit clears the hierarchy's fields; explicit sizes build
    # the index from scratch
    m.build_serving_index(n_candidates=16)
    assert m.closure_candidates_.shape[1] == 16
    m.hierarchical = False
    m.fit(x)
    assert m.hier_routers_ is None and m.hier_offsets_ is None
    assert isinstance(m.n_accepted_, int)


def test_estimator_hierarchical_seeds_and_refusal():
    x = _t(_smooth(1024, 6, seed=11))
    a = AAKMeans(n_clusters=16, max_iter=15, seed=3, device="cpu",
                 hierarchical={"n_groups": 4, "n_reassign": 1}).fit(x)
    res = aa_kmeans_hierarchical(x, 16, a._config(), "dense", n_groups=4,
                                 n_reassign=1, seed=3)
    assert torch.equal(a.centroids_, res.centroids)
    # c0s hand over the sub-problems' seeds; G = 1 from the flat seeds
    c0s = batched_init("kmeans++", torch.Generator().manual_seed(0), x, 16,
                       1)
    g1 = AAKMeans(n_clusters=16, max_iter=15, device="cpu",
                  hierarchical={"n_groups": 1}).fit(x, c0s=c0s)
    flat = AAKMeans(n_clusters=16, max_iter=15, device="cpu").fit(x)
    assert torch.equal(g1.centroids_, flat.centroids_)
    assert g1.energy_ == flat.energy_
    with pytest.raises(FloatingPointError):
        x_nan = x.clone()
        x_nan[3] = float("nan")
        AAKMeans(n_clusters=16, max_iter=5, device="cpu",
                 hierarchical={"n_groups": 4}).fit(x_nan)


def test_reference_artifact_crosses_both_ways(tmp_path):
    """A reference-written hierarchical model loads in the port and
    predicts its labels; its free index equals the reference's; the
    port's artifact loads in the reference the same way."""
    x = _smooth(2048, 8, seed=12)
    jm = JAAKMeans(n_clusters=64, max_iter=25, seed=1,
                   hierarchical={"n_groups": 8, "n_reassign": 1}).fit(x)
    p = jm.save(str(tmp_path / "ref"))
    tm = AAKMeans.load(p, device="cpu")
    assert tm.hierarchical == {"n_groups": 8, "n_reassign": 1}
    assert tm.n_accepted_ is None and tm.n_iter_ == jm.n_iter_
    for f in ("centroids_", "labels_", "hier_routers_", "hier_offsets_"):
        assert np.array_equal(_np(getattr(tm, f)),
                              np.asarray(getattr(jm, f))), f
    assert np.array_equal(tm.predict(x), np.asarray(jm.predict(x)))
    jm.build_serving_index()
    tm.build_serving_index()
    assert np.array_equal(_np(tm.closure_candidates_),
                          np.asarray(jm.closure_candidates_))
    _close(tm.closure_routers_, jm.closure_routers_, "routers", 1e-6, 1e-6)
    assert np.array_equal(tm.predict(x, approx=True),
                          np.asarray(jm.predict(x, approx=True)))
    # the reverse: the port's artifact (index included) in the reference
    tp = AAKMeans(n_clusters=64, max_iter=25, seed=1, serving_index=True,
                  hierarchical={"n_groups": 8, "n_reassign": 1},
                  device="cpu").fit(x)
    jm2 = JAAKMeans.load(str(tp.save(tmp_path / "port")))
    assert jm2.hierarchical == {"n_groups": 8, "n_reassign": 1}
    assert jm2.n_accepted_ is None
    for f in ("centroids_", "labels_", "hier_routers_", "hier_offsets_",
              "closure_routers_", "closure_candidates_"):
        assert np.array_equal(np.asarray(getattr(jm2, f)),
                              _np(getattr(tp, f))), f
    assert np.array_equal(np.asarray(jm2.predict(x)), tp.predict(x))


def test_interop_rebuilds_the_hierarchical_estimator():
    params = {"n_clusters": 64, "hierarchical": {"n_groups": 8},
              "mesh": None, "data_axes": ["data"], "backend": "fused"}
    kw = estimator_kwargs(AAKMeans, params, "cpu")
    assert kw["hierarchical"] == {"n_groups": 8} and "mesh" not in kw
    rng = np.random.default_rng(0)
    arrays = {"centroids_": rng.normal(size=(64, 4)).astype(np.float32),
              "hier_routers_": rng.normal(size=(8, 4)).astype(np.float32),
              "hier_offsets_": np.arange(9, dtype=np.int64) * 8,
              "n_iter_": np.asarray(2), "n_accepted_": None}
    m = estimator_from_arrays(params, arrays, device="cpu")
    assert m.hierarchical == {"n_groups": 8} and m.n_accepted_ is None
    assert m.hier_offsets_.dtype == torch.int32 and m.n_iter_ == 2
    m.build_serving_index()
    assert sorted(m.closure_candidates_.reshape(-1).tolist()) == list(
        range(64))
