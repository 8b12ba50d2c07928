"""Segmented, resumable drivers of the port (``core/segmented.py``)
against themselves and against the JAX package's: a run resumed from a
boundary against the uninterrupted run, the snapshot trees' layouts,
the refusals of ``_check_resume_meta``, the locality engine's mid-sort
resume, and snapshots and run directories crossing between the packages
in both directions.

Inputs are numpy from a seed, handed to both packages, with ``c0`` from
the reference's K-Means++ where the reference runs.  The port runs on
the CPU (its kernel engines run their plain versions); the reference
runs its Pallas engines in interpret mode.  Tolerances: the port against
itself bit for bit (results, artifacts member by member); the reference
against the port on well-separated blobs: labels, iteration counts and
acceptance counts exact, energies within rtol 1e-5, centroids within
atol 1e-5; a minibatch snapshot's leaves exact across the packages, and
one further epoch from it within 1e-5 (the decayed update may be an FMA
in XLA, ``tests/test_torch_minibatch.py``).
"""

import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import latest_snapshot as jlatest_snapshot
from repro.core import serialize as jserialize
from repro.core.backends import get_backend as jget_backend
from repro.core.init_schemes import kmeanspp_init as jkmeanspp
from repro.core.kmeans import KMeansConfig as JKMeansConfig
from repro.core.kmeans import aa_kmeans as jaa_kmeans
from repro.core.kmeans import aa_kmeans_batched as jaa_kmeans_batched
from repro.core.kmeans import aa_kmeans_minibatch as jaa_kmeans_minibatch
from repro.core.kmeans import minibatch_stream_like as jminibatch_stream_like
from repro.core.minibatch import MiniBatchConfig as JMiniBatchConfig
from repro.core.minibatch import run_epoch as jrun_epoch
from repro.data.streaming import chunk_dataset as jchunk_dataset
from repro.data.synthetic import make_blobs
from repro_torch.checkpoint import latest_snapshot, resume_point
from repro_torch.core import get_backend, serialize
from repro_torch.core.kmeans import (KMeansConfig, _check_resume_meta,
                                     _init_state, aa_kmeans,
                                     aa_kmeans_batched, aa_kmeans_minibatch,
                                     batched_state_like, loop_state_like,
                                     minibatch_stream_like)
from repro_torch.core.locality import permutation, sort_count
from repro_torch.core.minibatch import (MiniBatchConfig,
                                        from_reference_layout, run_epoch)
from repro_torch.core.segmented import _host_copy
from repro_torch.data.streaming import chunk_dataset
from repro_torch.runtime.metrics import CollectMetrics
from repro_torch.runtime.writer import read_manifest, snapshot_name

torch.set_num_threads(2)

K, D, N = 8, 6, 800


@pytest.fixture(scope="module")
def blobs():
    """(x, c0): separated blobs and the reference's K-Means++ seeds,
    numpy.  The solve takes 11 iterations and rejects 4 accelerated
    iterates, so boundaries fall on both kinds."""
    x = make_blobs(N, D, K, seed=1, spread=3.0)
    c0 = np.array(jkmeanspp(jax.random.PRNGKey(1), jnp.asarray(x), K))
    return x, c0


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _same(a, b) -> bool:
    """Results, equal on every leaf bit for bit."""
    return all(torch.equal(torch.as_tensor(u), torch.as_tensor(v))
               for u, v in zip(a, b))


def _members(path) -> dict:
    with zipfile.ZipFile(path) as z:
        return {name: z.read(name) for name in z.namelist()}


def _snaps(d) -> list:
    return sorted(d.glob("it_*.npz"))


def _assert_close_to_reference(got, want):
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.n_iter.numpy(), np.asarray(want.n_iter))
    np.testing.assert_array_equal(got.n_accepted.numpy(),
                                  np.asarray(want.n_accepted))
    np.testing.assert_allclose(got.energy.numpy(), np.asarray(want.energy),
                               rtol=1e-5)
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), atol=1e-5)


def _leaves(tree) -> dict:
    paths, leaves, _ = serialize.flatten_with_paths(tree)
    return {p: np.asarray(v) for p, v in zip(paths, leaves)}


# -- within the port ----------------------------------------------------------

@pytest.mark.parametrize("backend", ["dense", "fused"])
def test_single_resume_from_every_boundary_is_bitwise(tmp_path, blobs,
                                                      backend):
    x, c0 = map(_t, blobs)
    cfg = KMeansConfig(k=K, max_iter=40)
    ref = aa_kmeans(x, c0, cfg, backend=backend)
    trees = {}
    seg = aa_kmeans(x, c0, cfg, backend=backend, checkpoint_every=2,
                    checkpoint_dir=tmp_path,
                    checkpoint_cb=lambda st, t: trees.setdefault(t, st))
    assert _same(seg, ref)
    snaps = _snaps(tmp_path)
    assert len(snaps) == len(trees) >= 3
    assert int(ref.n_accepted) > 0 and int(ref.n_iter) > 6
    for p in snaps:
        assert _same(aa_kmeans(x, c0, cfg, backend=backend, resume_from=p),
                     ref), p.name
    for t, tree in trees.items():
        assert tree.t.dim() == 0 and int(tree.t) == t
        assert _same(aa_kmeans(x, c0, cfg, backend=backend,
                               resume_from=tree), ref), t


@pytest.mark.parametrize("backend", ["dense", "fused"])
def test_batched_resume_from_first_snapshot_is_bitwise(tmp_path, blobs,
                                                       backend):
    x, c0 = map(_t, blobs)
    c0s = torch.stack([c0, x[:K], x[100:100 + K]])
    cfg = KMeansConfig(k=K, max_iter=40)
    ref = aa_kmeans_batched(x, c0s, cfg, backend=backend)
    trees = {}
    seg = aa_kmeans_batched(x, c0s, cfg, backend=backend, checkpoint_every=3,
                            checkpoint_dir=tmp_path,
                            checkpoint_cb=lambda b, t: trees.setdefault(t, b))
    assert _same(seg, ref)
    first = _snaps(tmp_path)[0]
    assert first.name == snapshot_name(3)
    assert _same(aa_kmeans_batched(x, c0s, cfg, backend=backend,
                                   resume_from=first), ref)
    assert _same(aa_kmeans_batched(x, c0s, cfg, backend=backend,
                                   resume_from=trees[3]), ref)
    meta, _ = serialize.load(first)
    assert (meta["t"], meta["k"], meta["backend"]) == (3, K, backend)


@pytest.fixture(scope="module")
def stream(blobs):
    """(chunks, weights, x_val, c0, cfg): 12 chunks of 64 rows (the last
    padded at weight 0), 3 epochs."""
    x, c0 = blobs
    dc = chunk_dataset(_t(x[88:]), 64)
    return (dc.chunks, dc.weights, _t(x[:88]), _t(c0),
            MiniBatchConfig(k=K, chunk_size=64, epochs=3))


def _mb(stream, **kw):
    chunks, weights, x_val, c0, cfg = stream
    return aa_kmeans_minibatch(chunks, weights, x_val, c0, cfg,
                               backend=kw.pop("backend", "fused"),
                               device="cpu", **kw)


def _gen(seed=4):
    return torch.Generator().manual_seed(seed)


def test_minibatch_segmented_and_resumed_are_bitwise(tmp_path, stream):
    ref, ref_tr = _mb(stream, generator=_gen(), return_trace=True)
    payloads = {}
    seg, seg_tr = _mb(stream, generator=_gen(), return_trace=True,
                      checkpoint_every=1, checkpoint_dir=tmp_path,
                      checkpoint_cb=lambda tr, e: payloads.setdefault(e, tr))
    assert _same(seg, ref) and _same(seg_tr, ref_tr)
    assert [p.name for p in _snaps(tmp_path)] == \
        [snapshot_name(e) for e in (1, 2, 3)]
    res, tr = _mb(stream, resume_from=tmp_path / snapshot_name(2),
                  return_trace=True)
    assert _same(res, ref)
    # a resumed run's trace holds the epochs run since the snapshot
    assert _same(tr, tuple(v[2:] for v in ref_tr))
    assert _same(_mb(stream, resume_from=payloads[2]), ref)
    key = payloads[2]["key"]
    assert key.dtype == np.uint32 and key.tolist() == [0, 4]


def test_minibatch_cb_payload_resumes_without_rerunning_epochs(stream):
    """The callback's payload carries its epoch, so feeding it back runs
    only the epochs left, whatever the caller's generator."""
    payloads = {}
    ref = _mb(stream, generator=_gen(),
              checkpoint_cb=lambda tr, e: payloads.setdefault(e, tr))
    res = _mb(stream, generator=_gen(99), resume_from=payloads[1])
    assert res.n_steps == ref.n_steps == 3 * stream[0].shape[0]
    assert _same(res, ref)


@pytest.mark.parametrize("driver", ["batched", "minibatch"])
def test_async_artifacts_equal_sync_artifacts(tmp_path, blobs, stream,
                                              driver):
    x, c0 = map(_t, blobs)
    for sync in (True, False):
        d = tmp_path / str(sync)
        if driver == "batched":
            aa_kmeans_batched(x, torch.stack([c0, x[:K]]),
                              KMeansConfig(k=K, max_iter=40),
                              checkpoint_every=4, checkpoint_dir=d,
                              sync_writes=sync)
        else:
            _mb(stream, generator=_gen(), checkpoint_every=1,
                checkpoint_dir=d, sync_writes=sync)
    names = [p.name for p in _snaps(tmp_path / "True")]
    assert names and names == [p.name for p in _snaps(tmp_path / "False")]
    for name in names:
        assert _members(tmp_path / "True" / name) == \
            _members(tmp_path / "False" / name)
    assert read_manifest(tmp_path / "True") == \
        read_manifest(tmp_path / "False")


class _Die(RuntimeError):
    pass


def _die_at(n):
    seen = []

    def cb(tree, step):
        seen.append(step)
        if len(seen) == n:
            raise _Die("preempted")
    return cb


@pytest.mark.parametrize("driver", ["batched", "minibatch"])
def test_killed_run_resumes_from_latest_snapshot(tmp_path, blobs, stream,
                                                 driver):
    x, c0 = map(_t, blobs)
    c0s = torch.stack([c0, x[:K]])
    cfg = KMeansConfig(k=K, max_iter=40)

    def run(**kw):
        if driver == "batched":
            return aa_kmeans_batched(x, c0s, cfg, **kw)
        return _mb(stream, **kw)

    ref = run() if driver == "batched" else run(generator=_gen())
    with pytest.raises(_Die):
        kw = {} if driver == "batched" else {"generator": _gen()}
        run(checkpoint_every=2 if driver == "batched" else 1,
            checkpoint_dir=tmp_path, checkpoint_cb=_die_at(2), **kw)
    p, meta = resume_point(tmp_path)
    assert meta["t"] == (4 if driver == "batched" else 2)
    assert _same(run(resume_from=latest_snapshot(tmp_path)), ref)


# -- the snapshot trees -------------------------------------------------------

LIKE_ENGINES = ["dense", "blocked", "fused", "pallas", "fused_bounds",
                "hamerly", "elkan", "yinyang", "elkan_reorder",
                "fused_bounds_reorder"]


@pytest.mark.parametrize("engine", LIKE_ENGINES)
def test_like_trees_match_the_live_state(blobs, engine):
    """The meta-device layouts that restores fill have the live state's
    paths, shapes and dtypes, for every engine's carry."""
    x, c0 = map(_t, blobs)
    c0s = torch.stack([c0, x[:K]])
    cfg = KMeansConfig(k=K, max_iter=4)
    bk = get_backend(engine)
    live = _init_state(x, c0s, cfg, bk)
    for got, want in ((batched_state_like(x, c0s, cfg, bk), live),
                      (loop_state_like(x, c0, cfg, bk),
                       _init_state(x, c0[None], cfg, bk).inner)):
        gp, gl, _ = serialize.flatten_with_paths(got)
        wp, wl, _ = serialize.flatten_with_paths(want)
        if want is not live:
            wl = [leaf[0] for leaf in wl]
        assert gp == wp
        assert all(g.device.type == "meta" for g in gl)
        assert [(tuple(g.shape), g.dtype) for g in gl] == \
            [(tuple(w.shape), w.dtype) for w in wl]


def test_minibatch_like_tree_matches_the_reference(blobs):
    _, c0 = blobs
    like = minibatch_stream_like(_t(c0), MiniBatchConfig(k=K, chunk_size=64))
    jlike = jminibatch_stream_like(jnp.asarray(c0),
                                   JMiniBatchConfig(k=K, chunk_size=64),
                                   "dense")
    gp, gl, _ = serialize.flatten_with_paths(like)
    jp, jl, _ = serialize.flatten_with_paths(jlike)
    assert gp == jp
    assert [tuple(g.shape) for g in gl] == [tuple(j.shape) for j in jl]
    assert [str(g.dtype).removeprefix("torch.") for g in gl] == \
        [np.dtype(j.dtype).name for j in jl]


# -- refusals -----------------------------------------------------------------

def test_check_resume_meta_refuses_another_k_and_engine():
    cfg = KMeansConfig(k=K)
    dense = get_backend("dense")
    _check_resume_meta({"k": K, "backend": "dense"}, cfg, dense, "p")
    _check_resume_meta({"k": K, "backend": "dense@data"}, cfg, dense, "p")
    _check_resume_meta({}, cfg, dense, "p")
    with pytest.raises(ValueError, match="k=7"):
        _check_resume_meta({"k": 7, "backend": "dense"}, cfg, dense, "p")
    with pytest.raises(ValueError, match="backend"):
        _check_resume_meta({"k": K, "backend": "fused"}, cfg, dense, "p")
    with pytest.raises(ValueError, match="backend"):
        _check_resume_meta({"k": K, "backend": "fused_bounds+reorder"},
                           cfg, get_backend("fused_bounds"), "p")


def test_resume_refuses_a_snapshot_of_another_k(tmp_path, blobs):
    x, c0 = map(_t, blobs)
    aa_kmeans(x, c0, KMeansConfig(k=K, max_iter=10), checkpoint_every=3,
              checkpoint_dir=tmp_path)
    with pytest.raises(ValueError, match=f"k={K}"):
        aa_kmeans(x, x[:K + 1], KMeansConfig(k=K + 1, max_iter=10),
                  resume_from=latest_snapshot(tmp_path))


def test_minibatch_refuses_a_drawn_from_generator(stream):
    gen = _gen()
    torch.randperm(8, generator=gen)
    with pytest.raises(ValueError, match="drawn from"):
        _mb(stream, generator=gen, checkpoint_every=1)


def _drawn_from(seed=4):
    gen = _gen(seed)
    torch.randperm(8, generator=gen)
    return gen


@pytest.mark.parametrize("make_gen, kw", [
    (_drawn_from, lambda: {"metrics": CollectMetrics()}),
    (_gen, lambda: {"checkpoint_every": 1,
                    "checkpoint_cb": lambda tree, epoch: None})],
    ids=["sink_alone", "checkpoint"])
def test_minibatch_advances_the_callers_generator(stream, make_gen, kw):
    """A run draws its chunk orders from the caller's generator, as the
    run without keywords does: with a sink alone a drawn-from generator
    is taken as it is; either way the generator ends where the plain
    run leaves it, so a later call sharing it draws the same orders."""
    g_ref, g_kw = make_gen(), make_gen()
    ref = _mb(stream, generator=g_ref)
    res = _mb(stream, generator=g_kw, **kw())
    assert _same(res, ref)
    assert torch.equal(g_kw.get_state(), g_ref.get_state())


def _elkan_problem():
    """The reference's locality problem: 512 blobs rows, 8 of them as
    seeds."""
    x = _t(make_blobs(512, 8, 8, seed=3))
    c0 = x[np.random.default_rng(0).permutation(512)[:8]].clone()
    return x, c0, KMeansConfig(k=8, max_iter=40)


def test_resume_mid_sort_bitwise():
    x, c0, cfg = _elkan_problem()
    snaps = {}
    full = aa_kmeans(x, c0, cfg, backend="elkan", reorder=True,
                     checkpoint_every=3,
                     checkpoint_cb=lambda st, t: snaps.setdefault(t, st))
    t0 = min(snaps)
    carry = snaps[t0].carry
    # the snapshot holds a live permutation, not the identity
    assert int(sort_count(carry)) > 0
    assert not np.array_equal(permutation(carry).numpy(), np.arange(512))
    resumed = aa_kmeans(x, c0, cfg, backend="elkan", reorder=True,
                        checkpoint_every=3, resume_from=snaps[t0])
    assert _same(full, resumed)


def test_resume_rejects_reorder_mismatch(tmp_path):
    x, c0, cfg = _elkan_problem()
    aa_kmeans(x, c0, cfg, backend="elkan", reorder=True, checkpoint_every=3,
              checkpoint_dir=tmp_path)
    ckpts = _snaps(tmp_path)
    assert ckpts
    with pytest.raises(ValueError, match="backend"):
        aa_kmeans(x, c0, cfg, backend="elkan", checkpoint_every=3,
                  resume_from=ckpts[-1])


@pytest.mark.parametrize("driver", ["single", "batched"])
def test_mid_sort_artifact_resumes_and_refuses_the_raw_engine(tmp_path,
                                                              driver):
    """fused_bounds_reorder (the card's locality path): a snapshot taken
    after a sort resumes from its file bit for bit, and the raw engine
    refuses it."""
    x, c0, cfg = _elkan_problem()
    bk = get_backend("fused_bounds_reorder", group_size=2)
    raw = get_backend("fused_bounds", group_size=2)
    if driver == "single":
        def run(engine, **kw):
            return aa_kmeans(x, c0, cfg, backend=engine, **kw)
    else:
        c0s = torch.stack([c0, x[:8]])

        def run(engine, **kw):
            return aa_kmeans_batched(x, c0s, cfg, backend=engine, **kw)
    full = run(bk)
    run(bk, checkpoint_every=4, checkpoint_dir=tmp_path)
    first = _snaps(tmp_path)[0]
    meta, by_path = serialize.load(first)
    assert meta["backend"] == "fused_bounds+reorder"
    assert int(by_path["inner/carry/4" if driver == "batched"
                       else "carry/4"].max()) > 0
    assert _same(run(bk, resume_from=first), full)
    with pytest.raises(ValueError, match="backend"):
        run(raw, resume_from=first)


# -- across the packages ------------------------------------------------------

CROSS_ENGINES = ["dense", "fused", "hamerly"]


@pytest.mark.parametrize("engine", CROSS_ENGINES)
def test_reference_loop_snapshot_resumes_in_the_port(tmp_path, blobs,
                                                     engine):
    x, c0 = blobs
    jcfg = JKMeansConfig(k=K, max_iter=40)
    want = jaa_kmeans(jnp.asarray(x), jnp.asarray(c0), jcfg, backend=engine)
    jaa_kmeans(jnp.asarray(x), jnp.asarray(c0), jcfg, backend=engine,
               checkpoint_every=3, checkpoint_dir=tmp_path)
    first = _snaps(tmp_path)[0]
    assert latest_snapshot(tmp_path).name == \
        jlatest_snapshot(tmp_path).name == read_manifest(tmp_path)["latest"]
    got = aa_kmeans(_t(x), _t(c0), KMeansConfig(k=K, max_iter=40),
                    backend=engine, resume_from=first)
    assert serialize.load(first)[0]["t"] == 3 < int(want.n_iter)
    _assert_close_to_reference(got, want)


@pytest.mark.parametrize("engine", CROSS_ENGINES)
def test_port_loop_snapshot_resumes_in_the_reference(tmp_path, blobs,
                                                     engine):
    x, c0 = blobs
    got = aa_kmeans(_t(x), _t(c0), KMeansConfig(k=K, max_iter=40),
                    backend=engine, checkpoint_every=3,
                    checkpoint_dir=tmp_path)
    assert jlatest_snapshot(tmp_path) == latest_snapshot(tmp_path)
    first = _snaps(tmp_path)[0]
    want = jaa_kmeans(jnp.asarray(x), jnp.asarray(c0),
                      JKMeansConfig(k=K, max_iter=40), backend=engine,
                      resume_from=first)
    _assert_close_to_reference(got, want)


def test_reference_batched_snapshot_resumes_in_the_port(tmp_path, blobs):
    x, c0 = blobs
    c0s = np.stack([c0, x[:K]])
    jcfg = JKMeansConfig(k=K, max_iter=40)
    want = jaa_kmeans_batched(jnp.asarray(x), jnp.asarray(c0s), jcfg)
    jaa_kmeans_batched(jnp.asarray(x), jnp.asarray(c0s), jcfg,
                       checkpoint_every=3, checkpoint_dir=tmp_path)
    got = aa_kmeans_batched(_t(x), _t(c0s), KMeansConfig(k=K, max_iter=40),
                            resume_from=_snaps(tmp_path)[0])
    _assert_close_to_reference(got, want)


def test_port_batched_snapshot_resumes_in_the_reference(tmp_path, blobs):
    x, c0 = blobs
    c0s = np.stack([c0, x[:K]])
    got = aa_kmeans_batched(_t(x), _t(c0s), KMeansConfig(k=K, max_iter=40),
                            checkpoint_every=3, checkpoint_dir=tmp_path)
    want = jaa_kmeans_batched(jnp.asarray(x), jnp.asarray(c0s),
                              JKMeansConfig(k=K, max_iter=40),
                              resume_from=_snaps(tmp_path)[0])
    _assert_close_to_reference(got, want)


def test_batched_state_to_numpy_is_the_reference_layout(blobs):
    """A batched snapshot's host copy (``segmented._host_copy``, what the
    artifact holds) as numpy has the reference's leaves: the same paths
    as the reference's batched snapshot tree, of its dtypes and
    shapes."""
    x, c0 = blobs
    c0s = np.stack([c0, x[:K]])
    bk = get_backend("hamerly")
    cfg = KMeansConfig(k=K, max_iter=4)
    host = _host_copy(_init_state(_t(x), _t(c0s), cfg, bk))
    from repro.core.kmeans import batched_state_like as jbatched_state_like
    jlike = jbatched_state_like(jnp.asarray(x), jnp.asarray(c0s),
                                JKMeansConfig(k=K, max_iter=4),
                                jget_backend("hamerly"))
    paths, leaves, _ = serialize.flatten_with_paths(host)
    jpaths, jleaves, _ = serialize.flatten_with_paths(jlike)
    assert paths == jpaths
    for p, a, j in zip(paths, leaves, jleaves):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu", p
        a = a.numpy()
        assert (a.shape, a.dtype) == (tuple(j.shape), np.dtype(j.dtype)), p


MB_B, MB_V = 64, 88


@pytest.fixture(scope="module")
def jstream(blobs):
    """The reference's chunked inputs of ``stream`` and its config."""
    x, c0 = blobs
    jdc = jchunk_dataset(jnp.asarray(x[MB_V:]), MB_B)
    return (jdc.chunks, jdc.weights, jnp.asarray(x[:MB_V]), jnp.asarray(c0),
            JMiniBatchConfig(k=K, chunk_size=MB_B, epochs=3))


def _assert_mb_state_close(got, want):
    np.testing.assert_array_equal(int(got.t), int(want.t))
    np.testing.assert_array_equal(int(got.n_acc), int(want.n_acc))
    for f in ("c", "c_au", "sums", "counts", "e_prev", "e_prev2"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    for f in ("m", "ncols", "head"):
        assert int(getattr(got.aa, f)[0]) == int(getattr(want.aa, f)), f


def test_reference_minibatch_snapshot_restores_in_the_port(tmp_path, blobs,
                                                           stream, jstream):
    jchunks, jweights, jxv, jc0, jcfg = jstream
    jaa_kmeans_minibatch(jchunks, jweights, jxv, jc0, jcfg, backend="dense",
                         key=jax.random.PRNGKey(3), checkpoint_every=1,
                         checkpoint_dir=tmp_path)
    path = tmp_path / snapshot_name(1)
    jtree, _ = jserialize.restore(path, jminibatch_stream_like(jc0, jcfg,
                                                               "dense"))
    meta, by_path = serialize.load(path, expect_kind=serialize.KIND_MINIBATCH)
    cfg = stream[4]
    state = serialize.fill(by_path, minibatch_stream_like(
        stream[3], cfg)["state"], prefix="state/", device="cpu")
    got, want = _leaves(state), _leaves(jtree["state"])
    assert list(got) == list(want)
    for p in got:
        np.testing.assert_array_equal(got[p], want[p], err_msg=p)
    # one more epoch on each side, with the reference's permutation
    _, sub = jax.random.split(jnp.asarray(jtree["key"]))
    jbk = jget_backend("dense")
    jst, _ = jrun_epoch(jchunks, jweights, jxv, jtree["state"], jcfg, jbk,
                        sub)
    perm = np.asarray(jax.random.permutation(sub, jchunks.shape[0]))
    chunks, weights, x_val = stream[:3]
    pst, _ = run_epoch(chunks, weights, x_val, from_reference_layout(state),
                       cfg, get_backend("dense"), perm)
    _assert_mb_state_close(pst, jst)
    # and the port resumes it to the end, in its own chunk order
    res = _mb(stream, backend="dense", resume_from=path)
    assert res.n_steps == 3 * chunks.shape[0]
    assert np.isfinite(float(res.energy))


def test_port_minibatch_snapshot_restores_in_the_reference(tmp_path, stream,
                                                           jstream):
    payloads = {}
    _mb(stream, backend="dense", generator=_gen(), checkpoint_every=1,
        checkpoint_dir=tmp_path,
        checkpoint_cb=lambda tr, e: payloads.setdefault(e, tr))
    jchunks, jweights, jxv, jc0, jcfg = jstream
    path = tmp_path / snapshot_name(2)
    assert jlatest_snapshot(tmp_path) == latest_snapshot(tmp_path)
    jtree, jmeta = jserialize.restore(path, jminibatch_stream_like(
        jc0, jcfg, "dense"))
    assert jmeta["epoch"] == 2 and jmeta["backend"] == "dense"
    got, want = _leaves(payloads[2]), _leaves(jtree)
    assert list(want) == [p for p in got if p != "epoch"]
    for p in want:
        np.testing.assert_array_equal(want[p], got[p], err_msg=p)
    res = jaa_kmeans_minibatch(jchunks, jweights, jxv, jc0, jcfg,
                               backend="dense", resume_from=path)
    assert int(res.n_steps) == 3 * jchunks.shape[0]
