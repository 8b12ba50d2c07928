"""The estimators and the streaming layer on a mesh: ``AAKMeans(mesh=)``
and ``MiniBatchAAKMeans(mesh=)`` (fit, predict, transform, exact and
approximate, save and load, the refusals), ``chunk_dataset(mesh=)``,
``aa_kmeans_minibatch_streamed(mesh=)``, and the reference's artifacts
with ``data_axes``.

Ranks are spawned Gloo processes on a "cpu" mesh
(``tests/torch_dist_ranks.py``); every rank calls the estimator with the
same global X, numpy from a seed.  Tolerances: at one rank the
single-device estimator's bits (computed in the rank's process); at two
ranks labels equal to the single-device fit's, energies within 1e-5
(the minibatch fit's and the stream's within 1e-4), iteration counts
within 2, and every rank's results equal bit for bit; predict and
transform under the mesh equal the single-device ones of the same
centroids (distances within 1e-5).  Rows padding N to the shard count
weigh 0, so a padded fit matches the unpadded one, where the reference's
repeated last row moves the energy (ROADMAP queue C).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.api import AAKMeans as JAAKMeans
from repro.core.api import MiniBatchAAKMeans as JMiniBatchAAKMeans
from repro.data.synthetic import make_blobs
from repro_torch.core import AAKMeans, MiniBatchAAKMeans
from repro_torch.core.kmeans import (KMeansConfig, aa_kmeans,
                                     aa_kmeans_minibatch_streamed)
from repro_torch.core.minibatch import MiniBatchConfig
from repro_torch.data.streaming import chunk_dataset
from repro_torch.interop import estimator_kwargs
from torch_dist_ranks import run_ranks

torch.set_num_threads(2)

K, DIM, N, N_ODD, MAX_ITER, CHUNK, VAL = 8, 6, 2000, 1999, 100, 200, 400


@pytest.fixture(scope="module")
def x():
    return make_blobs(N, DIM, K, seed=5, spread=3.0).astype(np.float32)


@pytest.fixture(scope="module")
def runs(x, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("estimators")
    return {w: run_ranks("estimators", w, dict(x=x), tmp, k=K, n_odd=N_ODD,
                         backend="fused", max_iter=MAX_ITER, chunk=CHUNK,
                         val=VAL) for w in (1, 2)}


def _single(rows):
    return AAKMeans(n_clusters=K, backend="fused", seed=0,
                    max_iter=MAX_ITER, device="cpu").fit(rows)


@pytest.mark.parametrize("what", ["even", "padded"])
def test_one_rank_fit_is_the_single_device_fit(what, runs):
    got = runs[1][0][what]
    want = got["local"]
    for a, b in zip(want, (got["centroids"], got["labels"], got["energy"],
                           got["n_iter"], got["n_accepted"])):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


@pytest.mark.parametrize("what", ["even", "padded"])
def test_two_rank_fit_matches_the_single_device_fit(what, x, runs):
    """Seeded on rank 0 from the single-device fit's generator, so both
    start from the same seeds; labels global (in the original row order)
    on every rank."""
    rows = x if what == "even" else x[:N_ODD]
    want = _single(rows)
    ranks = runs[2]
    got = ranks[0][what]
    assert got["labels"].shape == (rows.shape[0],)
    assert torch.equal(got["labels"], want.labels_)
    assert got["energy"] == pytest.approx(want.energy_, rel=1e-5)
    assert abs(got["n_iter"] - want.n_iter_) <= 2
    for key in ("centroids", "labels", "energy", "n_iter", "n_accepted"):
        a, b = got[key], ranks[1][what][key]
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def test_padding_rows_weigh_nothing(x, runs):
    """N = 1999 over two ranks pads one row at weight 0: the energy is the
    unpadded solve's.  The reference's shard_dataset pads with a copy of
    the last row at weight 1, which moves the energy by that row's
    distance (ROADMAP queue C)."""
    rows = x[:N_ODD]
    got = runs[2][0]["padded"]
    c = got["centroids"]
    exact = float(torch.sum(torch.min(torch.cdist(
        torch.from_numpy(rows).double(), c.double()) ** 2, dim=1).values))
    assert got["energy"] == pytest.approx(exact, rel=1e-5)
    dup = np.concatenate([rows, rows[-1:]])
    res = aa_kmeans(torch.from_numpy(dup), c, KMeansConfig(k=K, max_iter=1),
                    backend="dense")
    last = float(torch.min(torch.sum((torch.from_numpy(rows[-1]) - c) ** 2,
                                     dim=1)))
    assert last > 0
    assert float(res.energy) == pytest.approx(exact + last, rel=1e-4)


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("what", ["predict", "transform", "predict_approx",
                                  "transform_approx"])
def test_inference_under_the_mesh(what, world, x, runs):
    """predict / transform, exact and through the serving index, under
    the mesh on the padded rows: the single-device estimator's on the
    same centroids and index, on every row."""
    rows = x[:N_ODD]
    got = runs[world][0]["padded"]
    local = AAKMeans(n_clusters=K, backend="fused", device="cpu")
    local.centroids_ = got["centroids"]
    local.closure_routers_, local.closure_candidates_ = got["index"]
    approx = what.endswith("approx")
    fn = local.predict if what.startswith("predict") else local.transform
    want = fn(rows, approx=approx)
    assert got[what].shape == want.shape
    if what.startswith("predict"):
        assert np.array_equal(got[what], want)
        assert np.array_equal(got[what], got["labels"].numpy()) or approx
    else:
        np.testing.assert_allclose(got[what], want, rtol=1e-5, atol=1e-5)
    for r in runs[world][1:]:
        assert np.array_equal(r["padded"][what], got[what])


@pytest.mark.parametrize("world", [1, 2])
def test_minibatch_fit_under_the_mesh(world, x, runs):
    """MiniBatchAAKMeans(mesh=).fit: at one rank the single-device fit's
    bits; at two, its energy within 1e-4 and its step count, labels_
    from the distributed predict."""
    got = runs[world][0]["minibatch"]
    if world == 1:
        want = got["local"]
        assert torch.equal(got["centroids"], want[0])
        assert (got["energy"], got["n_steps"], got["n_accepted"]) == \
            want[1:]
        return
    want = MiniBatchAAKMeans(n_clusters=K, chunk_size=CHUNK, epochs=2,
                             val_size=VAL, backend="fused", seed=1,
                             device="cpu").fit(x)
    assert got["energy"] == pytest.approx(want.energy_, rel=1e-4)
    assert got["n_steps"] == want.n_steps_
    assert np.mean(got["labels"] == want.labels_) > 0.999
    assert torch.equal(got["centroids"], runs[2][1]["minibatch"]["centroids"])


@pytest.mark.parametrize("what,kind", [
    ("partial_fit", "NotImplementedError"),
    ("hierarchical", "NotImplementedError"),
    ("device", "ValueError")])
def test_mesh_refusals(what, kind, runs):
    """partial_fit and hierarchical= refuse a mesh with the reference's
    messages; a device= other than the mesh's raises."""
    for world in (1, 2):
        got = runs[world][0]["raised"][what]
        assert got[0] == kind
    assert "mesh" in runs[2][0]["raised"][what][1] or what == "device"


def test_saved_mesh_model_loads_local(runs):
    """save under a mesh persists data_axes but never the mesh; the
    loaded model is local and predicts the same labels."""
    for world in (1, 2):
        got = runs[world][0]
        assert got["loaded"]["mesh"] is None
        assert got["loaded"]["data_axes"] == ("data",)
        assert np.array_equal(got["loaded"]["predict"],
                              got["padded"]["predict"])


def test_save_params_mirror_the_reference(x, tmp_path):
    """A port artifact's params hold data_axes as a list and no mesh, as
    the reference's do; the reference loads it, and a reference artifact
    with data_axes ("pod", "data") rebuilds the same port estimator."""
    from repro_torch.core import serialize
    m = _single(x)
    m.mesh, m.data_axes = object(), ("pod", "data")
    path = m.save(tmp_path / "port.npz")
    meta, _ = serialize.load(path)
    assert meta["params"]["data_axes"] == ["pod", "data"]
    assert "mesh" not in meta["params"] and "device" not in meta["params"]
    jm = JAAKMeans.load(path)
    assert jm.data_axes == ("pod", "data") and jm.mesh is None
    jref = JAAKMeans(n_clusters=K, data_axes=("pod", "data"), max_iter=20)
    jref.fit(x)
    jpath = jref.save(tmp_path / "ref.npz")
    loaded = AAKMeans.load(jpath, device="cpu")
    assert loaded.data_axes == ("pod", "data") and loaded.mesh is None
    assert np.array_equal(loaded.predict(x), np.asarray(jref.predict(x)))
    kw = estimator_kwargs(AAKMeans, serialize.load(jpath)[0]["params"],
                          device="cpu")
    assert kw["data_axes"] == ("pod", "data") and "mesh" not in kw


@pytest.mark.parametrize("cls,jcls", [(AAKMeans, JAAKMeans),
                                      (MiniBatchAAKMeans,
                                       JMiniBatchAAKMeans)])
def test_constructor_fields_mirror_the_reference(cls, jcls):
    """Both estimators take the reference's parameters, mesh and
    data_axes included, plus ``device``."""
    def params(c):
        return {f.name: f.default for f in dataclasses.fields(c)
                if not f.name.endswith("_") and not f.name.startswith("_")}
    mine, ref = params(cls), params(jcls)
    assert set(mine) == set(ref) | {"device"}
    assert mine["mesh"] is None and mine["data_axes"] == ref["data_axes"]


# -- the streaming layer -----------------------------------------------------

@pytest.fixture(scope="module")
def stream_inputs(x):
    return dict(x=x[VAL:], x_val=x[:VAL], c0=x[:K].copy())


@pytest.fixture(scope="module")
def stream_runs(stream_inputs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("streamed")
    return {w: run_ranks("streamed", w, stream_inputs, tmp, chunk=CHUNK)
            for w in (1, 2)}


@pytest.mark.parametrize("world", [1, 2])
def test_chunk_dataset_shards_the_rows(world, stream_inputs, stream_runs):
    """Each rank's chunks are its block of every chunk's rows, its
    weights the mask's block; together, the unsharded layout."""
    want = chunk_dataset(torch.from_numpy(stream_inputs["x"]), CHUNK)
    got = [r["chunks"] for r in stream_runs[world]]
    assert all(g.chunks.n == CHUNK and g.chunks.dim == 1 for g in got)
    assert torch.equal(torch.cat([g.chunks.local for g in got], dim=1),
                       want.chunks)
    assert torch.equal(torch.cat([g.weights.local for g in got], dim=1),
                       want.weights)


@pytest.mark.parametrize("world", [1, 2])
def test_streamed_driver_under_the_mesh(world, stream_inputs, stream_runs):
    """aa_kmeans_minibatch_streamed(mesh=): at one rank the unmeshed
    stream's bits, at two its energy within 1e-4; equal on repeat and on
    every rank."""
    ranks = stream_runs[world]
    first, again = ranks[0]["mesh"]
    for a, b in zip(first, again):
        assert a == b if isinstance(a, int) else torch.equal(a, b)
    local = ranks[0]["local"]
    if world == 1:
        for a, b in zip(first, local):
            assert a == b if isinstance(a, int) else torch.equal(a, b)
    assert float(first[1]) == pytest.approx(float(local[1]), rel=1e-4)
    assert first[2] == local[2]
    for r in ranks[1:]:
        assert torch.equal(r["mesh"][0][0], first[0])


def test_streamed_mesh_refuses_ragged_chunks(stream_inputs):
    """A chunk whose rows do not divide over the shards is refused (here
    through a fake two-shard mesh, before any collective)."""

    class FakeMesh:
        mesh_dim_names = ("data",)
        device_type = "cpu"

        def size(self, i):
            return 2

        def get_coordinate(self):
            return [0]

    with pytest.raises(ValueError, match="divisible"):
        aa_kmeans_minibatch_streamed(
            iter([stream_inputs["x"][:201]]), stream_inputs["x_val"],
            stream_inputs["c0"], MiniBatchConfig(k=K, chunk_size=CHUNK,
                                                 epochs=1),
            "fused", mesh=FakeMesh())
