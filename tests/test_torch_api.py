"""Contracts of the port's estimator (repro_torch.core.api.AAKMeans) and
of repro_torch.interop, against the JAX package where it states them.

Tolerances: labels exact; transform distances 2e-5 (f32 cancellation in
the |x|^2 - 2x.c + |c|^2 expansion, as tests/test_kernels_v2.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import serialize
from repro.core.api import AAKMeans as JAAKMeans
from repro.core.init_schemes import batched_init as jbatched_init
from repro.data.synthetic import make_blobs
from repro_torch.core import AAKMeans, NotFittedError, get_backend
from repro_torch.device import resolve_device
from repro_torch.interop import estimator_from_arrays

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def fitted():
    """A JAX fit and the port's fit from the same seeds."""
    x = make_blobs(900, 5, 7, seed=11)
    jm = JAAKMeans(n_clusters=7, backend="fused").fit(x)
    keys = jax.random.split(jax.random.PRNGKey(0), 1)
    c0s = np.array(jbatched_init("kmeans++", keys, jnp.asarray(x), 7))
    tm = AAKMeans(n_clusters=7, backend="fused", device="cpu").fit(
        x, c0s=c0s)
    return x, jm, tm


def test_predict_pads_the_tail_chunk_to_one_shape(fitted):
    x, _, tm = fitted
    shapes = []
    dense = get_backend("dense")

    def spy(xc, c):
        shapes.append(tuple(xc.shape))
        return dense.assign(xc, c)

    model = dataclasses.replace(tm, backend=dataclasses.replace(
        dense, name="spy", assign_fn=spy))
    labels = model.predict(x[:150], chunk_size=64)
    assert shapes == [(64, 5)] * 3
    np.testing.assert_array_equal(labels, tm.predict(x[:150]))
    assert labels.dtype == np.int32 and labels.shape == (150,)


def test_predict_and_transform_match_jax(fitted):
    x, jm, tm = fitted
    x_new = make_blobs(300, 5, 7, seed=12)
    np.testing.assert_array_equal(tm.predict(x_new),
                                  np.asarray(jm.predict(x_new)))
    np.testing.assert_allclose(tm.transform(x_new),
                               np.asarray(jm.transform(x_new)),
                               rtol=2e-5, atol=2e-5)
    assert tm.inertia_ == tm.energy_


def test_unfitted_model_raises():
    m = AAKMeans(n_clusters=3, device="cpu")
    with pytest.raises(NotFittedError):
        m.predict(np.zeros((4, 2), np.float32))
    with pytest.raises(NotFittedError):
        m.transform(np.zeros((4, 2), np.float32))


@pytest.mark.parametrize("backend", ["dense", "fused"])
def test_nan_rows_raise_floating_point_error(backend):
    x = make_blobs(200, 3, 4, seed=13)
    x[5] = np.nan
    with pytest.raises(FloatingPointError):
        AAKMeans(n_clusters=4, backend=backend, n_init=2, max_iter=20,
                 device="cpu").fit(x)
    with pytest.raises(FloatingPointError):
        JAAKMeans(n_clusters=4, backend=backend, n_init=2,
                  max_iter=20).fit(x)


def test_no_cuda_means_no_fit(monkeypatch):
    """device=None means CUDA: without a card the fit raises instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = make_blobs(100, 3, 8, seed=14)
    with pytest.raises(RuntimeError, match="CUDA"):
        AAKMeans(n_clusters=8).fit(x)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_input_dtypes():
    x = make_blobs(120, 3, 4, seed=15)
    a = AAKMeans(n_clusters=4, device="cpu").fit(x.astype(np.float64))
    b = AAKMeans(n_clusters=4, device="cpu").fit(x)
    assert torch.equal(a.centroids_, b.centroids_)
    with pytest.raises(TypeError):
        AAKMeans(n_clusters=4, device="cpu").fit(x.astype(np.int32))


def test_seeding_is_reproducible_per_seed():
    x = make_blobs(300, 3, 6, seed=16)
    a = AAKMeans(n_clusters=6, n_init=2, seed=4, device="cpu").fit(x)
    b = AAKMeans(n_clusters=6, n_init=2, seed=4, device="cpu").fit(x)
    assert torch.equal(a.centroids_, b.centroids_)
    assert a.n_iter_ == b.n_iter_ and a.inertia_ == b.inertia_


def test_interop_estimator_from_arrays(fitted, tmp_path):
    x, jm, _ = fitted
    path = jm.save(tmp_path / "model.npz")
    meta, by_path = serialize.load(path)
    arrays = {name: by_path[f"arrays/{name}"] for name in meta["has"]}
    arrays.update(meta["scalars"])
    model = estimator_from_arrays(meta["params"], arrays, device="cpu")
    assert model.n_clusters == jm.n_clusters and model.backend == "fused"
    assert (model.n_iter_, model.n_accepted_, model.inertia_) == \
        (jm.n_iter_, jm.n_accepted_, jm.inertia_)
    x_new = make_blobs(400, 5, 7, seed=17)
    np.testing.assert_array_equal(model.predict(x_new),
                                  np.asarray(jm.predict(x_new)))
    np.testing.assert_array_equal(model.labels_.numpy(),
                                  np.asarray(jm.labels_))


@pytest.mark.parametrize("params,exc", [
    ({"n_clusters": 3, "backend": {"name": "dense", "compute": "bfloat16"}},
     NotImplementedError),
    ({"n_clusters": 3, "block_n": 64}, ValueError),
])
def test_interop_rejects_what_is_not_ported(params, exc):
    with pytest.raises(exc):
        estimator_from_arrays(params, {"centroids_": np.zeros((3, 2))},
                              device="cpu")
