"""The port's Algorithm 1 (repro_torch.core.kmeans) against the JAX
package's, backend "fused" on both sides (interpret-mode Pallas there,
the kernels' plain versions here).

* One trip from identical state: every state the JAX batched driver
  passes to ``checkpoint_cb`` is carried across with
  ``interop.batched_state_from_numpy``; one port trip must land on the
  JAX package's next state — counters, flags, window size and labels
  exact, energies within rtol 1e-5, centroids within 1e-4 (they come out
  of the window solve, which amplifies the stats' reduction-order
  differences).
* The slice end to end: ``AAKMeans(backend="fused", device="cpu")`` from
  the JAX package's seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.api import AAKMeans as JAAKMeans
from repro.core.init_schemes import batched_init as jbatched_init
from repro.core.kmeans import KMeansConfig as JKMeansConfig
from repro.core.kmeans import _init_batched_state, resolve_backend
from repro.core.kmeans import aa_kmeans_batched as jaa_kmeans_batched
from repro.data.synthetic import make_blobs, make_dataset
from repro_torch.core import AAKMeans, get_backend
from repro_torch.core.kmeans import (KMeansConfig, _init_state,
                                     aa_kmeans_batched, batched_trip)
from repro_torch.data import synthetic as tsynthetic
from repro_torch.interop import batched_state_from_numpy

torch.set_num_threads(2)

EXACT = ("t", "n_acc", "converged", "labels", "p_prev")
ENERGIES = ("e_prev", "e_prev2", "e_last")
CENTROIDS = ("c", "c_au")


def _jax_seeds(x, k, r, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), r)
    return np.array(jbatched_init("kmeans++", keys, jnp.asarray(x), k))


def _assert_state_close(got, want, where):
    gi, wi = got.inner, want.inner
    for name in EXACT:
        np.testing.assert_array_equal(
            getattr(gi, name).numpy(), np.asarray(getattr(wi, name)),
            err_msg=f"{name} {where}")
    np.testing.assert_array_equal(got.pending.numpy(),
                                  np.asarray(want.pending),
                                  err_msg=f"pending {where}")
    for name in ("m", "ncols", "head"):
        np.testing.assert_array_equal(
            getattr(gi.aa, name).numpy(), np.asarray(getattr(wi.aa, name)),
            err_msg=f"aa.{name} {where}")
    for name in ENERGIES:
        np.testing.assert_allclose(
            getattr(gi, name).numpy(), np.asarray(getattr(wi, name)),
            rtol=1e-5, err_msg=f"{name} {where}")
    for name in CENTROIDS:
        np.testing.assert_allclose(
            getattr(gi, name).numpy(), np.asarray(getattr(wi, name)),
            rtol=1e-4, atol=1e-4, err_msg=f"{name} {where}")


def _problem(kind):
    """(x, c0s, weights, k): overlapping shared X with two restarts, or
    three per-problem datasets with weight-0 padding rows; both reject
    some accelerated iterates."""
    if kind == "shared":
        x = make_dataset("AllUsers", scale=0.008)
        return x, _jax_seeds(x, 6, 2), None, 6
    rng = np.random.default_rng(2)
    x = np.stack([make_blobs(400, 3, 5, seed=s, spread=2.0)
                  for s in (3, 4, 5)])
    w = np.ones((3, 400), np.float32)
    w[:, 350:] = 0.0
    c0s = np.stack([x[i, rng.choice(350, 5, replace=False)]
                    for i in range(3)])
    return x, c0s, w, 5


@pytest.mark.parametrize("kind", ["shared", "per-problem, weighted"])
def test_one_trip_from_identical_state(kind):
    x, c0s, w, k = _problem(kind)
    jcfg = JKMeansConfig(k=k, max_iter=40)
    wj = None if w is None else jnp.asarray(w)
    states = [jax.device_get(_init_batched_state(
        jnp.asarray(x), jnp.asarray(c0s), jcfg, resolve_backend("fused"),
        0 if x.ndim == 3 else None, w=wj))]
    jaa_kmeans_batched(jnp.asarray(x), jnp.asarray(c0s), jcfg,
                       backend="fused", checkpoint_every=1, weights=wj,
                       checkpoint_cb=lambda bst, _: states.append(
                           jax.device_get(bst)))
    assert len(states) > 8
    cfg = KMeansConfig(k=k, max_iter=40)
    bk = get_backend("fused")
    xt = torch.from_numpy(x)
    wt = None if w is None else torch.from_numpy(w)
    init = _init_state(xt, torch.from_numpy(c0s), cfg, bk, w=wt)
    _assert_state_close(init, states[0], "after the init step")
    trips_with_rejection = 0
    for i in range(len(states) - 1):
        got = batched_trip(xt, batched_state_from_numpy(states[i], "cpu"),
                           cfg, bk, w=wt)
        _assert_state_close(got, states[i + 1], f"after trip {i + 1}")
        trips_with_rejection += int(np.asarray(states[i + 1].pending).any())
    # the split-phase path (a rejected iterate completing next trip) ran
    assert trips_with_rejection > 0


def test_fit_matches_jax_on_separated_blobs():
    x = make_blobs(2000, 8, 12, seed=0)
    jm = JAAKMeans(n_clusters=12, backend="fused", n_init=2).fit(x)
    tm = AAKMeans(n_clusters=12, backend="fused", n_init=2, device="cpu")
    tm.fit(x, c0s=_jax_seeds(x, 12, 2))
    assert (tm.n_iter_, tm.n_accepted_) == (jm.n_iter_, jm.n_accepted_)
    np.testing.assert_array_equal(tm.labels_.numpy(), np.asarray(jm.labels_))
    np.testing.assert_allclose(tm.inertia_, jm.inertia_, rtol=1e-5)
    np.testing.assert_array_equal(tm.predict(x), np.asarray(jm.predict(x)))


def test_fit_on_overlapping_data_reaches_the_same_energy():
    """Overlapping clusters: AA's accept test sits on energy differences
    that reduction-order noise can flip, and AA amplifies such noise, so
    the trajectories may part.  The final energy must agree within 1e-4
    relative and the iteration counts within 10."""
    x = make_dataset("AllUsers", scale=0.02)
    jm = JAAKMeans(n_clusters=20, backend="fused", n_init=2).fit(x)
    tm = AAKMeans(n_clusters=20, backend="fused", n_init=2, device="cpu")
    tm.fit(x, c0s=_jax_seeds(x, 20, 2))
    np.testing.assert_allclose(tm.inertia_, jm.inertia_, rtol=1e-4)
    assert abs(tm.n_iter_ - jm.n_iter_) <= 10


def test_batched_result_and_dense_agree():
    """Dense and fused engines of the port from the same seeds."""
    x = make_blobs(500, 5, 6, seed=9)
    c0s = torch.from_numpy(_jax_seeds(x, 6, 3))
    xt = torch.from_numpy(x)
    cfg = KMeansConfig(k=6)
    a = aa_kmeans_batched(xt, c0s, cfg, backend="fused")
    b = aa_kmeans_batched(xt, c0s, cfg, backend="dense")
    assert torch.equal(a.n_iter, b.n_iter) and torch.equal(a.labels, b.labels)
    np.testing.assert_allclose(a.energy.numpy(), b.energy.numpy(), rtol=1e-5)
    assert a.centroids.shape == (3, 6, 5) and a.converged.all()


@pytest.mark.parametrize("bad", ["c0s 2-D", "x 1-D", "R mismatch",
                                 "weights shape"])
def test_batched_driver_input_checks(bad):
    xt = torch.zeros(2, 10, 3)
    c0s = torch.zeros(2, 4, 3)
    args = {"c0s 2-D": (xt[0], c0s[0], None),
            "x 1-D": (xt[0, 0], c0s, None),
            "R mismatch": (xt, torch.zeros(3, 4, 3), None),
            "weights shape": (xt[0], c0s, torch.ones(2, 9))}[bad]
    with pytest.raises(ValueError):
        aa_kmeans_batched(args[0], args[1], KMeansConfig(k=4),
                          weights=args[2])


def test_synthetic_copy_gives_the_same_data():
    np.testing.assert_array_equal(
        tsynthetic.make_dataset("Colorment", scale=0.01, seed=3),
        make_dataset("Colorment", scale=0.01, seed=3))
    np.testing.assert_array_equal(tsynthetic.make_blobs(50, 3, 4, seed=2),
                                  make_blobs(50, 3, 4, seed=2))
