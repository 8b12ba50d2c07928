"""The port's update kernel and its two-kernel engine ("pallas") against
the JAX package's.

On the CPU ``update`` runs its plain version; it is held to the Pallas
update kernel run in interpret mode on the same numpy inputs: counts
exact when unweighted (integer sums), within 1e-5 with real weights (as
tests/test_kernels_v2.py:79), sums within 1e-4 (reduction order, the
tolerance of tests/test_kernels_v2.py).  The "pallas" engine is held to
the reference's "pallas" engine step slot by step slot, for one trip of
the batched driver from identical state, and as a whole fit.  The CUDA
kernel itself is tested on the card by tests/test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.api import AAKMeans as JAAKMeans
from repro.core.backends import get_backend as jget_backend
from repro.core.kmeans import KMeansConfig as JKMeansConfig
from repro.core.kmeans import _init_batched_state, resolve_backend
from repro.core.kmeans import aa_kmeans_batched as jaa_kmeans_batched
from repro.data.synthetic import make_blobs, make_dataset
from repro.kernels.update import update_pallas
from repro_torch.core import AAKMeans, get_backend
from repro_torch.core.kmeans import KMeansConfig, _init_state, batched_trip
from repro_torch.interop import batched_state_from_numpy
from repro_torch.kernels import ref
from repro_torch.kernels import update as U
from test_torch_kmeans import _assert_state_close, _jax_seeds

torch.set_num_threads(2)

JAX_TILES = dict(tn=16, tk=8, interpret=True)


def _inputs(n, d, k, r=None, x_batched=False, weighted=False, seed=0):
    """x, labels in [-1, K] (so -1 and K land nowhere), w (N,) or None."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(((r, n, d) if x_batched else (n, d)),
                            dtype=np.float32)
    labels = rng.integers(-1, k + 1, (r, n) if r else (n,)).astype(np.int32)
    w = rng.uniform(0.0, 2.0, n).astype(np.float32) if weighted else None
    return x, labels, w


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _assert_stats_close(got, want, weighted):
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]),
                               rtol=1e-4, atol=1e-4)
    ctol = 1e-5 if weighted else 0
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]),
                               rtol=ctol, atol=ctol)


@pytest.mark.parametrize("weighted", [False, True])
def test_update_ref_drops_labels_outside_k(weighted):
    x, labels, w = _inputs(301, 7, 11, weighted=weighted, seed=1)
    assert (labels == -1).any() and (labels == 11).any()
    got = ref.update_ref(_t(x), _t(labels), 11, _t(w))
    want = update_pallas(_j(x), _j(labels), 11, w=_j(w), **JAX_TILES)
    _assert_stats_close(got, want, weighted)
    keep = (labels >= 0) & (labels < 11)
    assert float(got[1].sum()) == pytest.approx(
        float(keep.sum() if w is None else w[keep].sum()), rel=1e-6)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("r,x_batched", [(None, False), (3, False),
                                         (3, True)],
                         ids=["single", "R label sets", "per-problem X"])
def test_update_matches_jax_kernel(r, x_batched, weighted):
    x, labels, w = _inputs(257, 9, 13, r=r, x_batched=x_batched,
                           weighted=weighted, seed=2)
    got = U.update(_t(x), _t(labels), 13, _t(w))
    want = update_pallas(_j(x), _j(labels), 13, w=_j(w), **JAX_TILES)
    lead = (r,) if r else ()
    assert got[0].shape == lead + (13, 9) and got[1].shape == lead + (13,)
    _assert_stats_close(got, want, weighted)


def test_cpu_tensors_take_the_plain_update():
    x, labels, w = _inputs(40, 3, 5, weighted=True)
    before = (U.launches, U.plain_calls)
    U.update(_t(x), _t(labels), 5, _t(w))
    assert (U.launches, U.plain_calls) == (before[0], before[1] + 1)


@pytest.mark.parametrize("case,exc", [
    ("per-problem x, unbatched labels", ValueError),
    ("labels of the wrong length", ValueError),
    ("(R, N) weights", ValueError),
    ("int64 labels", TypeError),
    ("bf16 x", None),
    ("fp16 x", TypeError),
])
def test_update_operand_checks(case, exc):
    """Shape and label-type errors raise; a bf16 X is taken (its sums
    are the upcast X's, in f32), a float16 one is not."""
    x = torch.zeros(3, 10, 4)
    lab = torch.zeros(10, dtype=torch.int32)
    args = {"per-problem x, unbatched labels": (x, lab, None),
            "labels of the wrong length": (x[0], lab[:9], None),
            "(R, N) weights": (x[0], lab, torch.ones(3, 10)),
            "int64 labels": (x[0], lab.long(), None),
            "bf16 x": (torch.randn(10, 4).bfloat16(),
                       torch.arange(10, dtype=torch.int32) % 5,
                       torch.rand(10).bfloat16()),
            "fp16 x": (x[0].half(), lab, None)}[case]
    if exc is None:
        got = U.update(args[0], args[1], 5, args[2])
        want = U.update(args[0].float(), args[1], 5, args[2].float())
        assert got[0].dtype == got[1].dtype == torch.float32
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        return
    with pytest.raises(exc):
        U.update(args[0], args[1], 5, args[2])


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


def test_pallas_step_slots_match_jax():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((203, 6)).astype(np.float32)
    c = rng.standard_normal((10, 6)).astype(np.float32)
    w = rng.uniform(0, 2, 203).astype(np.float32)
    cs = rng.standard_normal((3, 10, 6)).astype(np.float32)
    xs = rng.standard_normal((3, 203, 6)).astype(np.float32)
    ws = rng.uniform(0, 2, (3, 203)).astype(np.float32)
    bk, jbk = get_backend("pallas"), jget_backend("pallas")
    t, j = torch.from_numpy, jnp.asarray
    _check_step(bk.step(t(x), t(c), 10)[0], jbk.step(j(x), j(c), 10)[0])
    _check_step(bk.minibatch_step(t(x), t(c), 10, t(w))[0],
                jbk.minibatch_step(j(x), j(c), 10, j(w))[0], weighted=True)
    carries = ((),) * 3
    _check_step(bk.batched_step(t(x), t(cs), 10, ())[0],
                jbk.batched_step(j(x), j(cs), 10, carries)[0])
    _check_step(bk.batched_step(t(xs), t(cs), 10, (), w=t(ws))[0],
                jbk.batched_step(j(xs), j(cs), 10, carries, x_batched=True,
                                 w=j(ws))[0], weighted=True)
    np.testing.assert_array_equal(
        bk.assign(t(x), t(c)).labels.numpy(),
        np.asarray(jbk.assign(j(x), j(c)).labels))


@pytest.mark.parametrize("name", ["dense", "fused", "pallas",
                                  "fused_bounds"])
def test_update_op_matches_jax(name):
    """The stats slot and the derived update op of every backend."""
    x, labels, _ = _inputs(150, 5, 8, seed=4)
    labels = np.clip(labels, 0, 7)
    c_prev = np.random.default_rng(5).standard_normal((8, 5)) \
        .astype(np.float32)
    bk, jbk = get_backend(name), jget_backend(name)
    got = bk.update(_t(x), _t(labels), 8, _t(c_prev))
    want = jbk.update(_j(x), _j(labels), 8, _j(c_prev))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    _assert_stats_close(bk.stats_fn(_t(x), _t(labels), 8),
                        jbk.stats_fn(_j(x), _j(labels), 8), False)


def test_pallas_one_trip_from_identical_state():
    """Every state the JAX batched driver passes to ``checkpoint_cb``,
    carried across; one port trip lands on the JAX package's next state
    (the tolerances of tests/test_torch_kmeans.py)."""
    x = make_dataset("AllUsers", scale=0.008)
    c0s = _jax_seeds(x, 6, 2)
    jcfg = JKMeansConfig(k=6, max_iter=40)
    states = [jax.device_get(_init_batched_state(
        jnp.asarray(x), jnp.asarray(c0s), jcfg, resolve_backend("pallas"),
        None))]
    jaa_kmeans_batched(jnp.asarray(x), jnp.asarray(c0s), jcfg,
                       backend="pallas", checkpoint_every=1,
                       checkpoint_cb=lambda bst, _: states.append(
                           jax.device_get(bst)))
    assert len(states) > 8
    cfg = KMeansConfig(k=6, max_iter=40)
    bk = get_backend("pallas")
    xt = torch.from_numpy(x)
    _assert_state_close(_init_state(xt, torch.from_numpy(c0s), cfg, bk),
                        states[0], "after the init step")
    rejected = 0
    for i in range(len(states) - 1):
        got = batched_trip(xt, batched_state_from_numpy(states[i], "cpu"),
                           cfg, bk)
        _assert_state_close(got, states[i + 1], f"after trip {i + 1}")
        rejected += int(np.asarray(states[i + 1].pending).any())
    assert rejected > 0


def test_pallas_fit_matches_jax():
    x = make_blobs(2000, 8, 12, seed=0)
    jm = JAAKMeans(n_clusters=12, backend="pallas", n_init=2).fit(x)
    tm = AAKMeans(n_clusters=12, backend="pallas", n_init=2, device="cpu")
    tm.fit(x, c0s=_jax_seeds(x, 12, 2))
    assert (tm.n_iter_, tm.n_accepted_) == (jm.n_iter_, jm.n_accepted_)
    np.testing.assert_array_equal(tm.labels_.numpy(), np.asarray(jm.labels_))
    np.testing.assert_allclose(tm.inertia_, jm.inertia_, rtol=1e-5)
    np.testing.assert_array_equal(tm.predict(x), np.asarray(jm.predict(x)))
