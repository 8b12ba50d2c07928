"""Wide rows: the port's kernels and fused driver at d past the CUDA
sweep's resident X tile (821 features on an H100), against the JAX
package.

On the card the three sweep kernels stream X in feature slabs past that
width (tests/test_torch_gpu.py holds them to their plain versions there);
on the CPU each wrapper runs its plain version, held here to the Pallas
kernel run in interpret mode on the same numpy inputs, at d = 822, 1023,
1024 and 4096.  Tolerances, as tests/test_torch_kernels.py holds them:
labels exact; min_sqdist within 2e-5 of max(|x|^2, 1) (f32 cancellation
in |x|^2 - 2 x.c + |c|^2, whose terms grow with d); sums and energy 1e-4
(reduction order); counts 1e-6 unweighted, 1e-5 weighted.  The rows are a
Gaussian mixture with centroids near its centers, so no label sits on a
near tie.  The fused driver and ``AAKMeans`` run at d = 1024 from one
``c0`` handed over as numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.backends import get_backend as jget_backend
from repro.core.kmeans import KMeansConfig as JKMeansConfig
from repro.core.kmeans import aa_kmeans as jaa_kmeans
from repro.kernels.assignment import assignment_pallas
from repro.kernels.fused_lloyd import fused_lloyd_pallas
from repro.kernels.update import update_pallas
from repro_torch.core import AAKMeans
from repro_torch.core.kmeans import KMeansConfig, aa_kmeans
from repro_torch.kernels import assignment as A
from repro_torch.kernels import build, ref
from repro_torch.kernels import fused_lloyd as F
from repro_torch.kernels import update as U

torch.set_num_threads(2)

WIDE_DS = (822, 1023, 1024, 4096)
JAX_TILES = dict(tn=16, tk=8, interpret=True)


def _mixture(n, d, k, r=None, x_batched=False, weights=None, seed=0):
    """A k-component mixture (centers 1.5 x N(0, 1), unit noise) and
    centroids 0.1 from its centers, numpy f32; weights as
    tests/test_torch_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    rr = r or 1
    centers = rng.standard_normal((k, d), dtype=np.float32) * 1.5
    lead = (rr, n) if x_batched else (n,)
    x = centers[rng.integers(0, k, lead)] \
        + rng.standard_normal(lead + (d,), dtype=np.float32)
    c = centers + 0.1 * rng.standard_normal((rr, k, d), dtype=np.float32)
    w = None
    if weights == "n":
        w = rng.uniform(0.0, 2.0, n).astype(np.float32)
        w[n // 2:] = 0.0
    elif weights == "rn":
        w = rng.uniform(0.0, 2.0, (rr, n)).astype(np.float32)
        w[:, : n // 3] = 0.0
    return x, (c if r else c[0]), w


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(np.asarray(a))


def _mind_atol(x):
    """2e-5 of max(|x|^2, 1) over the rows of x."""
    x = np.asarray(x, dtype=np.float32)
    return 2e-5 * max(float(np.sum(x * x, axis=-1).max()), 1.0)


def _assert_step_close(got, want, x, weighted):
    lab, mind, sums, counts, energy = [np.asarray(g) for g in got]
    wl, wm, ws, wc, we = [np.asarray(v) for v in want]
    np.testing.assert_array_equal(lab, wl)
    np.testing.assert_allclose(mind, wm, rtol=2e-5, atol=_mind_atol(x))
    np.testing.assert_allclose(sums, ws, rtol=1e-4, atol=1e-4)
    ctol = 1e-5 if weighted else 1e-6
    np.testing.assert_allclose(counts, wc, rtol=ctol if weighted else 0,
                               atol=ctol)
    np.testing.assert_allclose(energy, we, rtol=1e-4)


# (n, k, r, x per problem, weights): one problem unweighted; R = 2 per
# problem X with (R, N) weights
STEP_CASES = {"single": (130, 9, None, False, None),
              "R=2 per-problem X, (R,N) weights": (70, 9, 2, True, "rn")}


@pytest.mark.parametrize("case", list(STEP_CASES))
@pytest.mark.parametrize("d", WIDE_DS)
def test_fused_plain_matches_jax_kernel_at_wide_d(d, case):
    n, k, r, x_batched, weights = STEP_CASES[case]
    x, c, w = _mixture(n, d, k, r, x_batched, weights, seed=d)
    got = F.fused_lloyd(_t(x), _t(c), _t(w))
    want = fused_lloyd_pallas(_j(x), _j(c), _j(w), **JAX_TILES)
    _assert_step_close(got, want, x, w is not None)


@pytest.mark.parametrize("d", WIDE_DS)
def test_assignment_plain_matches_jax_kernel_at_wide_d(d):
    x, c, _ = _mixture(97, d, 11, r=3, seed=d + 1)
    lab, mind = A.assignment(_t(x), _t(c))
    wl, wm = assignment_pallas(_j(x), _j(c), **JAX_TILES)
    assert lab.shape == (3, 97)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(wl))
    np.testing.assert_allclose(mind.numpy(), np.asarray(wm), rtol=2e-5,
                               atol=_mind_atol(x))


@pytest.mark.parametrize("d", WIDE_DS)
def test_update_plain_matches_jax_kernel_at_wide_d(d):
    """Labels in [-1, K]: -1 and K land nowhere; (N,) weights."""
    rng = np.random.default_rng(d)
    x = rng.standard_normal((150, d), dtype=np.float32)
    labels = rng.integers(-1, 10, 150).astype(np.int32)
    w = rng.uniform(0.0, 2.0, 150).astype(np.float32)
    sums, counts = U.update(_t(x), _t(labels), 9, _t(w))
    ws, wc = update_pallas(_j(x), _j(labels), 9, w=_j(w), tn=16,
                           interpret=True)
    np.testing.assert_allclose(sums.numpy(), np.asarray(ws), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(counts.numpy(), np.asarray(wc), rtol=1e-5,
                               atol=1e-5)


def _loose_bounds(x, c, gs, rng):
    """Valid bounds of x against c at group size gs: lab0 the nearest
    centroid of c moved a little, ub^2 the squared distance to it grown by
    10 %, lb^2 each group's squared minimum shrunk by a random factor in
    [0.9, 1] (tests/test_torch_bounds.py's recipe, in f64, then f32)."""
    x64, c64 = x.astype(np.float64), c.astype(np.float64)
    d2 = (x64 * x64).sum(1)[:, None] - 2 * x64 @ c64.T \
        + (c64 * c64).sum(1)[None]
    moved = c64 + 0.1 * rng.standard_normal(c.shape)
    lab0 = ((x64 * x64).sum(1)[:, None] - 2 * x64 @ moved.T
            + (moved * moved).sum(1)[None]).argmin(1)
    ub_sq = 1.1 * d2[np.arange(len(x)), lab0]
    k, g = c.shape[0], -(-c.shape[0] // gs)
    d2 = np.concatenate([d2, np.full((len(x), g * gs - k), np.inf)], axis=1)
    lb_sq = d2.reshape(len(x), g, gs).min(-1) * rng.uniform(0.9, 1.0,
                                                              (len(x), g))
    return (lab0.astype(np.int32), lb_sq.astype(np.float32),
            ub_sq.astype(np.float32))


def _assert_bounded_close(got, want, x, bnds, tile_rows):
    lab, mind, sums, counts, energy, gmin, skip = \
        [np.asarray(g) for g in got]
    wl, wm, ws, wc, we, wg, wk = [np.asarray(v) for v in want]
    atol = _mind_atol(x)
    np.testing.assert_array_equal(lab, wl)
    np.testing.assert_array_equal(skip, wk)
    np.testing.assert_allclose(mind, wm, rtol=2e-5, atol=atol)
    np.testing.assert_allclose(sums, ws, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(counts, wc, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(energy, we, rtol=1e-4)
    computed = ref.computed_cells(_t(bnds[1]), _t(bnds[2]),
                                  tile_rows).numpy()
    np.testing.assert_array_equal(gmin[~computed], bnds[1][~computed])
    np.testing.assert_array_equal(wg[~computed], bnds[1][~computed])
    np.testing.assert_allclose(gmin[computed], wg[computed], rtol=2e-5,
                               atol=atol)


@pytest.mark.parametrize("d", WIDE_DS)
def test_fused_bounds_plain_matches_jax_kernel_at_wide_d(d):
    """Rows cluster by cluster, so some (64-row tile, group) cells skip;
    (N,) weights; groups of 3 over K = 12 (the JAX kernel runs the port's
    row tile and gs as its k tile)."""
    rng = np.random.default_rng(d)
    k, n, gs = 12, 160, 3
    centers = rng.standard_normal((k, d)).astype(np.float32) * 1.5
    x = centers[np.sort(rng.integers(0, k, n))] \
        + rng.standard_normal((n, d)).astype(np.float32)
    c = centers + 0.1 * rng.standard_normal((k, d)).astype(np.float32)
    w = rng.uniform(0.0, 2.0, n).astype(np.float32)
    bnds = _loose_bounds(x, c, gs, rng)
    tile_rows = build.tile_rows()
    got = F.fused_bounds_plain(_t(x), _t(c), _t(w), *(_t(b) for b in bnds),
                               gs, tile_rows)
    want = fused_lloyd_pallas(_j(x), _j(c), _j(w), tn=tile_rows, tk=gs,
                              interpret=True,
                              bounds=tuple(_j(b) for b in bnds))
    assert 0.0 < float(got[6]) < 1.0
    _assert_bounded_close(got, want, x, bnds, tile_rows)


def test_bf16_plain_versions_match_jax_kernels_at_d_1024():
    """bf16 X and C at d = 1024: the fused step and the assignment
    against the Pallas kernels on the same bf16 operands (both compute in
    f32 on the upcast values)."""
    x, c, w = _mixture(130, 1024, 9, weights="n", seed=3)
    xb, cb = torch.from_numpy(x).bfloat16(), torch.from_numpy(c).bfloat16()
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    cj = jnp.asarray(c).astype(jnp.bfloat16)
    got = F.fused_lloyd(xb, cb, _t(w))
    want = fused_lloyd_pallas(xj, cj, _j(w), **JAX_TILES)
    _assert_step_close(got, want, xb.float().numpy(), True)
    lab, mind = A.assignment(xb, cb)
    wl, wm = assignment_pallas(xj, cj, **JAX_TILES)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(wl))
    np.testing.assert_allclose(mind.numpy(), np.asarray(wm), rtol=2e-5,
                               atol=_mind_atol(xb.float().numpy()))


def _driver_problem(seed=0):
    """(x, c0, k) at N = 600, d = 1024, K = 8: a mixture of 8 components
    with unit noise, seeded from 8 rows (two of them from one component,
    so Lloyd has work to do)."""
    x, _, _ = _mixture(600, 1024, 8, seed=seed)
    rng = np.random.default_rng(seed + 1)
    c0 = x[rng.choice(600, 8, replace=False)].copy()
    return x, c0, 8


def test_fused_driver_matches_jax_at_d_1024():
    """The port's aa_kmeans on the fused engine (its plain version here)
    against the reference's on its fused engine (Pallas, interpret mode)
    from one c0: iterations and labels equal, energy within 1e-5."""
    x, c0, k = _driver_problem()
    got = aa_kmeans(_t(x), _t(c0), KMeansConfig(k=k, max_iter=20),
                    backend="fused")
    want = jaa_kmeans(_j(x), _j(c0), JKMeansConfig(k=k, max_iter=20),
                      backend=jget_backend("fused"))
    assert int(got.n_iter) == int(want.n_iter)
    assert int(got.n_accepted) == int(want.n_accepted)
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))
    np.testing.assert_allclose(float(got.energy), float(want.energy),
                               rtol=1e-5)


def test_estimator_fits_and_predicts_at_d_1024():
    """AAKMeans(backend="fused") on the CPU at d = 1024: the fit is the
    driver's from the same seeds, and predict's labels are the last
    step's; no kernel was launched."""
    x, c0, k = _driver_problem(seed=2)
    launched = (F.launches, A.launches)
    m = AAKMeans(n_clusters=k, backend="fused", device="cpu",
                 max_iter=20).fit(x, c0s=c0[None])
    res = aa_kmeans(_t(x), _t(c0), KMeansConfig(k=k, max_iter=20),
                    backend="fused")
    assert (m.n_iter_, m.n_accepted_) == (int(res.n_iter),
                                          int(res.n_accepted))
    assert torch.equal(m.centroids_, res.centroids)
    assert m.n_iter_ <= 20                         # converged
    np.testing.assert_array_equal(m.predict(x), res.labels.numpy())
    assert (F.launches, A.launches) == launched
