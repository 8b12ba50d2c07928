"""The bf16 compute path of the port against the JAX package.

Two ways into bf16, as in the reference: a ``Precision(compute=bf16)``
policy on an engine (X and C cast for the distance pass, stats, energies
and centroids in f32) and bf16 data (the whole solve in bf16, stats and
energies in f32).  Inputs are numpy from a seed, rounded to bf16 once and
handed to both packages; the reference's Pallas kernels run in interpret
mode, as its own tests run them.

Tolerances:
  * the kernels' plain versions against the Pallas kernels on bf16
    operands: labels exact, min_sqdist within 2e-5 (the reference's own
    bound for bf16 assignment, tests/test_kernels.py:17-26), sums within
    1e-4, counts exact;
  * every engine and step slot at the bf16 policy: the reference's
    conformance contract (tests/test_conformance.py:71-110) at its bf16
    tolerances, for the port and for the reference's same engine; the two
    energies within the same bf16 tolerance of each other;
  * the drivers: a bf16-policy fit's energy within the reference's 2 % of
    the f32 fit (tests/test_backends.py:201-213), in both packages; a
    bf16-data fit on a kernel engine, whose arithmetic is f32 on bf16
    values in both packages, ends on the reference's centroids to one
    bf16 rounding step and its energy to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backends as JB
from repro.core.api import AAKMeans as JAAKMeans
from repro.core.api import MiniBatchAAKMeans as JMiniBatchAAKMeans
from repro.core.init_schemes import kmeanspp_init as jkmeanspp
from repro.core.kmeans import KMeansConfig as JKMeansConfig
from repro.core.kmeans import aa_kmeans as jaa_kmeans
from repro.data.synthetic import make_blobs
from repro.kernels.assignment import assignment_pallas
from repro.kernels.fused_lloyd import fused_lloyd_pallas
from repro.kernels.update import update_pallas
from repro_torch.core import AAKMeans, MiniBatchAAKMeans, get_backend
from repro_torch.core import lloyd
from repro_torch.core.backends import (Precision, backend_names,
                                       dense_backend)
from repro_torch.core.kmeans import KMeansConfig, aa_kmeans
from repro_torch.core.minibatch import MiniBatchConfig, minibatch_init
from repro_torch.kernels import assignment as A
from repro_torch.kernels import build
from repro_torch.kernels import fused_lloyd as F
from repro_torch.kernels import update as U
from test_conformance import BACKEND_OPTS, TOLS, _check

torch.set_num_threads(2)

BF16 = Precision(compute=torch.bfloat16)
JBF16 = JB.Precision(compute=jnp.bfloat16)


def _bf16(a: np.ndarray) -> np.ndarray:
    """a rounded to bf16 (round to nearest even), kept as f32 values."""
    return torch.from_numpy(np.array(a, np.float32)) \
        .bfloat16().float().numpy()


def _t(a):
    """A bf16-exact f32 array as a bf16 tensor."""
    return torch.from_numpy(a).bfloat16()


def _j(a):
    """The same values as a bf16 JAX array (exact: they are bf16)."""
    return jnp.asarray(a, jnp.bfloat16)


def _np(t) -> np.ndarray:
    """A tensor or a JAX array as numpy, bf16 widened to f32."""
    if isinstance(t, torch.Tensor):
        return t.float().numpy() if t.is_floating_point() else t.numpy()
    return np.asarray(t, np.float32 if jnp.issubdtype(
        t.dtype, jnp.floating) else t.dtype)


def _close_step(got, want, sums=True, atol=2e-5, weighted=False):
    """The kernels' bf16 gates: labels exact, min_sqdist 2e-5 (``atol``
    where |x|^2 is large: the expansion cancels to its ulps), sums 1e-4,
    counts exact (weight totals 1e-5: sums of floats in another order),
    energy 1e-5 relative."""
    np.testing.assert_array_equal(_np(got[0]), _np(want[0]))
    np.testing.assert_allclose(_np(got[1]), _np(want[1]), rtol=2e-5,
                               atol=atol)
    if sums:
        np.testing.assert_allclose(_np(got[2]), _np(want[2]), rtol=1e-4,
                                   atol=1e-4)
        if weighted:
            np.testing.assert_allclose(_np(got[3]), _np(want[3]),
                                       rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(_np(got[3]), _np(want[3]))
        np.testing.assert_allclose(_np(got[4]), _np(want[4]), rtol=1e-5)


def _operands(n, d, k, r=None, x_batched=False, weights=None, seed=0):
    rng = np.random.default_rng(seed)
    x = _bf16(rng.standard_normal(((r, n, d) if x_batched else (n, d))))
    c = _bf16(rng.standard_normal(((r, k, d) if r else (k, d))))
    w = None
    if weights == "n":
        w = rng.uniform(0.0, 2.0, n).astype(np.float32)
    elif weights == "rn":
        w = rng.uniform(0.0, 2.0, (r, n)).astype(np.float32)
        w[:, : n // 3] = 0.0
    return x, c, w


# -- the kernels' plain versions against the Pallas kernels ------------------

# tests/test_kernels.py's shapes within this file's size limits
SHAPES = [(64, 4, 3), (513, 7, 3), (1000, 16, 10), (300, 2, 37)]


@pytest.mark.parametrize("n,d,k", SHAPES)
def test_assignment_plain_matches_pallas_bf16(n, d, k):
    x, c, _ = _operands(n, d, k, seed=n)
    got = A.assignment(_t(x), _t(c))              # the plain version
    want = assignment_pallas(_j(x), _j(c), interpret=True)
    _close_step(got, want, sums=False)
    # bf16 X against f32 centroids: the plain version on the upcast X
    mixed = A.assignment(_t(x), torch.from_numpy(c))
    for a, b in zip(mixed, A.assignment(torch.from_numpy(x),
                                        torch.from_numpy(c))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["single", "batched", "weighted"])
def test_fused_plain_matches_pallas_bf16(case):
    """One step: (N, d) X; R = 3 centroid sets over per-problem X with
    (R, N) weights (a third of them 0); (N,) weights."""
    n, d, k = 513, 7, 33
    r, xb, wk = {"single": (None, False, None),
                 "batched": (3, True, "rn"),
                 "weighted": (None, False, "n")}[case]
    x, c, w = _operands(n, d, k, r, xb, wk, seed=7)
    wt = None if w is None else torch.from_numpy(w)
    got = F.fused_lloyd(_t(x), _t(c), wt)
    want = fused_lloyd_pallas(_j(x), _j(c), None if w is None
                              else jnp.asarray(w), interpret=True)
    _close_step(got, want, weighted=w is not None)
    assert got[2].dtype == got[3].dtype == got[4].dtype == torch.float32


@pytest.mark.parametrize("weighted", [False, True])
def test_update_plain_matches_pallas_bf16(weighted):
    """Labels -1 and K land nowhere; the sums of the bf16 X are f32."""
    n, d, k = 1000, 16, 10
    x, _, w = _operands(n, d, k, weights="n" if weighted else None, seed=3)
    labels = np.random.default_rng(4).integers(-1, k + 1, n).astype(np.int32)
    got = U.update(_t(x), torch.from_numpy(labels), k,
                   None if w is None else torch.from_numpy(w))
    want = update_pallas(_j(x), jnp.asarray(labels), k,
                         w=None if w is None else jnp.asarray(w),
                         interpret=True)
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=1e-4,
                               atol=1e-4)
    if weighted:
        np.testing.assert_allclose(_np(got[1]), _np(want[1]), rtol=1e-5,
                                   atol=1e-5)
    else:
        np.testing.assert_array_equal(_np(got[1]), _np(want[1]))


@pytest.mark.parametrize("gs", [8, 16, 24, 40])
def test_fused_bounds_plain_matches_pallas_bf16(gs):
    """The bounded step on bf16 X and C from loose but valid bounds, at
    group sizes that are multiples of 8 (as the engines give them, and as
    the card's tensor-core bounded sweep takes them): the JAX kernel runs
    the port's 64-row tile and gs as its k tile.  Labels, the skipped
    share and every skipped group's bound exact; distances and computed
    group minima 2e-5; stats as the fused step.  Some cells skip where
    there are several groups; one group (gs = K) is always computed, since
    its lb^2 is at most the row's least distance."""
    rng = np.random.default_rng(gs)
    k, d, n = 40, 8, 390
    centers = rng.standard_normal((k, d)) * 20.0
    x = _bf16(centers[np.sort(rng.integers(0, k, n))]
              + rng.standard_normal((n, d)))
    c = _bf16(centers + 0.5 * rng.standard_normal((k, d)))
    w = rng.uniform(0.0, 2.0, n).astype(np.float32)
    x64, c64 = x.astype(np.float64), c.astype(np.float64)
    d2 = ((x64[:, None] - c64[None]) ** 2).sum(-1)
    lab0 = d2.argmin(1)
    ub_sq = 1.1 * d2[np.arange(n), lab0]
    g = -(-k // gs)
    d2p = np.concatenate([d2, np.full((n, g * gs - k), np.inf)], axis=1)
    lb_sq = d2p.reshape(n, g, gs).min(-1) * rng.uniform(0.9, 1.0, (n, g))
    bnds = (lab0.astype(np.int32), lb_sq.astype(np.float32),
            ub_sq.astype(np.float32))
    tile_rows = build.tile_rows()
    got = F.fused_bounds_plain(_t(x), _t(c), torch.from_numpy(w),
                               *(torch.from_numpy(b) for b in bnds), gs,
                               tile_rows)
    want = fused_lloyd_pallas(_j(x), _j(c), jnp.asarray(w), tn=tile_rows,
                              tk=gs, interpret=True,
                              bounds=tuple(jnp.asarray(b) for b in bnds))
    atol = max(2e-5, 1e-6 * float(np.max(np.sum(x * x, axis=-1))))
    _close_step(got[:5], want[:5], atol=atol, weighted=True)
    assert float(got[6]) == float(want[6])
    assert 0.0 < float(got[6]) < 1.0 if g > 1 else float(got[6]) == 0.0
    computed = F.ref.computed_cells(torch.from_numpy(bnds[1]),
                                    torch.from_numpy(bnds[2]),
                                    tile_rows).numpy()
    gmin, wg = _np(got[5]), _np(want[5])
    np.testing.assert_array_equal(gmin[~computed], bnds[1][~computed])
    np.testing.assert_array_equal(wg[~computed], bnds[1][~computed])
    np.testing.assert_allclose(gmin[computed], wg[computed], rtol=2e-5,
                               atol=atol)


def test_fused_bounds_plain_at_the_anchor_matches_pallas_bf16():
    """ub^2 = +inf and lb^2 = 0 (the card's bit-exact anchor): every cell
    is computed and no seed wins, so the bounded step's labels and
    distances are the bf16 fused step's (bit for bit in the plain
    versions, which share their arithmetic), each row's least group
    minimum is its distance and nothing skips; against the reference's
    bounded kernel as ``test_fused_bounds_plain_matches_pallas_bf16``
    holds it."""
    rng = np.random.default_rng(11)
    k, d, n, gs = 40, 8, 390, 8
    x = _bf16(rng.standard_normal((n, d)) * 3.0)
    c = _bf16(rng.standard_normal((k, d)) * 3.0)
    w = rng.uniform(0.0, 2.0, n).astype(np.float32)
    g = -(-k // gs)
    bnds = (rng.integers(0, k, n).astype(np.int32),
            np.zeros((n, g), np.float32), np.full(n, np.inf, np.float32))
    got = F.fused_bounds_plain(_t(x), _t(c), torch.from_numpy(w),
                               *(torch.from_numpy(b) for b in bnds), gs,
                               build.tile_rows())
    fused = F.fused_lloyd_plain(_t(x), _t(c), torch.from_numpy(w))
    for a, b in zip(got[:5], fused):
        assert torch.equal(a, b)
    assert torch.equal(got[5].amin(dim=-1), got[1])
    assert float(got[6]) == 0.0
    want = fused_lloyd_pallas(_j(x), _j(c), jnp.asarray(w),
                              tn=build.tile_rows(), tk=gs, interpret=True,
                              bounds=tuple(jnp.asarray(b) for b in bnds))
    atol = max(2e-5, 1e-6 * float(np.max(np.sum(x * x, axis=-1))))
    _close_step(got[:5], want[:5], atol=atol, weighted=True)
    assert float(want[6]) == 0.0
    np.testing.assert_allclose(_np(got[5]), _np(want[5]), rtol=2e-5,
                               atol=atol)


# -- every engine and step slot at the bf16 policy ---------------------------

K, R = 5, 3


@pytest.fixture(scope="module")
def conformance():
    """tests/test_conformance.py's fixture: blobs (384, 8), K = 5, R = 3
    kmeans++ seed sets, the last 84 rows of weight 0."""
    x = np.asarray(make_blobs(384, 8, K, seed=0, spread=6.0), np.float32)
    xj = jnp.asarray(x)
    c = np.asarray(jkmeanspp(jax.random.PRNGKey(0), xj, K))
    cs = np.stack([np.asarray(jkmeanspp(jax.random.PRNGKey(r), xj, K))
                   for r in range(R)])
    w = np.concatenate([np.ones(300, np.float32),
                        np.zeros(84, np.float32)])
    return x, c, cs, w


def _slot(bk, mode, x, c, cs, w, conv, batch):
    """One step of the given slot; -> StepResult (leading R for batched)."""
    if mode == "single":
        res, _ = bk.step(conv(x), conv(c), K, bk.init_carry(conv(x),
                                                            conv(c), K))
    elif mode == "minibatch":
        res, _ = bk.minibatch_step(conv(x), conv(c), K, conv(w),
                                   bk.init_carry(conv(x), conv(c), K))
    else:
        res, _ = bk.batched_step(conv(x), conv(cs), K,
                                 batch(bk, conv(x), conv(cs)))
    return res


def _jax_batch(bk, x, cs):
    return jax.vmap(lambda cc: bk.init_carry(x, cc, K))(cs)


def _port_batch(bk, x, cs):
    return bk.batched_init_carry(x, cs, K)


# the reference's own bf16 cells that fail on some hosts (ROADMAP.md queue
# C): the port is held to the contract there, the reference is not
REFERENCE_FLAKY = {("blocked", "batched"), ("dense", "batched")}


@pytest.mark.parametrize("mode", ["single", "batched", "minibatch"])
@pytest.mark.parametrize("name", backend_names())
def test_step_slots_at_bf16_match_the_reference(conformance, name, mode):
    x, c, cs, w = conformance
    opts = BACKEND_OPTS.get(name.removesuffix("_reorder"), {})
    got = _slot(get_backend(name, precision=BF16, **opts), mode, x, c, cs,
                w, torch.from_numpy, _port_batch)
    want = _slot(JB.get_backend(name, precision=JBF16, **opts), mode, x, c,
                 cs, w, jnp.asarray, _jax_batch)
    tol = TOLS["bf16"]
    cell = f"{name}/{mode}/bf16"
    assert got.sums.dtype == got.counts.dtype == torch.float32
    port = {f: _np(getattr(got, f)) for f in got._fields}
    ref = {f: _np(getattr(want, f)) for f in want._fields}
    if mode == "batched":
        for r in range(R):
            _check(x, cs[r], type(want)(*(v[r] for v in port.values())),
                   tol, f"port {cell}[r={r}]")
            if (name, mode) not in REFERENCE_FLAKY:
                _check(x, cs[r], type(want)(*(v[r] for v in ref.values())),
                       tol, f"reference {cell}[r={r}]")
    else:
        wt = w if mode == "minibatch" else None
        _check(x, c, type(want)(*port.values()), tol, f"port {cell}", w=wt)
        _check(x, c, type(want)(*ref.values()), tol, f"reference {cell}",
               w=wt)
    np.testing.assert_allclose(port["energy"], ref["energy"],
                               rtol=tol["rtol"])


# -- the drivers --------------------------------------------------------------

@pytest.fixture(scope="module")
def backends_fixture():
    """tests/test_backends.py's fixture: blobs (1200, 8), K = 7."""
    x = np.asarray(make_blobs(1200, 8, 7, seed=0, spread=1.5), np.float32)
    c0 = np.asarray(jkmeanspp(jax.random.PRNGKey(0), jnp.asarray(x), 7))
    return x, c0


@pytest.mark.parametrize("name", ["dense", "fused", "pallas",
                                  "fused_bounds", "hamerly"])
def test_aa_kmeans_bf16_policy_against_reference(backends_fixture, name):
    """From the same c0: the bf16-policy fit lands within 2 % of the f32
    fit's energy in both packages (tests/test_backends.py:201-213), and
    the two bf16 energies within 2 % of each other; centroids stay f32.
    The iteration counts are reported, not compared: a bf16 distance tie
    can part the trajectories."""
    x, c0 = backends_fixture
    cfg = KMeansConfig(k=7, max_iter=300)
    f32 = aa_kmeans(torch.from_numpy(x), torch.from_numpy(c0), cfg,
                    backend=get_backend(name))
    res = aa_kmeans(torch.from_numpy(x), torch.from_numpy(c0), cfg,
                    backend=get_backend(name, precision=BF16))
    jres = jaa_kmeans(jnp.asarray(x), jnp.asarray(c0),
                      JKMeansConfig(k=7, max_iter=300),
                      backend=JB.get_backend(name, precision=JBF16))
    print(f"{name}: port {int(res.n_iter)} iterations, reference "
          f"{int(jres.n_iter)}, f32 {int(f32.n_iter)}")
    assert res.centroids.dtype == torch.float32
    e32, e, je = float(f32.energy), float(res.energy), float(jres.energy)
    assert np.isfinite(e) and abs(e - e32) / e32 < 0.02
    assert abs(je - e32) / e32 < 0.02 and abs(e - je) / je < 0.02


@pytest.mark.parametrize("name", ["fused", "pallas"])
def test_aa_kmeans_bf16_data_against_reference(backends_fixture, name):
    """bf16 X and c0 through the whole solve: seeds, the Anderson window
    and the centroids in bf16, stats and energies in f32.  On a kernel
    engine both packages compute in f32 on the bf16 values, so the port
    ends on the reference's iteration count, its centroids to one bf16
    rounding step (2**-7 of their magnitude) and its energy to 1e-4."""
    x, c0 = backends_fixture
    x, c0 = _bf16(x), _bf16(c0)
    res = aa_kmeans(_t(x), _t(c0), KMeansConfig(k=7, max_iter=300),
                    backend=get_backend(name))
    jres = jaa_kmeans(_j(x), _j(c0), JKMeansConfig(k=7, max_iter=300),
                      backend=JB.get_backend(name))
    assert res.centroids.dtype == torch.bfloat16
    assert res.energy.dtype == torch.float32
    assert int(res.n_iter) == int(jres.n_iter)
    got, want = _np(res.centroids), _np(jres.centroids)
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7,
                               atol=2.0 ** -7 * float(np.abs(want).max()))
    np.testing.assert_allclose(float(res.energy), float(jres.energy),
                               rtol=1e-4)


def test_traced_and_batched_drivers_on_bf16_data(backends_fixture):
    """The traced driver on bf16 X and c0 records the solve aa_kmeans makes
    (the same centroids bit for bit, its iteration count and energy), in
    step with the reference's traced driver (iterations equal, energies
    within 1e-4); the batched driver keeps R bf16 windows and f32
    energies, each restart within 1e-4 of its own single solve's energy
    (the segment sum's slabs follow R, so the sums' last bits may
    differ)."""
    from repro.core.kmeans import aa_kmeans_traced as jtraced
    from repro_torch.core.kmeans import aa_kmeans_batched, aa_kmeans_traced
    x, c0 = backends_fixture
    x, c0 = _bf16(x), _bf16(c0)
    cfg = KMeansConfig(k=7, max_iter=300)
    single = aa_kmeans(_t(x), _t(c0), cfg, backend="fused")
    tr = aa_kmeans_traced(_t(x), _t(c0), cfg, backend="fused")
    assert torch.equal(tr.result.centroids, single.centroids)
    assert int(tr.result.n_iter) == int(single.n_iter)
    assert float(tr.result.energy) == float(single.energy)
    jtr = jtraced(_j(x), _j(c0), JKMeansConfig(k=7, max_iter=300),
                  backend=JB.get_backend("fused"))
    assert int(tr.result.n_iter) == int(jtr.result.n_iter)
    np.testing.assert_allclose(np.asarray(tr.energies, np.float64),
                               np.asarray(jtr.energies, np.float64),
                               rtol=1e-4)
    c1 = _bf16(x[np.random.default_rng(1).choice(len(x), 7, replace=False)])
    both = aa_kmeans_batched(_t(x), torch.stack([_t(c0), _t(c1)]), cfg,
                             backend="fused")
    assert both.centroids.dtype == torch.bfloat16
    assert both.energy.dtype == torch.float32
    for r, c in enumerate((c0, c1)):
        alone = aa_kmeans(_t(x), _t(c), cfg, backend="fused")
        np.testing.assert_allclose(float(both.energy[r]),
                                   float(alone.energy), rtol=1e-4)


# -- the accumulation floor (tests/test_persistence.py:386-450) --------------

def test_bf16_counts_do_not_saturate():
    n = 1000
    x = torch.ones((n, 4), dtype=torch.bfloat16)
    labels = torch.zeros((n,), dtype=torch.int32)
    sums, counts = lloyd.cluster_sums(x, labels, 2)
    assert counts.dtype == torch.float32 and sums.dtype == torch.float32
    np.testing.assert_array_equal(counts.numpy(), [n, 0])
    _, wcounts = lloyd.weighted_cluster_sums(
        x, labels, torch.ones((n,), dtype=torch.bfloat16), 2)
    np.testing.assert_array_equal(wcounts.numpy(), [n, 0])


def test_batched_accum_policy_floors_at_f32():
    bk = dense_backend(Precision(compute=torch.bfloat16,
                                 accum=torch.bfloat16))
    n = 1000
    x = torch.ones((n, 4), dtype=torch.bfloat16)
    cs = torch.zeros((2, 2, 4), dtype=torch.bfloat16)
    cs[:, 1] = 9.0
    res, _ = bk.batched_step_fn(x, cs, 2, ((), ()))
    assert res.counts.dtype == torch.float32
    np.testing.assert_array_equal(res.counts.numpy(), [[n, 0]] * 2)
    resw, _ = bk.minibatch_step_fn(x, cs[0], 2,
                                   torch.ones((n,), dtype=torch.bfloat16),
                                   ())
    np.testing.assert_array_equal(resw.counts.numpy(), [n, 0])


def test_bf16_dense_solve_counts_match_f32_oracle():
    """A bf16 dense solve whose clusters pass 256 members keeps exact
    counts; the streaming state floors its accumulators the same way."""
    x = np.asarray(make_blobs(2000, 4, 4, seed=8, spread=6.0), np.float32)
    c0 = np.asarray(jkmeanspp(jax.random.PRNGKey(8), jnp.asarray(x), 4))
    bk = dense_backend(Precision(compute=torch.bfloat16,
                                 accum=torch.bfloat16))
    xb = torch.from_numpy(x).bfloat16()
    res = aa_kmeans(xb, torch.from_numpy(c0).bfloat16(),
                    KMeansConfig(k=4, max_iter=50), backend=bk)
    step, _ = bk.step(xb, res.centroids, 4, ())
    oracle = np.bincount(step.labels.numpy(), minlength=4)
    assert oracle.max() > 256, "fixture must exercise the saturation range"
    np.testing.assert_array_equal(step.counts.numpy().astype(np.float64),
                                  oracle)
    st = minibatch_init(torch.from_numpy(c0), MiniBatchConfig(k=4), bk)
    assert st.counts.dtype == torch.float32
    assert st.sums.dtype == st.e_prev.dtype == torch.float32


# -- the estimators -----------------------------------------------------------

@pytest.fixture(scope="module")
def est_data():
    return np.asarray(make_blobs(1500, 6, 5, seed=11, spread=4.0),
                      np.float32)


def _ref_seeds(x, k, seed=0):
    """The seeds the reference's AAKMeans(seed=seed).fit(x) draws (x a
    JAX array: a bf16 X is seeded in bf16), as f32 numpy."""
    from repro.core.init_schemes import batched_init
    keys = jax.random.split(jax.random.PRNGKey(seed), 1)
    return np.asarray(batched_init("kmeans++", keys, jnp.asarray(x), k),
                      np.float32)


@pytest.mark.parametrize("mode", ["policy", "data"])
def test_estimator_fit_predict_transform(est_data, mode):
    """Both entry modes through AAKMeans from the reference's seeds: the
    fitted labels and predict equal the reference's, the energy within
    1e-3; the bf16-data model predicts and transforms bf16 rows in bf16,
    the bf16-policy model f32 rows in f32 (the policy does not apply at
    predict, as in the reference)."""
    x = est_data
    if mode == "policy":
        port = AAKMeans(n_clusters=5, device="cpu",
                        backend=get_backend("fused", precision=BF16))
        jm = JAAKMeans(n_clusters=5,
                       backend=JB.get_backend("fused", precision=JBF16))
        xp, xj = x, jnp.asarray(x)
    else:
        port = AAKMeans(n_clusters=5, device="cpu", backend="fused")
        jm = JAAKMeans(n_clusters=5, backend="fused")
        x = _bf16(x)
        xp, xj = _t(x), _j(x)
    port.fit(xp, c0s=_ref_seeds(xj, 5))
    jm.fit(xj)
    want_dtype = torch.float32 if mode == "policy" else torch.bfloat16
    assert port.centroids_.dtype == want_dtype
    np.testing.assert_allclose(port.inertia_, jm.inertia_, rtol=1e-3)
    labels = port.predict(xp)
    np.testing.assert_array_equal(labels, np.asarray(jm.predict(xj)))
    np.testing.assert_array_equal(labels, port.labels_.numpy())
    dist = port.transform(xp)
    assert dist.dtype == np.float32 and dist.shape == (x.shape[0], 5)
    np.testing.assert_array_equal(np.argmin(dist, axis=1), labels)
    # squared distances within four bf16 steps of the largest |x|^2: the
    # two packages round the bf16 expansion at other places
    jd = np.asarray(jm.transform(xj), np.float32)
    np.testing.assert_allclose(dist ** 2, jd ** 2, rtol=2e-2, atol=2.0 ** -6
                               * float(np.max(np.sum(x * x, axis=1))))
    # numpy bf16 input (np.asarray of a jax bf16 array) reads as bf16
    np.testing.assert_array_equal(port.predict(np.asarray(_j(x))),
                                  port.predict(_t(x)))


def test_bf16_artifacts_cross_load(tmp_path, est_data):
    """A bf16-policy artifact saved by the reference loads in the port
    with its policy, and the port's loads back in the reference with
    ``precision.compute == jnp.bfloat16``; bf16 centroids round-trip bit
    for bit in both directions."""
    x = est_data
    jm = JAAKMeans(n_clusters=5, max_iter=30,
                   backend=JB.get_backend("fused", precision=JBF16)).fit(
        jnp.asarray(x))
    pm = AAKMeans.load(jm.save(tmp_path / "ref_policy"), device="cpu")
    assert pm.backend.precision.compute == torch.bfloat16
    np.testing.assert_array_equal(pm.predict(x), np.asarray(jm.predict(x)))
    port = AAKMeans(n_clusters=5, max_iter=30, device="cpu",
                    backend=get_backend("fused", precision=BF16)).fit(
        x, c0s=_ref_seeds(jnp.asarray(x), 5))
    back = JAAKMeans.load(port.save(tmp_path / "port_policy"))
    assert back.backend.precision.compute == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back.predict(x)),
                                  port.predict(x))
    # bf16 centroids: port -> port, port -> reference, reference -> port
    xb = _bf16(x)
    pb = AAKMeans(n_clusters=5, max_iter=30, device="cpu",
                  backend="fused").fit(_t(xb), c0s=_ref_seeds(_j(xb), 5))
    p2 = AAKMeans.load(pb.save(tmp_path / "port_bf16"), device="cpu")
    assert p2.centroids_.dtype == torch.bfloat16
    assert torch.equal(p2.centroids_.view(torch.int16),
                       pb.centroids_.view(torch.int16))
    j2 = JAAKMeans.load(tmp_path / "port_bf16.npz")
    assert np.asarray(j2.centroids_).dtype.name == "bfloat16"
    np.testing.assert_array_equal(
        np.asarray(j2.centroids_).view(np.int16),
        pb.centroids_.view(torch.int16).numpy())
    jb = JAAKMeans(n_clusters=5, max_iter=30, backend="fused").fit(_j(xb))
    p3 = AAKMeans.load(jb.save(tmp_path / "ref_bf16"), device="cpu")
    np.testing.assert_array_equal(p3.centroids_.view(torch.int16).numpy(),
                                  np.asarray(jb.centroids_).view(np.int16))
    np.testing.assert_array_equal(p3.predict(_t(xb)),
                                  np.asarray(jb.predict(_j(xb))))


def test_minibatch_estimator_bf16_policy(tmp_path, est_data):
    """MiniBatchAAKMeans with the bf16-policy fused engine: chunks stay
    f32 and are cast in the step; the running stats, energies and
    centroids are f32; a repeat is bit-equal; the model saves and loads
    with its policy and predicts as before; its energy is within 2 % of
    the f32 engine's fit."""
    x = est_data
    kw = dict(n_clusters=5, chunk_size=256, epochs=2, val_size=256,
              device="cpu")
    bk = get_backend("fused", precision=BF16)
    fits = [MiniBatchAAKMeans(backend=bk, **kw).fit(x) for _ in range(2)]
    m = fits[0]
    assert m.centroids_.dtype == torch.float32
    assert torch.equal(m.centroids_, fits[1].centroids_)
    f32 = MiniBatchAAKMeans(backend="fused", **kw).fit(x)
    assert abs(m.energy_ - f32.energy_) / f32.energy_ < 0.02
    m2 = MiniBatchAAKMeans.load(m.save(tmp_path / "mb"), device="cpu")
    assert m2.backend.precision.compute == torch.bfloat16
    np.testing.assert_array_equal(m2.predict(x), m.predict(x))
    jm = JMiniBatchAAKMeans.load(tmp_path / "mb.npz")
    assert jm.backend.precision.compute == jnp.bfloat16


def test_minibatch_estimator_bf16_data(est_data):
    """MiniBatchAAKMeans on a bf16 X held on the device: bf16 chunks,
    seeds and centroids, f32 running stats and energies, a bit-equal
    repeat, and labels_ its predict of the bf16 rows; its energy within
    2 % of the f32 fit's."""
    x = est_data
    kw = dict(n_clusters=5, chunk_size=256, epochs=2, val_size=256,
              device="cpu", backend="fused")
    fits = [MiniBatchAAKMeans(**kw).fit(_t(_bf16(x))) for _ in range(2)]
    m = fits[0]
    assert m.centroids_.dtype == torch.bfloat16
    assert torch.equal(m.centroids_, fits[1].centroids_)
    assert m._state is None and np.isfinite(m.energy_)
    np.testing.assert_array_equal(m.labels_, m.predict(_t(_bf16(x))))
    f32 = MiniBatchAAKMeans(**kw).fit(x)
    assert abs(m.energy_ - f32.energy_) / f32.energy_ < 0.02


# -- refusals -----------------------------------------------------------------

def test_float16_is_refused():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Precision(compute=torch.float16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Precision(accum=torch.float16)
    with pytest.raises(TypeError):
        AAKMeans(n_clusters=2, device="cpu").fit(
            torch.zeros((8, 2), dtype=torch.float16))
    with pytest.raises(TypeError):
        F.fused_lloyd(torch.zeros((8, 2), dtype=torch.float16),
                      torch.zeros((2, 2)))


def _fitted(mode, x):
    if mode == "policy":
        return AAKMeans(n_clusters=3, max_iter=10, device="cpu",
                        backend=get_backend("fused", precision=BF16)).fit(x)
    return AAKMeans(n_clusters=3, max_iter=10, device="cpu",
                    backend="fused").fit(torch.from_numpy(x).bfloat16())


@pytest.mark.parametrize("mode", ["policy", "data"])
def test_serving_refuses_bf16(mode):
    from repro_torch.serving.closure import build_closure_index
    from repro_torch.serving.server import KMeansServer, ServingModel
    x = np.asarray(make_blobs(300, 4, 3, seed=1), np.float32)
    m = _fitted(mode, x)
    for call in (lambda: m.build_serving_index(),
                 lambda: m.predict(x, approx=True),
                 lambda: m.transform(x, approx=True),
                 lambda: ServingModel.from_estimator(m),
                 lambda: KMeansServer(m)):
        with pytest.raises(NotImplementedError, match="bf16 paths refused"):
            call()
    if mode == "data":
        with pytest.raises(NotImplementedError, match="serving index"):
            build_closure_index(m.centroids_)


@pytest.mark.parametrize("mode", ["policy", "data"])
def test_hierarchy_and_applications_refuse_bf16(mode):
    from repro_torch.core.applications import (kv_codebook_hierarchical,
                                               kv_codebooks_batched)
    from repro_torch.core.hierarchy import aa_kmeans_hierarchical
    x = np.asarray(make_blobs(400, 4, 8, seed=2), np.float32)
    if mode == "policy":
        bk, xin = get_backend("fused", precision=BF16), x
    else:
        bk, xin = "fused", torch.from_numpy(x).bfloat16()
    with pytest.raises(NotImplementedError, match="two-level"):
        AAKMeans(n_clusters=8, device="cpu", backend=bk,
                 hierarchical=True).fit(xin)
    with pytest.raises(NotImplementedError, match="two-level"):
        aa_kmeans_hierarchical(torch.as_tensor(xin), 8, backend=bk)
    if mode == "policy":
        v = torch.from_numpy(x)[None]
        with pytest.raises(NotImplementedError, match="codebook"):
            kv_codebooks_batched(v, 4, backend=bk)
        with pytest.raises(NotImplementedError, match="two-level"):
            kv_codebook_hierarchical(v[0], 8, backend=bk)


@pytest.mark.parametrize("mode", ["policy", "data"])
def test_mesh_refuses_bf16(mode):
    """Every mesh path refuses before it touches the mesh or a process
    group: the estimators' mesh fits, the data placement and
    ``distribute``."""
    from repro_torch.core import distributed as D
    from repro_torch.core.backends import distribute
    x = np.asarray(make_blobs(200, 4, 3, seed=3), np.float32)
    if mode == "policy":
        bk, xin = get_backend("fused", precision=BF16), x
        with pytest.raises(NotImplementedError, match="mesh"):
            distribute(bk, ("data",))
    else:
        bk, xin = "fused", torch.from_numpy(x).bfloat16()
        with pytest.raises(NotImplementedError, match="mesh"):
            D.shard_dataset(xin, None)
        with pytest.raises(NotImplementedError, match="mesh"):
            D.local_block(xin, None, ("data",))
    for est in (AAKMeans, MiniBatchAAKMeans):
        with pytest.raises(NotImplementedError, match="mesh"):
            est(n_clusters=3, backend=bk, mesh=object()).fit(xin)


@pytest.mark.parametrize("mode", ["policy", "data"])
def test_host_streaming_refuses_bf16(mode):
    from repro_torch.core.kmeans import aa_kmeans_minibatch_streamed
    x = np.asarray(make_blobs(600, 4, 3, seed=4), np.float32)
    if mode == "policy":
        bk, chunk = get_backend("fused", precision=BF16), x
    else:
        bk, chunk = "fused", torch.from_numpy(x).bfloat16()
    m = MiniBatchAAKMeans(n_clusters=3, val_size=64, device="cpu",
                          backend=bk)
    with pytest.raises(NotImplementedError, match="host-streamed"):
        m.partial_fit(chunk)
    with pytest.raises(NotImplementedError, match="host-streamed"):
        m.partial_fit_stream(iter([chunk]))
    with pytest.raises(NotImplementedError, match="host-streamed"):
        aa_kmeans_minibatch_streamed(
            chunk, torch.as_tensor(chunk[:64]), torch.as_tensor(chunk[:3]),
            MiniBatchConfig(k=3, epochs=1), bk, chunk_size=128,
            device="cpu")
    if mode == "data":
        # an iterator's bf16 chunk is refused where it arrives
        with pytest.raises(NotImplementedError, match="host-streamed"):
            aa_kmeans_minibatch_streamed(
                iter([chunk[:128]]), torch.from_numpy(x[:64]),
                torch.from_numpy(x[:3]), MiniBatchConfig(k=3, epochs=1),
                "fused", device="cpu")
