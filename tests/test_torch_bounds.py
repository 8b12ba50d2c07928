"""The port's bound contract (repro_torch.core.backends.bounds), its
tile-skipping kernel's plain version and its "fused_bounds" engine
against the JAX package's.

* The group and drift helpers and ``init_carry`` equal the reference's.
* ``fused_bounds_plain`` at the port's row tile against the Pallas
  ``_fused_bounds_kernel`` run in interpret mode with the same row tile
  (``tn``) and group size (``tk``), on bounds of real drift-updated
  carries: labels and the skipped share exact, every skipped group's
  minimum exact (both pass the input bound through), computed group
  minima and min distances within 2e-5 (each side's own matmul, the
  tolerance of tests/test_kernels_v2.py) or 1e-6 of max |x|^2 where that
  is larger (after real Lloyd steps a centroid can sit on a row, and
  |x|^2 - 2 x.c + |c|^2 then cancels to a few ulps of |x|^2 on one side
  and 0 on the other), sums within 1e-5 of their scale and energies
  within 1e-5 relative plus 1e-6 of sum |x|^2 (the rows' errors add).
* The carry invariants after Lloyd steps, an accepted-Anderson-like jump
  and an exact revert, against brute-force f32 distances
  (``pairwise_sqdist``), as tests/test_bounds.py checks them for the
  reference.
* One batched trip from identical JAX state through ``interop``, and
  whole fits, against the reference's engine.  The two packages tile
  rows differently (64 here, up to 512 there), so their carries' lower
  bounds differ where one computed a cell the other skipped: they are
  checked as bounds, not against each other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.api import AAKMeans as JAAKMeans
from repro.core.backends import bounds as jbounds
from repro.core.backends import get_backend as jget_backend
from repro.core.kmeans import KMeansConfig as JKMeansConfig
from repro.core.kmeans import _init_batched_state
from repro.core.kmeans import aa_kmeans_batched as jaa_kmeans_batched
from repro.data.synthetic import make_blobs, make_dataset
from repro.kernels.fused_lloyd import fused_lloyd_pallas
from repro_torch.core import AAKMeans, get_backend
from repro_torch.core.backends import bounds
from repro_torch.core.backends.fused_bounds import squared_bounds
from repro_torch.core.kmeans import KMeansConfig, _init_state, batched_trip
from repro_torch.core.lloyd import pairwise_sqdist
from repro_torch.data import synthetic as tsynthetic
from repro_torch.interop import batched_state_from_numpy
from repro_torch.kernels import build, ref
from repro_torch.kernels import fused_lloyd as F
from test_torch_kmeans import _assert_state_close, _jax_seeds

torch.set_num_threads(2)

# carry slack for f32 sqrt/drift round-off, as tests/test_bounds.py
ATOL = 1e-3


def _j(a):
    return None if a is None else jnp.asarray(np.asarray(a))


def _tj(a):
    """A JAX array as a tensor."""
    return torch.from_numpy(np.array(a))


# -- the contract's helpers ---------------------------------------------------

@pytest.mark.parametrize("k,gs", [(1000, None), (13, None), (37, 24),
                                  (37, 500), (1000, 200)])
def test_group_helpers_match_jax(k, gs):
    size = bounds.resolve_group_size(k, gs)
    assert size == jbounds.resolve_group_size(k, gs, "tile")
    g, size = bounds.group_layout(k, size)
    assert (g, size) == jbounds.group_layout(k, size)
    assert torch.equal(bounds.group_ids(k, size),
                       _tj(jbounds.group_ids(k, size)))
    rng = np.random.default_rng(k)
    c_new = rng.standard_normal((k, 4)).astype(np.float32)
    c_old = rng.standard_normal((k, 4)).astype(np.float32)
    d = rng.uniform(0, 5, (20, k)).astype(np.float32)
    labels = rng.integers(0, k, 20).astype(np.int32)
    upper = rng.uniform(0, 5, 20).astype(np.float32)
    lower = rng.uniform(0, 5, (20, g)).astype(np.float32)
    drift = bounds.centroid_drift(torch.from_numpy(c_new),
                                  torch.from_numpy(c_old))
    jdrift = jbounds.centroid_drift(_j(c_new), _j(c_old))
    np.testing.assert_allclose(drift.numpy(), np.asarray(jdrift), rtol=1e-6)
    assert torch.equal(bounds.group_max(drift, g, size),
                       _tj(jbounds.group_max(_j(drift), g, size)))
    assert torch.equal(bounds.group_min(torch.from_numpy(d), g, size),
                       _tj(jbounds.group_min(_j(d), g, size)))
    got = bounds.drift_update(torch.from_numpy(labels),
                              torch.from_numpy(upper),
                              torch.from_numpy(lower), drift, g, size)
    want = jbounds.drift_update(_j(labels), _j(upper), _j(lower), _j(drift),
                                g, size)
    for a, b in zip(got, want):
        assert torch.equal(a, _tj(b))
    # batched: every leaf with a leading R axis, each row as one problem
    got_b = bounds.drift_update(*(torch.from_numpy(np.stack([a, a]))
                                  for a in (labels, upper, lower)),
                                torch.stack([drift, drift]), g, size)
    for a, b in zip(got_b, got):
        assert torch.equal(a[1], b)


def test_init_carry_matches_jax_and_batches():
    x = np.zeros((50, 3), np.float32)
    c = np.random.default_rng(0).standard_normal((2, 13, 3)) \
        .astype(np.float32)
    one = bounds.init_carry(torch.from_numpy(x), torch.from_numpy(c[0]),
                            13, 8)
    want = jbounds.init_carry(_j(x), _j(c[0]), 13, 8)
    for a, b in zip(one[:4], want[:4]):
        assert torch.equal(a, _tj(b))
    assert float(one[4].skipped_frac) == 0.0
    both = bounds.init_carry(torch.from_numpy(x), torch.from_numpy(c), 13, 8)
    for a, b in zip(both[:4], one[:4]):
        assert a.shape == (2,) + b.shape and torch.equal(a[0], b)
    assert both[4].skipped_frac.shape == (2,)
    assert bounds.extract_stats(((), both)) is both[4]
    assert bounds.extract_stats(()) is None


# -- the tile-skipping kernel's plain version ---------------------------------

def _drifted_bounds(x, c, w, gs, steps=2):
    """Bounds of a real carry: the engine steps ``steps`` times from the
    init carry, each time to the Lloyd update of the last step; then the
    drift to the next centroids is applied.  -> (c, (lab0, lb_sq, ub_sq))
    with a leading R axis."""
    bk = get_backend("fused_bounds", group_size=gs)
    k = c.shape[-2]
    carry = bk.init_carry(x, c, k)
    for _ in range(steps):
        res, carry = bk.batched_step(x, c, k, carry, w=w)
        c = bk.centroids_from_step(x, res, k, c)
    return c, squared_bounds(carry, c, k, gs)


def _problem(n, d, k, r, x_batched, weights, seed, ordered=False):
    rng = np.random.default_rng(seed)
    if ordered:               # rows cluster by cluster, centroids likewise
        centers = rng.standard_normal((k, d)).astype(np.float32) * 20.0
        x = np.concatenate([centers[j] + rng.standard_normal(
            (n // k, d)).astype(np.float32) for j in range(k)])
        c = (centers + 0.5 * rng.standard_normal((k, d)))[None] \
            .astype(np.float32)
    else:
        x = rng.standard_normal(((r, n, d) if x_batched else (n, d)),
                                dtype=np.float32) * 3.0
        c = rng.standard_normal((r, k, d), dtype=np.float32)
    w = None
    if weights == "n":
        w = rng.uniform(0.0, 2.0, n).astype(np.float32)
    elif weights == "rn":
        w = rng.uniform(0.0, 2.0, (r, n)).astype(np.float32)
        w[:, : n // 4] = 0.0
    return x, c, w


def _assert_bounded_step_close(got, want, x, lb_sq, ub_sq, tile_rows):
    lab, mind, sums, counts, energy, gmin, skip = \
        [np.asarray(g) for g in got]
    wl, wm, ws, wc, we, wg, wk = [np.asarray(v) for v in want]
    np.testing.assert_array_equal(lab, wl)
    np.testing.assert_array_equal(skip, wk)
    atol = max(2e-5, 1e-6 * float(np.max(np.sum(np.square(x), axis=-1))))
    np.testing.assert_allclose(mind, wm, rtol=2e-5, atol=atol)
    scale = np.abs(ws).max()
    np.testing.assert_allclose(sums, ws, rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(counts, wc, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(energy, we, rtol=1e-5, atol=1e-6 * float(
        np.sum(np.square(x), axis=(-2, -1)).max()))
    computed = np.stack([ref.computed_cells(lb, ub, tile_rows).numpy()
                         for lb, ub in zip(lb_sq, ub_sq)])
    gmin, wg = gmin.reshape(computed.shape), wg.reshape(computed.shape)
    np.testing.assert_array_equal(gmin[~computed], wg[~computed])
    np.testing.assert_array_equal(gmin[~computed],
                                  np.asarray(lb_sq)[~computed])
    np.testing.assert_allclose(gmin[computed], wg[computed], rtol=2e-5,
                               atol=atol)


CASES = {
    "single": (300, 5, 37, 1, False, None),
    "(N,) weights": (300, 5, 37, 1, False, "n"),
    "R=2 shared X": (200, 7, 29, 2, False, None),
    "R=2 per-problem X, (R,N) weights": (200, 7, 29, 2, True, "rn"),
}


@pytest.mark.parametrize("gs", [8, 24, 40])
@pytest.mark.parametrize("case", list(CASES))
def test_fused_bounds_plain_matches_jax_kernel(case, gs):
    """gs = 24 and 40 divide neither the 64-row tile nor K; the JAX kernel
    runs the port's row tile and gs as its k tile."""
    n, d, k, r, x_batched, weights = CASES[case]
    x, c, w = _problem(n, d, k, r, x_batched, weights, seed=gs)
    xt, wt = torch.from_numpy(x), None if w is None else torch.from_numpy(w)
    c, bnds = _drifted_bounds(xt, torch.from_numpy(c), wt, gs)
    tile_rows = build.tile_rows()
    if r == 1 and weights != "rn":          # the unbatched form
        args = (xt, c[0], wt, *(b[0] for b in bnds))
        lift = (lambda out: [o[None] for o in out])
    else:
        args = (xt, c, wt, *bnds)
        lift = (lambda out: list(out))
    got = lift(F.fused_bounds_plain(*args, gs, tile_rows))
    want = lift(fused_lloyd_pallas(
        _j(args[0]), _j(args[1]), _j(args[2]), tn=tile_rows, tk=gs,
        interpret=True, bounds=tuple(_j(b) for b in args[3:])))
    _assert_bounded_step_close(got, want, x, bnds[1], bnds[2], tile_rows)


def _loose_bounds(x, c, gs, rng):
    """Valid bounds at any group size (the engine rounds its groups to 8):
    lab0 the nearest centroid of c moved a little, ub^2 the squared
    distance to it grown by 10%, lb^2 each group's squared minimum shrunk
    by a random factor in [0.9, 1].  In f64, then f32."""
    x64, c64 = x.astype(np.float64), c.astype(np.float64)
    d2 = ((x64[:, None] - c64[None]) ** 2).sum(-1)
    moved = c64 + 0.1 * rng.standard_normal(c.shape)
    lab0 = ((x64[:, None] - moved[None]) ** 2).sum(-1).argmin(1)
    ub_sq = 1.1 * d2[np.arange(len(x)), lab0]
    k, g = c.shape[0], -(-c.shape[0] // gs)
    d2 = np.concatenate([d2, np.full((len(x), g * gs - k), np.inf)], axis=1)
    lb_sq = d2.reshape(len(x), g, gs).min(-1) * rng.uniform(0.9, 1.0,
                                                              (len(x), g))
    return (lab0.astype(np.int32), lb_sq.astype(np.float32),
            ub_sq.astype(np.float32))


@pytest.mark.parametrize("gs", [7, 100, 200])
def test_fused_bounds_plain_matches_jax_kernel_across_chunks(gs):
    """K = 300 > 256, so the CUDA kernel's 256-centroid chunks split the
    centroids: groups of 100 and 200 straddle the chunk boundary, and 7 is
    not a multiple of the 4-centroid copy vector.  The bounds are built at
    exactly gs; rows come cluster by cluster, so cells skip."""
    rng = np.random.default_rng(gs)
    k, d, n = 300, 8, 390
    centers = rng.standard_normal((k, d)).astype(np.float32) * 20.0
    x = centers[np.sort(rng.integers(0, k, n))] + rng.standard_normal(
        (n, d)).astype(np.float32)
    c = centers + 0.5 * rng.standard_normal((k, d)).astype(np.float32)
    w = rng.uniform(0.0, 2.0, n).astype(np.float32)
    bnds = _loose_bounds(x, c, gs, rng)
    tile_rows = build.tile_rows()
    got = F.fused_bounds_plain(torch.from_numpy(x), torch.from_numpy(c),
                               torch.from_numpy(w),
                               *(torch.from_numpy(b) for b in bnds), gs,
                               tile_rows)
    want = fused_lloyd_pallas(_j(x), _j(c), _j(w), tn=tile_rows, tk=gs,
                              interpret=True,
                              bounds=tuple(_j(b) for b in bnds))
    assert 0.0 < float(got[6]) < 1.0
    _assert_bounded_step_close(
        [o[None] for o in got], [np.asarray(o)[None] for o in want], x,
        torch.from_numpy(bnds[1])[None], torch.from_numpy(bnds[2])[None],
        tile_rows)


def test_fused_bounds_skips_on_ordered_rows():
    """Rows laid out cluster by cluster (the reference's "ordered"
    layout): once the bounds are tight most cells skip, and the plain
    version still agrees with the JAX kernel."""
    x, c, _ = _problem(1024, 6, 32, 1, False, None, seed=7, ordered=True)
    xt = torch.from_numpy(x)
    c, bnds = _drifted_bounds(xt, torch.from_numpy(c), None, 8, steps=3)
    tile_rows = build.tile_rows()
    got = F.fused_bounds_plain(xt, c, None, *bnds, 8, tile_rows)
    want = fused_lloyd_pallas(_j(x), _j(c), tn=tile_rows, tk=8,
                              interpret=True,
                              bounds=tuple(_j(b) for b in bnds))
    assert float(got[6][0]) > 0.5
    _assert_bounded_step_close(got, want, x, bnds[1], bnds[2], tile_rows)


def test_seed_keeps_a_tie():
    """Integer data, so every distance is exact: centroid j and its copy
    j + 10 tie, the standing label is the copy, and it stays — in the
    reference's kernel and in the port's plain version alike."""
    rng = np.random.default_rng(3)
    x = rng.integers(-4, 5, (300, 6)).astype(np.float32)
    c = rng.integers(-4, 5, (10, 6)).astype(np.float32)
    c2 = np.concatenate([c, c])
    dist = ((x[:, None] - c2[None]) ** 2).sum(-1)
    lab0 = (dist[:, :10].argmin(1) + 10).astype(np.int32)
    ub_sq = dist[:, :10].min(1).astype(np.float32)
    lb_sq = np.zeros((300, 5), np.float32)
    got = F.fused_lloyd(*(torch.from_numpy(a) for a in (x, c2)),
                        bounds=tuple(torch.from_numpy(a)
                                     for a in (lab0, lb_sq, ub_sq)), gs=4)
    want = fused_lloyd_pallas(_j(x), _j(c2), tn=build.tile_rows(), tk=4,
                              interpret=True,
                              bounds=(_j(lab0), _j(lb_sq), _j(ub_sq)))
    np.testing.assert_array_equal(np.asarray(want[0]), lab0)
    np.testing.assert_array_equal(got[0].numpy(), lab0)
    np.testing.assert_array_equal(got[1].numpy(), ub_sq)


def test_bounds_operand_checks():
    x, c = torch.zeros(10, 3), torch.zeros(5, 3)
    lab0 = torch.zeros(10, dtype=torch.int32)
    ub = torch.zeros(10)
    with pytest.raises(ValueError):                # G = 3 for gs = 2
        F.fused_lloyd(x, c, bounds=(lab0, torch.zeros(10, 2), ub), gs=2)
    with pytest.raises(ValueError):
        F.fused_lloyd(x, c, bounds=(lab0, torch.zeros(10, 3), ub))
    with pytest.raises(TypeError):
        F.fused_lloyd(x, c, bounds=(lab0.long(), torch.zeros(10, 3), ub),
                      gs=2)
    with pytest.raises(ValueError):
        F.fused_lloyd(x, c, gs=2)


# -- the engine ---------------------------------------------------------------

def _aa_like_moves(x, c0, k, bk, rng):
    """Yields the centroids of each step: two Lloyd updates, an
    accepted-Anderson-like jump, an exact revert, then Lloyd."""
    c, c_prejump = c0, None
    for step_i in range(7):
        yield c
        if step_i == 2:
            c_prejump = c
            c = c + torch.from_numpy(
                rng.normal(size=tuple(c.shape)).astype(np.float32))
        elif step_i == 3:
            c = c_prejump
        else:
            lab = torch.argmin(torch.cdist(x, c), dim=1).to(torch.int32)
            c = bk.update(x, lab, k, c)


@pytest.mark.parametrize("group_size", [None, 8, 24])
def test_bound_invariants_across_jumps_and_reverts(group_size):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(257, 7)).astype(np.float32) * 3)
    c0 = torch.from_numpy(rng.normal(size=(40, 7)).astype(np.float32))
    k = 40
    bk = get_backend("fused_bounds", group_size=group_size)
    gs = bounds.round_up(bounds.resolve_group_size(k, group_size), 8)
    g, _ = bounds.group_layout(k, gs)
    carry = bk.init_carry(x, c0, k)
    skipped = []
    for c in _aa_like_moves(x, c0, k, bk, np.random.default_rng(42)):
        res, carry = bk.step(x, c, k, carry)
        lab_o, mind_o = ref.assignment_ref(x, c)        # the f32 oracle
        np.testing.assert_array_equal(res.labels.numpy(), lab_o.numpy())
        np.testing.assert_allclose(res.min_sqdist.numpy(), mind_o.numpy(),
                                   rtol=3e-5, atol=3e-5)
        d = torch.sqrt(pairwise_sqdist(x, c).double())
        labels, upper, lower, c_last, stats = carry
        assert torch.equal(c_last, c) and lower.shape == (257, g)
        d_a = d[torch.arange(257), labels.long()]
        assert bool((upper.double() >= d_a - ATOL).all())
        assert bool((lower.double() <= bounds.group_min(d, g, gs) + ATOL)
                    .all())
        skipped.append(float(stats.skipped_frac))
    assert skipped[0] == 0.0 and all(0.0 <= s <= 1.0 for s in skipped)


def test_fused_bounds_one_trip_from_identical_state():
    """Every state the JAX batched driver passes to ``checkpoint_cb``,
    bound carry included, carried across with ``interop``; one port trip
    lands on the JAX package's next state (the tolerances of
    tests/test_torch_kmeans.py), and its carry holds valid bounds."""
    x = make_dataset("AllUsers", scale=0.008)
    k, gs = 20, 8
    c0s = _jax_seeds(x, k, 2)
    jbk = jget_backend("fused_bounds", group_size=gs)
    jcfg = JKMeansConfig(k=k, max_iter=30)
    states = [jax.device_get(_init_batched_state(
        jnp.asarray(x), jnp.asarray(c0s), jcfg, jbk, None))]
    jaa_kmeans_batched(jnp.asarray(x), jnp.asarray(c0s), jcfg, backend=jbk,
                       checkpoint_every=1,
                       checkpoint_cb=lambda bst, _: states.append(
                           jax.device_get(bst)))
    assert len(states) > 8
    cfg = KMeansConfig(k=k, max_iter=30)
    bk = get_backend("fused_bounds", group_size=gs)
    xt = torch.from_numpy(x)
    _assert_state_close(_init_state(xt, torch.from_numpy(c0s), cfg, bk),
                        states[0], "after the init step")
    rejected = 0
    for i in range(len(states) - 1):
        got = batched_trip(xt, batched_state_from_numpy(states[i], "cpu"),
                           cfg, bk)
        where = f"after trip {i + 1}"
        _assert_state_close(got, states[i + 1], where)
        labels, upper, lower, c_last, stats = got.inner.carry
        jlab, jupper, _, jc_last, _ = states[i + 1].inner.carry
        np.testing.assert_array_equal(labels.numpy(), jlab, err_msg=where)
        np.testing.assert_allclose(upper.numpy(), jupper, rtol=1e-5,
                                   atol=1e-5, err_msg=where)
        np.testing.assert_allclose(c_last.numpy(), jc_last, rtol=1e-4,
                                   atol=1e-4, err_msg=where)
        d = torch.sqrt(torch.stack([pairwise_sqdist(xt, cl)
                                    for cl in c_last]).double())
        assert bool((upper.double() >= torch.gather(
            d, 2, labels.long()[..., None])[..., 0] - ATOL).all()), where
        assert bool((lower.double() <= bounds.group_min(
            d, *bounds.group_layout(k, gs)) + ATOL).all()), where
        assert stats.skipped_frac.shape == (2,)
        rejected += int(np.asarray(states[i + 1].pending).any())
    assert rejected > 0


@pytest.mark.parametrize("group_size", [None, 24])
def test_fused_bounds_fit_matches_jax(group_size):
    x = make_blobs(2000, 8, 12, seed=0)
    jm = JAAKMeans(n_clusters=12, n_init=2, backend=jget_backend(
        "fused_bounds", group_size=group_size)).fit(x)
    tm = AAKMeans(n_clusters=12, n_init=2, device="cpu", backend=get_backend(
        "fused_bounds", group_size=group_size))
    tm.fit(x, c0s=_jax_seeds(x, 12, 2))
    assert (tm.n_iter_, tm.n_accepted_) == (jm.n_iter_, jm.n_accepted_)
    np.testing.assert_array_equal(tm.labels_.numpy(), np.asarray(jm.labels_))
    np.testing.assert_allclose(tm.inertia_, jm.inertia_, rtol=1e-5)
    np.testing.assert_array_equal(tm.predict(x), np.asarray(jm.predict(x)))


def test_dataset_components_replay_the_generator():
    """Every row lies nearest the mean of its replayed component, so
    sorting by it lays X out cluster by cluster."""
    x = make_dataset("USCensus1990", scale=0.002)
    comp = tsynthetic.dataset_components("USCensus1990", scale=0.002)
    assert comp.shape == (x.shape[0],) and set(np.unique(comp)) <= set(
        range(25))
    means = np.stack([x[comp == j].mean(0) for j in np.unique(comp)])
    near = np.argmin(((x[:, None] - means[None]) ** 2).sum(-1), axis=1)
    np.testing.assert_array_equal(np.unique(comp)[near], comp)
    with pytest.raises(ValueError):
        tsynthetic.dataset_components("Birch")
