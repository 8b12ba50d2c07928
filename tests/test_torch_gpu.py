"""The port's CUDA kernels on the card (marker ``gpu``; skips without a
CUDA device).  Imports nothing of the JAX package, so it runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each kernel is held to its plain PyTorch version on the same inputs:
labels exact, min_sqdist within 1e-5 (f32 cross terms summed in another
order than cuBLAS), sums within 1e-4 and counts within 1e-5 (reduction
order), energy within 1e-6 relative.  The fused-bounds kernel besides:
the skipped share exact and every skipped group's minimum bit for bit
(both pass the input bound through), computed group minima within 1e-5.
The fused step launches the assignment kernel's own sweep (8 x 8 register
blocks, csrc/sweep_fp32.cuh), so its labels and distances are the
assignment's by construction; the bounded sweep computes each distance
with the same FMA chain.  On exact small-integer data every distance is
exact, so a tie goes to the lowest index.  Relaunches are bitwise equal.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import AAKMeans, get_backend
from repro_torch.core.backends.fused_bounds import (engine_group_size,
                                                  squared_bounds)
from repro_torch.data.synthetic import make_blobs
from repro_torch.kernels import assignment as A
from repro_torch.kernels import build
from repro_torch.kernels import fused_lloyd as F
from repro_torch.kernels import ref
from repro_torch.kernels import update as U

# (n, d, k, r, x per problem, weights): ragged, (N,) weights, (R, N)
# weights with per-problem X, shared X for R = 3, wide rows
CASES = [(1000, 69, 37, None, False, None),
         (4097, 9, 1000, None, False, "n"),
         (2001, 33, 45, 3, True, "rn"),
         (3001, 20, 130, 3, False, None),
         (700, 385, 50, None, False, None)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(device, n, d, k, r, x_batched, weights, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(((r, n, d) if x_batched else (n, d)),
                            dtype=np.float32)
    c = rng.standard_normal(((r, k, d) if r else (k, d)), dtype=np.float32)
    w = None
    if weights == "n":
        w = rng.uniform(0.0, 2.0, n).astype(np.float32)
    elif weights == "rn":
        w = rng.uniform(0.0, 2.0, (r, n)).astype(np.float32)
        w[:, : n // 3] = 0.0
    return [None if a is None else torch.from_numpy(a).to(device)
            for a in (x, c, w)]


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,k,r,x_batched,weights", CASES)
def test_kernels_match_plain(cuda, n, d, k, r, x_batched, weights):
    x, c, w = _inputs(cuda, n, d, k, r, x_batched, weights)
    launched = F.launches
    got = [g.cpu() for g in F.fused_lloyd(x, c, w)]
    assert F.launches == launched + 1
    want = [v.cpu() for v in F.fused_lloyd_plain(x, c, w)]
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[4], want[4], rtol=1e-6)
    lab, mind = A.assignment(x, c)
    np.testing.assert_array_equal(lab.cpu().numpy(), got[0].numpy())
    assert torch.equal(mind.cpu(), got[1])   # the same FMA chains


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,k,r,x_batched,weights", CASES)
def test_relaunch_is_bitwise_equal(cuda, n, d, k, r, x_batched, weights):
    args = _inputs(cuda, n, d, k, r, x_batched, weights)
    first = F.fused_lloyd(*args)
    for a, b in zip(first, F.fused_lloyd(*args)):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_operand_checks_on_cuda(cuda):
    x, c, _ = _inputs(cuda, 100, 8, 5, None, False, None)
    with pytest.raises(ValueError):
        F.fused_lloyd(x.t().contiguous().t(), c)        # not contiguous
    with pytest.raises(ValueError):
        A.assignment(x, c.cpu())                        # mixed devices
    with pytest.raises(ValueError):
        A.assignment(torch.zeros(10, 900, device=cuda),
                     torch.zeros(3, 900, device=cuda))  # d too wide


@pytest.mark.gpu
def test_fit_runs_on_the_kernels(cuda):
    """The same seeds on the card and on the CPU end at the same energy
    (within 1e-4: the two runs sum in other orders, so their trajectories
    may part near convergence)."""
    x = make_blobs(20000, 16, 40, seed=3)
    c0s = x[np.random.default_rng(4).choice(20000, (2, 40), replace=False)]
    F.launches = A.launches = F.plain_calls = A.plain_calls = 0
    m = AAKMeans(n_clusters=40, backend="fused").fit(x, c0s=c0s)
    assert m.centroids_.device.type == "cuda"
    assert F.launches > 1 and F.plain_calls == 0
    assert m.n_iter_ <= m.max_iter                      # converged
    labels = m.predict(x)
    assert A.launches == 2 and A.plain_calls == 0       # 20000 rows
    # converged: the last step's labels are those of the final centroids,
    # and the two sweeps sum each distance in the same order
    np.testing.assert_array_equal(labels, m.labels_.cpu().numpy())
    cpu = AAKMeans(n_clusters=40, backend="fused", device="cpu").fit(
        x, c0s=c0s)
    np.testing.assert_allclose(m.inertia_, cpu.inertia_, rtol=1e-4)


def _update_inputs(device, n, d, k, r, x_batched, weights, seed=1):
    x, _, w = _inputs(device, n, d, k, r, x_batched, weights, seed)
    rng = np.random.default_rng(seed + 1)
    labels = rng.integers(-1, k + 1, (r, n) if r else (n,)).astype(np.int32)
    if w is not None and w.dim() == 2:
        w = w[0].contiguous()                  # the update takes (N,)
    return x, torch.from_numpy(labels).to(device), w


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,k,r,x_batched,weights", CASES)
def test_update_matches_plain(cuda, n, d, k, r, x_batched, weights):
    """Labels -1 and K are in the input and land nowhere."""
    x, labels, w = _update_inputs(cuda, n, d, k, r, x_batched, weights)
    launched, plain = U.launches, U.plain_calls
    got = [g.cpu() for g in U.update(x, labels, k, w)]
    assert (U.launches, U.plain_calls) == (launched + 1, plain)
    want = [v.cpu() for v in U.update_plain(x, labels, k, w)]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)
    again = U.update(x, labels, k, w)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(again, got))


@pytest.mark.gpu
def test_update_with_cluster_ranges(cuda):
    """K = 20,000 is too many clusters for one block's shared memory, so
    blocks split them into ranges as well as columns."""
    x, labels, _ = _update_inputs(cuda, 4000, 69, 20000, None, False, None)
    lay = U.layout(U._bind(build.load("update")), 4000, 1, 20000, 69)
    assert lay.ranges > 1
    got = [g.cpu() for g in U.update(x, labels, 20000)]
    want = [v.cpu() for v in U.update_plain(x, labels, 20000)]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)
    again = U.update(x, labels, 20000)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(again, got))


@pytest.mark.gpu
def test_assignment_tie_goes_to_the_lowest_index(cuda):
    """Integer data: every distance is exact, so centroid j and its
    duplicate j + 10 tie exactly, and j wins."""
    rng = np.random.default_rng(11)
    x = rng.integers(-4, 5, (500, 6)).astype(np.float32)
    c = rng.integers(-4, 5, (10, 6)).astype(np.float32)
    c2 = np.concatenate([c, c])
    lab, mind = A.assignment(torch.from_numpy(x).to(cuda),
                             torch.from_numpy(c2).to(cuda))
    want = A.assignment_plain(torch.from_numpy(x), torch.from_numpy(c2))
    assert int(lab.max()) < 10
    np.testing.assert_array_equal(lab.cpu().numpy(), want[0].numpy())
    np.testing.assert_array_equal(mind.cpu().numpy(), want[1].numpy())


@pytest.mark.gpu
def test_assignment_nan_row(cuda):
    """A NaN row gets a NaN distance and label 0 (NaN first, lowest
    index); the other rows are unharmed."""
    x, c, _ = _inputs(cuda, 1000, 69, 37, None, False, None, seed=5)
    x[7, 3] = float("nan")
    lab, mind = (t.cpu() for t in A.assignment(x, c))
    want = A.assignment_plain(x.cpu(), c.cpu())
    assert torch.isnan(mind[7]) and int(lab[7]) == 0
    np.testing.assert_array_equal(lab.numpy(), want[0].numpy())
    keep = ~torch.isnan(want[1])
    assert int(keep.sum()) == 999
    np.testing.assert_allclose(mind[keep], want[1][keep], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.gpu
def test_assignment_at_its_widest_d(cuda):
    """The widest d the kernel takes (its X tile and shallowest C stage
    fill a block's shared memory), with fewer and more rows than fill the
    card."""
    widest = A._bind(build.load("assignment")).assignment_max_features(0)
    assert widest >= 818
    for n in (300, 20000):
        x, c, _ = _inputs(cuda, n, widest, 70, None, False, None, seed=n)
        lab, mind = A.assignment(x, c)
        want = A.assignment_plain(x, c)
        np.testing.assert_array_equal(lab.cpu().numpy(),
                                      want[0].cpu().numpy())
        np.testing.assert_allclose(mind.cpu(), want[1].cpu(), rtol=1e-5,
                                   atol=1e-5)
    with pytest.raises(ValueError):
        A.assignment(torch.zeros(10, widest + 1, device=cuda),
                     torch.zeros(3, widest + 1, device=cuda))


def _drifted_bounds(x, c, w, gs, steps=2):
    """Bounds of a real carry: the fused_bounds engine steps ``steps``
    times from the init carry, each time to the Lloyd update of the last
    step, then the drift to the next centroids is applied."""
    bk = get_backend("fused_bounds", group_size=gs)
    k = c.shape[-2]
    cs = c if c.dim() == 3 else c[None]
    carry = bk.init_carry(x, cs, k)
    for _ in range(steps):
        res, carry = bk.batched_step(x, cs, k, carry, w=w)
        cs = bk.centroids_from_step(x, res, k, cs)
    gsr = engine_group_size(k, gs)
    lift = (lambda t: t) if c.dim() == 3 else (lambda t: t[0])
    return lift(cs).contiguous(), gsr, tuple(
        lift(t).contiguous() for t in squared_bounds(carry, cs, k, gsr))


@pytest.mark.gpu
@pytest.mark.parametrize("gs", [8, 24, 64, 200])
@pytest.mark.parametrize("n,d,k,r,x_batched,weights", CASES)
def test_fused_bounds_matches_plain(cuda, n, d, k, r, x_batched, weights,
                                    gs):
    x, c, w = _inputs(cuda, n, d, k, r, x_batched, weights)
    c, gsr, bnds = _drifted_bounds(x, c, w, gs)
    launched, plain = F.bounds_launches, F.bounds_plain_calls
    got = [g.cpu() for g in F.fused_lloyd(x, c, w, bounds=bnds, gs=gsr)]
    assert (F.bounds_launches, F.bounds_plain_calls) == (launched + 1, plain)
    want = [v.cpu() for v in F.fused_bounds_plain(
        x, c, w, *bnds, gsr, build.tile_rows())]
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    # after real Lloyd steps a centroid can sit on a row (a singleton
    # cluster): there |x|^2 - 2 x.c + |c|^2 cancels to a few ulps of |x|^2
    # on one side and 0 on the other
    atol = 1e-6 * float(torch.sum(x * x, dim=-1).max())
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=atol)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[4], want[4], rtol=1e-6)
    assert torch.equal(got[6], want[6])
    lb_sq, ub_sq = bnds[1].cpu(), bnds[2].cpu()
    lift = (lambda t: t) if r else (lambda t: t[None])
    skipped = ~torch.stack([ref.computed_cells(lb, ub, build.tile_rows())
                            for lb, ub in zip(lift(lb_sq), lift(ub_sq))])
    assert torch.equal(lift(got[5])[skipped], lift(lb_sq)[skipped])
    np.testing.assert_allclose(got[5], want[5], rtol=1e-5, atol=atol)
    again = F.fused_lloyd(x, c, w, bounds=bnds, gs=gsr)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(again, got))


@pytest.mark.gpu
def test_fused_bounds_skips_on_ordered_rows(cuda):
    """Rows laid out cluster by cluster with matching centroid order: once
    the bounds are tight most (tile, group) cells skip, and the result is
    still the plain version's."""
    rng = np.random.default_rng(7)
    k, d, per = 64, 16, 256
    centers = rng.standard_normal((k, d)).astype(np.float32) * 20.0
    x = np.concatenate([centers[j] + rng.standard_normal((per, d))
                        .astype(np.float32) for j in range(k)])
    c0 = centers + 0.5 * rng.standard_normal((k, d)).astype(np.float32)
    x, c0 = torch.from_numpy(x).to(cuda), torch.from_numpy(c0).to(cuda)
    c, gs, bnds = _drifted_bounds(x, c0, None, 8, steps=3)
    got = F.fused_lloyd(x, c, bounds=bnds, gs=gs)
    want = F.fused_bounds_plain(x, c, None, *bnds, gs, build.tile_rows())
    assert float(got[6]) > 0.5 and torch.equal(got[6].cpu(), want[6].cpu())
    assert torch.equal(got[0], want[0])


@pytest.mark.gpu
def test_seed_keeps_a_tie(cuda):
    """Integer data, so every distance is exact: a duplicated centroid
    below the standing label ties with it, and the standing label stays."""
    rng = np.random.default_rng(3)
    x = rng.integers(-4, 5, (300, 6)).astype(np.float32)
    c = rng.integers(-4, 5, (10, 6)).astype(np.float32)
    c2 = np.concatenate([c, c])                 # j and j + 10 tie
    dist = ((x[:, None] - c2[None]) ** 2).sum(-1)
    lab0 = (dist[:, :10].argmin(1) + 10).astype(np.int32)
    ub_sq = dist[:, :10].min(1).astype(np.float32)
    lb_sq = np.zeros((300, 20 // 4), np.float32)
    t = [torch.from_numpy(a).to(cuda) for a in (x, c2, lab0, lb_sq, ub_sq)]
    got = F.fused_lloyd(t[0], t[1], bounds=tuple(t[2:]), gs=4)
    np.testing.assert_array_equal(got[0].cpu().numpy(), lab0)
    np.testing.assert_array_equal(got[1].cpu().numpy(), ub_sq)


@pytest.mark.gpu
def test_cuda_tensors_never_reach_a_plain_version(cuda):
    x = torch.from_numpy(make_blobs(5000, 8, 12, seed=5)).to(cuda)
    F.plain_calls = F.bounds_plain_calls = A.plain_calls = 0
    U.plain_calls = 0
    for name in ("pallas", "fused_bounds", "fused"):
        m = AAKMeans(n_clusters=12, backend=name, n_init=2).fit(x)
        m.predict(x)
        get_backend(name).update(x, m.labels_, 12, m.centroids_)
    assert (F.plain_calls, F.bounds_plain_calls, A.plain_calls,
            U.plain_calls) == (0, 0, 0, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,k,r", [(5000, 69, 1000, None),
                                     (3001, 20, 300, 3), (2000, 385, 50, None)])
def test_fused_distances_equal_the_assignment(cuda, n, d, k, r):
    """Several 256-centroid chunks and C stages: the fused step's labels and
    min_sqdist are the assignment kernel's, bit for bit (both launch one
    sweep: this holds the two wrappers' operands and outputs together)."""
    x, c, _ = _inputs(cuda, n, d, k, r, False, None, seed=k)
    got = F.fused_lloyd(x, c)
    lab, mind = A.assignment(x, c)
    assert torch.equal(got[0], lab) and torch.equal(got[1], mind)


@pytest.mark.gpu
def test_fused_at_k_20000(cuda):
    """The largest partials: (slabs, 20000, d + 1) floats."""
    x, c, w = _inputs(cuda, 6000, 16, 20000, None, False, "n", seed=2)
    got = [g.cpu() for g in F.fused_lloyd(x, c, w)]
    want = [v.cpu() for v in F.fused_lloyd_plain(x, c, w)]
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[4], want[4], rtol=1e-6)
    again = F.fused_lloyd(x, c, w)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(again, got))


@pytest.mark.gpu
@pytest.mark.parametrize("bounded", [False, True])
def test_fused_at_its_widest_d(cuda, bounded):
    """The widest d each fused kernel takes (its X tile, shallowest C stage
    and own shared words fill a block's shared memory), and one more
    raising ValueError."""
    k, gs = 70, 16
    g = -(-k // gs)
    if bounded:
        lib = F._bind_bounds(build.load("fused_bounds"))
        widest = lib.fused_bounds_max_features(0, g)
    else:
        widest = F._bind(build.load("fused_lloyd")).fused_lloyd_max_features(0)
    assert widest >= 700

    def run(x, c):
        if not bounded:
            return F.fused_lloyd(x, c)
        n = x.shape[0]
        bnds = (torch.zeros(n, dtype=torch.int32, device=cuda),
                torch.zeros(n, g, device=cuda),
                torch.full((n,), float("inf"), device=cuda))
        return F.fused_lloyd(x, c, bounds=bnds, gs=gs)

    x, c, _ = _inputs(cuda, 300, widest, k, None, False, None, seed=3)
    got = run(x, c)
    want = F.fused_lloyd_plain(x, c)
    np.testing.assert_array_equal(got[0].cpu().numpy(),
                                  want[0].cpu().numpy())
    np.testing.assert_allclose(got[1].cpu(), want[1].cpu(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got[2].cpu(), want[2].cpu(), rtol=1e-4,
                               atol=1e-4)
    with pytest.raises(ValueError):
        run(torch.zeros(10, widest + 1, device=cuda),
            torch.zeros(k, widest + 1, device=cuda))


def _loose_bounds(x, c, gs, seed):
    """Valid bounds at any group size (the engine rounds its groups to 8):
    lab0 the nearest centroid of c moved a little, ub^2 the squared
    distance to it grown by 10%, lb^2 each group's squared minimum shrunk
    by a random factor in [0.9, 1]."""
    rng = np.random.default_rng(seed)
    x64, c64 = x.double(), c.double()
    d2 = torch.cdist(x64, c64) ** 2
    moved = c64 + 0.1 * torch.from_numpy(
        rng.standard_normal(tuple(c.shape))).to(c.device)
    lab0 = torch.cdist(x64, moved).argmin(dim=1)
    ub_sq = 1.1 * d2.gather(1, lab0[:, None])[:, 0]
    k, g = c.shape[0], -(-c.shape[0] // gs)
    pad = torch.full((x.shape[0], g * gs - k), float("inf"),
                     dtype=torch.float64, device=x.device)
    gmin = torch.cat([d2, pad], dim=1).reshape(-1, g, gs).amin(dim=-1)
    shrink = torch.from_numpy(rng.uniform(0.9, 1.0, tuple(gmin.shape)))
    lb_sq = gmin * shrink.to(x.device)
    return (lab0.to(torch.int32), lb_sq.float().contiguous(),
            ub_sq.float().contiguous())


@pytest.mark.gpu
@pytest.mark.parametrize("gs", [7, 100, 200, 512])
def test_fused_bounds_group_sizes_at_k_1000(cuda, gs):
    """Groups that do not divide 4 (7), straddle the 256-centroid chunk
    (100, 200) or span chunks (512).  Rows come cluster by cluster, three
    to a centroid, so many (tile, group) cells skip."""
    rng = np.random.default_rng(gs)
    centers = rng.standard_normal((1000, 24)).astype(np.float32) * 20.0
    x = np.repeat(centers, 3, axis=0) + rng.standard_normal(
        (3000, 24)).astype(np.float32)
    c = centers + 0.5 * rng.standard_normal((1000, 24)).astype(np.float32)
    w = rng.uniform(0.0, 2.0, 3000).astype(np.float32)
    x, c, w = (torch.from_numpy(a).to(cuda) for a in (x, c, w))
    bnds = _loose_bounds(x, c, gs, seed=gs)
    got = [g.cpu() for g in F.fused_lloyd(x, c, w, bounds=bnds, gs=gs)]
    want = [v.cpu() for v in F.fused_bounds_plain(
        x, c, w, *bnds, gs, build.tile_rows())]
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    atol = 1e-6 * float(torch.sum(x * x, dim=-1).max())
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=atol)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[4], want[4], rtol=1e-6)
    assert torch.equal(got[6], want[6]) and float(got[6]) > 0.4
    skipped = ~ref.computed_cells(bnds[1].cpu(), bnds[2].cpu(),
                                  build.tile_rows())
    assert torch.equal(got[5][skipped], bnds[1].cpu()[skipped])
    np.testing.assert_allclose(got[5], want[5], rtol=1e-5, atol=atol)
    again = F.fused_lloyd(x, c, w, bounds=bnds, gs=gs)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(again, got))


@pytest.mark.gpu
@pytest.mark.parametrize("skipping", [False, True])
def test_fused_bounds_at_k_120000(cuda, skipping):
    """K = 120,000 at d = 69, past where a list of all the live vectors
    would fill a block's shared memory: the bounded kernel lists them a
    chunk at a time.  Without skipping every group is computed (469
    chunks), and the labels and distances are the assignment kernel's bit
    for bit; with skipping, rows come in runs near nearby centroids, so a
    tile computes a few of its 235 groups, split over several chunks."""
    k, d, n, gs = 120_000, 69, 1024, 512
    g = -(-k // gs)
    rng = np.random.default_rng(12)
    centers = rng.standard_normal((k, d)).astype(np.float32) * 4.0
    pick = np.sort(rng.choice(k, n, replace=False))
    x = centers[pick] + rng.standard_normal((n, d)).astype(np.float32)
    c = centers + 0.1 * rng.standard_normal((k, d)).astype(np.float32)
    x, c = (torch.from_numpy(a).to(cuda) for a in (x, c))
    if skipping:
        bnds = _loose_bounds(x, c, gs, seed=12)
    else:
        bnds = (torch.zeros(n, dtype=torch.int32, device=cuda),
                torch.zeros(n, g, device=cuda),
                torch.full((n,), float("inf"), device=cuda))
    got = [t.cpu() for t in F.fused_lloyd(x, c, bounds=bnds, gs=gs)]
    want = [t.cpu() for t in F.fused_bounds_plain(
        x, c, None, *bnds, gs, build.tile_rows())]
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    atol = 1e-6 * float(torch.sum(x * x, dim=-1).max())
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=atol)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[4], want[4], rtol=1e-6)
    assert torch.equal(got[6], want[6])
    np.testing.assert_allclose(got[5], want[5], rtol=1e-5, atol=atol)
    if skipping:
        assert float(got[6]) > 0.5
        skipped = ~ref.computed_cells(bnds[1].cpu(), bnds[2].cpu(),
                                      build.tile_rows())
        assert torch.equal(got[5][skipped], bnds[1].cpu()[skipped])
    else:
        assert float(got[6]) == 0.0
        lab, mind = A.assignment(x, c)
        assert torch.equal(got[0], lab.cpu()) and torch.equal(got[1],
                                                              mind.cpu())
    again = F.fused_lloyd(x, c, bounds=bnds, gs=gs)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(again, got))


# -- the single-problem path --------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("n,d,k", [(20000, 16, 40), (5000, 2, 10),
                                   (5000, 3, 100)])
def test_aa_kmeans_is_the_batched_driver_on_the_card(cuda, n, d, k):
    """aa_kmeans runs the batched driver at R = 1: equal bit for bit, at a
    small shape and at Table 3's (K = 10 on d = 2, K = 100 on d = 3)."""
    from repro_torch.core.init_schemes import kmeanspp_init
    from repro_torch.core.kmeans import (KMeansConfig, aa_kmeans,
                                         aa_kmeans_batched)
    x = torch.from_numpy(make_blobs(n, d, k, seed=d)).to(cuda)
    c0 = kmeanspp_init(torch.Generator(device=cuda).manual_seed(0), x, k)
    cfg = KMeansConfig(k=k)
    F.launches = F.plain_calls = 0
    one = aa_kmeans(x, c0, cfg, backend="fused")
    assert F.launches >= 2 and F.plain_calls == 0
    batched = aa_kmeans_batched(x, c0[None], cfg, backend="fused")
    for a, b in zip(one, batched):
        assert torch.equal(a, b[0])


class _HostCopies(torch.utils._python_dispatch.TorchDispatchMode):
    """Records the size of every device-to-host copy."""

    def __init__(self):
        super().__init__()
        self.sizes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if isinstance(out, torch.Tensor) and out.device.type == "cpu" and any(
                isinstance(a, torch.Tensor) and a.device.type == "cuda"
                for a in args):
            self.sizes.append(out.numel())
        return out


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["afk-mc2", "bf", "clarans"])
def test_seedings_stay_on_the_card(cuda, name):
    """Each seeding returns a CUDA tensor and copies no more than a few
    hundred scalars to the host (afk-mc2's chain values, clarans's trial
    costs), never X."""
    from repro_torch.core.init_schemes import INIT_SCHEMES
    x = torch.from_numpy(make_blobs(20000, 8, 10, seed=6)).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    with _HostCopies() as copies:
        c = INIT_SCHEMES[name](gen, x, 10)
    assert c.device.type == "cuda" and c.shape == (10, 8)
    assert bool(torch.isfinite(c).all())
    assert max(copies.sizes, default=0) <= 300, max(copies.sizes)


@pytest.mark.gpu
def test_pallas_lloyd_ops_launch_both_kernels(cuda):
    from repro_torch.core.lloyd import DENSE_OPS, lloyd_iteration
    from repro_torch.kernels.ops import pallas_lloyd_ops
    x = torch.from_numpy(make_blobs(30000, 69, 10, seed=7)).to(cuda)
    c = x[:10].clone()
    A.launches = U.launches = A.plain_calls = U.plain_calls = 0
    c1, lab, e = lloyd_iteration(x, c, 10, ops=pallas_lloyd_ops())
    assert (A.launches, U.launches) == (1, 1)
    assert A.plain_calls == U.plain_calls == 0
    c1_d, lab_d, e_d = lloyd_iteration(x, c, 10, ops=DENSE_OPS)
    assert torch.equal(lab, lab_d)
    np.testing.assert_allclose(c1.cpu().numpy(), c1_d.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(e), float(e_d), rtol=1e-5)


@pytest.mark.gpu
def test_lloyd_kmeans_repeats_bit_for_bit_on_the_card(cuda):
    """The dense stats on CUDA are one-hot matmuls added in a fixed order
    (no float atomics), so Lloyd from one seed set repeats exactly; they
    agree with the CPU's index_add_ within the stats' 1e-4."""
    from repro_torch.core import lloyd
    x = torch.from_numpy(make_blobs(200000, 9, 10, seed=8, spread=1.5)).to(
        cuda)
    c0 = x[:10].clone()
    a = lloyd.lloyd_kmeans(x, c0, 10, 60)
    b = lloyd.lloyd_kmeans(x, c0, 10, 60)
    assert a[3] == b[3] and torch.equal(a[0], b[0]) \
        and torch.equal(a[1], b[1])
    lab = a[1]
    sums, counts = lloyd.cluster_sums(x, lab, 10)
    sums_c, counts_c = lloyd.cluster_sums(x.cpu(), lab.cpu(), 10)
    np.testing.assert_allclose(sums.cpu().numpy(), sums_c.numpy(),
                               rtol=1e-4, atol=1e-2)
    np.testing.assert_array_equal(counts.cpu().numpy(), counts_c.numpy())
