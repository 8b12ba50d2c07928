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
blocks, csrc/sweep_fp32.cuh; past the resident X tile the streamed sweep
of csrc/sweep_wide.cuh), so its labels and distances are the
assignment's by construction; the bounded sweep (past the resident tile
csrc/sweep_bounded.cuh's) computes each distance with the same FMA chain.
On exact small-integer data every distance is exact, so a tie goes to the
lowest index; a row whose every distance is +inf gets label 0 (the
bounded step: its seed).  Relaunches are bitwise equal.

On bfloat16 X and C the assignment, the fused step and the bounded step
(at a group size that is a multiple of 8) run the tensor-core sweep
(csrc/sweep_tc.cuh), whose f32 sums of the bf16 products run in another
order: labels equal the plain version's but at near ties
(``ref.tie_gap`` within ``ref.NEAR_TIE``), min distances and computed
group minima within 1e-5 of |x|^2 + max |c|^2, the stats of the kernel's
labels within the gates above; skipped group minima and the skipped
share exact.  The assignment's and the fused step's labels and distances
are equal bit for bit (one sweep), as is the bounded step from
ub^2 = +inf, lb^2 = 0, and a relaunch is bitwise equal.  The update on
bf16 operands, and the three distance kernels on mixed operands, convert
a bf16 value to f32 where they load it: each equals its float32 launch
on the upcast operands bit for bit.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import AAKMeans, get_backend
from repro_torch.core.backends import Precision
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
    # past the resident tile's widest d the launch streams X: all-zero
    # rows tie on every centroid, so the lowest index wins at distance 0
    streamed, plain = A.stream_launches, A.plain_calls
    lab, mind = A.assignment(torch.zeros(10, 900, device=cuda),
                             torch.zeros(3, 900, device=cuda))
    assert (A.stream_launches, A.plain_calls) == (streamed + 1, plain)
    assert not bool(lab.any()) and not bool(mind.any())


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
    """The widest d of the resident path (its X tile and shallowest C
    stage fill a block's shared memory), with fewer and more rows than fill
    the card: the streamed launch there equals the resident one bit for
    bit, and one feature more streams."""
    widest = A._bind(build.load("assignment")).assignment_max_features(0)
    assert widest >= 818
    for n in (300, 20000):
        x, c, _ = _inputs(cuda, n, widest, 70, None, False, None, seed=n)
        streamed = A.stream_launches
        lab, mind = A.assignment(x, c)
        assert A.stream_launches == streamed
        want = A.assignment_plain(x, c)
        np.testing.assert_array_equal(lab.cpu().numpy(),
                                      want[0].cpu().numpy())
        np.testing.assert_allclose(mind.cpu(), want[1].cpu(), rtol=1e-5,
                                   atol=1e-5)
        _assert_equal(A.assignment(x, c, _stream=True), (lab, mind))
        assert A.stream_launches == streamed + 1
    x, c, _ = _inputs(cuda, 300, widest + 1, 70, None, False, None, seed=1)
    streamed = A.stream_launches
    lab, mind = A.assignment(x, c)
    assert A.stream_launches == streamed + 1
    want = A.assignment_plain(x, c)
    np.testing.assert_array_equal(lab.cpu().numpy(), want[0].cpu().numpy())
    np.testing.assert_allclose(mind.cpu(), want[1].cpu(), rtol=1e-5,
                               atol=1e-5)


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
    """The widest d of each fused kernel's resident path (its X tile,
    shallowest C stage and own shared words fill a block's shared memory),
    where the streamed launch equals the resident one bit for bit, and one
    more, which streams."""
    k, gs = 70, 16
    g = -(-k // gs)
    if bounded:
        lib = F._bind_bounds(build.load("fused_bounds"))
        widest = lib.fused_bounds_max_features(0, g)
    else:
        widest = F._bind(build.load("fused_lloyd")).fused_lloyd_max_features(0)
    assert widest >= 700

    def run(x, c, stream=False):
        if not bounded:
            return F.fused_lloyd(x, c, _stream=stream)
        n = x.shape[0]
        bnds = (torch.zeros(n, dtype=torch.int32, device=cuda),
                torch.zeros(n, g, device=cuda),
                torch.full((n,), float("inf"), device=cuda))
        return F.fused_lloyd(x, c, bounds=bnds, gs=gs, _stream=stream)

    def streamed():
        return F.bounds_stream_launches if bounded else F.stream_launches

    for d in (widest, widest + 1):
        x, c, _ = _inputs(cuda, 300, d, k, None, False, None, seed=3)
        before = streamed()
        got = run(x, c)
        assert streamed() == before + (d > widest)
        want = F.fused_lloyd_plain(x, c)
        np.testing.assert_array_equal(got[0].cpu().numpy(),
                                      want[0].cpu().numpy())
        np.testing.assert_allclose(got[1].cpu(), want[1].cpu(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got[2].cpu(), want[2].cpu(), rtol=1e-4,
                                   atol=1e-4)
    x, c, _ = _inputs(cuda, 300, widest, k, None, False, None, seed=3)
    _assert_equal(run(x, c, stream=True), run(x, c))


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


# -- the locality engine and the CPU bound engines ----------------------------

def _unordered_blobs(cuda, n, d, k, seed):
    """Blobs with their rows shuffled, so no tile shares an owner until
    the locality engine sorts them."""
    x = make_blobs(n, d, k, seed=seed, spread=2.0)
    x = x[np.random.default_rng(seed).permutation(n)]
    return torch.from_numpy(np.ascontiguousarray(x)).to(cuda)


@pytest.mark.gpu
def test_reorder_last_step_equals_the_raw_kernel_bitwise(cuda):
    """The wrapper's step, gathered back to original order, equals the
    raw bounded kernel's step on the original rows with the carry the
    wrapper's kernel saw permuted back: each row's labels and min_sqdist
    are its own.  The fit launches one bounded and one update kernel a
    step and no plain version."""
    import dataclasses
    from repro_torch.core.locality import (ReorderConfig, inner_carry,
                                           permute_bound_carry, resort,
                                           sort_count)
    x = _unordered_blobs(cuda, 30000, 16, 64, seed=3)
    k, gs = 64, 8
    bk = get_backend("fused_bounds_reorder", group_size=gs)
    last = {}

    def step(x_, cs, k_, carries, w=None):
        last["in"] = (cs, carries)
        res, last["out"] = bk.batched_step(x_, cs, k_, carries, w=w)
        return res, last["out"]

    F.bounds_launches = U.launches = F.bounds_plain_calls = 0
    U.plain_calls = 0
    model = AAKMeans(n_clusters=k, device=cuda, backend=dataclasses.replace(
        bk, batched_step_fn=step)).fit(x)
    steps = F.bounds_launches
    assert steps > 2 and U.launches == steps
    assert F.bounds_plain_calls == U.plain_calls == 0
    assert int(sort_count(last["out"])[0]) > 0
    cs, carry = last["in"]
    res, _ = bk.batched_step(x, cs, k, carry)
    carry_s = resort(carry, k, ReorderConfig())
    bnds = squared_bounds(permute_bound_carry(inner_carry(carry_s),
                                              carry_s[1]), cs, k, gs)
    raw = F.fused_lloyd(x, cs, bounds=bnds, gs=gs)
    assert torch.equal(res.labels, raw[0])
    assert torch.equal(res.min_sqdist, raw[1])
    assert np.isfinite(model.inertia_)


@pytest.mark.gpu
@pytest.mark.parametrize("r", [1, 2])
def test_reorder_always_equals_never_on_the_card(cuda, r):
    """Sorting on any change and never sorting run one program on other
    data: equal on every result leaf.  Each wrapped step's labels and
    min_sqdist equal the raw kernel's on the original rows with the carry
    permuted back (whole fits against the raw engine may part at a near
    tie of the accept test: its energy is the kernel's row sum, the
    wrapper's a torch.sum)."""
    import dataclasses
    from repro_torch.core.kmeans import KMeansConfig, aa_kmeans_batched
    from repro_torch.core.locality import (ReorderConfig, inner_carry,
                                           permute_bound_carry, resort)
    x = _unordered_blobs(cuda, 20000, 12, 40, seed=4)
    c0s = torch.stack([x[i * 40:(i + 1) * 40] for i in range(r)])
    cfg, gs = KMeansConfig(k=40, max_iter=80), 8
    always_cfg = ReorderConfig(churn_threshold=0.0)
    always_bk = get_backend("fused_bounds_reorder", group_size=gs,
                            churn_threshold=0.0)
    differ = []

    def redone(x_, cs, k, carries, w=None):
        res, out = always_bk.batched_step(x_, cs, k, carries, w=w)
        carry_s = resort(carries, k, always_cfg)
        raw = F.fused_lloyd(x_, cs, gs=gs, bounds=squared_bounds(
            permute_bound_carry(inner_carry(carry_s), carry_s[1]), cs, k,
            gs))
        differ.append(int((res.labels != raw[0]).sum())
                      + int((res.min_sqdist != raw[1]).sum()))
        return res, out

    F.bounds_plain_calls = U.plain_calls = 0
    always = aa_kmeans_batched(x, c0s, cfg, backend=dataclasses.replace(
        always_bk, batched_step_fn=redone))
    never = aa_kmeans_batched(x, c0s, cfg, backend=get_backend(
        "fused_bounds_reorder", group_size=gs, churn_threshold=1.5))
    assert F.bounds_plain_calls == U.plain_calls == 0
    assert all(torch.equal(a, b) for a, b in zip(always, never))
    assert len(differ) > 2 and sum(differ) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["hamerly", "elkan", "yinyang"])
def test_cpu_bound_engines_wrapped_equal_raw_on_the_card(cuda, name):
    """The masked dense engines on CUDA tensors: wrapped in the locality
    engine equal to raw on every leaf, the energy within 1e-5 of
    dense's."""
    from repro_torch.core.kmeans import KMeansConfig, aa_kmeans
    x = _unordered_blobs(cuda, 20000, 69, 30, seed=5)
    c0 = x[:30].clone()
    cfg = KMeansConfig(k=30, max_iter=60)
    raw = aa_kmeans(x, c0, cfg, backend=name)
    wrapped = aa_kmeans(x, c0, cfg, backend=name, reorder=True)
    assert all(torch.equal(a, b) for a, b in zip(raw, wrapped))
    e_dense = float(aa_kmeans(x, c0, cfg, backend="dense").energy)
    assert abs(float(raw.energy) - e_dense) <= 1e-5 * e_dense


# -- the streaming path --------------------------------------------------------

def _stream_problem(device, n=20000, d=16, k=40):
    x = make_blobs(n, d, k, seed=2, spread=3.0)
    x_val = torch.from_numpy(x[:1024]).to(device)
    return x[1024:], x_val, x_val[:k].clone()


@pytest.mark.gpu
def test_prefetched_stream_equals_synchronous_copies_on_the_card(cuda):
    """The streamed driver at prefetch 1, 2 and 3 (pinned slots, copies
    on a side stream) against chunk steps on chunks copied one by one with
    a blocking copy: equal bit for bit."""
    from repro_torch.core.kmeans import aa_kmeans_minibatch_streamed
    from repro_torch.core.minibatch import (MiniBatchConfig, guard_pick,
                                            minibatch_init,
                                            minibatch_iteration)
    from repro_torch.data.streaming import host_chunk_stream
    from repro_torch.runtime import IngestMeter
    x_host, x_val, c0 = _stream_problem(cuda)
    cfg = MiniBatchConfig(k=40, chunk_size=2048, epochs=2)
    bk = get_backend("fused")
    state = minibatch_init(c0, cfg, bk)
    for chunk in host_chunk_stream(x_host, 2048, epochs=2, seed=3):
        xc = torch.from_numpy(chunk).to(cuda)
        w = torch.ones(xc.shape[0], device=cuda)
        state, _ = minibatch_iteration(xc, w, x_val, state, cfg, bk)
    c_sync, e_sync, _, _ = guard_pick(x_val, state, cfg, bk)
    for prefetch in (1, 2, 3):
        meter = IngestMeter()
        res = aa_kmeans_minibatch_streamed(x_host, x_val, c0, cfg,
                                           backend="fused", seed=3,
                                           prefetch=prefetch, meter=meter)
        assert res.n_steps == state.t == meter.chunks
        assert len(meter.copy_ms()) == meter.chunks
        assert torch.equal(res.centroids, c_sync)
        assert torch.equal(res.energy, e_sync)
        assert torch.equal(res.n_accepted, state.n_acc)


@pytest.mark.gpu
def test_prefetch_yields_the_input_sequence_on_the_card(cuda):
    """Chunks of two shapes and a shorter tail through the pinned ring:
    every yielded tensor is on the card and equals its input, also while
    earlier chunks are still held."""
    from repro_torch.runtime import prefetch_to_device
    rng = np.random.default_rng(0)
    chunks = [rng.normal(size=(n, 7)).astype(np.float32)
              for n in (512, 512, 300, 512, 512, 100, 700)]
    got = list(prefetch_to_device(iter(chunks), size=2))
    torch.cuda.synchronize()
    assert len(got) == len(chunks)
    for a, b in zip(got, chunks):
        assert a.device.type == "cuda" and a.is_contiguous()
        np.testing.assert_array_equal(a.cpu().numpy(), b)


@pytest.mark.gpu
def test_streaming_fit_runs_on_the_kernels(cuda):
    """MiniBatchAAKMeans(backend="fused"): two fused launches a chunk step
    (the R = 2 guard and the weighted chunk step) plus the final pick,
    predict's assignment chunks, no plain version; partial_fit_stream
    equals partial_fit per chunk bit for bit."""
    from repro_torch.core import MiniBatchAAKMeans
    from repro_torch.core.api import PREDICT_CHUNK
    x = make_blobs(40000, 16, 40, seed=4, spread=3.0)
    F.launches = A.launches = F.plain_calls = A.plain_calls = 0
    U.plain_calls = 0
    m = MiniBatchAAKMeans(n_clusters=40, chunk_size=4096, epochs=3,
                          val_size=2048, backend="fused").fit(x)
    assert m.n_steps_ == 3 * -(-(40000 - 2048) // 4096)
    assert F.launches == 2 * m.n_steps_ + 1
    assert A.launches == -(-40000 // PREDICT_CHUNK)
    assert F.plain_calls == A.plain_calls == U.plain_calls == 0
    chunks = [x[i:i + 5000] for i in range(0, 40000, 5000)]
    a = MiniBatchAAKMeans(n_clusters=40, backend="fused")
    for ch in chunks:
        a.partial_fit(ch)
    b = MiniBatchAAKMeans(n_clusters=40,
                          backend="fused").partial_fit_stream(iter(chunks))
    assert torch.equal(a.centroids_, b.centroids_)
    assert torch.equal(a.energy_, b.energy_)
    assert torch.equal(a.n_accepted_, b.n_accepted_)
    assert F.plain_calls == 0


# -- persistence ---------------------------------------------------------------

@pytest.mark.gpu
def test_loaded_model_predicts_as_saved_on_the_card(cuda, tmp_path):
    """AAKMeans(backend="fused") saved and loaded with device=None, through
    AAKMeans.load and checkpoint.load_estimator: on the card, with the
    fitted state equal and predict's labels equal to the saved model's,
    on the assignment kernel."""
    from repro_torch.checkpoint import load_estimator
    from repro_torch.core.api import PREDICT_CHUNK
    x = make_blobs(20000, 16, 40, seed=5, spread=3.0)
    m = AAKMeans(n_clusters=40, backend="fused").fit(x)
    want = m.predict(x)
    p = m.save(tmp_path / "model")
    A.launches = A.plain_calls = 0
    for loaded in (AAKMeans.load(p), load_estimator(p)):
        assert type(loaded) is AAKMeans
        assert loaded.centroids_.device.type == "cuda"
        assert torch.equal(loaded.centroids_, m.centroids_)
        assert torch.equal(loaded.labels_, m.labels_)
        assert (loaded.energy_, loaded.n_iter_, loaded.n_accepted_) == \
            (m.energy_, m.n_iter_, m.n_accepted_)
        np.testing.assert_array_equal(loaded.predict(x), want)
    assert A.launches == 2 * -(-20000 // PREDICT_CHUNK)
    assert A.plain_calls == 0


@pytest.mark.gpu
def test_midstream_resume_is_bit_identical_on_the_card(cuda, tmp_path):
    """A partial_fit stream saved after 4 of 9 chunks and loaded in a
    fresh estimator ends, fed the same remaining chunks, bit for bit where
    the stream that was not interrupted ends."""
    from repro_torch.core import MiniBatchAAKMeans
    x = make_blobs(40000, 16, 40, seed=6, spread=3.0)
    chunks = [x[i:i + 4096] for i in range(0, 9 * 4096, 4096)]
    a = MiniBatchAAKMeans(n_clusters=40, chunk_size=4096, val_size=1024,
                          backend="fused")
    for ch in chunks[:4]:
        a.partial_fit(ch)
    b = MiniBatchAAKMeans.load(a.save(tmp_path / "mid"))
    assert b._state.t == 4 and b._x_val.device.type == "cuda"
    F.launches = F.plain_calls = 0
    for m in (a, b):
        for ch in chunks[4:]:
            m.partial_fit(ch)
        m.finalize()
    assert torch.equal(a.centroids_, b.centroids_)
    assert a.energy_ == b.energy_
    assert a.n_steps_ == b.n_steps_ == len(chunks)
    assert torch.equal(a.n_accepted_, b.n_accepted_)
    assert F.launches == 2 * 2 * 5 + 2 and F.plain_calls == 0


def _blob_problem(device, n=30000, d=16, k=40, seed=7):
    x = torch.from_numpy(make_blobs(n, d, k, seed=seed, spread=2.0))
    c0 = x[torch.from_numpy(np.random.default_rng(seed).permutation(n)[:k])]
    return x.to(device), c0.clone().to(device)


@pytest.mark.gpu
def test_fused_resume_is_bit_identical_on_the_card(cuda, tmp_path):
    """aa_kmeans on the fused kernel, cut every 5 iterations: the
    segmented run and runs resumed from each artifact equal the
    uninterrupted run bit for bit, all on the kernel."""
    from repro_torch.core.kmeans import KMeansConfig, aa_kmeans
    x, c0 = _blob_problem(cuda)
    cfg = KMeansConfig(k=40, max_iter=60)
    ref = aa_kmeans(x, c0, cfg, backend="fused")
    F.launches = F.plain_calls = 0
    seg = aa_kmeans(x, c0, cfg, backend="fused", checkpoint_every=5,
                    checkpoint_dir=tmp_path)
    assert all(torch.equal(a, b) for a, b in zip(seg, ref))
    snaps = sorted(tmp_path.glob("it_*.npz"))
    assert len(snaps) >= 2
    for p in snaps[:3]:
        res = aa_kmeans(x, c0, cfg, backend="fused", resume_from=p)
        assert res.centroids.device.type == "cuda"
        assert all(torch.equal(a, b) for a, b in zip(res, ref)), p.name
    assert F.launches > 0 and F.plain_calls == 0


@pytest.mark.gpu
def test_async_artifacts_equal_sync_artifacts_on_the_card(cuda, tmp_path):
    import zipfile

    from repro_torch.core.kmeans import KMeansConfig, aa_kmeans_batched
    x, c0 = _blob_problem(cuda)
    c0s = torch.stack([c0, x[:40]])
    cfg = KMeansConfig(k=40, max_iter=30)
    for sync in (True, False):
        aa_kmeans_batched(x, c0s, cfg, backend="fused", checkpoint_every=7,
                          checkpoint_dir=tmp_path / str(sync),
                          sync_writes=sync)
    names = sorted(p.name for p in (tmp_path / "True").glob("it_*.npz"))
    assert names == sorted(p.name for p in
                           (tmp_path / "False").glob("it_*.npz")) and names
    for name in names:
        members = []
        for sync in ("True", "False"):
            with zipfile.ZipFile(tmp_path / sync / name) as z:
                members.append({m: z.read(m) for m in z.namelist()})
        assert members[0] == members[1], name


@pytest.mark.gpu
def test_metrics_fit_equals_the_sink_free_fit_on_the_card(cuda):
    from repro_torch.runtime.metrics import CollectMetrics
    x = make_blobs(20000, 16, 40, seed=8, spread=2.0)
    mx = CollectMetrics()
    a = AAKMeans(n_clusters=40, n_init=2, backend="fused").fit(x)
    b = AAKMeans(n_clusters=40, n_init=2, backend="fused", metrics=mx).fit(x)
    assert torch.equal(a.centroids_, b.centroids_)
    assert torch.equal(a.labels_, b.labels_)
    assert (a.energy_, a.n_iter_, a.n_accepted_) == \
        (b.energy_, b.n_iter_, b.n_accepted_)
    assert mx.records and mx.records[-1][1]["n_active"] == 0.0


# -- serving -------------------------------------------------------------------

def _closure_problem(n=16384, d=16, k=40, seed=9):
    """Blobs, their fitted-like centroids (one row of each blob) and the
    index (16 of 40 candidates) built on the CPU."""
    from repro_torch.serving import build_closure_index
    x = make_blobs(n, d, k, seed=seed, spread=3.0)
    c = torch.from_numpy(x[np.random.default_rng(seed).permutation(n)[:k]])
    return x, c, build_closure_index(c, n_candidates=16)


@pytest.mark.gpu
@pytest.mark.parametrize("adaptive", [False, True])
def test_closure_functions_on_the_card_match_the_cpu(cuda, adaptive):
    """closure_assign and closure_sqdist on CUDA tensors against the same
    functions on CPU tensors: labels exact, squared distances within 1e-6
    of |x|^2 + |c|^2, +inf at the same columns."""
    from repro_torch.serving import (build_closure_index, closure_assign,
                                     closure_sqdist)
    x, c, _ = _closure_problem(n=4000)
    idx = build_closure_index(c, n_candidates=16, adaptive=adaptive)
    xt = torch.from_numpy(x)
    args = (c, idx.routers, idx.candidates)
    nv = idx.n_valid
    on = [a.to(cuda) for a in (xt, *args)]
    nv_on = None if nv is None else nv.to(cuda)
    lab, mind = closure_assign(xt, *args, n_valid=nv)
    lab_g, mind_g = closure_assign(*on, n_valid=nv_on)
    np.testing.assert_array_equal(lab_g.cpu().numpy(), lab.numpy())
    xsq = (xt.double() ** 2).sum(1)
    csq = (c.double() ** 2).sum(1)
    scale = xsq[:, None] + csq[None, :]
    assert bool(((mind_g.cpu().double() - mind.double()).abs()
                 <= 1e-6 * scale[torch.arange(4000), lab.long()]).all())
    s = closure_sqdist(xt, *args, n_valid=nv)
    s_g = closure_sqdist(*on, n_valid=nv_on).cpu()
    assert torch.equal(torch.isinf(s_g), torch.isinf(s))
    fin = torch.isfinite(s)
    assert bool(((s_g[fin].double() - s[fin].double()).abs()
                 <= 1e-6 * scale[fin]).all())


@pytest.mark.gpu
@pytest.mark.parametrize("n", [256, 16384])
def test_bucketed_scan_equals_plain_on_the_card(cuda, n):
    """The router-bucketed scan equals the plain one bit for bit on the
    card, at a serving batch and at a predict chunk; a row's distances
    are the same bits in the 256-row batch and in the chunk."""
    from repro_torch.serving import (candidate_table, closure_assign,
                                     closure_sqdist)
    x, c, idx = _closure_problem()
    xt = torch.from_numpy(x[:n]).to(cuda)
    cg, rg, cdg = (a.to(cuda) for a in (c, idx.routers, idx.candidates))
    tab = candidate_table(cg, cdg)
    l0, d0 = closure_assign(xt, cg, rg, cdg, tab)
    l1, d1 = closure_assign(xt, cg, rg, cdg, tab, bucketed=True)
    assert torch.equal(l0, l1) and torch.equal(d0, d1)
    s0 = closure_sqdist(xt, cg, rg, cdg, tab)
    s1 = closure_sqdist(xt, cg, rg, cdg, tab, bucketed=True)
    assert torch.equal(s0, s1)
    full = closure_sqdist(torch.from_numpy(x).to(cuda), cg, rg, cdg, tab)
    assert torch.equal(s0, full[:n])


@pytest.mark.gpu
def test_server_round_trip_on_the_card(cuda, tmp_path):
    """KMeansServer(path) with device=None serves on the card: labels equal
    predict(approx=True), transforms argmin-consistent, the exact path
    equal to predict's labels."""
    from repro_torch.serving import KMeansServer, serve_manifest
    x = make_blobs(20000, 16, 40, seed=10, spread=3.0)
    m = AAKMeans(n_clusters=40, backend="fused").fit(x)
    m.build_serving_index(n_candidates=16)
    p = m.save(tmp_path / "model")
    with KMeansServer(p, batch_size=256) as srv:
        assert srv._model.device.type == "cuda" and srv._model.approx
        futs = [srv.submit(x[i:i + 700]) for i in range(0, 7000, 700)]
        got = np.concatenate([f.result(timeout=30) for f in futs])
        np.testing.assert_array_equal(got, m.predict(x[:7000], approx=True))
        dist = srv.transform(x[:300], timeout=30)
        np.testing.assert_array_equal(np.argmin(dist, axis=1), got[:300])
        assert '"approx": true' in serve_manifest(srv)
    with KMeansServer(m, batch_size=256, approx=False) as srv:
        np.testing.assert_array_equal(srv.predict(x[:5000], timeout=30),
                                      m.predict(x[:5000]))


@pytest.mark.gpu
def test_server_hot_reload_on_the_card(cuda, tmp_path):
    """Overwrite the watched artifact under traffic: no request fails,
    each is answered by one model, and after the swap the new model
    answers."""
    import threading
    import time

    from repro_torch.serving import KMeansServer
    x = make_blobs(20000, 16, 40, seed=11, spread=3.0)
    m1 = AAKMeans(n_clusters=40, backend="fused", serving_index=16).fit(x)
    m2 = AAKMeans(n_clusters=40, backend="fused", serving_index=16,
                  seed=5).fit(x * -1.0 + 2.0)
    want = [m.predict(x, approx=True) for m in (m1, m2)]
    p = tmp_path / "model.npz"
    m1.save(p)
    errors, seen = [], []
    stop = threading.Event()
    with KMeansServer(p, batch_size=256, poll_s=0.02, flush_ms=0.5) as srv:
        def traffic():
            i = 0
            while not stop.is_set():
                s = (i * 37) % 19000
                try:
                    seen.append((s, srv.predict(x[s:s + 300], timeout=30)))
                except Exception as e:   # noqa: BLE001 — recorded
                    errors.append(e)
                i += 1
        t = threading.Thread(target=traffic)
        t.start()
        try:
            time.sleep(0.2)
            m2.save(p)
            deadline = time.time() + 10
            while srv.reload_count == 0 and time.time() < deadline:
                time.sleep(0.02)
            time.sleep(0.2)
        finally:
            stop.set()
            t.join(timeout=30)
        assert not t.is_alive() and not errors and seen
        assert srv.reload_count == 1 and srv.last_reload_error is None
        assert all(any(np.array_equal(got, w[s:s + 300]) for w in want)
                   for s, got in seen)
        np.testing.assert_array_equal(srv.predict(x[:1000], timeout=30),
                                      want[1][:1000])


# -- hierarchy and applications ---------------------------------------------

def _hier_data():
    from repro_torch.data.synthetic import make_dataset
    return torch.from_numpy(make_dataset("USCensus1990", scale=0.04)).cuda()


def _zero_counts():
    for mod in (F, A, U):
        mod.launches = mod.plain_calls = 0
    F.bounds_launches = F.bounds_plain_calls = 0


@pytest.mark.gpu
def test_hierarchical_fit_runs_on_the_kernels(cuda):
    """AAKMeans(K=1024, backend="fused", hierarchical=True) on 98,331 rows
    of the USCensus1990 stand-in (G = 32, K/G = 32): fused launches for
    the super-solve and the batched sub-solves, assignment launches for
    the reassignment, no plain version; the energy finite, the sum of
    the sub-energies, no higher than round 0's; every label inside its
    super-group's block; repeated bit for bit."""
    from repro_torch.core.hierarchy import default_n_groups
    from repro_torch.runtime.metrics import CollectMetrics
    x = _hier_data()
    assert default_n_groups(1024) == 32
    mx = CollectMetrics()
    _zero_counts()
    m = AAKMeans(n_clusters=1024, backend="fused", hierarchical=True,
                 max_iter=60, metrics=mx).fit(x)
    assert F.launches > 0 and A.launches > 0
    assert F.plain_calls == A.plain_calls == U.plain_calls == 0
    assert F.bounds_launches == 0
    assert np.isfinite(m.energy_)
    assert m.energy_ <= mx.records[0][1]["energy"]
    lab = m.labels_.long()
    offs = m.hier_offsets_.long()
    assert offs.tolist() == list(range(0, 1025, 32))
    # every row's label lies in the block of the router it was solved in
    e = float(torch.sum((x - m.centroids_[lab]) ** 2))
    assert e == pytest.approx(m.energy_, rel=1e-5)
    again = AAKMeans(n_clusters=1024, backend="fused", hierarchical=True,
                     max_iter=60).fit(x)
    assert torch.equal(again.centroids_, m.centroids_)
    assert torch.equal(again.labels_, m.labels_)


@pytest.mark.gpu
def test_hierarchical_solve_leaves_on_the_card(cuda):
    """The solve's own invariants at K = 1024: sub-energies summing to the
    energy within 1e-6, labels inside each row's super-group block, and
    the routers the update kernel's row means."""
    from repro_torch.core import KMeansConfig, aa_kmeans_hierarchical
    from repro_torch.core.hierarchy import _routers_of
    x = _hier_data()
    res = aa_kmeans_hierarchical(x, 1024, KMeansConfig(k=1024, max_iter=60),
                                 "fused")
    assert float(res.sub_energies.sum()) == pytest.approx(float(res.energy),
                                                          rel=1e-6)
    assert torch.equal(res.labels.long() // 32, res.labels_super.long())
    bk = get_backend("fused")
    want = _routers_of(x.cpu(), res.labels_super.cpu(), 32,
                       res.routers.cpu(), get_backend("dense"))
    got = _routers_of(x, res.labels_super, 32, res.routers, bk)
    np.testing.assert_allclose(got.cpu(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_hierarchical_predict_and_free_index_on_the_card(cuda):
    """Exact predict at K = 4096 on the assignment kernel (its energy no
    higher than the fit's), the kernel against its plain version on a
    16,384-row chunk at that K (distances within 1e-5 of |x|^2 + |c|^2),
    the hierarchy's free index built with no kernel launch, and
    approximate predict's recall."""
    from repro_torch.core.api import PREDICT_CHUNK
    from repro_torch.serving import hierarchy_closure_index
    x = _hier_data()
    m = AAKMeans(n_clusters=4096, backend="fused", hierarchical=True,
                 max_iter=30).fit(x)
    _zero_counts()
    lab = m.predict(x)
    assert A.launches == -(-x.shape[0] // PREDICT_CHUNK)
    e = float(torch.sum((x - m.centroids_[torch.from_numpy(lab).cuda()
                                          .long()]) ** 2))
    assert e <= m.energy_ * (1 + 1e-5)
    xc = x[:PREDICT_CHUNK]
    got, want = A.assignment(xc, m.centroids_), A.assignment_plain(
        xc, m.centroids_)
    assert float((got[0] != want[0]).float().mean()) < 1e-4
    # at this K a distance is far smaller than the norms it cancels
    # from: held to the f32 expansion's scale, |x|^2 + |c|^2
    scale = torch.maximum(want[1], torch.sum(xc * xc, dim=1) + torch.sum(
        m.centroids_ ** 2, dim=1)[want[0].long()]).clamp_min(1.0)
    assert float(((got[1] - want[1]).abs() / scale).max()) < 1e-5
    _zero_counts()
    m.build_serving_index()
    assert F.launches == A.launches == U.launches == 0
    idx = hierarchy_closure_index(m.centroids_, m.hier_routers_,
                                  m.hier_offsets_)
    assert torch.equal(m.closure_candidates_, idx.candidates)
    la = m.predict(x, approx=True)
    assert float((la == lab).mean()) > 0.9


@pytest.mark.gpu
def test_hierarchical_g1_equals_flat_on_the_card(cuda):
    from repro_torch.core import (KMeansConfig, aa_kmeans_batched,
                                  aa_kmeans_hierarchical, select_best)
    from repro_torch.core.init_schemes import batched_init
    x = _hier_data()
    c0s = batched_init("kmeans++", torch.Generator(device="cuda")
                       .manual_seed(0), x, 200, 2)
    cfg = KMeansConfig(k=200, max_iter=60)
    res = aa_kmeans_hierarchical(x, 200, cfg, "fused", n_groups=1, c0s=c0s)
    flat = select_best(aa_kmeans_batched(x, c0s, cfg, backend="fused"))
    assert torch.equal(res.centroids, flat.centroids)
    assert torch.equal(res.labels, flat.labels)
    assert torch.equal(res.energy, flat.energy)


@pytest.mark.gpu
def test_hierarchical_resume_is_bit_identical_on_the_card(cuda, tmp_path):
    import glob
    from repro_torch.core import KMeansConfig, aa_kmeans_hierarchical
    x = _hier_data()
    cfg = KMeansConfig(k=1024, max_iter=30)
    kw = dict(n_reassign=2, super_max_iter=5)
    full = aa_kmeans_hierarchical(x, 1024, cfg, "fused",
                                  checkpoint_dir=tmp_path, **kw)
    snaps = sorted(glob.glob(str(tmp_path / "it_*.npz")))
    assert len(snaps) == full.n_rounds + 1
    resumed = aa_kmeans_hierarchical(x, 1024, cfg, "fused",
                                     resume_from=snaps[0], **kw)
    for f, a, b in zip(full._fields, full, resumed):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b), f


@pytest.mark.gpu
def test_padded_group_equals_unpadded_on_the_card(cuda):
    """One group of a G = 2 partition solved padded beside the other and
    alone on its live rows from the same seeds: one fused step's labels
    equal and its stats within 1e-6; a plain Lloyd solve through the
    same driver with equal labels and iterations, centroids and energy
    within 1e-6; the AA solve with equal labels and iterations and its
    energy within 1e-6.  Not bit for bit: the segment sum's slabs follow
    N and R, and Anderson steps extrapolate the sums' last bits, so the
    AA centroids are not held to 1e-6."""
    import dataclasses
    from repro_torch.core import KMeansConfig, aa_kmeans_batched
    from repro_torch.core.hierarchy import _partition
    from repro_torch.core.init_schemes import batched_init
    x = _hier_data()[:30000]
    lab = (torch.arange(30000, device="cuda") >= 20000).to(torch.int32)
    xg, wg, _, n_max = _partition(x, lab, 2, 64, 256)
    c0s = batched_init("kmeans++", torch.Generator(device="cuda")
                       .manual_seed(1), xg, 64, 2, weights=wg)
    step_p = F.fused_lloyd(xg, c0s, wg)
    step_a = F.fused_lloyd(x[20000:], c0s[1])
    assert torch.equal(step_p[0][1, :10000], step_a[0])
    for i in (2, 3, 4):
        np.testing.assert_allclose(step_p[i][1].cpu(), step_a[i].cpu(),
                                   rtol=1e-6, atol=1e-6 * float(
                                       step_a[i].abs().max()))
    cfg = KMeansConfig(k=64, max_iter=60)
    for acc in (False, True):
        cfg_s = dataclasses.replace(cfg, accelerated=acc)
        both = aa_kmeans_batched(xg, c0s, cfg_s, backend="fused",
                                 weights=wg)
        alone = aa_kmeans_batched(x[20000:], c0s[1:], cfg_s,
                                  backend="fused")
        assert torch.equal(both.labels[1, :10000], alone.labels[0])
        assert torch.equal(both.n_iter[1:], alone.n_iter)
        np.testing.assert_allclose(both.energy[1:].cpu(),
                                   alone.energy.cpu(), rtol=1e-6)
        if not acc:
            scale = float(alone.centroids.abs().max())
            assert float((both.centroids[1:] - alone.centroids).abs()
                         .max()) <= 1e-6 * scale


@pytest.mark.gpu
def test_applications_on_the_card(cuda):
    """The batched and hierarchical KV codebooks on the fused engine run
    its kernels with no plain version; compress_kv_cache and
    embedding_codebook on the dense engine run none."""
    from repro_torch.core import applications as app
    g = torch.Generator(device="cuda").manual_seed(0)
    kv = torch.randn((2, 4096, 64), generator=g, device="cuda")
    _zero_counts()
    cbs, codes, res = app.kv_codebooks_batched(kv, 64, backend="fused")
    assert F.launches > 0 and F.plain_calls == 0
    assert cbs.shape == (2, 64, 64) and bool(torch.isfinite(res.energy)
                                             .all())
    cb, codes, res = app.kv_codebook_hierarchical(kv[0], 1024,
                                                  backend="fused")
    assert A.launches > 0 and F.plain_calls == A.plain_calls == 0
    e = float(torch.sum((kv[0] - cb[codes.long()]) ** 2))
    assert e == pytest.approx(float(res.energy), rel=1e-5)
    _zero_counts()
    cache = {n: torch.randn((1, 512, 2, 64), generator=g, device="cuda")
             for n in ("k", "v")}
    new, err = app.compress_kv_cache(cache, 32, 512)
    assert 0.0 < err < 1.0 and new["k"].device.type == "cuda"
    cbs, codes, err = app.embedding_codebook(
        torch.randn((3000, 64), generator=g, device="cuda"), 32)
    assert 0.0 < err < 1.0 and codes.shape == (3000, 4)
    assert F.launches == A.launches == U.launches == 0


# -- distribution on the card (core/distributed.py) --------------------------

def _dist_ranks(case, world, pg, inputs, tmp_path, **params):
    from torch_dist_ranks import run_ranks
    return run_ranks(case, world, inputs, tmp_path, timeout=300.0, pg=pg,
                     mesh_device="cuda", **params)


@pytest.mark.gpu
def test_mesh_fit_one_rank_nccl_is_bitwise_on_the_card(cuda, tmp_path):
    """AAKMeans(mesh=) at one rank over NCCL against the undistributed
    fit in the same process: every fitted field and predict bit for bit,
    on the fused and assignment kernels, no plain version."""
    x = make_blobs(60000, 16, 40, seed=2, spread=2.0).astype(np.float32)
    got = _dist_ranks("gpu_solve", 1, "nccl", dict(x=x), tmp_path, k=40)[0]
    for a, b in zip(got["mesh"], got["local"]):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    assert np.array_equal(*got["predict"])
    n = got["launches"]
    assert n["fused_lloyd"] > 0 and n["assignment"] > 0 and n["plain"] == 0


@pytest.mark.gpu
def test_mesh_steps_two_ranks_gloo_on_the_card(cuda, tmp_path):
    """Two ranks sharing the card over Gloo (card tensors staged through
    the host) against one rank over NCCL: two steps (at c, then at c2 on
    the carry) of fused, pallas and fused_bounds (16-centroid groups,
    G = 3 at K = 40) through distribute: labels equal on every row, sums within 1e-6 of their
    scale, counts equal, energies 1e-6, both ranks' stats equal bit for
    bit, the skipped share equal to one rank's within 1e-6; kernel
    launches only."""
    rng = np.random.default_rng(4)
    x = make_blobs(40960, 16, 40, seed=4, spread=2.0).astype(np.float32)
    c = x[rng.choice(x.shape[0], 40, replace=False)].copy()
    c2 = (c + 0.05 * rng.standard_normal(c.shape)).astype(np.float32)
    inputs = dict(x=x, c=c, c2=c2)
    one = _dist_ranks("gpu_steps", 1, "nccl", inputs, tmp_path)[0]
    two = _dist_ranks("gpu_steps", 2, "gloo", inputs, tmp_path)
    for name in ("fused", "pallas", "fused_bounds"):
        for i in range(2):
            want = one[name]["steps"][i]
            got = [r[name]["steps"][i] for r in two]
            assert torch.equal(torch.cat([g[0] for g in got]), want[0])
            scale = float(want[2].abs().max())
            assert float((got[0][2] - want[2]).abs().max()) <= 1e-6 * scale
            assert torch.equal(got[0][3], want[3])
            assert float(got[0][4]) == pytest.approx(float(want[4]),
                                                     rel=1e-6)
            for j in (2, 3, 4):
                assert torch.equal(got[0][j], got[1][j])
        if one[name]["stats"] is not None:
            for a, b, w in zip(two[0][name]["stats"], two[1][name]["stats"],
                               one[name]["stats"]):
                assert torch.equal(a, b)
                assert abs(float(a) - float(w)) <= 1e-6
        for r in two + [one]:
            n = r[name]["launches"]
            assert n["plain"] == 0 and sum(
                v for key, v in n.items() if key != "plain") > 0


# bf16 shapes: d = 1, 69 and 821 (the FP32 sweep's widest tile); K not a
# multiple of 128 or 256; N not a multiple of 64; per-problem X with (R, N)
# weights
BF16_CASES = [(1000, 1, 37, None, False, None),
              (4097, 69, 1000, None, False, "n"),
              (2001, 69, 45, 3, True, "rn"),
              (777, 821, 300, None, False, None)]


def _assert_equal(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _bf16_operands(cuda, n, d, k, r, x_batched, weights, seed=5):
    x, c, w = _inputs(cuda, n, d, k, r, x_batched, weights, seed)
    return x.bfloat16(), c.bfloat16(), w


def _lift(x, c, out):
    """A kernel's outputs and C with the leading R axis (c (K, d) -> R = 1)."""
    if c.dim() == 3:
        return c, list(out)
    return c[None], [o[None] for o in out]


def _tc_scale(x, c):
    """(R, N): |x|^2 + max |c|^2 of the row's problem, at least 1 — the
    scale of a bf16 distance's rounding (the rows' and centroids' norms it
    cancels from).  c (R, K, d)."""
    xf, cf = x.float(), c.float()
    xs = xf if xf.dim() == 3 else xf.expand(cf.shape[0], *xf.shape)
    return (torch.sum(xs * xs, dim=-1) + torch.sum(cf * cf, dim=-1).max(
        dim=-1).values[:, None]).clamp_min(1.0)


def _assert_tc_contract(x, c, w, got, want):
    """The tensor-core sweep's outputs against the plain version's on the
    same bf16 operands: labels equal but at near ties (``ref.tie_gap``
    within ``ref.NEAR_TIE``), min distances within 1e-5 of |x|^2 + max
    |c|^2; with the fused step's five outputs, the sums and counts of the
    kernel's own labels within 1e-4 and 1e-5 of ``ref.update_ref``'s and
    the energy as ``_assert_energy_close`` holds a bf16 energy."""
    c3, got = _lift(x, c, got)
    _, want = _lift(x, c, want)
    agree, gap = ref.tie_gap(got[0], want[0], x, c3)
    assert agree == 1.0 or gap <= ref.NEAR_TIE, (agree, gap)
    err = (got[1] - want[1]).abs()
    assert bool((err <= 1e-5 * _tc_scale(x, c3)).all()), float(err.max())
    if len(got) == 2:
        return
    xs = x if x.dim() == 3 else x.expand(c3.shape[0], *x.shape)
    for i in range(c3.shape[0]):
        wi = None if w is None else (w[i] if w.dim() == 2 else w)
        sums, counts = ref.update_ref(xs[i], got[0][i], c3.shape[1], wi)
        np.testing.assert_allclose(got[2][i].cpu(), sums.cpu(), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(got[3][i].cpu(), counts.cpu(), rtol=1e-5,
                                   atol=1e-5)
    _assert_energy_close(got[4].cpu(), want[4].cpu(), x, w)


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,k,r,x_batched,weights", BF16_CASES)
def test_bf16_fused_and_assignment(cuda, n, d, k, r, x_batched, weights):
    """bf16 X and C: the fused step and the assignment run the tensor-core
    sweep (its counters move), their labels and distances are equal bit
    for bit, a relaunch is equal, and both meet the tensor-core contract
    against the plain version (``_assert_tc_contract``)."""
    xb, cb, w = _bf16_operands(cuda, n, d, k, r, x_batched, weights)
    launched = F.launches, F.tc_launches
    got = F.fused_lloyd(xb, cb, w)
    assert (F.launches, F.tc_launches) == (launched[0] + 1, launched[1] + 1)
    _assert_equal(F.fused_lloyd(xb, cb, w), got)
    _assert_tc_contract(xb, cb, w, got, F.fused_lloyd_plain(xb, cb, w))
    launched = A.launches, A.tc_launches
    lab, mind = A.assignment(xb, cb)
    assert (A.launches, A.tc_launches) == (launched[0] + 1, launched[1] + 1)
    assert torch.equal(lab, got[0]) and torch.equal(mind, got[1])


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,k,r,x_batched,weights", BF16_CASES)
def test_bf16_update(cuda, n, d, k, r, x_batched, weights):
    """A bf16 X's segment sum (labels -1 and K land nowhere) against the
    plain version and bit for bit against the f32 launch on the upcast X:
    the bf16 kernel keeps the f32 layout's slabs and order of additions."""
    x, labels, w = _update_inputs(cuda, n, d, k, r, x_batched, weights)
    xb = x.bfloat16()
    launched = U.launches
    got = U.update(xb, labels, k, w)
    assert U.launches == launched + 1
    _assert_equal(got, U.update(xb.float(), labels, k, w))
    want = U.update_plain(xb, labels, k, w)
    np.testing.assert_allclose(got[0].cpu(), want[0].cpu(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got[1].cpu(), want[1].cpu(), rtol=1e-5,
                               atol=1e-5)
    if xb.dim() == 2:
        # a view whose first row is not 16-byte aligned: the staged
        # vectors start before it
        _assert_equal(U.update(xb[1:], labels[..., 1:], k),
                      U.update(xb[1:].float(), labels[..., 1:], k))


def _assert_bounds_tc_contract(x, c, w, bnds, got, want):
    """The bounded step on the tensor cores against the plain version on the
    same bf16 operands: the fused step's five as ``_assert_tc_contract``
    holds them (the energy as ``_assert_energy_close`` holds a seeded
    step), computed group minima within 1e-5 of |x|^2 + max |c|^2, every
    skipped group's minimum its lb^2 bit for bit and the skipped share
    exact (the skip test reads only the bounds)."""
    c3, got = _lift(x, c, got)
    _, want = _lift(x, c, want)
    lift = (lambda t: t) if c.dim() == 3 else (lambda t: t[None])
    _assert_tc_contract(x, c3, w, got[:2], want[:2])
    xs = x if x.dim() == 3 else x.expand(c3.shape[0], *x.shape)
    for i in range(c3.shape[0]):
        wi = None if w is None else (w[i] if w.dim() == 2 else w)
        sums, counts = ref.update_ref(xs[i], got[0][i], c3.shape[1], wi)
        np.testing.assert_allclose(got[2][i].cpu(), sums.cpu(), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(got[3][i].cpu(), counts.cpu(), rtol=1e-5,
                                   atol=1e-5)
    _assert_energy_close(got[4].cpu(), want[4].cpu(), x, w, seeded=True)
    lb_sq, ub_sq = lift(bnds[1]).cpu(), lift(bnds[2]).cpu()
    computed = torch.stack([ref.computed_cells(lb, ub, build.tile_rows())
                            for lb, ub in zip(lb_sq, ub_sq)])
    gmin, wg = got[5].cpu(), want[5].cpu()
    assert torch.equal(gmin[~computed], lb_sq[~computed])
    err = (gmin - wg).abs()[computed]
    scale = _tc_scale(x, c3).cpu()[..., None].expand_as(gmin)[computed]
    assert bool((err <= 1e-5 * scale).all()), float(err.max())
    assert torch.equal(got[6].cpu(), want[6].cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("gs", [8, 64])
@pytest.mark.parametrize("n,d,k,r,x_batched,weights", BF16_CASES)
def test_bf16_fused_bounds(cuda, n, d, k, r, x_batched, weights, gs):
    """The bounded step on bf16 X and C, from drifted bounds: the
    tensor-core sweep (its counter moves), a relaunch equal bit for bit,
    and the bounded tensor-core contract against the plain version
    (``_assert_bounds_tc_contract``)."""
    x, c, w = _inputs(cuda, n, d, k, r, x_batched, weights, seed=5)
    c, gsr, bnds = _drifted_bounds(x.bfloat16().float(),
                                   c.bfloat16().float(), w, gs)
    xb, cb = x.bfloat16(), c.bfloat16()
    launched = F.bounds_launches, F.bounds_tc_launches
    got = F.fused_lloyd(xb, cb, w, bounds=bnds, gs=gsr)
    assert (F.bounds_launches, F.bounds_tc_launches) == (launched[0] + 1,
                                                         launched[1] + 1)
    _assert_equal(F.fused_lloyd(xb, cb, w, bounds=bnds, gs=gsr), got)
    _assert_bounds_tc_contract(xb, cb, w, bnds, got, F.fused_bounds_plain(
        xb, cb, w, *bnds, gsr, build.tile_rows()))


@pytest.mark.gpu
@pytest.mark.parametrize("x_bf16", [True, False])
def test_mixed_operand_types_compute_in_f32(cuda, x_bf16):
    """bf16 X against f32 C (a bf16-policy model's predict of bf16 rows)
    and f32 X against bf16 C: each kernel equals its f32 launch on the
    upcast operand bit for bit."""
    x, c, w = _inputs(cuda, 4097, 69, 1000, None, False, "n", seed=6)
    if x_bf16:
        x = x.bfloat16()
    else:
        c = c.bfloat16()
    xu, cu = x.float(), c.float()
    _assert_equal(A.assignment(x, c), A.assignment(xu, cu))
    _assert_equal(F.fused_lloyd(x, c, w), F.fused_lloyd(xu, cu, w))
    lab = A.assignment_plain(x, c)[0]
    assert torch.equal(A.assignment(x, c)[0], lab)


@pytest.mark.gpu
def test_bf16_weighted_batched_step_drops_weight_zero_rows(cuda):
    """R = 3 bf16 problems with 700 padding rows of weight 0 against the
    unpadded step: labels and distances of the real rows equal bit for
    bit, counts equal, sums and energies within 1e-6 of their scale (the
    segment sum's slabs follow N)."""
    x, c, _ = _inputs(cuda, 3000, 69, 45, 3, False, None, seed=7)
    xb, cb = x.bfloat16(), c.bfloat16()
    pad = torch.randn(700, 69, device=cuda).bfloat16()
    w = torch.ones(3, 3700, device=cuda)
    w[:, 3000:] = 0.0
    got = F.fused_lloyd(torch.cat([xb, pad]), cb, w)
    want = F.fused_lloyd(xb, cb)
    assert torch.equal(got[0][:, :3000], want[0])
    assert torch.equal(got[1][:, :3000], want[1])
    assert torch.equal(got[3], want[3])
    scale = float(want[2].abs().max())
    assert float((got[2] - want[2]).abs().max()) <= 1e-6 * scale
    np.testing.assert_allclose(got[4].cpu(), want[4].cpu(), rtol=1e-6)


@pytest.mark.gpu
def test_bf16_fits_run_on_the_kernels(cuda, tmp_path):
    """Both ways into bf16 on the card: a bf16-policy fused fit keeps f32
    centroids and predicts as an f32 assignment of them; a bf16-X fit keeps
    bf16 centroids and repeats bit for bit; the policy survives save and
    load."""
    x = make_blobs(20000, 16, 40, seed=3)
    c0s = x[np.random.default_rng(4).choice(20000, (1, 40), replace=False)]
    bk = get_backend("fused", precision=Precision(compute=torch.bfloat16))
    F.launches = F.plain_calls = 0
    m = AAKMeans(n_clusters=40, backend=bk).fit(x, c0s=c0s)
    assert F.launches > 1 and F.plain_calls == 0
    assert m.centroids_.dtype == torch.float32
    lab = m.predict(x)
    want = A.assignment(torch.from_numpy(x).to(cuda), m.centroids_)[0]
    np.testing.assert_array_equal(lab, want.cpu().numpy())
    f32 = AAKMeans(n_clusters=40, backend="fused").fit(x, c0s=c0s)
    assert abs(m.inertia_ - f32.inertia_) <= 0.02 * f32.inertia_
    m2 = AAKMeans.load(m.save(tmp_path / "bf16"))
    assert m2.backend.precision.compute == torch.bfloat16
    np.testing.assert_array_equal(m2.predict(x), lab)
    xb = torch.from_numpy(x).to(cuda).bfloat16()
    fits = [AAKMeans(n_clusters=40, backend="fused").fit(xb, c0s=c0s)
            for _ in range(2)]
    assert fits[0].centroids_.dtype == torch.bfloat16
    assert np.isfinite(fits[0].inertia_)
    assert torch.equal(fits[0].centroids_, fits[1].centroids_)


# Wide rows: past the resident X tile's widest d (821 for the assignment on
# an H100) the three sweep kernels stream X in 32-feature slabs.  Widths
# around and far past it (d = 1023: f32 rows not 16-byte aligned); K = 256
# (one C chunk) and 1000 (four); shared X at R = 3; per-problem X with
# (R, N) weights.
WIDE_DS = (822, 1023, 1024, 4096)
WIDE_SHAPES = [(700, 256, None, False, None),
               (600, 1000, None, False, "n"),
               (500, 300, 3, False, None),
               (400, 256, 3, True, "rn")]


def _mixture(device, n, d, k, r, x_batched, weights, seed=0):
    """Rows of a k-component Gaussian mixture (centers 1.5 x N(0, 1), unit
    noise) and centroids 0.1 from its centers: each row's own component's
    centroid is nearest by a wide margin, so labels are exact at any d
    (random centroids at d = 4096 leave near ties within the rounding of
    |c|^2).  Weights as ``_inputs`` draws them."""
    rng = np.random.default_rng(seed)
    rr = r or 1
    centers = rng.standard_normal((k, d), dtype=np.float32) * 1.5
    lead = (rr, n) if x_batched else (n,)
    x = centers[rng.integers(0, k, lead)] \
        + rng.standard_normal(lead + (d,), dtype=np.float32)
    c = centers + 0.1 * rng.standard_normal((rr, k, d), dtype=np.float32)
    _, _, w = _inputs(device, n, 1, 1, r, False, weights, seed)
    return (torch.from_numpy(x).to(device),
            torch.from_numpy(c if r else c[0]).to(device), w)


def _wide_atol(x):
    """min_sqdist's tolerance: 1e-5 of max(|x|^2, 1)."""
    xf = x.float()
    return 1e-5 * max(float(torch.sum(xf * xf, dim=-1).max()), 1.0)


def _assert_energy_close(got, want, x, w, seeded=False):
    """The energy: within 1e-6 relative where each row's distance errs
    without a bias.  Two cases err with one, and are held to the per-row
    min_sqdist rule summed, 1e-5 of sum(w max(|x|^2, 1)):
    - bf16 rows: the |x|^2 and x.c FMA chains round with a bias (the
      products carry 16 significant bits, so the sums meet exact halfway
      cases), about -1.4e-6 of |x|^2 a row at d = 822 on this mixture
      against the plain version's summation trees;
    - a bounded step from drifted bounds (``seeded``): a settled row's
      seed ub^2 is its last distance, so the kernel and the plain version
      each keep the smaller of the seed and their own rounding of the
      same distance, and the plain version's is below the seed (the
      kernel's own) about half the time: about 1.5e-6 of the energy at
      d = 822."""
    if x.dtype != torch.bfloat16 and not seeded:
        np.testing.assert_allclose(got, want, rtol=1e-6)
        return
    xf = x.float()
    rows = torch.sum(xf * xf, dim=-1).clamp_min(1.0)
    scale = torch.sum(rows if w is None else rows * w, dim=-1)
    assert bool(((got - want).abs() <= 1e-5 * scale.cpu()).all())


def _counts():
    return (F.launches, F.stream_launches, F.bounds_launches,
            F.bounds_stream_launches, A.launches, A.stream_launches,
            F.plain_calls + F.bounds_plain_calls + A.plain_calls,
            F.tc_launches, A.tc_launches, F.bounds_tc_launches)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("n,k,r,x_batched,weights", WIDE_SHAPES)
@pytest.mark.parametrize("d", WIDE_DS)
def test_wide_kernels_match_plain(cuda, d, n, k, r, x_batched, weights,
                                  bf16):
    """The fused step and the assignment at wide d launch the streamed
    sweep on f32 operands and the tensor-core sweep on bf16 ones: the
    assignment's labels and distances equal to the step's, a relaunch
    equal, bit for bit; f32 against the plain version (labels exact,
    min_sqdist within 1e-5 of |x|^2, sums 1e-4, counts 1e-5, energy
    1e-6), bf16 by the tensor-core contract (``_assert_tc_contract``)."""
    x, c, w = _mixture(cuda, n, d, k, r, x_batched, weights, seed=d)
    if bf16:
        x, c = x.bfloat16(), c.bfloat16()
    before = _counts()
    got = F.fused_lloyd(x, c, w)
    lab, mind = A.assignment(x, c)
    after = _counts()
    assert [b - a for a, b in zip(before, after)] == (
        [1, 0, 0, 0, 1, 0, 0, 1, 1, 0] if bf16
        else [1, 1, 0, 0, 1, 1, 0, 0, 0, 0])
    assert torch.equal(lab, got[0]) and torch.equal(mind, got[1])
    _assert_equal(F.fused_lloyd(x, c, w), got)
    if bf16:
        _assert_tc_contract(x, c, w, got, F.fused_lloyd_plain(x, c, w))
        return
    got = [g.cpu() for g in got]
    want = [v.cpu() for v in F.fused_lloyd_plain(x, c, w)]
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5,
                               atol=_wide_atol(x))
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5, atol=1e-5)
    _assert_energy_close(got[4], want[4], x, w)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("gs", [8, 64])
@pytest.mark.parametrize("n,k,r,x_batched,weights",
                         [WIDE_SHAPES[0], WIDE_SHAPES[1], WIDE_SHAPES[3]])
@pytest.mark.parametrize("d", WIDE_DS)
def test_wide_fused_bounds_matches_plain(cuda, d, n, k, r, x_batched,
                                         weights, gs, bf16):
    """The bounded step at wide d from drifted bounds launches the
    streamed bounded sweep on f32 operands: against the plain version as
    ``test_fused_bounds_matches_plain`` holds it (min_sqdist and group
    minima within 1e-5 of |x|^2; the energy as ``_assert_energy_close``
    holds a seeded step).  bf16 X and C take the tensor-core sweep, held to
    ``_assert_bounds_tc_contract``.  A relaunch is equal bit for bit."""
    x, c, w = _mixture(cuda, n, d, k, r, x_batched, weights, seed=d + gs)
    if bf16:
        x, c = x.bfloat16(), c.bfloat16()
    c, gsr, bnds = _drifted_bounds(x.float(), c.float(), w, gs)
    if bf16:
        c = c.bfloat16()
    before = _counts()
    got = F.fused_lloyd(x, c, w, bounds=bnds, gs=gsr)
    after = _counts()
    assert [b - a for a, b in zip(before, after)] == (
        [0, 0, 1, 0, 0, 0, 0, 0, 0, 1] if bf16
        else [0, 0, 1, 1, 0, 0, 0, 0, 0, 0])
    _assert_equal(F.fused_lloyd(x, c, w, bounds=bnds, gs=gsr), got)
    if bf16:
        _assert_bounds_tc_contract(x, c, w, bnds, got, F.fused_bounds_plain(
            x, c, w, *bnds, gsr, build.tile_rows()))
        return
    got = [g.cpu() for g in got]
    want = [v.cpu() for v in F.fused_bounds_plain(
        x, c, w, *bnds, gsr, build.tile_rows())]
    atol = _wide_atol(x)
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=atol)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5, atol=1e-5)
    _assert_energy_close(got[4], want[4], x, w, seeded=True)
    np.testing.assert_allclose(got[5], want[5], rtol=1e-5, atol=atol)
    assert torch.equal(got[6], want[6])
    lb_sq, ub_sq = bnds[1].cpu(), bnds[2].cpu()
    lift = (lambda t: t) if r else (lambda t: t[None])
    skipped = ~torch.stack([ref.computed_cells(lb, ub, build.tile_rows())
                            for lb, ub in zip(lift(lb_sq), lift(ub_sq))])
    assert torch.equal(lift(got[5])[skipped], lift(lb_sq)[skipped])


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("kernel", ["assignment", "fused", "bounded"])
@pytest.mark.parametrize("at", ["d=69", "widest"])
def test_streamed_equals_resident(cuda, at, kernel, bf16):
    """Where both paths fit (d = 69, and the resident path's widest d),
    the launch forced to stream X equals the resident launch bit for bit
    in every output: the same FMA chains in the same order.  Random data,
    two C chunks, a ragged row tile, (R, N) weights; the bounded step from
    drifted bounds at G = 19.  bf16 X and C take the tensor-core sweep in
    all three (the bounded step at gs 16, a multiple of 8), which has no
    streamed path: forcing one raises."""
    n, k, r = 777, 300, 2
    gs = 16
    g = -(-k // gs)
    if at == "widest":
        if kernel == "assignment":
            d = A._bind(build.load("assignment")).assignment_max_features(0)
        elif kernel == "fused":
            d = F._bind(build.load("fused_lloyd")).fused_lloyd_max_features(0)
        else:
            d = F._bind_bounds(build.load("fused_bounds")) \
                .fused_bounds_max_features(0, g)
    else:
        d = 69
    x, c, w = _inputs(cuda, n, d, k, r, False, "rn", seed=11)
    if kernel == "bounded":
        c, gsr, bnds = _drifted_bounds(x, c, w, gs)
        assert gsr == gs
    if bf16:
        x, c = x.bfloat16(), c.bfloat16()

    def run(stream):
        if kernel == "assignment":
            return A.assignment(x, c, _stream=stream)
        if kernel == "fused":
            return F.fused_lloyd(x, c, w, _stream=stream)
        return F.fused_lloyd(x, c, w, bounds=bnds, gs=gsr, _stream=stream)

    if bf16:
        with pytest.raises(ValueError):
            run(True)
        return
    before = _counts()
    resident = run(False)
    middle = _counts()
    streamed = run(True)
    after = _counts()
    assert middle[1] + middle[3] + middle[5] \
        == before[1] + before[3] + before[5]
    assert after[1] + after[3] + after[5] \
        == middle[1] + middle[3] + middle[5] + 1
    _assert_equal(streamed, resident)


# The streamed sweep of the assignment and the fused step
# (csrc/sweep_wide.cuh): 128-row tiles, 256-centroid chunks, X slabs of 32
# features read at any alignment.  Their bf16 cases run the tensor-core
# sweep (csrc/sweep_tc.cuh): 128-row tiles, 128-centroid chunks, X slabs
# of 64 features, by TMA or by plain loads.


def _assert_streamed_assignment(x, c, lab, mind):
    """One wide assignment launch against the plain version: f32 labels
    exact and min distances within 1e-5 of max(|x|^2, 1); bf16 by the
    tensor-core contract."""
    want = A.assignment_plain(x, c)
    if x.dtype == torch.bfloat16:
        _assert_tc_contract(x, c, None, (lab, mind), want)
        return
    want = [v.cpu() for v in want]
    np.testing.assert_array_equal(lab.cpu().numpy(), want[0].numpy())
    np.testing.assert_allclose(mind.cpu(), want[1], rtol=1e-5,
                               atol=_wide_atol(x))


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
def test_streamed_sweep_ragged_k_and_rows(cuda, bf16):
    """d = 4096, K = 1000 (four 256-centroid chunks or eight of 128, the
    last one ragged) and N = 1000 (not a multiple of the 128-row tile): the
    streamed launch (f32) or the tensor-core one (bf16) against the plain
    version, and a relaunch equal bit for bit."""
    x, c, _ = _mixture(cuda, 1000, 4096, 1000, None, False, None, seed=41)
    if bf16:
        x, c = x.bfloat16(), c.bfloat16()
    before = A.tc_launches if bf16 else A.stream_launches
    lab, mind = A.assignment(x, c)
    assert (A.tc_launches if bf16 else A.stream_launches) == before + 1
    _assert_streamed_assignment(x, c, lab, mind)
    _assert_equal(A.assignment(x, c), (lab, mind))


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
def test_streamed_sweep_per_problem_x(cuda, bf16):
    """Per-problem X at R = 3 with (R, N) weights at d = 4096 and a ragged
    N: the fused step against the plain version (bf16: the tensor-core
    contract), its sweep equal to the assignment's launch bit for bit."""
    x, c, w = _mixture(cuda, 515, 4096, 256, 3, True, "rn", seed=43)
    if bf16:
        x, c = x.bfloat16(), c.bfloat16()
    got = F.fused_lloyd(x, c, w)
    _assert_equal(A.assignment(x, c), got[:2])
    if bf16:
        _assert_tc_contract(x, c, w, got, F.fused_lloyd_plain(x, c, w))
        return
    got = [g.cpu() for g in got]
    want = [v.cpu() for v in F.fused_lloyd_plain(x, c, w)]
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5,
                               atol=_wide_atol(x))
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5, atol=1e-5)
    _assert_energy_close(got[4], want[4], x, w)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d,offset", [(torch.float32, 1023, 0),
                                            (torch.bfloat16, 822, 0),
                                            (torch.float32, 4096, 1),
                                            (torch.bfloat16, 4096, 1)])
def test_streamed_sweep_unaligned_rows(cuda, dtype, d, offset):
    """Rows that do not start 16-byte aligned: f32 rows of odd width, bf16
    rows, and a base one element past an aligned one
    (``torch.empty(n * d + 1)[1:].view(n, d)``), so X comes by plain loads
    (bf16: into the tensor-core sweep's swizzled slabs).  Equal bit for bit
    to the launch on an aligned copy of the same values (bf16 at d = 4096:
    X by TMA), and against the plain version."""
    x, c, _ = _mixture(cuda, 700, d, 256, None, False, None, seed=d + 7)
    x, c = x.to(dtype), c.to(dtype)
    n = x.shape[0]
    moved = torch.empty(n * d + offset, dtype=dtype,
                        device=cuda)[offset:].view(n, d)
    moved.copy_(x)
    assert moved.is_contiguous()
    assert moved.data_ptr() % 16 == offset * x.element_size()
    lab, mind = A.assignment(moved, c)
    _assert_equal((lab, mind), A.assignment(x, c))
    _assert_streamed_assignment(x, c, lab, mind)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
def test_streamed_sweep_ties_and_nan(cuda, bf16):
    """Integer data at d = 4096, so every distance is exact (the
    tensor-core sweep's too: small integer products and sums): K = 1000 is
    250 centroids four times over, so each one ties with copies in other
    lanes, warps and chunks (the last ragged), and the lowest index wins;
    rows with a NaN (in the first and in a later tile) get a NaN distance
    and label 0.  Labels and distances equal the plain version's."""
    rng = np.random.default_rng(53)
    x = rng.integers(-4, 5, (600, 4096)).astype(np.float32)
    c = np.tile(rng.integers(-4, 5, (250, 4096)).astype(np.float32), (4, 1))
    x[[7, 300], [3, 4000]] = np.nan
    xt, ct = torch.from_numpy(x).to(cuda), torch.from_numpy(c).to(cuda)
    if bf16:
        xt, ct = xt.bfloat16(), ct.bfloat16()
    lab, mind = (t.cpu() for t in A.assignment(xt, ct))
    want = A.assignment_plain(torch.from_numpy(x), torch.from_numpy(c))
    assert int(lab.max()) < 250
    assert int(lab[7]) == int(lab[300]) == 0
    assert torch.isnan(mind[7]) and torch.isnan(mind[300])
    np.testing.assert_array_equal(lab.numpy(), want[0].numpy())
    np.testing.assert_array_equal(mind.numpy(), want[1].numpy())


@pytest.mark.gpu
def test_streamed_sweep_predict_chunk(cuda):
    """A 16,384-row predict chunk at d = 4096, K = 256 (128 tiles of 128
    rows): against the plain version, each row equal bit for bit to the
    same row in a launch over more rows, a relaunch equal."""
    x, c, _ = _mixture(cuda, 20000, 4096, 256, None, False, None, seed=47)
    part = x[:16384]
    lab, mind = A.assignment(part, c)
    _assert_streamed_assignment(part, c, lab, mind)
    whole = A.assignment(x, c)
    _assert_equal((lab, mind), (whole[0][:16384], whole[1][:16384]))
    _assert_equal(A.assignment(part, c), (lab, mind))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1023, 4096])
def test_wide_fits_run_on_the_kernels(cuda, d):
    """Every kernel engine fits at wide d on the streamed kernels, from the
    dense engine's seeds to its energy (within 1e-4), and predict's labels
    are the last step's."""
    x, _, _ = _mixture(cuda, 3000, d, 16, None, False, None, seed=5)
    c0s = x[torch.from_numpy(np.random.default_rng(6).choice(
        3000, (1, 16), replace=False)).to(cuda)]
    dense = AAKMeans(n_clusters=16, backend="dense").fit(x, c0s=c0s)
    for name in ("fused", "pallas", "fused_bounds"):
        before = _counts()
        m = AAKMeans(n_clusters=16, backend=name).fit(x, c0s=c0s)
        lab = m.predict(x)
        after = _counts()
        assert after[6] == before[6]                   # no plain version
        assert after[1] + after[3] + after[5] > before[1] + before[3] \
            + before[5]
        np.testing.assert_allclose(m.inertia_, dense.inertia_, rtol=1e-4)
        np.testing.assert_array_equal(lab, m.labels_.cpu().numpy())


# The tensor-core sweep (csrc/sweep_tc.cuh) on bf16 X and C: every d (X
# resident up to 256 padded features, streamed past them), K on both sides
# of the 128-centroid chunk, N = 777 (a ragged 128-row tile).
TC_DS = (1, 8, 16, 69, 80, 821, 822, 4096)
TC_KS = (1, 37, 256, 257, 1000)


def _tc_counts():
    return (F.tc_launches, A.tc_launches, F.stream_launches,
            A.stream_launches, F.plain_calls + A.plain_calls)


@pytest.mark.gpu
@pytest.mark.parametrize("k", TC_KS)
@pytest.mark.parametrize("d", TC_DS)
def test_tensor_core_sweep_matches_plain(cuda, d, k):
    """(N,) weights: the fused step and the assignment each launch the
    tensor-core sweep (its counters move, no FP32 streamed launch, no
    plain version), their labels and distances are equal bit for bit, a
    relaunch is equal, and the step meets the tensor-core contract against
    the plain version."""
    x, c, w = _mixture(cuda, 777, d, k, None, False, "n", seed=7 * d + k)
    xb, cb = x.bfloat16(), c.bfloat16()
    before = _tc_counts()
    got = F.fused_lloyd(xb, cb, w)
    lab, mind = A.assignment(xb, cb)
    assert [b - a for a, b in zip(before, _tc_counts())] == [1, 1, 0, 0, 0]
    assert torch.equal(lab, got[0]) and torch.equal(mind, got[1])
    _assert_equal(F.fused_lloyd(xb, cb, w), got)
    _assert_equal(A.assignment(xb, cb), (lab, mind))
    _assert_tc_contract(xb, cb, w, got, F.fused_lloyd_plain(xb, cb, w))


@pytest.mark.gpu
@pytest.mark.parametrize("x_batched", [False, True])
@pytest.mark.parametrize("d", [69, 821, 4096])
def test_tensor_core_sweep_batched(cuda, d, x_batched):
    """R = 3 with shared X (N, d), or per-problem X (R, N, d) with (R, N)
    weights that zero a fifth of the rows; N = 515, so at d = 69 and 821
    the problem stride N*d*2 is not a multiple of 16 bytes (plain X loads)
    and at 4096 it is (X by TMA).  The step meets the tensor-core contract
    (weight-0 rows add nothing to the stats), and each problem's rows
    equal bit for bit a launch of that problem alone."""
    x, c, w = _mixture(cuda, 515, d, 256, 3, x_batched,
                       "rn" if x_batched else None, seed=d + x_batched)
    xb, cb = x.bfloat16(), c.bfloat16()
    got = F.fused_lloyd(xb, cb, w)
    _assert_tc_contract(xb, cb, w, got, F.fused_lloyd_plain(xb, cb, w))
    for i in range(3):
        alone = A.assignment(xb[i].contiguous() if x_batched else xb, cb[i])
        assert torch.equal(alone[0], got[0][i])
        assert torch.equal(alone[1], got[1][i])


@pytest.mark.gpu
@pytest.mark.parametrize("d", [69, 192, 193])
def test_tensor_core_sweep_rows_independent(cuda, d):
    """Each row's label and distance depend on its own row alone: a
    40,000-row launch equals a launch of its first 16,384 rows there bit
    for bit, at the widest resident d (192) and the first streamed one
    (193), and the whole launch meets the tensor-core contract."""
    x, c, _ = _mixture(cuda, 40000, d, 300, None, False, None, seed=d)
    xb, cb = x.bfloat16(), c.bfloat16()
    whole = A.assignment(xb, cb)
    part = A.assignment(xb[:16384], cb)
    _assert_equal(part, (whole[0][:16384], whole[1][:16384]))
    _assert_tc_contract(xb, cb, None, whole, A.assignment_plain(xb, cb))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [69, 300])
def test_tensor_core_sweep_ties_and_nan(cuda, d):
    """Integer data, so every product and sum is exact: K = 1000 is 250
    centroids four times over, so each one ties with copies in other
    lanes, chunks and the ragged last chunk, and the lowest index wins;
    rows with a NaN (in the first and in a later tile) get a NaN distance
    and label 0.  Labels and distances equal the plain version's."""
    rng = np.random.default_rng(59 + d)
    x = rng.integers(-4, 5, (600, d)).astype(np.float32)
    c = np.tile(rng.integers(-4, 5, (250, d)).astype(np.float32), (4, 1))
    x[[7, 300], [3, d - 1]] = np.nan
    xt = torch.from_numpy(x).to(cuda).bfloat16()
    ct = torch.from_numpy(c).to(cuda).bfloat16()
    lab, mind = (t.cpu() for t in A.assignment(xt, ct))
    want = A.assignment_plain(torch.from_numpy(x), torch.from_numpy(c))
    assert int(lab.max()) < 250
    assert int(lab[7]) == int(lab[300]) == 0
    assert torch.isnan(mind[7]) and torch.isnan(mind[300])
    np.testing.assert_array_equal(lab.numpy(), want[0].numpy())
    np.testing.assert_array_equal(mind.numpy(), want[1].numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("d", [69, 821, 4096])
def test_tensor_core_cross_terms(cuda, d):
    """The sweep's cross terms x.c (``assignment.cross_terms``: the
    accumulator its epilogue reads) against an f64 product of the same
    bf16 values: within 2e-6 of |x| |c| (summed in f32 from exact
    products; past 256 features each 64-feature slab is summed apart and
    added with round to nearest)."""
    x, c, _ = _mixture(cuda, 300, d, 257, 2, False, None, seed=d)
    xb, cb = x.bfloat16(), c.bfloat16()
    before = A.cross_launches
    got = A.cross_terms(xb, cb)
    assert A.cross_launches == before + 1
    xd, cd = xb.double(), cb.double()
    want = torch.einsum("nd,rkd->rnk", xd, cd)
    norms = torch.linalg.norm(xd, dim=-1)[None, :, None] \
        * torch.linalg.norm(cd, dim=-1)[:, None, :]
    rel = float(((got.double() - want).abs() / norms.clamp_min(1e-30)).max())
    assert rel <= 2e-6, rel


@pytest.mark.gpu
def test_tensor_core_sweep_refuses_forced_streaming(cuda):
    """bf16 X and C have no streamed FP32 path: ``_stream=True`` raises,
    and a bf16 X against f32 C still streams when forced."""
    x, c, _ = _inputs(cuda, 300, 69, 40, None, False, None, seed=3)
    xb, cb = x.bfloat16(), c.bfloat16()
    with pytest.raises(ValueError):
        A.assignment(xb, cb, _stream=True)
    with pytest.raises(ValueError):
        F.fused_lloyd(xb, cb, _stream=True)
    before = A.stream_launches
    A.assignment(xb, c, _stream=True)
    assert A.stream_launches == before + 1


# The bounded step's streamed sweep (csrc/sweep_bounded.cuh): 128-row
# blocks, each two of the skip test's 64-row tiles, and 256-slot chunks of
# the live 16-byte vectors of C.


def _tile_bounds(x, c, gs, seed):
    """Bounds under which adjacent 64-row tiles compute different groups:
    lab0 a random label and ub^2 the squared distance to it (an upper
    bound), each tile computing a random half of the groups (one random
    row of the tile with lb^2 = 0 a group), every other cell lb^2 = 2 ub^2
    + 1 (above the bound).  -> (lab0, lb_sq, ub_sq) on the CPU."""
    rng = np.random.default_rng(seed)
    n, k = x.shape[0], c.shape[0]
    g = -(-k // gs)
    lab0 = rng.integers(0, k, n)
    xd, cd = x.double().cpu(), c.double().cpu()
    ub_sq = ((xd - cd[torch.from_numpy(lab0)]) ** 2).sum(-1).float()
    lb_sq = (2 * ub_sq + 1)[:, None].repeat(1, g)
    for t in range(-(-n // 64)):
        rows = np.arange(64 * t, min(64 * t + 64, n))
        for grp in rng.choice(g, size=g // 2, replace=False):
            lb_sq[rng.choice(rows), grp] = 0.0
    return torch.from_numpy(lab0.astype(np.int32)), lb_sq, ub_sq


@pytest.mark.gpu
@pytest.mark.parametrize("k,gs", [(300, 16), (900, 48), (93, 5), (1000, 53)])
@pytest.mark.parametrize("d", [1023, 4096])
def test_streamed_bounds_tiles_need_different_groups(cuda, d, k, gs):
    """G = 19 at a ragged N = 777 (the last 128-row block one partial
    64-row tile): each 64-row tile computes its own random half of the
    groups, so the two tiles of a block differ and the block computes
    their union.  gs 16 and 48 with K a multiple of 4 (each vector in one
    group; gs 48 groups straddle the 256-slot chunks), gs 5 and 53 the
    general merge (K = 93 not a multiple of 4; gs 53 groups straddle
    chunks); d = 1023 takes X by plain loads, 4096 by TMA.  The streamed
    launch against the plain version: labels exact, min distances and
    computed group minima within 1e-5 of |x|^2, the skipped share exact
    and every skipped cell's lb^2 passed through bit for bit; a relaunch
    equal, and a bf16 X equal to the launch on its upcast values."""
    x, c, _ = _mixture(cuda, 777, d, k, None, False, None, seed=d + k)
    lab0, lb_sq, ub_sq = _tile_bounds(x, c, gs, seed=k)
    assert lb_sq.shape[1] == 19
    need = ref.computed_cells(lb_sq, ub_sq, 64)[::64]
    assert not torch.equal(need[0], need[1])
    assert 0.0 < float(need.float().mean()) < 1.0
    bnds = tuple(t.to(cuda) for t in (lab0, lb_sq, ub_sq))
    before = _counts()
    got = F.fused_lloyd(x, c, None, bounds=bnds, gs=gs)
    after = _counts()
    assert [b - a for a, b in zip(before, after)] == [0, 0, 1, 1, 0, 0, 0,
                                                      0, 0, 0]
    _assert_equal(F.fused_lloyd(x, c, None, bounds=bnds, gs=gs), got)
    xb = x.bfloat16()
    _assert_equal(F.fused_lloyd(xb, c, None, bounds=bnds, gs=gs),
                  F.fused_lloyd(xb.float(), c, None, bounds=bnds, gs=gs))
    got = [t.cpu() for t in got]
    want = [t.cpu() for t in F.fused_bounds_plain(
        x, c, None, *bnds, gs, build.tile_rows())]
    atol = _wide_atol(x)
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=atol)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5, atol=1e-5)
    _assert_energy_close(got[4], want[4], x, None, seeded=True)
    computed = ref.computed_cells(lb_sq, ub_sq, 64)
    np.testing.assert_allclose(got[5][computed], want[5][computed],
                               rtol=1e-5, atol=atol)
    assert torch.equal(got[5][~computed], lb_sq[~computed])
    assert torch.equal(got[6], want[6])


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("kernel", ["assignment", "fused", "bounded"])
@pytest.mark.parametrize("d", [69, 4096])
def test_rows_at_infinite_distance_keep_a_real_label(cuda, d, kernel, bf16):
    """Rows with one feature at 3e19, whose |x|^2 overflows f32, so that
    their distance to every real centroid is +inf, in three 128-row tiles
    (the first, a middle one and the ragged last), at K = 300: not a
    multiple of the FP32 sweeps' 256-slot chunk or the tensor-core sweep's
    128.  Each kernel's labels lie in [0, K) and equal the plain
    version's: the first index, 0, where nothing bounds the row, and the
    bounded step's seed lab0 (ub^2 = +inf keeps a tie); those rows' min
    distances are +inf; every other row as the plain version gives it
    (bf16 X and C, on the tensor cores in all three: but at near ties)."""
    n, k, gs = 777, 300, 16
    x, c, _ = _mixture(cuda, n, d, k, None, False, None, seed=61 + d)
    far = [0, 300, n - 1]
    x[far, 5] = 3e19
    if bf16:
        x, c = x.bfloat16(), c.bfloat16()
    if kernel == "assignment":
        got, want = A.assignment(x, c), A.assignment_plain(x, c)
    elif kernel == "fused":
        got, want = F.fused_lloyd(x, c), F.fused_lloyd_plain(x, c)
    else:
        lab0 = torch.from_numpy(np.random.default_rng(d).integers(
            0, k, n).astype(np.int32)).to(cuda)
        bnds = (lab0, torch.zeros((n, -(-k // gs)), device=cuda),
                torch.full((n,), float("inf"), device=cuda))
        got = F.fused_lloyd(x, c, bounds=bnds, gs=gs)
        want = F.fused_bounds_plain(x, c, None, *bnds, gs, build.tile_rows())
    lab, want_lab = got[0].cpu(), want[0].cpu()
    assert 0 <= int(lab.min()) and int(lab.max()) < k
    assert torch.equal(lab[far], want_lab[far])
    assert bool(torch.isinf(got[1][far]).all())
    if bf16:
        assert ref.tie_gap(lab[None], want_lab[None], x.float().cpu(),
                           c.float().cpu()[None])[1] <= ref.NEAR_TIE
    else:
        np.testing.assert_array_equal(lab.numpy(), want_lab.numpy())
    if kernel != "assignment":
        np.testing.assert_array_equal(got[3].cpu().numpy(),
                                      want[3].cpu().numpy())


# The bounded step on the tensor cores (csrc/sweep_tc.cuh's bounds_tc): bf16
# X and C with gs a multiple of 8, at every d; each warpgroup's 64 rows one
# tile of the skip test, 128-slot chunks listed where a tile computes a
# group.


def _bounds_tc_counts():
    return (F.bounds_launches, F.bounds_tc_launches,
            F.bounds_stream_launches, F.bounds_plain_calls)


def _bounds_tc_launch(x, c, w, bnds, gs):
    """One bounded launch that must take the tensor cores, its relaunch
    equal bit for bit; -> its outputs."""
    before = _bounds_tc_counts()
    got = F.fused_lloyd(x, c, w, bounds=bnds, gs=gs)
    assert [b - a for a, b in zip(before, _bounds_tc_counts())] \
        == [1, 1, 0, 0]
    _assert_equal(F.fused_lloyd(x, c, w, bounds=bnds, gs=gs), got)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("d", [69, 4096])
def test_bounds_tc_anchor_is_the_fused_step(cuda, d):
    """ub^2 = +inf and lb^2 = 0 on finite rows: every cell is computed and
    no seed wins, so labels, min distances, sums, counts and energy equal
    the bf16 fused step's bit for bit (one sweep, the same segment sum and
    energy), each row's least group minimum is its distance bit for bit,
    and nothing is skipped.  K = 1000, gs 64 (G = 16), N = 777, (N,)
    weights."""
    n, k, gs = 777, 1000, 64
    x, c, w = _mixture(cuda, n, d, k, None, False, "n", seed=d + 3)
    xb, cb = x.bfloat16(), c.bfloat16()
    g = -(-k // gs)
    lab0 = torch.from_numpy(np.random.default_rng(d).integers(
        0, k, n).astype(np.int32)).to(cuda)
    bnds = (lab0, torch.zeros((n, g), device=cuda),
            torch.full((n,), float("inf"), device=cuda))
    got = _bounds_tc_launch(xb, cb, w, bnds, gs)
    _assert_equal(got[:5], F.fused_lloyd(xb, cb, w))
    assert torch.equal(got[5].amin(dim=-1), got[1])
    assert float(got[6]) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["every cell", "second tile"])
@pytest.mark.parametrize("d", [69, 300, 4096])
def test_bounds_tc_skipped_cells_keep_the_seed(cuda, d, mode):
    """lb^2 above ub^2 in every cell ("every cell": each block's chunk list
    is empty, so no stage starts) or in every cell of the second 64-row
    tile of each 128-row block ("second tile": its warpgroup sweeps no
    chunk while the first sweeps them all).  Skipped rows keep (ub^2,
    lab0) bit for bit and their group minima are their lb^2; the rest as
    ``_assert_bounds_tc_contract`` holds them.  d = 300 streams X by plain
    loads (600-byte rows are not a TMA box), 4096 by TMA."""
    n, k, gs = 777, 300, 16
    x, c, _ = _mixture(cuda, n, d, k, None, False, None, seed=d + 17)
    xb, cb = x.bfloat16(), c.bfloat16()
    g = -(-k // gs)
    lab0 = torch.from_numpy(np.random.default_rng(d).integers(
        0, k, n).astype(np.int32))
    xd, cd = xb.double().cpu(), cb.double().cpu()
    ub_sq = ((xd - cd[lab0.long()]) ** 2).sum(-1).float()
    lb_sq = (2 * ub_sq + 1)[:, None].repeat(1, g)
    skipped = torch.ones(n, dtype=torch.bool)
    if mode == "second tile":
        first = (torch.arange(n) // 64) % 2 == 0
        lb_sq[first] = 0.0
        skipped = ~first
    bnds = tuple(t.to(cuda) for t in (lab0, lb_sq, ub_sq))
    got = _bounds_tc_launch(xb, cb, None, bnds, gs)
    lab, mind, gmin = (t.cpu() for t in (got[0], got[1], got[5]))
    assert torch.equal(lab[skipped], lab0[skipped])
    assert torch.equal(mind[skipped], ub_sq[skipped])
    assert torch.equal(gmin[skipped], lb_sq[skipped])
    _assert_bounds_tc_contract(xb, cb, None, bnds, got, F.fused_bounds_plain(
        xb, cb, None, *bnds, gs, build.tile_rows()))
    if mode == "every cell":
        assert float(got[6]) == 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("k,gs", [(300, 8), (300, 16), (1000, 64),
                                  (1001, 136), (93, 8)])
@pytest.mark.parametrize("d", [69, 300, 4096])
def test_bounds_tc_tiles_need_different_groups(cuda, d, k, gs):
    """Each 64-row tile computes its own random half of the groups
    (``_tile_bounds``), so a block's two warpgroups sweep different chunks
    of its list, at N = 777 (the last block one ragged tile).  gs 8 and 16:
    several groups a chunk; gs 64; gs 136 at K = 1001 (K % 128 and K % 8
    not 0, the last group partial): groups that cross chunks; K = 93: one
    ragged chunk.  Against the plain version by
    ``_assert_bounds_tc_contract``, a relaunch equal bit for bit."""
    x, c, _ = _mixture(cuda, 777, d, k, None, False, None, seed=d + k + gs)
    xb, cb = x.bfloat16(), c.bfloat16()
    lab0, lb_sq, ub_sq = _tile_bounds(xb.float(), cb.float(), gs, seed=k + gs)
    need = ref.computed_cells(lb_sq, ub_sq, 64)[::64]
    assert not torch.equal(need[0], need[1])
    bnds = tuple(t.to(cuda) for t in (lab0, lb_sq, ub_sq))
    got = _bounds_tc_launch(xb, cb, None, bnds, gs)
    _assert_bounds_tc_contract(xb, cb, None, bnds, got, F.fused_bounds_plain(
        xb, cb, None, *bnds, gs, build.tile_rows()))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [69, 4096])
def test_bounds_tc_per_problem_x(cuda, d):
    """R = 3 with per-problem X (R, N, d), (R, N) weights that zero a
    third of the rows and each problem's own tile bounds: the contract
    against the plain version, and each problem's labels, distances and
    group minima equal bit for bit a launch of that problem alone."""
    n, k, gs, r = 515, 256, 16, 3
    x, c, w = _mixture(cuda, n, d, k, r, True, "rn", seed=d + 29)
    xb, cb = x.bfloat16(), c.bfloat16()
    parts = [_tile_bounds(xb[i].float(), cb[i].float(), gs, seed=i)
             for i in range(r)]
    bnds = tuple(torch.stack(t).to(cuda) for t in zip(*parts))
    got = _bounds_tc_launch(xb, cb, w, bnds, gs)
    _assert_bounds_tc_contract(xb, cb, w, bnds, got, F.fused_bounds_plain(
        xb, cb, w, *bnds, gs, build.tile_rows()))
    for i in range(r):
        alone = F.fused_lloyd(xb[i].contiguous(), cb[i], None,
                              bounds=tuple(t[i] for t in bnds), gs=gs)
        for j in (0, 1, 5):
            assert torch.equal(alone[j], got[j][i])


# The bf16 segment sum (csrc/segment_sum_bf16.cuh) on its own kernel: (n,
# d, k, r, x per problem, weights, labels).  Labels "random" lie in [-1, K]
# (-1 and K land nowhere), "sorted" are random labels in [0, K) sorted, so
# runs cross 32-row groups, 128-row tiles and the slabs (300,000 rows at
# K = 1000 are 66 slabs of 36 tiles), "mixed" sorts labels in [-1, K] (the
# runs of -1 and of K among them), "one" gives every row one label.
SEGMENT_CASES = [
    (300_000, 69, 1000, None, False, None, "sorted"),
    (20_000, 69, 1000, None, False, "n", "random"),
    (5_000, 69, 1, None, False, "n", "random"),
    (20_000, 33, 50, None, False, None, "one"),
    (10_000, 69, 40, None, False, "n", "mixed"),
    (4_000, 69, 20_000, None, False, None, "random"),
    (7_000, 1, 37, None, False, "n", "random"),
    (7_000, 1, 37, None, False, None, "sorted"),
    (3_000, 821, 300, None, False, None, "sorted"),
    (3_000, 821, 300, None, False, "n", "random"),
    (2_000, 4096, 256, None, False, "n", "random"),
    (2_000, 4096, 256, None, False, None, "sorted"),
    (2_001, 69, 45, 3, True, "n", "random"),
    (2_001, 69, 45, 3, True, None, "sorted"),
    (3_001, 20, 130, 3, False, None, "sorted"),
    (3_001, 20, 130, 3, False, "n", "mixed"),
]


def _segment_labels(device, n, k, r, kind, seed):
    rng = np.random.default_rng(seed)
    shape = (r, n) if r else (n,)
    if kind == "one":
        labels = np.full(shape, k // 2)
    else:
        lo, hi = (0, k) if kind == "sorted" else (-1, k + 1)
        labels = rng.integers(lo, hi, shape)
        if kind in ("sorted", "mixed"):
            labels = np.sort(labels, axis=-1)
    return torch.from_numpy(labels.astype(np.int32)).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,k,r,x_batched,weights,kind", SEGMENT_CASES)
def test_bf16_segment_sum(cuda, n, d, k, r, x_batched, weights, kind):
    """The bf16 update runs its own kernel (bf16_launches moves): bit for
    bit the f32 launch on the upcast X, within the gates of the plain
    version, a relaunch equal; on shared X also from a view whose first
    row is not 16-byte aligned."""
    x, _, w = _inputs(cuda, n, d, 1, r, x_batched, weights, seed=n + d)
    if w is not None and w.dim() == 2:
        w = w[0].contiguous()                  # the update takes (N,)
    labels = _segment_labels(cuda, n, k, r, kind, seed=k + d)
    xb = x.bfloat16()
    launched = U.launches, U.bf16_launches
    got = U.update(xb, labels, k, w)
    assert (U.launches, U.bf16_launches) == (launched[0] + 1,
                                             launched[1] + 1)
    lay = U.layout(U._bind(build.load("update")), n, r or 1, k, d,
                   torch.bfloat16)
    assert lay == U.layout(U._bind(build.load("update")), n, r or 1, k, d,
                           torch.bfloat16)
    _assert_equal(got, U.update(xb.float(), labels, k, w))
    _assert_equal(got, U.update(xb, labels, k, w))
    want = U.update_plain(xb, labels, k, w)
    np.testing.assert_allclose(got[0].cpu(), want[0].cpu(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got[1].cpu(), want[1].cpu(), rtol=1e-5,
                               atol=1e-5)
    if xb.dim() == 2:
        view_w = None if w is None else w[1:]
        view_l = labels[..., 1:].contiguous()
        _assert_equal(U.update(xb[1:], view_l, k, view_w),
                      U.update(xb[1:].float(), view_l, k, view_w))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [69, 1024])
@pytest.mark.parametrize("weights", [None, "n"])
def test_bf16_steps_stats_on_sorted_rows(cuda, d, weights):
    """Rows sorted by their component (runs of one label across groups,
    tiles and slabs): the stats of the bf16 fused step (tensor cores), of
    the mixed fused step (bf16 X, f32 C) and of the bounded step from
    drifted bounds on bf16 X and C (tensor cores) and on bf16 X against
    f32 C (the FP32 route) equal, bit for bit, the bf16 update of each
    step's own labels."""
    n, k = 40_000, 64
    x, c, w = _mixture(cuda, n, d, k, None, False, weights, seed=d + 3)
    x = x[torch.argsort(torch.cdist(x, c).argmin(dim=1), stable=True)]
    xb = x.contiguous().bfloat16()
    c, gs, bnds = _drifted_bounds(xb.float(), c.bfloat16().float(), w, 8)
    cb = c.bfloat16()
    launched = U.bf16_launches, F.bounds_tc_launches

    def stats_equal(out):
        _assert_equal(out[2:4], U.update(xb, out[0], k, w))

    stats_equal(F.fused_lloyd(xb, cb, w))
    stats_equal(F.fused_lloyd(xb, c, w))
    stats_equal(F.fused_lloyd(xb, cb, w, bounds=bnds, gs=gs))
    stats_equal(F.fused_lloyd(xb, c, w, bounds=bnds, gs=gs))
    assert (U.bf16_launches, F.bounds_tc_launches) == (launched[0] + 4,
                                                       launched[1] + 1)
