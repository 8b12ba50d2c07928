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
    assert torch.equal(mind.cpu(), got[1])        # the same sweep code


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
    # and both kernels run the same sweep
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
