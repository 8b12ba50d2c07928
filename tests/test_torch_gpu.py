"""The port's CUDA kernels on the card (marker ``gpu``; skips without a
CUDA device).  Imports nothing of the JAX package, so it runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each kernel is held to its plain PyTorch version on the same inputs:
labels exact, min_sqdist within 1e-5 (f32 cross terms summed in another
order than cuBLAS), sums within 1e-4 and counts within 1e-5 (reduction
order), energy within 1e-6 relative.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import AAKMeans
from repro_torch.data.synthetic import make_blobs
from repro_torch.kernels import assignment as A
from repro_torch.kernels import fused_lloyd as F

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
