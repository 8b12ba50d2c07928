"""The port's kernels (repro_torch.kernels) against the JAX package's.

On the CPU each wrapper runs its plain PyTorch version; it is held to the
Pallas kernel run in interpret mode on the same numpy inputs, with the
tolerances of tests/test_kernels_v2.py: labels exact, min_sqdist within
2e-5 (f32 cancellation in |x|^2 - 2x.c + |c|^2), sums and energy within
1e-4 (reduction order), counts within 1e-6 (integers when unweighted;
1e-5 with real-valued weights, as tests/test_kernels_v2.py:79).  The
CUDA kernels themselves are tested on the card by tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.assignment import assignment_pallas
from repro.kernels.fused_lloyd import fused_lloyd_pallas
from repro_torch.kernels import assignment as A
from repro_torch.kernels import fused_lloyd as F
from repro_torch.kernels import tiles

torch.set_num_threads(2)

# (n, d, k): non-tile-multiple N, K and d; the JAX side runs 16 x 8 tiles
# so its grid has several row and centroid tiles
SHAPES = [(97, 5, 33), (130, 17, 9), (64, 3, 70)]
JAX_TILES = dict(tn=16, tk=8, interpret=True)


def _inputs(n, d, k, r=None, x_batched=False, weights=None, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(((r, n, d) if x_batched else (n, d)),
                            dtype=np.float32)
    c = rng.standard_normal(((r, k, d) if r else (k, d)), dtype=np.float32)
    w = None
    if weights == "n":
        w = rng.uniform(0.0, 2.0, n).astype(np.float32)
        w[n // 2:] = 0.0
    elif weights == "rn":
        w = rng.uniform(0.0, 2.0, (r, n)).astype(np.float32)
        w[:, : n // 3] = 0.0
    return x, c, w


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _assert_step_close(got, want, weighted):
    lab, mind, sums, counts, energy = [np.asarray(g) for g in got]
    wl, wm, ws, wc, we = [np.asarray(v) for v in want]
    np.testing.assert_array_equal(lab, wl)
    np.testing.assert_allclose(mind, wm, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(sums, ws, rtol=1e-4, atol=1e-4)
    ctol = 1e-5 if weighted else 1e-6
    np.testing.assert_allclose(counts, wc, rtol=ctol if weighted else 0,
                               atol=ctol)
    np.testing.assert_allclose(energy, we, rtol=1e-4)


@pytest.mark.parametrize("weights", [None, "n"])
@pytest.mark.parametrize("n,d,k", SHAPES)
def test_fused_matches_jax_kernel(n, d, k, weights):
    x, c, w = _inputs(n, d, k, weights=weights)
    got = F.fused_lloyd(_t(x), _t(c), _t(w))
    want = fused_lloyd_pallas(_j(x), _j(c), _j(w), **JAX_TILES)
    _assert_step_close(got, want, w is not None)
    assert got[0].dtype == torch.int32 and got[2].shape == (k, d)


@pytest.mark.parametrize("weights", [None, "rn"])
@pytest.mark.parametrize("x_batched", [False, True])
def test_fused_batched_matches_jax_kernel(x_batched, weights):
    x, c, w = _inputs(97, 5, 33, r=3, x_batched=x_batched, weights=weights,
                      seed=3)
    got = F.fused_lloyd(_t(x), _t(c), _t(w))
    want = fused_lloyd_pallas(_j(x), _j(c), _j(w), **JAX_TILES)
    assert got[0].shape == (3, 97) and got[2].shape == (3, 33, 5)
    _assert_step_close(got, want, w is not None)


@pytest.mark.parametrize("n,d,k", SHAPES)
def test_assignment_matches_jax_kernel(n, d, k):
    x, c, _ = _inputs(n, d, k, seed=5)
    lab, mind = A.assignment(_t(x), _t(c))
    wl, wm = assignment_pallas(_j(x), _j(c), **JAX_TILES)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(wl))
    np.testing.assert_allclose(mind.numpy(), np.asarray(wm), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("x_batched", [False, True])
def test_assignment_batched_matches_jax_kernel(x_batched):
    x, c, _ = _inputs(130, 17, 9, r=2, x_batched=x_batched, seed=6)
    lab, mind = A.assignment(_t(x), _t(c))
    wl, wm = assignment_pallas(_j(x), _j(c), **JAX_TILES)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(wl))
    np.testing.assert_allclose(mind.numpy(), np.asarray(wm), rtol=2e-5,
                               atol=2e-5)


def test_ties_go_to_the_lowest_index():
    # duplicate centroids: every row ties between k and k + 3
    x, c, _ = _inputs(50, 4, 3, seed=8)
    c2 = np.concatenate([c, c])
    lab, _ = A.assignment(_t(x), _t(c2))
    flab = F.fused_lloyd(_t(x), _t(c2))[0]
    wl, _ = assignment_pallas(_j(x), _j(c2), **JAX_TILES)
    assert int(lab.max()) < 3
    np.testing.assert_array_equal(lab.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(flab.numpy(), np.asarray(wl))


def test_cpu_tensors_take_the_plain_version():
    x, c, w = _inputs(40, 3, 5, weights="n")
    before = (F.launches, F.plain_calls, A.launches, A.plain_calls)
    F.fused_lloyd(_t(x), _t(c), _t(w))
    A.assignment(_t(x), _t(c))
    assert (F.launches, F.plain_calls, A.launches, A.plain_calls) == \
        (before[0], before[1] + 1, before[2], before[3] + 1)


@pytest.mark.parametrize("case,exc", [
    ("per-problem x, unbatched c", ValueError),
    ("per-problem w, unbatched c", ValueError),
    ("w of the wrong length", ValueError),
    ("d mismatch", ValueError),
    ("bf16 x", TypeError),
])
def test_operand_checks(case, exc):
    x = torch.zeros(3, 10, 4)
    c = torch.zeros(5, 4)
    w = torch.ones(10)
    args = {
        "per-problem x, unbatched c": (x, c, None),
        "per-problem w, unbatched c": (x[0], c, torch.ones(3, 10)),
        "w of the wrong length": (x[0], c, torch.ones(9)),
        "d mismatch": (x[0], torch.zeros(5, 3), w),
        "bf16 x": (x[0].bfloat16(), c, w),
    }[case]
    with pytest.raises(exc):
        F.fused_lloyd(*args)
    if args[2] is None or case in ("d mismatch", "bf16 x"):
        with pytest.raises(exc):
            A.assignment(*args[:2])


@pytest.mark.parametrize("n,r,k,d", [(1, 1, 1, 1), (1000, 1, 37, 69),
                                     (2_458_285, 1, 1000, 69),
                                     (100_000, 3, 256, 69),
                                     (10_000_000, 8, 65536, 128)])
def test_slab_layout_covers_every_tile(n, r, k, d):
    tile_rows = 64                       # fused_lloyd_tile_rows() of the .cu
    n_slabs, per = tiles.slab_layout(n, r, k, d, tile_rows)
    n_tiles = tiles.cdiv(n, tile_rows)
    assert 1 <= n_slabs <= tiles.MAX_SLABS
    assert (n_slabs - 1) * per < n_tiles <= n_slabs * per
    assert n_slabs == 1 or \
        r * n_slabs * k * (d + 1) * 4 <= tiles.PARTIAL_BYTES


def test_pad_rows_repeats_the_last_row():
    x = torch.arange(12.0).reshape(4, 3)
    p = tiles.pad_rows(x, 7)
    assert p.shape == (7, 3)
    assert torch.equal(p[:4], x) and torch.equal(p[4:], x[3:].expand(3, 3))
    assert tiles.pad_rows(x, 4) is x
