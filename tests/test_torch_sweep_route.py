"""The sweep route of an assignment or fused-step launch
(``kernels/tiles.py::sweep_route``, the rule of ``csrc/sweep_wide.cuh``'s
``launch_assign``) and of a bounded-step launch (``tiles.bounds_route``,
the rule of ``csrc/fused_bounds.cu``'s ``fused_bounds_launch``), and the
near-tie rule both the card tests and ``chip_smoke.py`` hold labels to
(``kernels/ref.py::tie_gap``).  No JAX and no card: a few seconds.

    PYTHONPATH=src python -m pytest -q tests/test_torch_sweep_route.py
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref, tiles

F32, BF16 = torch.float32, torch.bfloat16
WIDEST = 821   # the FP32 sweep's widest resident d on an H100


@pytest.mark.parametrize("force", [False, True])
@pytest.mark.parametrize("d", [1, 69, 821, 822, 4096])
@pytest.mark.parametrize("x_dtype,c_dtype",
                         [(F32, F32), (BF16, BF16), (BF16, F32), (F32, BF16)])
def test_sweep_route(x_dtype, c_dtype, d, force):
    """bf16 X and C take the tensor cores at every d and refuse a forced
    stream; every other pair (mixed types compute in f32) takes the FP32
    sweep: streamed when forced or past the widest resident d."""
    if x_dtype == c_dtype == BF16:
        if force:
            with pytest.raises(ValueError):
                tiles.sweep_route(x_dtype, c_dtype, d, WIDEST, force)
            return
        want = tiles.TENSOR_CORES
    else:
        want = tiles.STREAMED if force or d > WIDEST else tiles.RESIDENT
    assert tiles.sweep_route(x_dtype, c_dtype, d, WIDEST, force) == want


def test_sweep_route_needs_the_widest_d_for_fp32_only():
    """A failed shared-memory query (widest < 0) stops an FP32 launch; the
    tensor-core route does not read it."""
    with pytest.raises(RuntimeError):
        tiles.sweep_route(F32, F32, 69, -1, False)
    with pytest.raises(RuntimeError):
        tiles.sweep_route(BF16, F32, 69, -1, False)
    assert tiles.sweep_route(BF16, BF16, 69, -1, False) == tiles.TENSOR_CORES


BOUNDED_WIDEST = 757   # the bounded resident tile's widest d at G = 19


@pytest.mark.parametrize("force", [False, True])
@pytest.mark.parametrize("gs", [8, 16, 24, 64])
@pytest.mark.parametrize("d", [69, 821, 822, 4096])
@pytest.mark.parametrize("x_dtype,c_dtype",
                         [(F32, F32), (BF16, BF16), (BF16, F32), (F32, BF16)])
def test_bounds_route(x_dtype, c_dtype, d, gs, force):
    """A bounded step with a group size that is a multiple of 8 (as the
    engines round it): bf16 X and C take the tensor cores at every d and
    refuse a forced stream; every other pair takes the FP32 bounded sweep,
    streamed when forced or past the resident tile's widest d."""
    if x_dtype == c_dtype == BF16:
        if force:
            with pytest.raises(ValueError):
                tiles.bounds_route(x_dtype, c_dtype, d, gs, BOUNDED_WIDEST,
                                   force)
            return
        want = tiles.TENSOR_CORES
    else:
        want = tiles.STREAMED if force or d > BOUNDED_WIDEST \
            else tiles.RESIDENT
    assert tiles.bounds_route(x_dtype, c_dtype, d, gs, BOUNDED_WIDEST,
                              force) == want


@pytest.mark.parametrize("force", [False, True])
@pytest.mark.parametrize("gs", [1, 5, 12, 53, 100])
@pytest.mark.parametrize("d", [69, 4096])
def test_bounds_route_fp32_for_other_group_sizes(d, gs, force):
    """A group size that is not a multiple of 8 (a raw kernel call; the
    engines never give one) keeps bf16 X and C on the FP32 bounded sweep,
    which converts them to f32 where it loads them, and a forced stream
    is taken."""
    want = tiles.STREAMED if force or d > BOUNDED_WIDEST else tiles.RESIDENT
    assert tiles.bounds_route(BF16, BF16, d, gs, BOUNDED_WIDEST,
                              force) == want


def test_bounds_route_needs_the_widest_d_for_fp32_only():
    """A failed shared-memory query (widest < 0) stops an FP32 bounded
    launch, a bf16 one with gs not a multiple of 8 included; the
    tensor-core route does not read it."""
    for x_dtype, c_dtype, gs in ((F32, F32, 16), (BF16, F32, 16),
                                 (BF16, BF16, 12)):
        with pytest.raises(RuntimeError):
            tiles.bounds_route(x_dtype, c_dtype, 69, gs, -1, False)
    assert tiles.bounds_route(BF16, BF16, 69, 16, -1, False) \
        == tiles.TENSOR_CORES


def _two_centroids(gap):
    """One row at 0 and two centroids at squared distances 1 and 1 + gap
    (d = 2), as x (1, 2), c (1, 2, 2)."""
    x = torch.zeros((1, 2), dtype=torch.float64)
    c = torch.tensor([[[1.0, 0.0], [0.0, math.sqrt(1.0 + gap)]]],
                     dtype=torch.float64)
    return x, c


@pytest.mark.parametrize("gap,near", [(0.0, True), (4e-6, True),
                                      (3e-5, False)])
def test_tie_gap_measures_a_label_flip(gap, near):
    """Labels 0 against 1 on a row whose two distances tie exactly, differ
    by 4e-6 relative (a near tie) or by 3e-5 (a real difference)."""
    x, c = _two_centroids(gap)
    lab = torch.tensor([[1]], dtype=torch.int32)
    lab_p = torch.tensor([[0]], dtype=torch.int32)
    agree, got = ref.tie_gap(lab, lab_p, x, c)
    assert agree == 0.0
    assert got == pytest.approx(gap, rel=1e-6, abs=1e-12)
    assert (got <= ref.NEAR_TIE) == near


def test_tie_gap_agreeing_labels_and_nan_rows():
    """Equal labels give (1, 0), NaN rows included; a NaN row whose labels
    differ has an infinite gap, so it never passes as a near tie."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((6, 3)))
    c = torch.from_numpy(rng.standard_normal((2, 4, 3)))
    x[2, 1] = float("nan")
    lab = torch.from_numpy(rng.integers(0, 4, (2, 6)).astype(np.int32))
    assert ref.tie_gap(lab, lab.clone(), x, c) == (1.0, 0.0)
    other = lab.clone()
    other[1, 2] = (other[1, 2] + 1) % 4
    agree, gap = ref.tie_gap(other, lab, x, c)
    assert agree == pytest.approx(11 / 12)
    assert gap == math.inf and not gap <= ref.NEAR_TIE
