"""Launch configuration and operand layout of the Hopper kernels.

The counterpart of ``repro.kernels.tiles``, without its TPU model (an
8 MB VMEM budget, 128-lane padding, ``round_up``/``pad_to``): the CUDA
kernels take any N, K and d and mask the ragged edges themselves, so no
operand is padded to a tile multiple.

The padding rules of the TPU wrappers hold inside the kernels instead —
a centroid past K never competes for the argmin (the TPU pads it with
|c|^2 = f32 max), and a row past N adds nothing to the stats (the TPU
gives it weight 0).

The tile geometry is the CUDA sources' alone (csrc/sweep_fp32.cuh): the
wrappers ask the built library for the rows per tile and pass them in
here.  The sweep takes any d: on bf16 X and C the assignment, the fused
step and the bounded step (with a group size that is a multiple of 8) run
the tensor-core sweep (csrc/sweep_tc.cuh) at every d; otherwise the FP32
sweep keeps the 64-row X tile in shared memory up to the widest d that
fits (the library's ``*_max_features``: 821 on an H100 for the
assignment) and streams X in feature slabs past it (``sweep_route``,
``bounds_route``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import torch

MAX_PROBLEMS = 65535     # the grid's y extent
UPDATE_BLOCKS = 132      # one update block on each of 132 SMs
UPDATE_PARTIAL_BYTES = 24 << 20   # the update's partials: half the 50 MB L2


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class UpdateLayout:
    """Launch layout of the segment sum: on a float32 X the update kernel
    (csrc/update.cu, whose segment sum csrc/segment_sum.cuh shares with
    the fused kernels; ``update_layout``), on a bfloat16 X its own kernel
    (csrc/segment_sum_bf16.cuh; ``update_bf16_layout``).

    Block (slab, range, group, r) owns the row tiles of one slab, the
    clusters [q * range_k, min((q + 1) * range_k, K)) of range q and the
    output columns [g * (d+1) // groups, (g+1) * (d+1) // groups) of group
    g (column d is the weight total).  Its (range_k, width | 1) partial
    lives in shared memory beside a ring of ``stages`` staged X tiles and
    their labels and weights; ``smem_bytes`` is that carve-up."""
    tile_rows: int
    stages: int
    groups: int
    width: int           # columns of the widest group
    warps: int           # warps per block; each owns columns of its group
    ranges: int
    range_k: int
    slabs: int
    tiles_per_slab: int
    smem_bytes: int


def update_staged_pitch(width: int) -> int:
    """Floats of one staged X row of a ``width``-column group: the 16-byte
    vectors that cover it from any alignment, plus 4 where that makes the
    pitch 4 mod 8 (csrc/segment_sum.cuh ``staged_pitch``)."""
    vec = cdiv(width + 3, 4)
    return 4 * vec + 4 * (vec % 2 == 0)


def update_smem_bytes(tile_rows: int, stages: int, width: int,
                      range_k: int) -> int:
    """Shared bytes of one update block: the (range_k, width | 1) partial,
    ``stages`` slots of a staged (tile_rows, update_staged_pitch(width))
    X tile, its labels and its weights, and three words per row of two
    tiles (the rows' peers); csrc/segment_sum.cuh ``update_smem``."""
    return 4 * (range_k * (width | 1)
                + stages * tile_rows * (update_staged_pitch(width) + 2)
                + 6 * tile_rows)


@functools.lru_cache(maxsize=256)
def update_layout(n: int, r: int, k: int, d: int, tile_rows: int,
                  stages: int, max_warps: int,
                  smem_budget: int) -> UpdateLayout:
    """The update kernel's layout for X (N, d) and K clusters over R label
    sets.  ``tile_rows``, ``stages``, ``max_warps`` and ``smem_budget``
    are the library's (``update_geometry``).

    Column groups are as wide as the budget allows with all K clusters in
    one block, balanced to within one column; where K is too large for a
    group of ``min(max_warps, d+1)`` columns (one per warp), blocks also
    split the clusters into ranges.  Slabs fill UPDATE_BLOCKS blocks, fewer
    when the (R, slabs, K, d+1) partials would pass UPDATE_PARTIAL_BYTES.
    Depends on the shapes only, so a relaunch is bitwise equal."""
    if min(n, r, k, d) < 1:
        raise ValueError(f"empty update: N={n} R={r} K={k} d={d}")
    cols = d + 1
    narrow = min(max_warps, cols)
    # widest group holding all K clusters
    widest = next((w for w in range(cols, 0, -1) if update_smem_bytes(
        tile_rows, stages, w, k) <= smem_budget), 0)
    if widest >= narrow:
        groups = cdiv(cols, min(widest, cols))
        width = cdiv(cols, groups)
        ranges, range_k = 1, k
    else:
        groups = cdiv(cols, narrow)
        width = cdiv(cols, groups)
        room = smem_budget - update_smem_bytes(tile_rows, stages, width, 0)
        ranges = cdiv(k, room // (4 * (width | 1)))
        range_k = cdiv(k, ranges)
    warps = min(max_warps, cols // groups)
    n_tiles = cdiv(n, tile_rows)
    cap = max(1, UPDATE_PARTIAL_BYTES // (r * k * cols * 4))
    want = cdiv(UPDATE_BLOCKS, groups * ranges * r)
    per = cdiv(n_tiles, min(n_tiles, cap, want))
    return UpdateLayout(tile_rows, stages, groups, width, warps, ranges,
                        range_k, cdiv(n_tiles, per), per,
                        update_smem_bytes(tile_rows, stages, width, range_k))


def update_bf16_staged_pitch(width: int) -> int:
    """Bytes of one staged bf16 X row of a ``width``-column group: the
    16-byte vectors that cover it from any alignment, an odd number of
    them (csrc/segment_sum_bf16.cuh ``staged_pitch``)."""
    vec = cdiv(width + 7, 8)
    return 16 * (vec + (vec % 2 == 0))


def update_bf16_smem_bytes(tile_rows: int, stages: int, width: int,
                           range_k: int) -> int:
    """Shared bytes of one bf16 segment-sum block: ``stages`` slots of a
    staged (tile_rows, update_bf16_staged_pitch(width)) X tile (and 48
    bytes a 32-row group, which shift its 8-row blocks apart in the banks)
    with its labels and weights, two tiles' ordered positions (three words
    a row) and longest runs (a word a 32-row group), and the (range_k,
    width | 1) f32 partial; csrc/segment_sum_bf16.cuh ``smem_bytes``."""
    groups = tile_rows // 32
    tile = tile_rows * update_bf16_staged_pitch(width) + 48 * groups
    return (stages * (tile + 8 * tile_rows) + 2 * tile_rows * 12
            + 2 * groups * 4 + 4 * range_k * (width | 1))


def _widest(cols: int, fits) -> int:
    """The largest w in [1, cols] with fits(w) (which holds up to some w and
    not past it), 0 when none."""
    lo, hi = 0, cols
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid - 1
    return lo


@functools.lru_cache(maxsize=256)
def update_bf16_layout(n: int, r: int, k: int, d: int, f32: UpdateLayout,
                       tile_rows: int, min_stages: int, max_stages: int,
                       max_warps: int, smem_budget: int,
                       column_width: int) -> UpdateLayout:
    """The bf16 segment sum's layout for X (N, d) bfloat16 and K clusters
    over R label sets, with the slabs of ``f32``, the float32 layout of the
    same shapes (``update_layout``): its bits are the float32 launch's, and
    the slabs fix them.  ``tile_rows`` (f32.tile_rows), ``min_stages``,
    ``max_stages``, ``max_warps``, ``smem_budget`` and ``column_width`` are
    the library's (``update_bf16_geometry``).

    Column groups hold all K clusters where a group of min(max_warps, d+1)
    columns does (else cluster ranges split K, as in the float32 layout),
    and are as many as the float32 slabs need to fill UPDATE_BLOCKS blocks
    in one wave (fewer where the shared memory needs more), balanced to
    within one column.  The ring then takes as many slots as fit, at most
    ``max_stages``.  Groups of ``column_width`` columns or more sum every
    tile by columns, one lane a column: their warps are those columns'
    (at least 8, for the copies); narrower groups run a warp a column, up
    to ``max_warps``.  Depends on the shapes only."""
    if f32.tile_rows != tile_rows:
        raise ValueError(f"the float32 layout's tiles are {f32.tile_rows} "
                         f"rows, the bf16 kernel's {tile_rows}")
    cols = d + 1
    narrow = min(max_warps, cols)

    def smem(width, range_k, stages=min_stages):
        return update_bf16_smem_bytes(tile_rows, stages, width, range_k)

    widest = _widest(cols, lambda w: smem(w, k) <= smem_budget)
    if widest >= narrow:
        wave = max(1, UPDATE_BLOCKS // (f32.slabs * r))
        groups = max(cdiv(cols, widest), min(wave, cols))
        width = cdiv(cols, groups)
        ranges, range_k = 1, k
    else:
        groups = cdiv(cols, narrow)
        width = cdiv(cols, groups)
        room = smem_budget - smem(width, 0)
        ranges = cdiv(k, room // (4 * (width | 1)))
        range_k = cdiv(k, ranges)
    per_stage = smem(width, 0, 1) - smem(width, 0, 0)
    stages = min(max_stages, min_stages
                 + (smem_budget - smem(width, range_k)) // per_stage)
    if width >= column_width:
        warps = min(max_warps, max(8, cdiv(width, 32)))
    else:
        warps = min(max_warps, width)
    return UpdateLayout(tile_rows, stages, groups, width, warps, ranges,
                        range_k, f32.slabs, f32.tiles_per_slab,
                        smem(width, range_k, stages))


def pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` grown to ``rows`` rows with copies of its last row — the
    fixed-shape chunk rule of predict (repro/core/api.py:85)."""
    m = x.shape[0]
    if m >= rows:
        return x
    return torch.cat([x, x[-1:].expand(rows - m, *x.shape[1:])])


# the operand types of X and C: csrc/nearest.cuh's type codes
OPERAND_TYPES = {torch.float32: 0, torch.bfloat16: 1}


def type_code(t: torch.Tensor) -> int:
    """X's or C's type code for a launcher (0 float32, 1 bfloat16)."""
    return OPERAND_TYPES[t.dtype]


def check_operand_types(*tensors: Optional[torch.Tensor]) -> None:
    """X, C and the row weights are each float32 or bfloat16; another
    dtype raises TypeError."""
    for t in tensors:
        if t is not None and t.dtype not in OPERAND_TYPES:
            raise TypeError(f"the kernels take float32 or bfloat16 "
                            f"operands; got {t.dtype}")


def kernel_weights(w: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Row weights as the kernels read them: float32 (a bf16 weight
    converts exactly, as repro/kernels/update.py:123 casts it)."""
    return None if w is None else w.to(torch.float32)


def problem_shape(x: torch.Tensor, c: torch.Tensor,
                  w: Optional[torch.Tensor] = None):
    """Validate the kernels' operand shapes; -> (batched, R, N, K, d).

    x (N, d) or (R, N, d); c (K, d) or (R, K, d); w None, (N,) or (R, N).
    X and C are each float32 or bfloat16 (a bf16 X against f32 centroids
    is what a bf16-policy model's predict sees), w float32 or bfloat16
    (``kernel_weights``).  A per-problem x or w needs a per-problem c, as
    in the TPU wrappers."""
    check_operand_types(x, c, w)
    if c.dim() not in (2, 3) or x.dim() not in (2, 3):
        raise ValueError(f"x must be (N, d) or (R, N, d) and c (K, d) or "
                         f"(R, K, d); got {tuple(x.shape)}, {tuple(c.shape)}")
    batched = c.dim() == 3
    r = c.shape[0] if batched else 1
    k, d = c.shape[-2], c.shape[-1]
    n = x.shape[-2]
    if x.dim() == 3 and not batched:
        raise ValueError(
            f"per-problem x {tuple(x.shape)} needs a per-problem c (R, K, d);"
            f" got {tuple(c.shape)}")
    if x.shape[-1] != d or (x.dim() == 3 and x.shape[0] != r):
        raise ValueError(f"x {tuple(x.shape)} does not match c "
                         f"{tuple(c.shape)}")
    if w is not None:
        if w.dim() == 2 and not batched:
            raise ValueError(f"per-problem w {tuple(w.shape)} needs a "
                             f"per-problem c (R, K, d); got {tuple(c.shape)}")
        if w.shape not in ((n,), (r, n)):
            raise ValueError(f"w must be (N,) or (R, N) = ({r}, {n}); got "
                             f"{tuple(w.shape)}")
    return batched, r, n, k, d


def check_cuda_operands(*tensors: Optional[torch.Tensor]) -> None:
    """What a kernel takes beyond ``problem_shape``: contiguous tensors on
    one CUDA device and no empty axis.  Any d: the kernels stream rows
    wider than their shared-memory tile."""
    present = [t for t in tensors if t is not None]
    dev = present[0].device
    for t in present:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"kernel operands must share one CUDA device; "
                             f"got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
        if t.numel() == 0:
            raise ValueError(f"empty operand of shape {tuple(t.shape)}")


# the sweep routes of an assignment, fused-step or bounded-step launch
TENSOR_CORES = "tensor_cores"   # csrc/sweep_tc.cuh: X and C both bf16
RESIDENT = "resident"           # the X tile resident (csrc/sweep_fp32.cuh,
#                                 fused_bounds.cu's bounds_tiles)
STREAMED = "streamed"           # X streamed in slabs (csrc/sweep_wide.cuh,
#                                 sweep_bounded.cuh)


def _fp32_route(d: int, widest: int, force_stream: bool) -> str:
    """The FP32 sweep's route: streamed when forced or past ``widest``,
    the resident tile's widest d (negative when it could not be queried:
    RuntimeError), resident else."""
    if widest < 0:
        raise RuntimeError("could not query the card's shared memory")
    return STREAMED if force_stream or d > widest else RESIDENT


def sweep_route(x_dtype: torch.dtype, c_dtype: torch.dtype, d: int,
                widest: int, force_stream: bool) -> str:
    """The sweep an assignment or fused-step launch takes, the launcher's
    own rule (csrc/sweep_wide.cuh ``launch_assign``): X and C both
    bfloat16 take the tensor-core sweep at any d, and it has no streamed
    path to force (ValueError); otherwise the FP32 sweep streams X when
    forced or past ``widest``, the resident tile's widest d (the
    library's ``*_max_features``; negative when it could not be
    queried: RuntimeError), and keeps the tile resident else."""
    if x_dtype == torch.bfloat16 and c_dtype == torch.bfloat16:
        if force_stream:
            raise ValueError("bf16 X and C take the tensor-core sweep, which "
                             "has no streamed FP32 path to force")
        return TENSOR_CORES
    return _fp32_route(d, widest, force_stream)


def bounds_route(x_dtype: torch.dtype, c_dtype: torch.dtype, d: int,
                 gs: int, widest: int, force_stream: bool) -> str:
    """The sweep a bounded-step launch takes, the launcher's own rule
    (csrc/fused_bounds.cu ``fused_bounds_launch``): X and C both bfloat16
    with ``gs`` a multiple of 8 (as the engines round it) take the
    tensor-core sweep at any d, with no streamed path to force
    (ValueError); every other pair, and any other gs, takes the FP32
    bounded sweep as ``sweep_route`` does, with ``widest`` the resident
    tile's widest d for the launch's G groups (the library's
    ``fused_bounds_max_features``)."""
    if x_dtype == torch.bfloat16 and c_dtype == torch.bfloat16 \
            and gs % 8 == 0:
        if force_stream:
            raise ValueError("bf16 X and C take the tensor-core sweep, which "
                             "has no streamed FP32 path to force")
        return TENSOR_CORES
    return _fp32_route(d, widest, force_stream)
