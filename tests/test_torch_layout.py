"""Launch layouts and the arithmetic the port's Hopper kernels rest on,
checked on the CPU (nothing here needs a card or the JAX package):

    PYTHONPATH=src python -m pytest -q tests/test_torch_layout.py

* ``tiles.update_layout`` — the update kernel's blocks cover every row
  tile, output column and cluster exactly once, fit the shared memory of a
  block (232,448 bytes on an H100), give every warp a column, and depend
  on the shapes alone.  The geometry is read from csrc/segment_sum.cuh
  (the update kernel's, which the fused kernels share), as the
  built library reports it.
* ``tiles.update_bf16_layout`` — the bf16 segment sum's blocks
  (csrc/segment_sum_bf16.cuh, geometry read from there) cover every row,
  output column and cluster once with the float32 layout's slabs (which
  fix its bits), fit a block's shared memory with as many ring slots as
  fit, depend on the shapes alone and fill one wave of 132 blocks at the
  main path's shapes; and the order it sums a group in (each label's rows
  as a run of positions, by columns or by rows) gives the float32
  kernel's bits, emulated here in float32.
* split TF32 — cross terms as three TF32 products,
  x_hi.c_hi + (x_hi.c_lo + x_lo.c_hi), with f32 sums.  Emulated here with
  round-to-nearest f32 sums on the USCensus1990 stand-in at K = 200, the
  min distance stays within 2x the error of the plain f32 product against
  f64 (both scaled by max(|x|^2, 1)) and picks the same labels, while one
  TF32 product alone does not.  This is the arithmetic a tensor-core
  distance sweep rests on.  (On the card the MMA's own accumulation
  truncates, which the emulation does not model; that is why the
  assignment kernel runs FP32 FMA chains, csrc/sweep_fp32.cuh.)
"""

import numpy as np
import pytest
import torch

from repro_torch.data.synthetic import make_dataset
from repro_torch.kernels import build, tiles

torch.set_num_threads(2)

SMEM_PER_BLOCK = 232448          # H100: the most shared memory of a block


def _geometry():
    """(tile_rows, stages, max_warps, smem_budget) of
    csrc/segment_sum.cuh."""
    return tuple(build.constant("segment_sum.cuh", name) for name in (
        "kUpdateRows", "kUpdateStages", "kUpdateWarps", "kUpdateSmem"))


# (N, K, d, R): the main path's shape, predict's chunk, K = 1 and
# K = 20,000 (cluster ranges), d = 1 and d = 818, ragged N, R > 1
SHAPES = [(2458285, 1000, 69, 1), (16384, 1000, 69, 1), (1000, 1, 69, 1),
          (4000, 20000, 69, 1), (777, 5, 1, 1), (300, 3, 818, 1),
          (16384, 1000, 818, 1), (3001, 130, 20, 3), (5000, 7000, 5, 2),
          (65, 20000, 818, 2), (1, 1, 1, 1), (4097, 1000, 9, 1)]


# what block (slab, range q, group g) owns, as csrc/segment_sum.cuh
# computes it
def _rows(lay, n, slab):
    per = lay.tiles_per_slab * lay.tile_rows
    return min(slab * per, n), min((slab + 1) * per, n)


def _columns(lay, d, g):
    return g * (d + 1) // lay.groups, (g + 1) * (d + 1) // lay.groups


def _clusters(lay, k, q):
    return q * lay.range_k, min((q + 1) * lay.range_k, k)


@pytest.mark.parametrize("n,k,d,r", SHAPES)
def test_update_layout_covers_everything_once(n, k, d, r):
    tile_rows, stages, max_warps, budget = _geometry()
    lay = tiles.update_layout(n, r, k, d, tile_rows, stages, max_warps,
                              budget)
    # rows: the slabs tile [0, N) in order, no slab empty
    row_cover = np.zeros(n, np.int64)
    for slab in range(lay.slabs):
        r0, r1 = _rows(lay, n, slab)
        assert r1 > r0 and r0 % tile_rows == 0
        row_cover[r0:r1] += 1
    assert (row_cover == 1).all()
    assert lay.slabs * lay.tiles_per_slab * tile_rows >= n
    # columns (d + 1, the last one the weight total) and clusters
    col_cover = np.zeros(d + 1, np.int64)
    for g in range(lay.groups):
        c0, c1 = _columns(lay, d, g)
        assert lay.warps <= c1 - c0 <= lay.width     # every warp has a column
        col_cover[c0:c1] += 1
    assert (col_cover == 1).all()
    k_cover = np.zeros(k, np.int64)
    for q in range(lay.ranges):
        k0, k1 = _clusters(lay, k, q)
        assert 0 < k1 - k0 <= lay.range_k
        k_cover[k0:k1] += 1
    assert (k_cover == 1).all()
    assert 1 <= lay.warps <= max_warps


@pytest.mark.parametrize("n,k,d,r", SHAPES)
def test_update_layout_fits_shared_memory(n, k, d, r):
    tile_rows, stages, max_warps, budget = _geometry()
    assert budget <= SMEM_PER_BLOCK
    lay = tiles.update_layout(n, r, k, d, tile_rows, stages, max_warps,
                              budget)
    assert lay.smem_bytes == tiles.update_smem_bytes(
        tile_rows, stages, lay.width, lay.range_k)
    assert lay.smem_bytes <= budget <= SMEM_PER_BLOCK
    # partials in device memory stay within their L2 share where more than
    # one slab is used
    if lay.slabs > 1:
        assert r * lay.slabs * k * (d + 1) * 4 <= tiles.UPDATE_PARTIAL_BYTES
    # cluster ranges only where all K clusters do not fit one narrow group
    if lay.ranges > 1:
        narrow = min(max_warps, d + 1)
        assert tiles.update_smem_bytes(tile_rows, stages, narrow, k) > budget


@pytest.mark.parametrize("n,k,d,r", SHAPES)
def test_update_layout_depends_on_shapes_only(n, k, d, r):
    geom = _geometry()
    assert tiles.update_layout(n, r, k, d, *geom) == \
        tiles.update_layout(n, r, k, d, *geom)


def test_update_layout_at_the_main_shape():
    """USCensus1990, K = 1000: two groups of 35 columns, all clusters in one
    block, one block on each of the 132 SMs, partials inside the L2."""
    lay = tiles.update_layout(2458285, 1, 1000, 69, *_geometry())
    assert (lay.groups, lay.width, lay.ranges) == (2, 35, 1)
    assert lay.slabs * lay.groups == tiles.UPDATE_BLOCKS
    assert lay.slabs * 1000 * 70 * 4 <= tiles.UPDATE_PARTIAL_BYTES


def test_update_layout_rejects_empty_shapes():
    with pytest.raises(ValueError):
        tiles.update_layout(0, 1, 10, 4, *_geometry())


def _geometry16():
    """(tile_rows, min_stages, max_stages, max_warps, smem_budget,
    column_width) of csrc/segment_sum_bf16.cuh."""
    return tuple(build.constant("segment_sum_bf16.cuh", name) for name in (
        "kRows", "kMinStages", "kMaxStages", "kWarps", "kSmem",
        "kColumnWidth"))


def _layouts(n, k, d, r):
    f32 = tiles.update_layout(n, r, k, d, *_geometry())
    return f32, tiles.update_bf16_layout(n, r, k, d, f32, *_geometry16())


# SHAPES, the Llama embedding table's (128,256 x 4096) at K = 256 and 1000,
# its four 1024-wide subspaces, and few rows at d = 4096
BF16_SHAPES = SHAPES + [(128256, 256, 4096, 1), (128256, 1000, 4096, 1),
                        (128256, 256, 1024, 4), (2000, 256, 4096, 1),
                        (300, 1, 4096, 1), (40000, 64, 1024, 1)]


@pytest.mark.parametrize("n,k,d,r", BF16_SHAPES)
def test_bf16_layout_covers_everything_once(n, k, d, r):
    f32, lay = _layouts(n, k, d, r)
    tile_rows, _, _, max_warps, _, column_width = _geometry16()
    # the slabs are the float32 layout's: the order of additions is its
    assert (lay.tile_rows, lay.slabs, lay.tiles_per_slab) == \
        (f32.tile_rows, f32.slabs, f32.tiles_per_slab) and \
        tile_rows == f32.tile_rows
    row_cover = np.zeros(n, np.int64)
    for slab in range(lay.slabs):
        r0, r1 = _rows(lay, n, slab)
        assert (r0, r1) == _rows(f32, n, slab) and r1 > r0
        row_cover[r0:r1] += 1
    assert (row_cover == 1).all()
    col_cover = np.zeros(d + 1, np.int64)
    for g in range(lay.groups):
        c0, c1 = _columns(lay, d, g)
        assert 0 < c1 - c0 <= lay.width
        col_cover[c0:c1] += 1
    assert (col_cover == 1).all()
    k_cover = np.zeros(k, np.int64)
    for q in range(lay.ranges):
        k0, k1 = _clusters(lay, k, q)
        assert 0 < k1 - k0 <= lay.range_k
        k_cover[k0:k1] += 1
    assert (k_cover == 1).all()
    # by columns every column has a lane of the block's warps; by rows
    # (narrower groups) each warp a column at most
    assert tiles.cdiv(lay.width, 32) <= lay.warps <= max_warps
    if lay.width < column_width:
        assert lay.warps <= lay.width


@pytest.mark.parametrize("n,k,d,r", BF16_SHAPES)
def test_bf16_layout_fits_shared_memory(n, k, d, r):
    _, lay = _layouts(n, k, d, r)
    tile_rows, min_stages, max_stages, max_warps, budget, _ = _geometry16()
    assert budget <= SMEM_PER_BLOCK
    assert lay.smem_bytes == tiles.update_bf16_smem_bytes(
        tile_rows, lay.stages, lay.width, lay.range_k) <= budget
    # as many ring slots as fit
    assert min_stages <= lay.stages <= max_stages
    assert lay.stages == max_stages or tiles.update_bf16_smem_bytes(
        tile_rows, lay.stages + 1, lay.width, lay.range_k) > budget
    # a staged row: an odd number of 16-byte vectors covering the group's
    # columns from any alignment, its byte offsets in a position's 20 bits
    pitch = tiles.update_bf16_staged_pitch(lay.width)
    assert pitch % 32 == 16 and pitch >= 2 * (lay.width + 7)
    assert tile_rows * pitch + 48 * tile_rows // 32 < 1 << 20
    # cluster ranges only where all K clusters do not fit a narrow group
    if lay.ranges > 1:
        assert tiles.update_bf16_smem_bytes(
            tile_rows, min_stages, min(max_warps, d + 1), k) > budget


@pytest.mark.parametrize("n,k,d,r", BF16_SHAPES)
def test_bf16_layout_depends_on_shapes_only(n, k, d, r):
    f32, lay = _layouts(n, k, d, r)
    assert lay == tiles.update_bf16_layout.__wrapped__(
        n, r, k, d, f32, *_geometry16())


@pytest.mark.parametrize("n,k,d,r,groups", [
    (2458285, 1000, 69, 1, 2), (128256, 256, 4096, 1, 44),
    (128256, 256, 1024, 4, 11)])
def test_bf16_layout_fills_one_wave(n, k, d, r, groups):
    """USCensus1990 at K = 1000, the Llama table at K = 256 and its four
    subspaces: the float32 slabs times the bf16 column groups make the
    132 blocks of one wave (the float32 layout runs 153 on the table)."""
    _, lay = _layouts(n, k, d, r)
    assert lay.groups == groups and lay.ranges == 1
    assert lay.slabs * lay.groups * r == tiles.UPDATE_BLOCKS


def _f32_order(v, labels, k):
    """One column's slab partial as update_slabs forms it, in float32: for
    each 32-row group, each label's leader (its first row) adds its peers
    in row order, then adds the sum into the partial."""
    part = np.zeros(k, np.float32)
    for g0 in range(0, len(labels), 32):
        lab, vv = labels[g0:g0 + 32], v[g0:g0 + 32]
        for i, li in enumerate(lab):
            if not 0 <= li < k or li in lab[:i]:
                continue
            s = vv[i]
            for q in range(i + 1, len(lab)):
                if lab[q] == li:
                    s = np.float32(s + vv[q])
            part[li] = np.float32(part[li] + s)
    return part


def _positions(lab, k):
    """A 32-row group's positions as the kernel's ``order`` makes them:
    the rows of a label as a run, the runs in order of their first rows
    (__match_any_sync, then a scan over the leaders); rows outside [0, K)
    share one run.  -> [(row, opens, closes, valid)] by position."""
    key = [li if 0 <= li < k else -1 for li in lab]
    peers = [[q for q in range(len(key)) if key[q] == key[i]]
             for i in range(len(key))]
    rank = [peers[i].index(i) for i in range(len(key))]
    opened = [len(peers[i]) if rank[i] == 0 else 0 for i in range(len(key))]
    upto = np.cumsum(opened)
    out = [None] * len(key)
    for i in range(len(key)):
        leader = peers[i][0]
        pos = int(upto[leader] - opened[leader]) + rank[i]
        out[pos] = (i, rank[i] == 0, rank[i] == len(peers[i]) - 1,
                    key[i] >= 0)
    return out


def _by_columns(v, labels, k):
    """A lane's walk over each group's positions: a run in a register, its
    total added into the partial where the run closes."""
    part = np.zeros(k, np.float32)
    for g0 in range(0, len(labels), 32):
        run = np.float32(0)
        for i, opens, closes, valid in _positions(labels[g0:g0 + 32], k):
            run = v[g0 + i] if opens else np.float32(run + v[g0 + i])
            if closes and valid:
                li = labels[g0 + i]
                part[li] = np.float32(part[li] + run)
    return part


def _by_rows(v, labels, k):
    """Each run's opening lane adds the run's later values shuffled down
    from the lanes that follow it, then updates the partial."""
    part = np.zeros(k, np.float32)
    for g0 in range(0, len(labels), 32):
        pos = _positions(labels[g0:g0 + 32], k)
        for p, (i, opens, _, valid) in enumerate(pos):
            if not (opens and valid):
                continue
            s = v[g0 + i]
            e = 1
            while p + e < len(pos) and not pos[p + e][1]:
                s = np.float32(s + v[g0 + pos[p + e][0]])
                e += 1
            li = labels[g0 + i]
            part[li] = np.float32(part[li] + s)
    return part


@pytest.mark.parametrize("kind", ["random", "few", "sorted", "one",
                                  "mixed", "ragged"])
def test_bf16_order_is_the_f32_order(kind):
    """Values spread over six decades, so the float32 sums depend on their
    order: both ways of summing by positions give update_slabs' partial
    bit for bit, labels outside [0, K) landing nowhere."""
    rng = np.random.default_rng(7)
    n, k = 32 * 12 + (5 if kind == "ragged" else 0), 9
    v = (rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 3, n)).astype(
        np.float32)
    if kind == "one":
        labels = np.full(n, 4)
    elif kind == "few":
        labels = rng.integers(0, 3, n)
    else:
        labels = rng.integers(-1, k + 1, n)
        if kind in ("sorted", "mixed"):
            labels = np.sort(np.clip(labels, 0, k - 1) if kind == "sorted"
                             else labels)
    want = _f32_order(v, labels, k)
    assert np.array_equal(_by_columns(v, labels, k), want)
    assert np.array_equal(_by_rows(v, labels, k), want)
    # the order matters at these values: a plain sum in row order differs
    plain = np.zeros(k, np.float32)
    for li, vi in zip(labels, v):
        if 0 <= li < k:
            plain[li] = np.float32(plain[li] + vi)
    assert kind == "one" or not np.array_equal(plain, want)


def _tf32(v: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _min_dist(x, c, cross):
    xsq = torch.sum(x * x, dim=1, keepdim=True)
    csq = torch.sum(c * c, dim=1)
    return torch.clamp_min(xsq - 2.0 * cross + csq[None], 0.0).min(dim=1)


@pytest.fixture(scope="module")
def census_k200():
    """USCensus1990 at scale 0.005 (12,291 x 69) and K = 200 centroids
    after five Lloyd steps from evenly spaced rows, in f64."""
    x = torch.from_numpy(make_dataset("USCensus1990", scale=0.005))
    x64 = x.double()
    c64 = x64[torch.linspace(0, x.shape[0] - 1, 200).long()]
    for _ in range(5):
        lab = torch.cdist(x64, c64).argmin(dim=1)
        s = torch.zeros_like(c64).index_add_(0, lab, x64)
        cnt = torch.bincount(lab, minlength=200).double()
        c64 = torch.where(cnt[:, None] > 0, s / cnt.clamp_min(1)[:, None],
                          c64)
    c = c64.float()
    c64 = c.double()
    d64 = torch.clamp_min(torch.sum(x64 * x64, 1, keepdim=True)
                          - 2.0 * x64 @ c64.T + torch.sum(c64 * c64, 1), 0)
    m64, l64 = d64.min(dim=1)
    scale = torch.sum(x64 * x64, dim=1).clamp_min(1.0)
    return x, c, m64, l64, scale


def test_tf32_rounding_is_round_to_nearest_away():
    v = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -12, -(1.0 + 2 ** -11),
                      1.0 + 3 * 2 ** -11, 3.0], dtype=torch.float32)
    want = torch.tensor([1.0 + 2 ** -10, 1.0, -(1.0 + 2 ** -10),
                         1.0 + 2 ** -9, 3.0], dtype=torch.float32)
    assert torch.equal(_tf32(v), want)


def test_split_tf32_holds_f32_accuracy(census_k200):
    x, c, m64, l64, scale = census_k200
    xh, ch = _tf32(x), _tf32(c)
    xl, cl = _tf32(x - xh), _tf32(c - ch)
    split = xh @ ch.T + (xh @ cl.T + xl @ ch.T)
    m_split, l_split = _min_dist(x, c, split)
    m_f32, l_f32 = _min_dist(x, c, x @ c.T)
    err_split = float(((m_split.double() - m64).abs() / scale).max())
    err_f32 = float(((m_f32.double() - m64).abs() / scale).max())
    assert err_f32 > 0.0
    assert err_split <= 2.0 * err_f32
    assert torch.equal(l_split, l64) and torch.equal(l_f32, l64)


def test_one_tf32_product_does_not(census_k200):
    x, c, m64, l64, scale = census_k200
    m_one, l_one = _min_dist(x, c, _tf32(x) @ _tf32(c).T)
    m_f32, _ = _min_dist(x, c, x @ c.T)
    err_one = float(((m_one.double() - m64).abs() / scale).max())
    err_f32 = float(((m_f32.double() - m64).abs() / scale).max())
    assert err_one > 100.0 * err_f32
