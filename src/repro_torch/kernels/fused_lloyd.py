"""One Lloyd step in one call: the CUDA kernels ``csrc/fused_lloyd.cu``
and ``csrc/fused_bounds.cu`` and their plain PyTorch versions.  On the
card a step is the assignment's sweep (labels and distances: the
tensor-core sweep on bf16 X and C, else the FP32 sweep), then the update
kernel's segment sum over those labels and the energy; the TPU kernel's
single pass over X does not pay on the H100 (csrc/fused_lloyd.cu says
why).

Counterpart of ``repro.kernels.fused_lloyd.fused_lloyd_pallas``: the TPU
kernel ``_fused_kernel``, and with ``bounds=`` the tile-skipping
``_fused_bounds_kernel``.  On a CUDA tensor ``fused_lloyd`` launches the
kernel or raises; on a CPU tensor it runs ``fused_lloyd_plain`` or
``fused_bounds_plain``.  Both kernels take any d: rows wider than the
shared-memory X tile stream through the sweep in feature slabs.

``launches`` / ``bounds_launches`` count the launches of the two kernels
(``bf16_launches`` / ``bounds_bf16_launches`` those of them on a bf16 X,
the kernels' bf16 variants; ``tc_launches`` / ``bounds_tc_launches``
those on the tensor cores; ``stream_launches`` /
``bounds_stream_launches`` those that streamed X through the FP32 sweep)
and ``plain_calls`` /
``bounds_plain_calls`` the calls of their plain versions, so a run can
show which of them it went through.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, ref, tiles, update

launches = 0
bf16_launches = 0
tc_launches = 0
stream_launches = 0
plain_calls = 0
bounds_launches = 0
bounds_bf16_launches = 0
bounds_tc_launches = 0
bounds_stream_launches = 0
bounds_plain_calls = 0


def fused_lloyd_plain(x: torch.Tensor, c: torch.Tensor,
                      w: Optional[torch.Tensor] = None):
    """The kernel's function in plain PyTorch (kernels/ref.py per
    problem), same shapes and outputs as ``fused_lloyd``."""
    global plain_calls
    plain_calls += 1
    batched, r, _, _, _ = tiles.problem_shape(x, c, w)
    cs = c if batched else c[None]
    outs = []
    for i in range(r):
        xi = x[i] if x.dim() == 3 else x
        if w is None:
            outs.append(ref.fused_lloyd_ref(xi, cs[i]))
        else:
            outs.append(ref.minibatch_ref(xi, cs[i],
                                          w[i] if w.dim() == 2 else w))
    stacked = tuple(torch.stack(o) for o in zip(*outs))
    return stacked if batched else tuple(o[0] for o in stacked)


def _stats_layout(lib: ctypes.CDLL, n: int, r: int, k: int, d: int,
                  dtype: torch.dtype):
    """The segment sum's layout for X of ``dtype`` (``update.layout``: the
    bf16 segment sum's on bfloat16, with the geometry the library reports)
    and the same as the int array the launch takes."""
    lay = update.layout(lib, n, r, k, d, dtype)
    arr = (ctypes.c_int * 9)(lay.groups, lay.width, lay.warps, lay.ranges,
                             lay.range_k, lay.slabs, lay.tiles_per_slab,
                             lay.smem_bytes, lay.stages)
    return lay, arr


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.fused_lloyd_launch
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, i, ll, p, i, p, ll, i, i, i, i, i, p,
                       p, p, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
        lib.fused_lloyd_error_string.argtypes = [ctypes.c_int]
        lib.fused_lloyd_error_string.restype = ctypes.c_char_p
        lib.fused_lloyd_max_features.argtypes = [ctypes.c_int]
        lib.fused_lloyd_max_features.restype = ctypes.c_int
        lib.fused_lloyd_tile_rows.argtypes = []
        lib.fused_lloyd_tile_rows.restype = ctypes.c_int
        lib.fused_lloyd_scratch_floats.argtypes = [ctypes.c_int] * 3
        lib.fused_lloyd_scratch_floats.restype = ctypes.c_longlong
        update.bind_geometry(lib)
    return lib


def fused_lloyd(x: torch.Tensor, c: torch.Tensor,
                w: Optional[torch.Tensor] = None, *, bounds=None,
                gs: Optional[int] = None, _stream: bool = False):
    """Assignment + weighted cluster stats + energy in one call.

    x (N, d) or (R, N, d); c (K, d) or (R, K, d); w None, (N,) or (R, N)
    row weights that scale sums/counts/energy (labels and min_sqdist stay
    unweighted).  x and c are each float32 or bfloat16, read as they are:
    bf16 x and c take the tensor-core sweep (bf16 products summed in f32,
    the reference's bf16 policy; with ``bounds=`` where gs is a multiple
    of 8, as the engines give it), other types compute in f32 on the
    upcast values, so a mixed call equals the f32 call on the upcast
    operands bit for bit; the stats are summed in f32 either way.  Any d.
    Returns (labels int32, min_sqdist f32, sums (K, d) f32, counts (K,)
    f32, energy () f32), each with a leading R axis when c is (R, K, d).
    Repeated calls on the same inputs are bitwise equal, and the labels
    and min_sqdist are ``assignment``'s on the same operands.

    ``bounds=(lab0, lb_sq, ub_sq)`` with a group size ``gs`` switches to
    the tile-skipping kernel: lab0 (N,) int32 the standing labels, lb_sq
    (N, G) the squared lower bounds of the G = ceil(K / gs) groups of gs
    contiguous centroids, ub_sq (N,) the squared upper bounds (each with a
    leading R axis when c has one).  Two outputs follow the five:
    gmin_sq (N, G), the squared group minima, and skipped_frac () f32,
    the share of (row tile, group) cells skipped (see
    ``fused_bounds_plain``).

    ``_stream`` streams X through the FP32 sweep on the card at any d,
    which the card tests compare with the resident launch bit for bit
    (ValueError on bf16 x and c, which take the tensor cores; with
    ``bounds`` where gs is a multiple of 8).
    """
    if bounds is not None:
        return _fused_bounds(x, c, w, bounds, gs, _stream)
    if gs is not None:
        raise ValueError("gs= goes with bounds=")
    global launches, bf16_launches, tc_launches, stream_launches
    batched, r, n, k, d = tiles.problem_shape(x, c, w)
    if x.device.type == "cpu" and c.device.type == "cpu" \
            and (w is None or w.device.type == "cpu"):
        return fused_lloyd_plain(x, c, w)
    if r > tiles.MAX_PROBLEMS:
        raise ValueError(f"R={r} exceeds {tiles.MAX_PROBLEMS} problems")
    lib = _bind(build.load("fused_lloyd"))
    tiles.check_cuda_operands(x, c, w)
    route = tiles.sweep_route(
        x.dtype, c.dtype, d, lib.fused_lloyd_max_features(x.device.index),
        _stream)
    w = tiles.kernel_weights(w)
    lay, lay_arr = _stats_layout(lib, n, r, k, d, x.dtype)
    f32 = dict(dtype=torch.float32, device=x.device)
    labels = torch.empty((r, n), dtype=torch.int32, device=x.device)
    mind = torch.empty((r, n), **f32)
    sums = torch.empty((r, k, d), **f32)
    counts = torch.empty((r, k), **f32)
    energy = torch.empty((r,), **f32)
    scratch = torch.empty(lib.fused_lloyd_scratch_floats(r, k, d), **f32)
    part = torch.empty((r, lay.slabs, k, d + 1), **f32)
    x_rstride = n * d if x.dim() == 3 else 0
    w_rstride = n if (w is not None and w.dim() == 2) else 0
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.fused_lloyd_launch(
            x.data_ptr(), tiles.type_code(x), x_rstride, c.data_ptr(),
            tiles.type_code(c), None if w is None else w.data_ptr(),
            w_rstride,
            r, n, k, d, int(_stream), lay_arr, scratch.data_ptr(),
            labels.data_ptr(), mind.data_ptr(), part.data_ptr(),
            sums.data_ptr(), counts.data_ptr(), energy.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"fused_lloyd launch failed: CUDA error {rc} "
                           f"({lib.fused_lloyd_error_string(rc).decode()})")
    launches += 1
    bf16_launches += x.dtype == torch.bfloat16
    tc_launches += route == tiles.TENSOR_CORES
    stream_launches += route == tiles.STREAMED
    out = (labels, mind, sums, counts, energy)
    return out if batched else tuple(o[0] for o in out)


def _bounds_shape(c, bounds, gs, batched, r, n, k):
    """Validate bounds=(lab0, lb_sq, ub_sq) and gs; -> G."""
    if gs is None or int(gs) < 1:
        raise ValueError(f"bounds= needs a group size gs >= 1; got {gs}")
    g = -(-k // int(gs))
    lab0, lb_sq, ub_sq = bounds
    lead = (r,) if batched else ()
    for name, t, shape, dtype in (("lab0", lab0, lead + (n,), torch.int32),
                                  ("lb_sq", lb_sq, lead + (n, g),
                                   torch.float32),
                                  ("ub_sq", ub_sq, lead + (n,),
                                   torch.float32)):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} for c {tuple(c.shape)}"
                             f" and gs={gs}; got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}; got {t.dtype}")
    return g


def fused_bounds_plain(x: torch.Tensor, c: torch.Tensor,
                       w: Optional[torch.Tensor], lab0: torch.Tensor,
                       lb_sq: torch.Tensor, ub_sq: torch.Tensor, gs: int,
                       tile_rows: int):
    """The tile-skipping kernel's function in plain PyTorch
    (``kernels/ref.py::fused_bounds_ref`` per problem) with rows tiled
    ``tile_rows`` at a time, which decides the cells that skip; same
    shapes and outputs as ``fused_lloyd(..., bounds=, gs=)``."""
    global bounds_plain_calls
    bounds_plain_calls += 1
    batched, r, n, k, _ = tiles.problem_shape(x, c, w)
    _bounds_shape(c, (lab0, lb_sq, ub_sq), gs, batched, r, n, k)
    lift = (lambda t: t) if batched else (lambda t: t[None])
    cs, l0, lb, ub = lift(c), lift(lab0), lift(lb_sq), lift(ub_sq)
    outs = []
    for i in range(r):
        wi = None if w is None else (w[i] if w.dim() == 2 else w)
        outs.append(ref.fused_bounds_ref(x[i] if x.dim() == 3 else x, cs[i],
                                         wi, l0[i], lb[i], ub[i], int(gs),
                                         tile_rows))
    stacked = tuple(torch.stack(o) for o in zip(*outs))
    return stacked if batched else tuple(o[0] for o in stacked)


def _bind_bounds(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.fused_bounds_launch
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, i, ll, p, i, p, ll, p, p, p, i, i, i, i, i, i, i,
                       p, p, p, p, p, p, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
        lib.fused_bounds_error_string.argtypes = [ctypes.c_int]
        lib.fused_bounds_error_string.restype = ctypes.c_char_p
        lib.fused_bounds_max_features.argtypes = [ctypes.c_int] * 2
        lib.fused_bounds_max_features.restype = ctypes.c_int
        lib.fused_bounds_tile_rows.argtypes = []
        lib.fused_bounds_tile_rows.restype = ctypes.c_int
        lib.fused_bounds_scratch_floats.argtypes = [ctypes.c_int] * 3
        lib.fused_bounds_scratch_floats.restype = ctypes.c_longlong
        update.bind_geometry(lib)
    return lib


def _fused_bounds(x, c, w, bounds, gs, force_stream):
    global bounds_launches, bounds_bf16_launches, bounds_tc_launches
    global bounds_stream_launches
    batched, r, n, k, d = tiles.problem_shape(x, c, w)
    g = _bounds_shape(c, bounds, gs, batched, r, n, k)
    lab0, lb_sq, ub_sq = bounds
    if all(t.device.type == "cpu" for t in (x, c, lab0, lb_sq, ub_sq)) \
            and (w is None or w.device.type == "cpu"):
        return fused_bounds_plain(x, c, w, lab0, lb_sq, ub_sq, gs,
                                  build.tile_rows())
    if r > tiles.MAX_PROBLEMS:
        raise ValueError(f"R={r} exceeds {tiles.MAX_PROBLEMS} problems")
    lib = _bind_bounds(build.load("fused_bounds"))
    tiles.check_cuda_operands(x, c, w, lab0, lb_sq, ub_sq)
    route = tiles.bounds_route(
        x.dtype, c.dtype, d, int(gs),
        lib.fused_bounds_max_features(x.device.index, g), force_stream)
    tile_rows = lib.fused_bounds_tile_rows()
    w = tiles.kernel_weights(w)
    lay, lay_arr = _stats_layout(lib, n, r, k, d, x.dtype)
    n_tiles = tiles.cdiv(n, tile_rows)
    f32 = dict(dtype=torch.float32, device=x.device)
    labels = torch.empty((r, n), dtype=torch.int32, device=x.device)
    mind = torch.empty((r, n), **f32)
    gmin_sq = torch.empty((r, n, g), **f32)
    sums = torch.empty((r, k, d), **f32)
    counts = torch.empty((r, k), **f32)
    energy = torch.empty((r,), **f32)
    skipped = torch.empty((r,), dtype=torch.int64, device=x.device)
    scratch = torch.empty(lib.fused_bounds_scratch_floats(r, k, d), **f32)
    part = torch.empty((r, lay.slabs, k, d + 1), **f32)
    part_skip = torch.empty((r, n_tiles), dtype=torch.int32, device=x.device)
    x_rstride = n * d if x.dim() == 3 else 0
    w_rstride = n if (w is not None and w.dim() == 2) else 0
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.fused_bounds_launch(
            x.data_ptr(), tiles.type_code(x), x_rstride, c.data_ptr(),
            tiles.type_code(c), None if w is None else w.data_ptr(),
            w_rstride,
            lab0.data_ptr(), lb_sq.data_ptr(), ub_sq.data_ptr(),
            r, n, k, d, int(gs), g, int(force_stream), lay_arr,
            scratch.data_ptr(),
            labels.data_ptr(), mind.data_ptr(), gmin_sq.data_ptr(),
            part.data_ptr(), part_skip.data_ptr(),
            sums.data_ptr(), counts.data_ptr(), energy.data_ptr(),
            skipped.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_bounds launch failed: CUDA error {rc} "
            f"({lib.fused_bounds_error_string(rc).decode()})")
    bounds_launches += 1
    bounds_bf16_launches += x.dtype == torch.bfloat16
    bounds_tc_launches += route == tiles.TENSOR_CORES
    bounds_stream_launches += route == tiles.STREAMED
    # the cell count made on the card: a host tensor would be a copy that
    # keeps the next launch waiting, a Python divisor a multiplication by
    # its reciprocal, not the plain version's division
    n_cells = torch.full((), n_tiles * g, **f32)
    skipped_frac = skipped.to(torch.float32) / n_cells
    out = (labels, mind, sums, counts, energy, gmin_sq, skipped_frac)
    return out if batched else tuple(o[0] for o in out)
