"""One Lloyd step in one pass over X: the CUDA kernels
``csrc/fused_lloyd.cu`` and ``csrc/fused_bounds.cu`` and their plain
PyTorch versions.

Counterpart of ``repro.kernels.fused_lloyd.fused_lloyd_pallas``: the TPU
kernel ``_fused_kernel``, and with ``bounds=`` the tile-skipping
``_fused_bounds_kernel``.  On a CUDA tensor ``fused_lloyd`` launches the
kernel or raises; on a CPU tensor it runs ``fused_lloyd_plain`` or
``fused_bounds_plain``.

``launches`` / ``bounds_launches`` count the launches of the two kernels
and ``plain_calls`` / ``bounds_plain_calls`` the calls of their plain
versions, so a run can show which of them it went through.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, ref, tiles

launches = 0
plain_calls = 0
bounds_launches = 0
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


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.fused_lloyd_launch
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, ll, p, p, ll, i, i, i, i, i, i,
                       p, p, p, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
        lib.fused_lloyd_error_string.argtypes = [ctypes.c_int]
        lib.fused_lloyd_error_string.restype = ctypes.c_char_p
        lib.fused_lloyd_max_features.argtypes = [ctypes.c_int]
        lib.fused_lloyd_max_features.restype = ctypes.c_int
        lib.fused_lloyd_tile_rows.argtypes = []
        lib.fused_lloyd_tile_rows.restype = ctypes.c_int
    return lib


def fused_lloyd(x: torch.Tensor, c: torch.Tensor,
                w: Optional[torch.Tensor] = None, *, bounds=None,
                gs: Optional[int] = None):
    """Assignment + weighted cluster stats + energy in ONE pass over x.

    x (N, d) or (R, N, d); c (K, d) or (R, K, d); w None, (N,) or (R, N)
    row weights that scale sums/counts/energy (labels and min_sqdist stay
    unweighted).  Returns (labels int32, min_sqdist f32, sums (K, d) f32,
    counts (K,) f32, energy () f32), each with a leading R axis when c is
    (R, K, d).  Repeated calls on the same inputs are bitwise equal.

    ``bounds=(lab0, lb_sq, ub_sq)`` with a group size ``gs`` switches to
    the tile-skipping kernel: lab0 (N,) int32 the standing labels, lb_sq
    (N, G) the squared lower bounds of the G = ceil(K / gs) groups of gs
    contiguous centroids, ub_sq (N,) the squared upper bounds (each with a
    leading R axis when c has one).  Two outputs follow the five:
    gmin_sq (N, G), the squared group minima, and skipped_frac () f32,
    the share of (row tile, group) cells skipped (see
    ``fused_bounds_plain``).
    """
    if bounds is not None:
        return _fused_bounds(x, c, w, bounds, gs)
    if gs is not None:
        raise ValueError("gs= goes with bounds=")
    global launches
    batched, r, n, k, d = tiles.problem_shape(x, c, w)
    if x.device.type == "cpu" and c.device.type == "cpu" \
            and (w is None or w.device.type == "cpu"):
        return fused_lloyd_plain(x, c, w)
    if r > tiles.MAX_PROBLEMS:
        raise ValueError(f"R={r} exceeds {tiles.MAX_PROBLEMS} problems")
    lib = _bind(build.load("fused_lloyd"))
    tiles.check_cuda_operands(lib.fused_lloyd_max_features, x, c, w)
    n_slabs, per_slab = tiles.slab_layout(n, r, k, d,
                                          lib.fused_lloyd_tile_rows())
    f32 = dict(dtype=torch.float32, device=x.device)
    labels = torch.empty((r, n), dtype=torch.int32, device=x.device)
    mind = torch.empty((r, n), **f32)
    sums = torch.empty((r, k, d), **f32)
    counts = torch.empty((r, k), **f32)
    energy = torch.empty((r,), **f32)
    csq = torch.empty((r, k), **f32)
    part = torch.empty((r, n_slabs, k, d + 1), **f32)
    part_e = torch.empty((r, n_slabs), **f32)
    x_rstride = n * d if x.dim() == 3 else 0
    w_rstride = n if (w is not None and w.dim() == 2) else 0
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.fused_lloyd_launch(
            x.data_ptr(), x_rstride, c.data_ptr(),
            None if w is None else w.data_ptr(), w_rstride,
            r, n, k, d, n_slabs, per_slab, csq.data_ptr(),
            labels.data_ptr(), mind.data_ptr(), part.data_ptr(),
            part_e.data_ptr(), sums.data_ptr(), counts.data_ptr(),
            energy.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"fused_lloyd launch failed: CUDA error {rc} "
                           f"({lib.fused_lloyd_error_string(rc).decode()})")
    launches += 1
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
        fn.argtypes = [p, ll, p, p, ll, p, p, p, i, i, i, i, i, i, i, i,
                       p, p, p, p, p, p, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
        lib.fused_bounds_error_string.argtypes = [ctypes.c_int]
        lib.fused_bounds_error_string.restype = ctypes.c_char_p
        lib.fused_bounds_max_features.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.fused_bounds_max_features.restype = ctypes.c_int
        lib.fused_bounds_tile_rows.argtypes = []
        lib.fused_bounds_tile_rows.restype = ctypes.c_int
    return lib


def _fused_bounds(x, c, w, bounds, gs):
    global bounds_launches
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
    tiles.check_cuda_operands(
        lambda dev: lib.fused_bounds_max_features(dev, g), x, c, w, lab0,
        lb_sq, ub_sq)
    tile_rows = lib.fused_bounds_tile_rows()
    n_slabs, per_slab = tiles.slab_layout(n, r, k, d, tile_rows)
    f32 = dict(dtype=torch.float32, device=x.device)
    labels = torch.empty((r, n), dtype=torch.int32, device=x.device)
    mind = torch.empty((r, n), **f32)
    gmin_sq = torch.empty((r, n, g), **f32)
    sums = torch.empty((r, k, d), **f32)
    counts = torch.empty((r, k), **f32)
    energy = torch.empty((r,), **f32)
    skipped = torch.empty((r,), dtype=torch.int64, device=x.device)
    csq = torch.empty((r, k), **f32)
    part = torch.empty((r, n_slabs, k, d + 1), **f32)
    part_e = torch.empty((r, n_slabs), **f32)
    part_skip = torch.empty((r, n_slabs), dtype=torch.int64, device=x.device)
    x_rstride = n * d if x.dim() == 3 else 0
    w_rstride = n if (w is not None and w.dim() == 2) else 0
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.fused_bounds_launch(
            x.data_ptr(), x_rstride, c.data_ptr(),
            None if w is None else w.data_ptr(), w_rstride,
            lab0.data_ptr(), lb_sq.data_ptr(), ub_sq.data_ptr(),
            r, n, k, d, int(gs), g, n_slabs, per_slab, csq.data_ptr(),
            labels.data_ptr(), mind.data_ptr(), gmin_sq.data_ptr(),
            part.data_ptr(), part_e.data_ptr(), part_skip.data_ptr(),
            sums.data_ptr(), counts.data_ptr(), energy.data_ptr(),
            skipped.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_bounds launch failed: CUDA error {rc} "
            f"({lib.fused_bounds_error_string(rc).decode()})")
    bounds_launches += 1
    n_cells = torch.tensor(tiles.cdiv(n, tile_rows) * g, **f32)
    skipped_frac = skipped.to(torch.float32) / n_cells
    out = (labels, mind, sums, counts, energy, gmin_sq, skipped_frac)
    return out if batched else tuple(o[0] for o in out)
