"""One Lloyd step in one pass over X: the CUDA kernel ``csrc/fused_lloyd.cu``
and its plain PyTorch version.

Counterpart of ``repro.kernels.fused_lloyd.fused_lloyd_pallas`` (the TPU
kernel ``_fused_kernel``).  On a CUDA tensor ``fused_lloyd`` launches the
kernel or raises; on a CPU tensor it runs ``fused_lloyd_plain``.

``launches`` counts the kernel launches and ``plain_calls`` the calls of
the plain version, so a run can show which of the two it went through.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, ref, tiles

launches = 0
plain_calls = 0


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
                w: Optional[torch.Tensor] = None):
    """Assignment + weighted cluster stats + energy in ONE pass over x.

    x (N, d) or (R, N, d); c (K, d) or (R, K, d); w None, (N,) or (R, N)
    row weights that scale sums/counts/energy (labels and min_sqdist stay
    unweighted).  Returns (labels int32, min_sqdist f32, sums (K, d) f32,
    counts (K,) f32, energy () f32), each with a leading R axis when c is
    (R, K, d).  Repeated calls on the same inputs are bitwise equal.
    """
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
