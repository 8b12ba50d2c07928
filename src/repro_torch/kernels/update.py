"""Weighted segment sum (the Update half of a Lloyd step): the CUDA kernel
``csrc/update.cu`` and its plain PyTorch version.

Counterpart of ``repro.kernels.update.update_pallas`` (the TPU kernel
``_update_kernel``), the second kernel of the ``pallas`` engine and the
``stats_fn`` of every kernel backend.  On a CUDA tensor ``update``
launches the kernel or raises; on a CPU tensor it runs ``update_plain``.
``launches`` / ``plain_calls`` count each, ``bf16_launches`` the launches
on a bf16 X, which run the bf16 segment sum (``csrc/segment_sum_bf16.cuh``,
its layout ``tiles.update_bf16_layout``): it equals the float32 launch on
the upcast X bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, ref, tiles

launches = 0
bf16_launches = 0
plain_calls = 0


def _shape(x: torch.Tensor, labels: torch.Tensor,
           w: Optional[torch.Tensor]):
    """Validate the operands; -> (batched, R, N, d).  labels (N,) or
    (R, N) int32 over x (N, d) shared or (R, N, d) per problem; w None or
    (N,); x and w each float32 or bfloat16 (the kernel adds a bf16 X's
    values in f32, and reads a bf16 w converted to f32)."""
    tiles.check_operand_types(x, w)
    if labels.dtype != torch.int32:
        raise TypeError(f"labels must be int32; got {labels.dtype}")
    if labels.dim() not in (1, 2) or x.dim() not in (2, 3):
        raise ValueError(f"labels must be (N,) or (R, N) and x (N, d) or "
                         f"(R, N, d); got {tuple(labels.shape)}, "
                         f"{tuple(x.shape)}")
    batched = labels.dim() == 2
    r = labels.shape[0] if batched else 1
    n, d = x.shape[-2], x.shape[-1]
    if x.dim() == 3 and not batched:
        raise ValueError(f"per-problem x {tuple(x.shape)} needs per-problem "
                         f"labels (R, N); got {tuple(labels.shape)}")
    if labels.shape[-1] != n or (x.dim() == 3 and x.shape[0] != r):
        raise ValueError(f"labels {tuple(labels.shape)} do not match x "
                         f"{tuple(x.shape)}")
    if w is not None and tuple(w.shape) != (n,):
        raise ValueError(f"w must be (N,) = ({n},); got {tuple(w.shape)}")
    return batched, r, n, d


def update_plain(x: torch.Tensor, labels: torch.Tensor, k: int,
                 w: Optional[torch.Tensor] = None):
    """The kernel's function in plain PyTorch (kernels/ref.py per label
    set), same shapes and outputs as ``update``."""
    global plain_calls
    plain_calls += 1
    batched, r, _, _ = _shape(x, labels, w)
    ls = labels if batched else labels[None]
    outs = [ref.update_ref(x[i] if x.dim() == 3 else x, ls[i], k, w)
            for i in range(r)]
    sums = torch.stack([o[0] for o in outs])
    counts = torch.stack([o[1] for o in outs])
    return (sums, counts) if batched else (sums[0], counts[0])


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.update_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, ctypes.c_longlong, p, p, i, i, i, i, i, i, i,
                       i, i, i, i, i, i, p, p, p, p]
        fn.restype = ctypes.c_int
        lib.update_error_string.argtypes = [ctypes.c_int]
        lib.update_error_string.restype = ctypes.c_char_p
        bind_geometry(lib)
    return lib


def bind_geometry(lib: ctypes.CDLL) -> None:
    """The argument types of the two layouts' geometry queries, which every
    library holding the segment sum exports (a library built before the
    bf16 segment sum has the first alone; ``layout`` then refuses bf16)."""
    for name in ("update_geometry", "update_bf16_geometry"):
        if hasattr(lib, name):
            getattr(lib, name).argtypes = [ctypes.c_void_p]
            getattr(lib, name).restype = None


def layout(lib: ctypes.CDLL, n: int, r: int, k: int, d: int,
           dtype: torch.dtype = torch.float32) -> tiles.UpdateLayout:
    """The segment sum's launch layout for X of ``dtype``, with the
    geometry the library reports: ``tiles.update_layout`` (rows per tile,
    ring slots, most warps, shared bytes per block) on float32,
    ``tiles.update_bf16_layout`` on bfloat16 (with the float32 layout's
    slabs; rows per tile, fewest and most ring slots, most warps, shared
    bytes per block, the width that sums by columns)."""
    geom = (ctypes.c_int * 4)()
    lib.update_geometry(geom)
    lay = tiles.update_layout(n, r, k, d, *geom)
    if dtype != torch.bfloat16:
        return lay
    geom16 = (ctypes.c_int * 6)()
    lib.update_bf16_geometry(geom16)
    return tiles.update_bf16_layout(n, r, k, d, lay, *geom16)


def update(x: torch.Tensor, labels: torch.Tensor, k: int,
           w: Optional[torch.Tensor] = None):
    """Per-cluster sums (K, d) f32 and counts (K,) f32 of a known
    assignment, each row scaled by its weight w (N,) when given.

    labels (N,) — or (R, N) for R label sets over shared (N, d) or
    per-problem (R, N, d) rows, adding a leading R axis to the outputs.  A
    label outside [0, K) adds nothing.  Repeated calls on the same inputs
    are bitwise equal."""
    global launches, bf16_launches
    batched, r, n, d = _shape(x, labels, w)
    if x.device.type == "cpu" and labels.device.type == "cpu" \
            and (w is None or w.device.type == "cpu"):
        return update_plain(x, labels, k, w)
    if r > tiles.MAX_PROBLEMS:
        raise ValueError(f"R={r} exceeds {tiles.MAX_PROBLEMS} problems")
    if k < 1:
        raise ValueError(f"k must be at least 1; got {k}")
    lib = _bind(build.load("update"))
    w = tiles.kernel_weights(w)
    tiles.check_cuda_operands(x, labels, w)
    lay = layout(lib, n, r, k, d, x.dtype)
    f32 = dict(dtype=torch.float32, device=x.device)
    sums = torch.empty((r, k, d), **f32)
    counts = torch.empty((r, k), **f32)
    part = torch.empty((r, lay.slabs, k, d + 1), **f32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.update_launch(
            x.data_ptr(), tiles.type_code(x), n * d if x.dim() == 3 else 0,
            labels.data_ptr(),
            None if w is None else w.data_ptr(), r, n, k, d, lay.groups,
            lay.width, lay.warps, lay.ranges, lay.range_k, lay.slabs,
            lay.tiles_per_slab, lay.smem_bytes, lay.stages, part.data_ptr(),
            sums.data_ptr(), counts.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"update launch failed: CUDA error {rc} "
                           f"({lib.update_error_string(rc).decode()})")
    launches += 1
    bf16_launches += x.dtype == torch.bfloat16
    return (sums, counts) if batched else (sums[0], counts[0])
