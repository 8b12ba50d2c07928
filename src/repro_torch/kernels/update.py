"""Weighted segment sum (the Update half of a Lloyd step): the CUDA kernel
``csrc/update.cu`` and its plain PyTorch version.

Counterpart of ``repro.kernels.update.update_pallas`` (the TPU kernel
``_update_kernel``), the second kernel of the ``pallas`` engine and the
``stats_fn`` of every kernel backend.  On a CUDA tensor ``update``
launches the kernel or raises; on a CPU tensor it runs ``update_plain``.
``launches`` / ``plain_calls`` count each.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, ref, tiles

launches = 0
plain_calls = 0


def _shape(x: torch.Tensor, labels: torch.Tensor,
           w: Optional[torch.Tensor]):
    """Validate the operands; -> (batched, R, N, d).  labels (N,) or
    (R, N) int32 over x (N, d) shared or (R, N, d) per problem; w None or
    (N,); float32 only (bf16 is still to be ported)."""
    for t in (x, w):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"the kernels take float32 only in this slice "
                            f"(bf16 is still to be ported); got {t.dtype}")
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
        fn.argtypes = [p, ctypes.c_longlong, p, p, i, i, i, i, i, i,
                       p, p, p, p]
        fn.restype = ctypes.c_int
        lib.update_error_string.argtypes = [ctypes.c_int]
        lib.update_error_string.restype = ctypes.c_char_p
        lib.update_max_features.argtypes = [ctypes.c_int]
        lib.update_max_features.restype = ctypes.c_int
        lib.update_tile_rows.argtypes = []
        lib.update_tile_rows.restype = ctypes.c_int
    return lib


def update(x: torch.Tensor, labels: torch.Tensor, k: int,
           w: Optional[torch.Tensor] = None):
    """Per-cluster sums (K, d) f32 and counts (K,) f32 of a known
    assignment, each row scaled by its weight w (N,) when given.

    labels (N,) — or (R, N) for R label sets over shared (N, d) or
    per-problem (R, N, d) rows, adding a leading R axis to the outputs.  A
    label outside [0, K) adds nothing.  Repeated calls on the same inputs
    are bitwise equal."""
    global launches
    batched, r, n, d = _shape(x, labels, w)
    if x.device.type == "cpu" and labels.device.type == "cpu" \
            and (w is None or w.device.type == "cpu"):
        return update_plain(x, labels, k, w)
    if r > tiles.MAX_PROBLEMS:
        raise ValueError(f"R={r} exceeds {tiles.MAX_PROBLEMS} problems")
    if k < 1:
        raise ValueError(f"k must be at least 1; got {k}")
    lib = _bind(build.load("update"))
    tiles.check_cuda_operands(lib.update_max_features, x, labels, w)
    n_slabs, per_slab = tiles.slab_layout(n, r, k, d,
                                          lib.update_tile_rows())
    f32 = dict(dtype=torch.float32, device=x.device)
    sums = torch.empty((r, k, d), **f32)
    counts = torch.empty((r, k), **f32)
    part = torch.empty((r, n_slabs, k, d + 1), **f32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.update_launch(
            x.data_ptr(), n * d if x.dim() == 3 else 0, labels.data_ptr(),
            None if w is None else w.data_ptr(), r, n, k, d, n_slabs,
            per_slab, part.data_ptr(), sums.data_ptr(), counts.data_ptr(),
            stream)
    if rc != 0:
        raise RuntimeError(f"update launch failed: CUDA error {rc} "
                           f"({lib.update_error_string(rc).decode()})")
    launches += 1
    return (sums, counts) if batched else (sums[0], counts[0])
