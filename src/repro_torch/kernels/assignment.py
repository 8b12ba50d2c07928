"""Nearest-centroid assignment: the CUDA kernel ``csrc/assignment.cu`` and
its plain PyTorch version.

Counterpart of ``repro.kernels.assignment.assignment_pallas`` (the TPU
kernel ``_assignment_kernel``), the kernel behind ``predict``.  On a CUDA
tensor ``assignment`` launches the kernel or raises, at any d; on a CPU
tensor it runs ``assignment_plain``.  The launch takes one of three sweeps
(``tiles.sweep_route``): bf16 X and C the tensor-core sweep, otherwise the
FP32 sweep with the X tile resident or, for rows wider than it, streamed
in feature slabs.  ``launches`` / ``plain_calls`` count each,
``bf16_launches`` the launches on a bf16 X (the kernel's bf16 variants),
``tc_launches`` those on the tensor cores and ``stream_launches`` those
that streamed X through the FP32 sweep.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref, tiles

launches = 0
bf16_launches = 0
tc_launches = 0
stream_launches = 0
cross_launches = 0
plain_calls = 0


def assignment_plain(x: torch.Tensor, c: torch.Tensor):
    """The kernel's function in plain PyTorch (kernels/ref.py per
    problem), same shapes and outputs as ``assignment``."""
    global plain_calls
    plain_calls += 1
    batched, r, _, _, _ = tiles.problem_shape(x, c)
    cs = c if batched else c[None]
    outs = [ref.assignment_ref(x[i] if x.dim() == 3 else x, cs[i])
            for i in range(r)]
    labels = torch.stack([o[0] for o in outs])
    mind = torch.stack([o[1] for o in outs])
    return (labels, mind) if batched else (labels[0], mind[0])


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.assignment_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, ctypes.c_longlong, p, i, i, i, i, i, i, p, p,
                       p, p]
        fn.restype = ctypes.c_int
        lib.assignment_error_string.argtypes = [ctypes.c_int]
        lib.assignment_error_string.restype = ctypes.c_char_p
        lib.assignment_max_features.argtypes = [ctypes.c_int]
        lib.assignment_max_features.restype = ctypes.c_int
        lib.assignment_scratch_floats.argtypes = [ctypes.c_int] * 3
        lib.assignment_scratch_floats.restype = ctypes.c_longlong
        lib.assignment_cross_launch.argtypes = [p, ctypes.c_longlong, p, i,
                                                i, i, i, p, p, p]
        lib.assignment_cross_launch.restype = ctypes.c_int
    return lib


def assignment(x: torch.Tensor, c: torch.Tensor, *, _stream: bool = False):
    """Nearest centroid of every row.  x (N, d) or (R, N, d); c (K, d) or
    (R, K, d), each float32 or bfloat16, any d: bf16 X and C on the tensor
    cores (bf16 products summed in f32), otherwise in f32 on the upcast
    values (mixed types too).  Returns (labels int32, min_sqdist f32),
    each with a leading R axis when c is (R, K, d).  ``_stream`` streams X
    through the FP32 sweep on the card at any d, which the card tests
    compare with the resident launch bit for bit (ValueError on bf16 X and
    C)."""
    global launches, bf16_launches, tc_launches, stream_launches
    batched, r, n, k, d = tiles.problem_shape(x, c)
    if x.device.type == "cpu" and c.device.type == "cpu":
        return assignment_plain(x, c)
    if r > tiles.MAX_PROBLEMS:
        raise ValueError(f"R={r} exceeds {tiles.MAX_PROBLEMS} problems")
    lib = _bind(build.load("assignment"))
    tiles.check_cuda_operands(x, c)
    route = tiles.sweep_route(
        x.dtype, c.dtype, d, lib.assignment_max_features(x.device.index),
        _stream)
    labels = torch.empty((r, n), dtype=torch.int32, device=x.device)
    mind = torch.empty((r, n), dtype=torch.float32, device=x.device)
    scratch = torch.empty(lib.assignment_scratch_floats(r, k, d),
                          dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.assignment_launch(
            x.data_ptr(), tiles.type_code(x), n * d if x.dim() == 3 else 0,
            c.data_ptr(), tiles.type_code(c), r, n, k, d, int(_stream),
            scratch.data_ptr(), labels.data_ptr(),
            mind.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"assignment launch failed: CUDA error {rc} "
                           f"({lib.assignment_error_string(rc).decode()})")
    launches += 1
    bf16_launches += x.dtype == torch.bfloat16
    tc_launches += route == tiles.TENSOR_CORES
    stream_launches += route == tiles.STREAMED
    return (labels, mind) if batched else (labels[0], mind[0])


def cross_terms(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The tensor-core sweep's cross terms x.c in f32, as its epilogue
    reads them, on bf16 X (N, d) or (R, N, d) and C (R, K, d) on the card:
    (R, N, K).  A measurement of the tensor cores' accumulation against an
    exact product (``chip_smoke.py`` phase 18); no path calls it.
    ``cross_launches`` counts its launches."""
    global cross_launches
    _, r, n, k, d = tiles.problem_shape(x, c)
    if not (x.dtype == c.dtype == torch.bfloat16 and c.dim() == 3):
        raise ValueError("cross_terms takes bf16 X and bf16 C (R, K, d)")
    lib = _bind(build.load("assignment"))
    tiles.check_cuda_operands(x, c)
    out = torch.empty((r, n, k), dtype=torch.float32, device=x.device)
    scratch = torch.empty(lib.assignment_scratch_floats(r, k, d),
                          dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.assignment_cross_launch(
            x.data_ptr(), n * d if x.dim() == 3 else 0, c.data_ptr(), r, n,
            k, d, scratch.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cross-term launch failed: CUDA error {rc} "
                           f"({lib.assignment_error_string(rc).decode()})")
    cross_launches += 1
    return out
