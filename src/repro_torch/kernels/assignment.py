"""Nearest-centroid assignment: the CUDA kernel ``csrc/assignment.cu`` and
its plain PyTorch version.

Counterpart of ``repro.kernels.assignment.assignment_pallas`` (the TPU
kernel ``_assignment_kernel``), the kernel behind ``predict``.  On a CUDA
tensor ``assignment`` launches the kernel or raises; on a CPU tensor it
runs ``assignment_plain``.  ``launches`` / ``plain_calls`` count each.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref, tiles

launches = 0
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
        fn.argtypes = [p, ctypes.c_longlong, p, i, i, i, i, p, p, p, p]
        fn.restype = ctypes.c_int
        lib.assignment_error_string.argtypes = [ctypes.c_int]
        lib.assignment_error_string.restype = ctypes.c_char_p
        lib.assignment_max_features.argtypes = [ctypes.c_int]
        lib.assignment_max_features.restype = ctypes.c_int
    return lib


def assignment(x: torch.Tensor, c: torch.Tensor):
    """Nearest centroid of every row.  x (N, d) or (R, N, d); c (K, d) or
    (R, K, d).  Returns (labels int32, min_sqdist f32), each with a
    leading R axis when c is (R, K, d)."""
    global launches
    batched, r, n, k, d = tiles.problem_shape(x, c)
    if x.device.type == "cpu" and c.device.type == "cpu":
        return assignment_plain(x, c)
    if r > tiles.MAX_PROBLEMS:
        raise ValueError(f"R={r} exceeds {tiles.MAX_PROBLEMS} problems")
    lib = _bind(build.load("assignment"))
    tiles.check_cuda_operands(lib.assignment_max_features, x, c)
    labels = torch.empty((r, n), dtype=torch.int32, device=x.device)
    mind = torch.empty((r, n), dtype=torch.float32, device=x.device)
    csq = torch.empty((r, k), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.assignment_launch(
            x.data_ptr(), n * d if x.dim() == 3 else 0, c.data_ptr(),
            r, n, k, d, csq.data_ptr(), labels.data_ptr(), mind.data_ptr(),
            stream)
    if rc != 0:
        raise RuntimeError(f"assignment launch failed: CUDA error {rc} "
                           f"({lib.assignment_error_string(rc).decode()})")
    launches += 1
    return (labels, mind) if batched else (labels[0], mind[0])
