"""Device selection for the port's entry points, and a mesh rank's
device."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means CUDA.  With no card that raises RuntimeError: an
    entry point never carries on on the CPU unless asked to with
    ``device="cpu"``.

    On CUDA this also turns TF32 off for matmuls and cuDNN: the solver's
    f32 distances (the dense oracle's, the plain versions') would
    otherwise keep about three decimal digits, far outside the
    tolerances the port is held to against the reference.  And bf16
    matmuls accumulate in f32 (no reduced-precision reduction), as the
    reference's bf16 products do."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run the plain versions")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = False
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu'; got {dev}")
    return dev


def mesh_device(mesh, device: Optional[Union[str, torch.device]] = None
                ) -> torch.device:
    """The device a rank of ``mesh`` (a ``torch.distributed``
    ``DeviceMesh``) computes on: the current CUDA device on a CUDA mesh,
    the CPU on a "cpu" mesh, which runs the kernels' plain versions.  A
    ``device`` that names another one raises ValueError."""
    if mesh.device_type == "cuda":
        dev = resolve_device(
            torch.device("cuda", torch.cuda.current_device())
            if torch.cuda.is_available() else None)
    elif mesh.device_type == "cpu":
        dev = torch.device("cpu")
    else:
        raise ValueError(f"a mesh must be on 'cuda' or 'cpu'; got "
                         f"{mesh.device_type!r}")
    if device is not None:
        want = torch.device(device)
        if want.type != dev.type or (want.index is not None
                                     and want.index != dev.index):
            raise ValueError(
                f"device={want} contradicts the mesh, whose ranks compute "
                f"on {dev}; pass device=None or the mesh's device")
    return dev
