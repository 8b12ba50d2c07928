"""Device selection for the port's entry points."""

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
    tolerances the port is held to against the reference."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run the plain versions")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu'; got {dev}")
    return dev
