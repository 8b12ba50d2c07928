"""Launch configuration and operand layout of the Hopper kernels.

The counterpart of ``repro.kernels.tiles``, without its TPU model (an
8 MB VMEM budget, 128-lane padding, ``round_up``/``pad_to``): the CUDA
kernels take any N, K and d and mask the ragged edges themselves, so no
operand is padded to a tile multiple.

The padding rules of the TPU wrappers hold inside the kernels instead —
a centroid past K never competes for the argmin (the TPU pads it with
|c|^2 = f32 max), and a row past N adds nothing to the stats (the TPU
gives it weight 0).

The tile geometry is the CUDA sources' alone (csrc/nearest.cuh): the
wrappers ask the built library for the widest d a tile takes and for the
rows per tile, and pass them in here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

MAX_SLABS = 264          # 2 x 132 SMs: row slabs of the fused kernel
PARTIAL_BYTES = 1 << 28  # cap on the fused kernel's per-slab partial stats
MAX_PROBLEMS = 65535     # the grid's y extent


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def slab_layout(n: int, r: int, k: int, d: int,
                tile_rows: int) -> Tuple[int, int]:
    """(n_slabs, tiles_per_slab) of the fused kernel: at most MAX_SLABS
    contiguous slabs of ``tile_rows``-row tiles, fewer when the
    (R, P, K, d+1) f32 partials would pass PARTIAL_BYTES.  Depends on the
    shapes only, so a step is reproducible bit for bit."""
    n_tiles = cdiv(n, tile_rows)
    cap = max(1, min(MAX_SLABS, PARTIAL_BYTES // (r * k * (d + 1) * 4)))
    per = cdiv(n_tiles, min(cap, n_tiles))
    return cdiv(n_tiles, per), per


def pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` grown to ``rows`` rows with copies of its last row — the
    fixed-shape chunk rule of predict (repro/core/api.py:85)."""
    m = x.shape[0]
    if m >= rows:
        return x
    return torch.cat([x, x[-1:].expand(rows - m, *x.shape[1:])])


def problem_shape(x: torch.Tensor, c: torch.Tensor,
                  w: Optional[torch.Tensor] = None):
    """Validate the kernels' operand shapes; -> (batched, R, N, K, d).

    x (N, d) or (R, N, d); c (K, d) or (R, K, d); w None, (N,) or (R, N),
    all float32 (bf16 is still to be ported).  A per-problem x or w needs
    a per-problem c, as in the TPU wrappers."""
    for t in (x, c, w):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"the kernels take float32 only in this slice "
                            f"(bf16 is still to be ported); got {t.dtype}")
    if c.dim() not in (2, 3) or x.dim() not in (2, 3):
        raise ValueError(f"x must be (N, d) or (R, N, d) and c (K, d) or "
                         f"(R, K, d); got {tuple(x.shape)}, {tuple(c.shape)}")
    batched = c.dim() == 3
    r = c.shape[0] if batched else 1
    k, d = c.shape[-2], c.shape[-1]
    n = x.shape[-2]
    if x.dim() == 3 and not batched:
        raise ValueError(
            f"per-problem x {tuple(x.shape)} needs a per-problem c (R, K, d);"
            f" got {tuple(c.shape)}")
    if x.shape[-1] != d or (x.dim() == 3 and x.shape[0] != r):
        raise ValueError(f"x {tuple(x.shape)} does not match c "
                         f"{tuple(c.shape)}")
    if w is not None:
        if w.dim() == 2 and not batched:
            raise ValueError(f"per-problem w {tuple(w.shape)} needs a "
                             f"per-problem c (R, K, d); got {tuple(c.shape)}")
        if w.shape not in ((n,), (r, n)):
            raise ValueError(f"w must be (N,) or (R, N) = ({r}, {n}); got "
                             f"{tuple(w.shape)}")
    return batched, r, n, k, d


def check_cuda_operands(max_features, *tensors: Optional[torch.Tensor]
                        ) -> None:
    """What a kernel takes beyond ``problem_shape``: contiguous tensors on
    one CUDA device, no empty axis, and d within the shared-memory tile,
    whose width ``max_features(device index)`` reports (the library's
    ``*_max_features``)."""
    present = [t for t in tensors if t is not None]
    dev = present[0].device
    for t in present:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"kernel operands must share one CUDA device; "
                             f"got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
        if t.numel() == 0:
            raise ValueError(f"empty operand of shape {tuple(t.shape)}")
    d = present[0].shape[-1]
    widest = max_features(dev.index)
    if widest < 0:
        raise RuntimeError(f"could not query the shared memory of {dev}")
    if d > widest:
        raise ValueError(f"d={d} exceeds the {widest} features one X tile "
                         f"can hold in the shared memory of {dev}")
