"""Dispatch layer over the kernels (counterpart of ``repro.kernels.ops``).

``use_pallas=True`` (the default, the reference's keyword) goes through
the kernel wrappers: on a CUDA tensor each launches its CUDA kernel, on a
CPU tensor it runs its plain version.  ``use_pallas=False`` asks for the
plain PyTorch version explicitly, as the reference's ``False`` asks for
its jnp oracle.  The solvers consume the kernels through the backends
(``get_backend("pallas" | "fused")``); ``pallas_lloyd_ops()`` remains as
the legacy LloydOps adapter for callers injecting assign/update
separately.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.lloyd import AssignResult, LloydOps, update_from_sums
from repro_torch.kernels import assignment as _assignment
from repro_torch.kernels import fused_lloyd as _fused
from repro_torch.kernels import update as _update


def assignment(x: torch.Tensor, c: torch.Tensor, *, use_pallas: bool = True):
    """(labels, min_sqdist); c may carry a leading R axis."""
    if use_pallas:
        return _assignment.assignment(x, c)
    return _assignment.assignment_plain(x, c)


def cluster_update(x: torch.Tensor, labels: torch.Tensor, k: int, *,
                   w: Optional[torch.Tensor] = None, use_pallas: bool = True):
    """(sums, counts); optional row weights w scale each row's share."""
    if use_pallas:
        return _update.update(x, labels, k, w)
    return _update.update_plain(x, labels, k, w)


def fused_lloyd_step(x: torch.Tensor, c: torch.Tensor, *,
                     w: Optional[torch.Tensor] = None,
                     use_pallas: bool = True):
    """(labels, min_sqdist, sums, counts, energy) in one call; optional
    row weights fold into the stats and energy, and a (R, K, d) centroid
    batch adds a leading R axis to every output."""
    if use_pallas:
        return _fused.fused_lloyd(x, c, w)
    return _fused.fused_lloyd_plain(x, c, w)


def fused_step(x: torch.Tensor, c: torch.Tensor, *, use_pallas: bool = True):
    """One full Lloyd iteration through the fused kernel:
    -> (c_next, labels, energy)."""
    labels, _, sums, counts, energy = fused_lloyd_step(
        x, c, use_pallas=use_pallas)
    c_next = update_from_sums(sums, counts, c.to(sums.dtype))
    return c_next.to(c.dtype), labels, energy


def pallas_lloyd_ops() -> LloydOps:
    """Lloyd ops on the separate assignment and update kernels (legacy:
    the solvers run ``get_backend("pallas")`` directly, one pass per
    accepted iteration)."""

    def assign_fn(x, c):
        return AssignResult(*assignment(x, c))

    def update_fn(x, labels, k, c_prev):
        sums, counts = cluster_update(x, labels, k)
        return update_from_sums(sums, counts,
                                c_prev.to(sums.dtype)).to(c_prev.dtype)

    def energy_fn(x, c, labels):
        diff = x.to(torch.float32) - c.to(torch.float32)[labels.long()]
        return torch.sum(diff * diff)

    return LloydOps(assign_fn=assign_fn, update_fn=update_fn,
                    energy_fn=energy_fn)
