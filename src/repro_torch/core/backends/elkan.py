"""Elkan-style bound engine, "elkan" (counterpart of
``repro.core.backends.elkan``): per-(row, group) lower bounds plus the
centre-centre gate.

Groups follow the "tile" policy of ``bounds.resolve_group_size`` (one
group for K <= 512 unless ``group_size=`` carves finer ones), so the same
carry can drive the ``fused_bounds`` kernel's skip test.  On top of the
group filter, each step prices the K x K centre-centre distances for the
global gate: a row with d(x, c_a) <= s(a), half the distance from its
centroid to that centroid's nearest neighbour, keeps its assignment and
skips every group.  The step itself is ``bounds.make_group_bound_backend``.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.core.backends.base import (DEFAULT_PRECISION, Backend,
                                            Precision)
from repro_torch.core.backends.bounds import make_group_bound_backend


def elkan_backend(precision: Precision = DEFAULT_PRECISION,
                  group_size: Optional[int] = None) -> Backend:
    return make_group_bound_backend("elkan", precision, group_size,
                                    policy="tile", center_gate=True)
