"""Yinyang-style bound engine, "yinyang" (counterpart of
``repro.core.backends.yinyang``): pure group filtering, no K x K term.

Each step pays one exact distance per row to its assigned centroid and
one comparison per centroid group; only groups whose drift-maintained,
inclusive lower bound could beat that distance are scanned.  Groups
default to the classic t = ceil(K/10) ("yinyang" policy of
``bounds.resolve_group_size``); ``group_size=`` overrides.  The step is
``bounds.make_group_bound_backend`` without elkan's centre gate.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.core.backends.base import (DEFAULT_PRECISION, Backend,
                                            Precision)
from repro_torch.core.backends.bounds import make_group_bound_backend


def yinyang_backend(precision: Precision = DEFAULT_PRECISION,
                    group_size: Optional[int] = None) -> Backend:
    return make_group_bound_backend("yinyang", precision, group_size,
                                    policy="yinyang", center_gate=False)
