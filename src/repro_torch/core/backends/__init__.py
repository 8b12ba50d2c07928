"""Backend engine of Algorithm 1 (counterpart of ``repro.core.backends``).

Registered backends:

    dense        — plain PyTorch reference semantics (the oracle)
    blocked      — dense, with the distances evaluated in row blocks
    fused        — the single-pass CUDA kernel: one X read per step
    pallas       — the two-kernel engine: assignment, then update
    fused_bounds — the single pass skipping centroid groups by the bound
                   carry of ``bounds.py``

Still to be ported: the CPU bound engines (hamerly, elkan,
yinyang), the locality reorder and ``distribute``.
"""

from repro_torch.core.backends.base import (Backend, Precision,  # noqa: F401
                                            StepResult, backend_names,
                                            from_lloyd_ops, get_backend,
                                            instrument, register_backend)
from repro_torch.core.backends.bounds import BoundStats  # noqa: F401
from repro_torch.core.backends.dense import (blocked_backend,  # noqa: F401
                                             dense_backend)
from repro_torch.core.backends.fused import fused_backend  # noqa: F401
from repro_torch.core.backends.fused_bounds import (  # noqa: F401
    fused_bounds_backend)
from repro_torch.core.backends.split import pallas_backend  # noqa: F401

register_backend("dense", dense_backend)
register_backend("blocked", blocked_backend)
register_backend("fused", fused_backend)
register_backend("pallas", pallas_backend)
register_backend("fused_bounds", fused_bounds_backend)
