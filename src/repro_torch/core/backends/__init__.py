"""Backend engine of Algorithm 1 (counterpart of ``repro.core.backends``).

Registered backends:

    dense — plain PyTorch reference semantics (the oracle)
    fused — the single-pass CUDA kernel: one X read per accepted iteration

Still to be ported: blocked, pallas (split kernels), the bound family and
``distribute``.
"""

from repro_torch.core.backends.base import (Backend, Precision,  # noqa: F401
                                            StepResult, backend_names,
                                            get_backend, register_backend)
from repro_torch.core.backends.dense import dense_backend  # noqa: F401
from repro_torch.core.backends.fused import fused_backend  # noqa: F401

register_backend("dense", dense_backend)
register_backend("fused", fused_backend)
