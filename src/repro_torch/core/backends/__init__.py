"""Backend engine of Algorithm 1 (counterpart of ``repro.core.backends``).

Registered backends:

    dense        — plain PyTorch reference semantics (the oracle)
    blocked      — dense, with the distances evaluated in row blocks
    fused        — the single-pass CUDA kernel: one X read per step
    pallas       — the two-kernel engine: assignment, then update
    hamerly      — scalar second-closest bound carried across iterations
    elkan        — per-(row, group) lower bounds plus the centre-centre
                   gate (groups sized like the kernel's default k tile)
    yinyang      — group filtering only, no K x K term (t = K/10 groups)
    fused_bounds — the single pass skipping centroid groups by the bound
                   carry of ``bounds.py``

hamerly, elkan and yinyang are masked dense PyTorch code, as in the
reference, with no kernel of their own.  Every bound backend also
registers a ``<name>_reorder`` variant wrapping it in the locality engine
(``core/locality.py``): churn-triggered row sorting by label, with
original-order outputs.  Its options ``warmup``, ``churn_threshold`` and
``sort_tile`` go to the ``ReorderConfig``, the rest to the inner
backend's factory.

``distribute(backend, axes)`` wraps any of them for rows sharded over a
``torch.distributed`` device mesh (``core/distributed.py``).
"""

import dataclasses as _dc

from repro_torch.core.backends.base import (Backend, Precision,  # noqa: F401
                                            StepResult, backend_names,
                                            distribute, from_lloyd_ops,
                                            get_backend, instrument,
                                            refuse_bf16, register_backend)
from repro_torch.core.backends.bounds import BoundStats  # noqa: F401
from repro_torch.core.backends.dense import (blocked_backend,  # noqa: F401
                                             dense_backend)
from repro_torch.core.backends.elkan import elkan_backend  # noqa: F401
from repro_torch.core.backends.fused import fused_backend  # noqa: F401
from repro_torch.core.backends.fused_bounds import (  # noqa: F401
    fused_bounds_backend)
from repro_torch.core.backends.hamerly import hamerly_backend  # noqa: F401
from repro_torch.core.backends.split import pallas_backend  # noqa: F401
from repro_torch.core.backends.yinyang import yinyang_backend  # noqa: F401

register_backend("dense", dense_backend)
register_backend("blocked", blocked_backend)
register_backend("fused", fused_backend)
register_backend("pallas", pallas_backend)
register_backend("hamerly", hamerly_backend)
register_backend("elkan", elkan_backend)
register_backend("yinyang", yinyang_backend)
register_backend("fused_bounds", fused_bounds_backend)


def _reorder_factory(inner_name):
    def factory(*, warmup=None, churn_threshold=None, sort_tile=None,
                **inner_opts):
        from repro_torch.core.locality import ReorderConfig, reorder_backend
        policy = {key: val for key, val in (
            ("warmup", warmup), ("churn_threshold", churn_threshold),
            ("sort_tile", sort_tile)) if val is not None}
        return reorder_backend(get_backend(inner_name, **inner_opts),
                               _dc.replace(ReorderConfig(), **policy))
    return factory


for _name in ("hamerly", "elkan", "yinyang", "fused_bounds"):
    register_backend(f"{_name}_reorder", _reorder_factory(_name))
del _name
