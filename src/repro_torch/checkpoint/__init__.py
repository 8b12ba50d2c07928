"""Persistence facade of the port (counterpart of ``repro.checkpoint``).

``kmeans`` saves and loads estimator artifacts without the caller
knowing which estimator class wrote them, over ``core/serialize.py``.
Still to be ported: ``latest_snapshot`` and ``resume_point``, which
need the segmented drivers' checkpoint directories.
"""

from repro_torch.checkpoint.kmeans import (load_estimator,  # noqa: F401
                                           save_estimator)
