"""Persistence facade of the port (counterpart of ``repro.checkpoint``).

``kmeans`` finds the newest snapshot of a segmented run's directory
(``latest_snapshot``, ``resume_point``), and saves and loads estimator
artifacts without the caller knowing which estimator class wrote them,
over ``core/serialize.py``.
"""

from repro_torch.checkpoint.kmeans import (latest_snapshot,  # noqa: F401
                                           load_estimator, resume_point,
                                           save_estimator)
