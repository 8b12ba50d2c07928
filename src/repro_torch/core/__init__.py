"""Anderson-accelerated K-Means (Algorithm 1), PyTorch port.

Public surface (this slice):
    AAKMeans           — estimator: fit / predict / transform / inertia_
    aa_kmeans_batched  — R restarts/problems driven together
    select_best        — best-of-R selection
    KMeansConfig/AAConfig — solver configuration
    get_backend/Backend/StepResult/Precision — step-primitive engine
"""

from repro_torch.core.anderson import AAConfig                  # noqa: F401
from repro_torch.core.api import AAKMeans, NotFittedError       # noqa: F401
from repro_torch.core.backends import (Backend, Precision,      # noqa: F401
                                       StepResult, get_backend)
from repro_torch.core.kmeans import (KMeansConfig,              # noqa: F401
                                     KMeansResult, aa_kmeans_batched,
                                     select_best)
