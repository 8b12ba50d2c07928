"""Anderson-accelerated K-Means (Algorithm 1), PyTorch port.

Public surface (ported so far):
    AAKMeans           — estimator: fit / predict / transform / inertia_ /
                         save / load
    MiniBatchAAKMeans  — streaming estimator: fit / partial_fit /
                         partial_fit_stream / finalize / predict / transform
                         / save / load (a mid-stream state included)
    serialize          — the artifact format both packages read and write
                         (``repro_torch.core.serialize``)
    aa_kmeans          — Algorithm 1 on one problem (checkpoint_every=,
                         resume_from=, metrics=: core/segmented.py)
    aa_kmeans_batched  — R restarts/problems driven together
    aa_kmeans_traced   — one problem, with per-iteration statistics
    aa_kmeans_minibatch / aa_kmeans_minibatch_streamed — streaming
                         Algorithm 1 over device chunks / host chunks
    MiniBatchConfig    — streaming solver configuration
    select_best        — best-of-R selection (per group with groups=)
    aa_kmeans_hierarchical / HierarchyResult — the two-level solve for
                         large K (core/hierarchy.py)
    lloyd_kmeans / hamerly_kmeans — the Lloyd and Hamerly-bound baselines
    ReorderConfig/reorder_backend — the locality engine
    KMeansConfig/AAConfig — solver configuration
    get_backend/Backend/StepResult/Precision — step-primitive engine
"""

from repro_torch.core.anderson import AAConfig                  # noqa: F401
from repro_torch.core.api import (AAKMeans,                     # noqa: F401
                                  MiniBatchAAKMeans, NotFittedError)
from repro_torch.core.backends import (Backend, Precision,      # noqa: F401
                                       StepResult, get_backend)
from repro_torch.core.hamerly import hamerly_kmeans             # noqa: F401
from repro_torch.core.hierarchy import (HierarchyResult,        # noqa: F401
                                        aa_kmeans_hierarchical)
from repro_torch.core.kmeans import (KMeansConfig,              # noqa: F401
                                     KMeansResult, aa_kmeans,
                                     aa_kmeans_batched, aa_kmeans_minibatch,
                                     aa_kmeans_minibatch_streamed,
                                     aa_kmeans_traced, select_best)
from repro_torch.core.lloyd import lloyd_kmeans                 # noqa: F401
from repro_torch.core.minibatch import MiniBatchConfig          # noqa: F401
from repro_torch.core.locality import (ReorderConfig,           # noqa: F401
                                       reorder_backend)
