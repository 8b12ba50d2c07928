"""Online serving tier (counterpart of ``repro.serving``): the
cluster-closure candidate index for sublinear-in-K assignment, and the
micro-batching request server with hot reload."""

from repro_torch.serving.closure import (ClosureIndex,  # noqa: F401
                                         build_closure_index,
                                         candidate_table, closure_assign,
                                         closure_sqdist,
                                         default_n_candidates,
                                         default_n_groups,
                                         hierarchy_closure_index)
from repro_torch.serving.server import (KMeansServer,  # noqa: F401
                                        ServingModel, serve_manifest)

__all__ = [
    "ClosureIndex", "build_closure_index", "candidate_table",
    "closure_assign", "closure_sqdist", "default_n_candidates",
    "default_n_groups", "KMeansServer", "ServingModel", "serve_manifest",
]
