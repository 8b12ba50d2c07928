"""Estimator persistence facade (counterpart of the estimator half of
``repro.checkpoint.kmeans``): the artifact's ``kind`` picks the class.

    save_estimator(model, "model.npz")
    model = load_estimator("model.npz")          # on CUDA
    model = load_estimator("model.npz", device="cpu")
"""

from __future__ import annotations

import os
from pathlib import Path

from repro_torch.core import serialize
from repro_torch.core.api import AAKMeans, MiniBatchAAKMeans

_ESTIMATORS = {
    serialize.KIND_ESTIMATOR_AA: AAKMeans,
    serialize.KIND_ESTIMATOR_MB: MiniBatchAAKMeans,
}


def save_estimator(model, path) -> Path:
    """``model.save(path)`` for either estimator (symmetry with
    ``load_estimator``)."""
    return model.save(path)


def load_estimator(path, device=None):
    """Load an estimator artifact, written by either package, without
    knowing which class wrote it: its ``kind`` picks AAKMeans or
    MiniBatchAAKMeans.  Tensors go to ``device`` (None: CUDA)."""
    meta, _ = serialize.load(path)
    cls = _ESTIMATORS.get(meta.get("kind"))
    if cls is None:
        raise ValueError(
            f"{os.fspath(path)}: kind {meta.get('kind')!r} is not an "
            f"estimator artifact (expected one of {sorted(_ESTIMATORS)})")
    return cls.load(path, device=device)
