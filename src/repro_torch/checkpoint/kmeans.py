"""Persistence facade (counterpart of ``repro.checkpoint.kmeans``).

What a preemptible job calls around the segmented drivers: the newest
snapshot of a run directory and the "fresh start or resume" decision in
one line, and estimator artifacts loaded without knowing which class
wrote them.

    ckpt_dir = "runs/run7"
    res = aa_kmeans(x, c0, cfg, checkpoint_every=50,
                    checkpoint_dir=ckpt_dir,
                    resume_from=latest_snapshot(ckpt_dir))  # None at first

    save_estimator(model, "model.npz")
    model = load_estimator("model.npz")          # on CUDA
    model = load_estimator("model.npz", device="cpu")

Run directories and artifacts are the reference's: either package reads
the other's.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Optional

from repro_torch.core import serialize
from repro_torch.core.api import AAKMeans, MiniBatchAAKMeans
from repro_torch.runtime.writer import read_manifest


def latest_snapshot(ckpt_dir) -> Optional[Path]:
    """The newest snapshot of a segmented run's directory, or None when
    there is none yet: the value to pass to ``resume_from=``.

    The directory's ``manifest.json`` names it; without a usable
    manifest, or when the file it names is gone, the directory is
    scanned for ``it_<step>.npz`` names (a crashed writer's
    ``*.npz.tmp`` does not match) and the newest is picked by the parsed
    step, never by name (it_9 is older than it_10)."""
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    m = read_manifest(d)
    if m is not None and m.get("latest"):
        p = d / m["latest"]
        if p.exists():
            return p
    snaps = []
    for p in d.glob("it_*.npz*"):
        match = re.fullmatch(r"it_(\d+)\.npz", p.name)
        if match:
            snaps.append((int(match.group(1)), p))
    return max(snaps, key=lambda sp: sp[0])[1] if snaps else None


def resume_point(ckpt_dir) -> tuple[Optional[Path], Optional[dict]]:
    """(path, meta) of the newest snapshot, or (None, None).  The meta
    holds what a scheduler logs on a restart: the iteration, trip or
    epoch counter ``t``, ``k`` and the engine's name."""
    p = latest_snapshot(ckpt_dir)
    if p is None:
        return None, None
    meta, _ = serialize.load(p)
    return p, meta


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
