"""Hand-written CUDA kernels (``csrc/``), their wrappers and plain versions.

    fused_lloyd  — one Lloyd step in one pass over X (labels, min
                   distances, weighted cluster stats, energy); with
                   ``bounds=`` the variant that skips centroid groups
    assignment   — nearest centroid only (predict, the pallas engine)
    update       — weighted cluster stats of known labels (the pallas
                   engine, every kernel backend's ``stats_fn``)

Modules import no compiler: a kernel builds at its first launch
(``build.py``).
"""
