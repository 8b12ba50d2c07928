"""Hand-written CUDA kernels (``csrc/``), their wrappers and plain versions.

    fused_lloyd  — one Lloyd step in one call (labels, min
                   distances, weighted cluster stats, energy); with
                   ``bounds=`` the variant that skips centroid groups
    assignment   — nearest centroid only (predict, the pallas engine)
    update       — weighted cluster stats of known labels (the pallas
                   engine, every kernel backend's ``stats_fn``)
    ops          — the reference's dispatch layer over the three
                   (``use_pallas=``) and ``pallas_lloyd_ops()``

Modules import no compiler: a kernel builds at its first launch
(``build.py``).
"""
