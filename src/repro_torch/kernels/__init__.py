"""Hand-written CUDA kernels (``csrc/``), their wrappers and plain versions.

    fused_lloyd  — one Lloyd step in one pass over X (labels, min
                   distances, weighted cluster stats, energy)
    assignment   — nearest centroid only (predict)

Modules import no compiler: a kernel builds at its first launch
(``build.py``).
"""
