"""Benchmarks of the PyTorch/CUDA port (``src/repro_torch``), beside the
reference's ``benchmarks/``.  Run from the repo root with the port on the
path, on the card by default:

    PYTHONPATH=src python -m benchmarks_torch.table3_vs_lloyd
    PYTHONPATH=src python -m benchmarks_torch.table2_dynamic_m

Each writes a ``BENCH_port_*.json`` at the repo root.
"""
