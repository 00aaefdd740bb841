"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``run.py`` runs one cell once; ``BENCHMARK.json`` at the root of the
repository lists the cells, and everything that belongs to one
configuration, traffic mix or per-layer metric sits in a file of its own
here, found by its name (``lib/manifest.py``).
"""
