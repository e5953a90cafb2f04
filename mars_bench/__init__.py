"""The benchmark of the PyTorch port (``repro_torch``): one command serves
one cell of ``BENCHMARK.json`` for a fixed window on one card and prints
one JSON line. See ``run.py``."""
