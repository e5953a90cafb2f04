"""Benchmarks of the PyTorch port (``src/repro_torch``): ``common`` is the
port's copy of ``benchmarks/common.py`` over the port's simulator, and
``serving_bench`` serves the generator's agentic trace live on
``TorchBackend``. Nothing here imports ``jax`` or ``repro``."""
