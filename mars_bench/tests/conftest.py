"""The benchmark's own tests. They run on the CPU (``PYTHONPATH=src
python -m pytest mars_bench/tests`` from the root of the checkout); the
ones marked ``card`` need an NVIDIA card and skip without one."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    """The card; afterwards the run's cyclic garbage (engine, weights) is
    collected and the cached blocks freed, so the next card test starts
    from an empty card."""
    import gc

    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; this host has none")
    yield torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()


@pytest.fixture
def one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
