"""Tests of the benchmark harness.  Run: ``python -m pytest port_bench/tests``.

Tests marked ``card`` need a CUDA card; they skip here, inside the
``card`` fixture, never while a module is imported.  On the card:
``python -m pytest port_bench/tests -m card``.
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture(autouse=True)
def few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
