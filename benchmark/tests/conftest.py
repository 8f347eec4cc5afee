"""Tests of the benchmark harness.  CPU tests run anywhere; tests marked
``card`` need an NVIDIA card and skip without one:

    python -m pytest benchmark/tests -q              # here, on the CPU
    python -m pytest benchmark/tests -q -m card      # on the H100
"""

import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parent.parent
for p in (str(BENCH_DIR.parent), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs an NVIDIA card; skipped without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark's chip runs need the H100")
    return torch.cuda.get_device_name(0)
