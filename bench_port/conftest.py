"""pytest settings of the benchmark's own tests (``bench_port/tests``).

    python -m pytest --confcutdir=bench_port bench_port/tests

runs them on the CPU; those marked ``card`` need a CUDA device and skip
without one (the fixture decides, when the test runs, never at import).
"""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card only")
    return torch.device("cuda")
