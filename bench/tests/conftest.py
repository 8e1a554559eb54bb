"""Tests of the benchmark (``python -m pytest bench/tests``).

They run on the CPU at small sizes.  Tests marked ``chip`` need a CUDA
card and skip without one, deciding inside the test; on the card they run
with ``python -m pytest bench/tests -m chip``.
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The CUDA device, or a skip where the machine has none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
