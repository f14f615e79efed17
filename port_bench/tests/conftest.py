"""The benchmark's own tests: `python -m pytest port_bench/tests` from the
repository's root. Tests marked `card` need an NVIDIA card and skip without
one (decided in the `card` fixture)."""

import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

torch.set_num_threads(2)   # test processes share the cores


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skipped without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark's runs need the card")
    return torch.device("cuda:0")
