"""CPU tests of the benchmark: ``python -m pytest perfbench/tests -q`` from
the root of a checkout. Tests marked ``card`` need a CUDA device and skip
without one; whether there is one is decided inside the ``card`` fixture."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark runs on the card")
    return torch.device("cuda", 0)
