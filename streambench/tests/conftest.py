"""The benchmark's own tests (not collected by the repository's `tests/`):

    python -m pytest streambench/tests -q

They run on the CPU at tiny sizes; the tests marked `cuda` need the card
and skip elsewhere (decided in a fixture)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips elsewhere")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs the cell on the card")
    return torch.device("cuda")
