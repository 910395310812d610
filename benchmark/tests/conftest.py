"""The benchmark's CPU tests (``pytest benchmark/tests``). A test marked ``chip`` needs
a CUDA card and skips without one, deciding inside the test."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control's TF32 has no CPU counterpart")
    return "cuda:0"
