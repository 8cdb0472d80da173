"""The benchmark's CPU tests: python -m pytest bench_port/tests -q
(from the repository's root).  Tests that need a CUDA card skip inside
the `card` fixture, never at import."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"
