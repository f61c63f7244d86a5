"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
checkout's root (CPU), ``-m gpu`` on a card. They import the harness as the
package ``benchmark`` from the checkout's root."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))


@pytest.fixture
def card():
    """The first CUDA card; skips where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
