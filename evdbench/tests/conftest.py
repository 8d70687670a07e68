"""Fixtures of the benchmark's tests: the checkout on ``sys.path``, the
CPU, and the card of the tests marked ``cuda``.

    python -m pytest evdbench/tests            # CPU (from the checkout's root)
    python -m pytest -m cuda evdbench/tests    # on the H100
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture(scope="session", autouse=True)
def _few_threads():
    """Keep each test process to two threads: workers that each take every
    core spin against one another."""
    import torch

    torch.set_num_threads(2)


@pytest.fixture
def cpu():
    import torch

    return torch.device("cpu")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with `python -m pytest -m cuda evdbench/tests` on the H100")
    return torch.device("cuda", 0)
