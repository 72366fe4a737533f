"""The benchmark's own tests: ``python -m pytest benchmark/tests -q``.

Tests that need a CUDA card carry the ``card`` marker and decide inside a
fixture whether there is one, so on the CPU they skip; on a card run them
with ``python -m pytest benchmark/tests -q -m card``.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(Path(__file__).resolve().parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session")
def tiny_copy(tmp_path_factory):
    import tiny

    return tiny.make_copy(tmp_path_factory.mktemp("perfbench") / "checkout")
