"""pytest set-up for the benchmark's own tests: the harness modules and
``src/`` on the path, and the ``card`` marker for tests that need a CUDA
card (decided inside the ``card`` fixture, never at import)."""
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
for p in (HERE, HERE.parent / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped where there is none")


@pytest.fixture(autouse=True)
def few_threads():
    """The harness's CPU runs share the machine with other test workers;
    on a card a run keeps the threads it would have."""
    import torch
    if torch.cuda.is_available():
        yield
        return
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
