"""The benchmark's CPU tests: the checkout and the program under test
(``src``) on the path. Tests marked ``cuda`` decide in a fixture whether a
card is there."""
import sys
from pathlib import Path

import pytest

_ROOT = Path(__file__).resolve().parents[1]
for p in (str(_ROOT / "src"), str(_ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture(autouse=True)
def _few_threads():
    """Two intra-op threads while a benchmark test runs, restored after:
    the suite's workers share the host's cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
