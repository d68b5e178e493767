"""The benchmark's own tests: ``python -m pytest -q cobsbench/tests`` from
the root of the checkout. Tests marked ``card`` need a CUDA card and skip
without one; on the card, ``python -m pytest -q -m card cobsbench/tests``."""
import sys
from pathlib import Path

import pytest

_ROOT = Path(__file__).resolve().parents[2]
for _p in (_ROOT / "src", _ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The CUDA card, or a skip: decided when the test runs."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny(tmp_path):
    """The benchmark's spec files over tiny configurations."""
    from cobsbench.tests.tiny import make_root
    return make_root(tmp_path / "spec")
