"""The benchmark's own tests: ``python -m pytest hbbench/tests`` from the
root of the repository.  Tests marked ``cuda`` need a card and skip
without one (the card is looked for in a fixture, never at import)."""
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
