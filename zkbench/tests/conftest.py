"""The benchmark's own tests: ``python -m pytest zkbench/tests -q``.

They put ``zkbench/`` and the repository root on the path, as
``zkbench/run.py`` does.  Tests marked ``cuda`` need a card; the
``cuda_device`` fixture skips them elsewhere (decided when a test runs,
never at import).
"""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
for p in (str(HERE.parent), str(HERE.parent.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
