"""Settings of the benchmark's own tests: the repository root on the path,
one torch thread, and the ``cuda`` marker for the tests that need a card
(each decides inside the test, never at import)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    import torch

    torch.set_num_threads(1)
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (hand-written kernels); skips without one")
