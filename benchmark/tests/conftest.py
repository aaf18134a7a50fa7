"""The benchmark's CPU tests: ``python -m pytest benchmark/tests -q``.
Tests that need a CUDA card carry the ``card`` marker and skip without
one (decided inside the test)."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    import torch

    # leave cores to the recorder process of the live cell
    torch.set_num_threads(min(torch.get_num_threads(), 4))
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")
