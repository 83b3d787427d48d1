"""The benchmark's CPU tests. They put the benchmark's folder and the
repo root on the import path, and register `card`, the marker of tests
that need a CUDA card (they skip here, deciding inside the test)."""

import os
import sys

import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (os.path.dirname(BENCH), BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

torch.set_num_threads(1)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")
