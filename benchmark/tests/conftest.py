"""The benchmark's own tests: CPU tests at tiny sizes, and tests marked
``cuda`` that need the card (they skip without one).  Run them from the
repository root with ``python -m pytest benchmark/tests -q``."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skipped without "
        "a CUDA device")
