"""The benchmark's tests: on the CPU, except those marked ``cuda``.

Run from the checkout's root: ``python -m pytest cctbench/tests``.  The
tests marked ``cuda`` skip without a card; on the card they run with the
rest.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")
