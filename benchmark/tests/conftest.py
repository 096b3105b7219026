"""The benchmark's own tests (CPU, with `cuda`-marked ones for the card):

    python -m pytest benchmark/tests -q              # here, on the CPU
    python -m pytest benchmark/tests -q -m cuda      # on a machine with a card
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where none is present")
