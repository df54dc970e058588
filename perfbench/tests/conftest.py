"""The benchmark's own CPU tests (`python -m pytest perfbench/tests -q` from the
root of the checkout). A test that needs the card is marked `card` and
decides inside itself whether one is present."""

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
torch.set_num_threads(2)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
