"""The benchmark's plain references. A model is found by its architecture's
name, as a configuration file gives it: `reference/<architecture>.py`."""

import importlib
from types import ModuleType


def model(architecture: str) -> ModuleType:
    """The reference module of `architecture`: `Net`, `param_shapes` and
    `init_params` (see `film_cross_attention.py`)."""
    return importlib.import_module(f"perfbench.reference.{architecture}")
