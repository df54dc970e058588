"""Visualization: the validation curves of an `Experiment`.

Counterpart of `gemm_gan_tpu/viz.py::plot_curves`. matplotlib is imported
when a figure is drawn, never when this module is imported, so the port
runs where matplotlib is not installed; `matplotlib_available` says whether
it is.
"""

from __future__ import annotations

import importlib.util
from typing import Dict, Optional, Sequence


def matplotlib_available() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_curves(history: Dict[str, Sequence[float]], out_path: Optional[str] = None,
                title: str = "training curves"):
    """Loss/metric curves, one line per key, against the index."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(7, 4))
    for name, values in history.items():
        ax.plot(values, label=name)
    ax.set_xlabel("epoch")
    ax.legend()
    ax.set_title(title)
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return out_path
    return fig
