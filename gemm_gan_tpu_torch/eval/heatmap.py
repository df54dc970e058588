"""Gene-gene correlation heatmap comparison.

Counterpart of `gemm_gan_tpu/eval/heatmap.py`: the correlation matrices of
real and generated expression, their MSE, and a difference heatmap. Each
matrix is one standardized-column GEMM on the device in f32 (full-f32
products, as `eval.gamma`); matplotlib is imported only by `plot_diff`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gemm_gan_tpu_torch.utils.device import DeviceLike, as_f32, host
from gemm_gan_tpu_torch.viz import _plt


@torch.no_grad()
def _corrcoef_cols(x: torch.Tensor) -> torch.Tensor:
    xc = x - x.mean(dim=0)
    std = torch.sqrt((xc * xc).mean(dim=0))
    xs = xc / torch.where(std > 0, std, 1.0)
    return (xs.T @ xs) / x.shape[0]


class CorrelationEvaluator:
    def __init__(self, real, gen, device: DeviceLike = None):
        real = as_f32(real, device)
        self.corr_real = host(_corrcoef_cols(real))
        self.corr_gen = host(_corrcoef_cols(as_f32(gen, real.device)))

    def mse(self) -> float:
        return float(np.mean((self.corr_real - self.corr_gen) ** 2))

    def plot_diff(self, out_path: Optional[str] = None):
        plt = _plt()
        diff = np.abs(self.corr_real - self.corr_gen)
        fig, ax = plt.subplots(figsize=(6, 5))
        im = ax.imshow(diff, cmap="viridis")
        fig.colorbar(im, ax=ax)
        ax.set_title(f"|corr_real - corr_gen|, MSE={self.mse():.4f}")
        if out_path:
            fig.savefig(out_path, dpi=120, bbox_inches="tight")
            plt.close(fig)
            return out_path
        return fig
