"""k-NN manifold precision/recall (Kynkäänniemi et al.) + realism score.

Counterpart of `gemm_gan_tpu/eval/knn_pr.py`: squared L2 pairwise distances,
per-point k-NN radius on the reference manifold, precision = fraction of
eval points inside any reference hypersphere, recall symmetric, realism =
max over (radius / distance) ratios. The distance blocks run on the device
of the inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from gemm_gan_tpu_torch.utils.device import DeviceLike, as_f32


def _pairwise_l2sq(x: torch.Tensor, y: torch.Tensor, block: int = 4096) -> torch.Tensor:
    """Squared L2 distances [N, M] (x² + y² - 2 x.y, clamped at 0), `block`
    rows of x at a time."""
    y2 = (y * y).sum(dim=1)[None, :]
    out = torch.empty(x.shape[0], y.shape[0], dtype=x.dtype, device=x.device)
    for s in range(0, x.shape[0], block):
        xb = x[s:s + block]
        x2 = (xb * xb).sum(dim=1)[:, None]
        out[s:s + block] = torch.clamp(x2 + y2 - 2.0 * (xb @ y.T), min=0.0)
    return out


class ManifoldEstimator:
    """k-NN hypersphere manifold of a feature set."""

    def __init__(self, features, nhood_sizes=(3,), clamp_to_percentile=None,
                 device: DeviceLike = None):
        self.features = as_f32(features, device)
        self.nhood_sizes = tuple(nhood_sizes)
        with torch.no_grad():
            d = _pairwise_l2sq(self.features, self.features)
            # k-th neighbor excluding self: (k+1)-th smallest incl. self-0
            kmax = max(self.nhood_sizes)
            smallest = torch.topk(d, kmax + 1, dim=1, largest=False).values
            self.radii = torch.stack([smallest[:, k] for k in self.nhood_sizes], dim=1)
            if clamp_to_percentile is not None:
                caps = torch.quantile(self.radii, clamp_to_percentile / 100.0, dim=0)
                self.radii = torch.where(self.radii > caps[None, :], 0.0, self.radii)

    def evaluate(self, eval_features, return_realism: bool = False):
        with torch.no_grad():
            ef = as_f32(eval_features, self.features.device)
            d = _pairwise_l2sq(ef, self.features)  # [M, N]
            # inside any reference hypersphere?
            preds = torch.stack([torch.any(d <= self.radii[None, :, i], dim=1)
                                 for i in range(len(self.nhood_sizes))], dim=1)
            batch_predictions = preds.to(torch.int32).cpu().numpy()
            if return_realism:
                realism = torch.max(self.radii[None, :, 0] / torch.clamp(d, min=1e-18), dim=1)
                return batch_predictions, realism.values.cpu().numpy()
        return batch_predictions


def knn_precision_recall_features(ref_features, eval_features, nhood_sizes=(3,),
                                  device: DeviceLike = None):
    ref_manifold = ManifoldEstimator(ref_features, nhood_sizes, device=device)
    eval_manifold = ManifoldEstimator(eval_features, nhood_sizes,
                                      device=ref_manifold.features.device)
    precision = ref_manifold.evaluate(eval_manifold.features).mean(axis=0)
    recall = eval_manifold.evaluate(ref_manifold.features).mean(axis=0)
    return {"precision": precision, "recall": recall}


def get_precision_recall(real_data, fake_data, nb_nn=(10,), device: DeviceLike = None):
    state = knn_precision_recall_features(real_data, fake_data, nhood_sizes=tuple(nb_nn),
                                          device=device)
    return float(state["precision"][0]), float(state["recall"][0])


def get_realism_score(real_data, fake_data, device: DeviceLike = None) -> np.ndarray:
    manifold = ManifoldEstimator(real_data, clamp_to_percentile=50, device=device)
    _, realism = manifold.evaluate(fake_data, return_realism=True)
    return realism
