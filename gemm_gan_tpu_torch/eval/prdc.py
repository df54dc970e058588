"""PRDC (precision / recall / density / coverage) on the device.

Counterpart of `gemm_gan_tpu/eval/prdc.py`: L1 pairwise distances, k-th NN
radius per manifold (the k+1-th smallest including self), then the four
indicator statistics; and the numpy golden `compute_prdc_np`.
"""

from __future__ import annotations

import numpy as np
import torch

from gemm_gan_tpu_torch.utils.device import DeviceLike, as_f32


def _pairwise_l1(x: torch.Tensor, y: torch.Tensor, block: int = 512,
                 feat_block: int = 256) -> torch.Tensor:
    """[N, M] L1 distances, blocked on rows AND features to bound memory.

    L1 has no matmul identity, so the broadcast |x_i - y_j| tensor is
    unavoidable, but it never materializes at full width: [rows, M, D] at
    the canonical test-block shape is hundreds of GB. Features are summed
    `feat_block` at a time, so the largest intermediate is block x M x
    feat_block."""
    out = torch.zeros(x.shape[0], y.shape[0], dtype=x.dtype, device=x.device)
    for s in range(0, x.shape[0], block):
        xb = x[s:s + block]
        acc = out[s:s + block]
        for f in range(0, x.shape[1], feat_block):
            acc += (xb[:, None, f:f + feat_block] - y[None, :, f:f + feat_block]).abs().sum(-1)
    return out


def _kth_value(d: torch.Tensor, k: int) -> torch.Tensor:
    """k-th smallest along the last axis (1-indexed k)."""
    return torch.topk(d, k, dim=-1, largest=False).values[..., k - 1]


def compute_nearest_neighbour_distances(features, nearest_k: int, block: int = 512,
                                        device: DeviceLike = None) -> torch.Tensor:
    f = as_f32(features, device)
    # the k+1-th smallest, the self-distance 0 included
    return _kth_value(_pairwise_l1(f, f, block), nearest_k + 1)


def compute_prdc(real_features, fake_features, nearest_k: int, block: int = 512,
                 device: DeviceLike = None):
    real = as_f32(real_features, device)
    fake = as_f32(fake_features, real.device)
    # sets smaller than k+1 have no k-th neighbour: clamp so tiny sets
    # degrade instead of crashing; a 1-sample set has no neighbour at all
    if real.shape[0] < 2 or fake.shape[0] < 2:
        return {"precision": 0.0, "recall": 0.0, "density": 0.0, "coverage": 0.0}
    nearest_k = max(1, min(nearest_k, real.shape[0] - 1, fake.shape[0] - 1))
    with torch.no_grad():
        real_nnd = compute_nearest_neighbour_distances(real, nearest_k, block)
        fake_nnd = compute_nearest_neighbour_distances(fake, nearest_k, block)
        d_rf = _pairwise_l1(real, fake, block)  # [N_real, N_fake]
        inside = d_rf < real_nnd[:, None]
        precision = inside.any(dim=0).float().mean()
        recall = (d_rf < fake_nnd[None, :]).any(dim=1).float().mean()
        density = inside.sum(dim=0).float().mean() / nearest_k
        coverage = (d_rf.min(dim=1).values < real_nnd).float().mean()
    return {"precision": float(precision), "recall": float(recall),
            "density": float(density), "coverage": float(coverage)}


# ------------------------------------------------------------ numpy golden
def compute_prdc_np(real_features, fake_features, nearest_k: int):
    """Numpy golden reference (mirrors the cited formulas exactly)."""
    def pair(a, b):
        return np.abs(a[:, None, :] - b[None, :, :]).sum(-1)

    def nnd(a):
        d = pair(a, a)
        part = np.argpartition(d, nearest_k + 1, axis=-1)[..., : nearest_k + 1]
        return np.take_along_axis(d, part, axis=-1).max(-1)

    real_nnd, fake_nnd = nnd(real_features), nnd(fake_features)
    d_rf = pair(real_features, fake_features)
    return {
        "precision": float((d_rf < real_nnd[:, None]).any(0).mean()),
        "recall": float((d_rf < fake_nnd[None, :]).any(1).mean()),
        "density": float((d_rf < real_nnd[:, None]).sum(0).mean() / nearest_k),
        "coverage": float((d_rf.min(1) < real_nnd).mean()),
    }
