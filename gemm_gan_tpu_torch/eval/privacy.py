"""Privacy metrics: DCR and NNDR.

Counterpart of `gemm_gan_tpu/eval/privacy.py` (`dcr`, `nndr`):
  * DCR: share of synthetic samples strictly closer (L2) to the nearest
    train-real sample than to the nearest test-real sample;
  * NNDR: share of synthetic samples whose 1st/2nd-NN distance ratio
    against train-real is below the same ratio against test-real.
Both over the blocked distances of `eval.knn_pr`. `PrivacyEvaluator` and
cross-modal retrieval are not ported yet.
"""

from __future__ import annotations

import torch

from gemm_gan_tpu_torch.eval.knn_pr import _pairwise_l2sq
from gemm_gan_tpu_torch.utils.device import DeviceLike, as_f32


def _min_dists(gen: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(_pairwise_l2sq(gen, ref).min(dim=1).values)


def _nndr_ratio(gen: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    d = torch.sqrt(_pairwise_l2sq(gen, ref))
    two = torch.topk(d, 2, dim=1, largest=False).values  # two smallest
    return two[:, 0] / two[:, 1]


def dcr(real_data, gen_data, test_data, device: DeviceLike = None) -> float:
    gen = as_f32(gen_data, device)
    with torch.no_grad():
        d_real = _min_dists(gen, as_f32(real_data, gen.device))
        d_test = _min_dists(gen, as_f32(test_data, gen.device))
        return float((d_real < d_test).float().mean())


def nndr(real_data, gen_data, test_data, device: DeviceLike = None) -> float:
    gen = as_f32(gen_data, device)
    with torch.no_grad():
        r_real = _nndr_ratio(gen, as_f32(real_data, gen.device))
        r_test = _nndr_ratio(gen, as_f32(test_data, gen.device))
        return float((r_real < r_test).float().mean())
