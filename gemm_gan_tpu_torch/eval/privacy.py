"""Privacy metrics: DCR, NNDR, cross-modal retrieval accuracy.

Counterpart of `gemm_gan_tpu/eval/privacy.py`:
  * DCR: share of synthetic samples strictly closer (L2) to the nearest
    train-real sample than to the nearest test-real sample;
  * NNDR: share of synthetic samples whose 1st/2nd-NN distance ratio
    against train-real is below the same ratio against test-real;
  * retrieval accuracy: top-1 cross-modal retrieval (cosine similarity and
    `torch.topk` on the device) of patch / text embeddings for generated
    profiles' embeddings, scored by label agreement;
  * `PrivacyEvaluator`: DCR / NNDR shares and means over a run's test_*
    dump directories.
The distances are the blocked ones of `eval.knn_pr`.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from gemm_gan_tpu_torch.eval.knn_pr import _pairwise_l2sq
from gemm_gan_tpu_torch.utils.device import DeviceLike, as_f32, host


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


@torch.no_grad()
def retrieve_cross_modal(query_emb, gallery_emb, top_k: int = 1, device: DeviceLike = None):
    """Cosine-similarity retrieval: (indices, scores) of the `top_k` gallery
    items per query, as numpy arrays."""
    q = as_f32(query_emb, device)
    g = as_f32(gallery_emb, q.device)
    q = q / torch.clamp(torch.linalg.norm(q, dim=1, keepdim=True), min=1e-12)
    g = g / torch.clamp(torch.linalg.norm(g, dim=1, keepdim=True), min=1e-12)
    scores, idx = torch.topk(q @ g.T, top_k, dim=1)
    return host(idx), host(scores)


def retrieval_accuracy(gen_embeddings, gen_labels, real_labels, real_patch_embeddings,
                       real_text_embeddings, device: DeviceLike = None):
    """(image, text) label agreement of top-1 cross-modal retrieval.
    `real_patch_embeddings` is a list of [P_i, D] arrays, one per real case."""
    patches_labels = np.concatenate([np.full(p.shape[0], real_labels[i])
                                     for i, p in enumerate(real_patch_embeddings)])
    patches_embeddings = np.concatenate(list(real_patch_embeddings), axis=0)

    idx, _ = retrieve_cross_modal(gen_embeddings, patches_embeddings, 1, device)
    acc_image = float((patches_labels[idx[:, 0]] == np.asarray(gen_labels)).mean())

    idx, _ = retrieve_cross_modal(gen_embeddings, real_text_embeddings, 1, device)
    acc_text = float((np.asarray(real_labels)[idx[:, 0]] == np.asarray(gen_labels)).mean())
    return acc_image, acc_text


class PrivacyEvaluator:
    """DCR / NNDR over each test_* dump directory of `results_path`.

    Two flavours, as in the JAX package:
      * `dcr_mean` / `nndr_mean`: the mean 1-NN L2 distance of the generated
        profiles to the directory's `data_real` (smaller: closer to the
        training sample), and the mean 1st/2nd-NN distance ratio against it;
      * `dcr` / `nndr`: the shares against the directory's `test_real`.
    `train_real` replaces each directory's `data_real` as the real
    reference. A directory that lacks one of the arrays is skipped."""

    def __init__(self, results_path: str, device: DeviceLike = None):
        self.results_dirs = sorted(glob.glob(os.path.join(results_path, "test_*")))
        self.device = device
        self.scores: dict = {}

    def evaluate(self, train_real: np.ndarray = None) -> dict:
        out = {"dcr": [], "nndr": [], "dcr_mean": [], "nndr_mean": []}
        for d in self.results_dirs:
            try:
                gen = np.load(os.path.join(d, "data_gen.npy"))
                test_real = np.load(os.path.join(d, "test_real.npy"))
                real = (train_real if train_real is not None
                        else np.load(os.path.join(d, "data_real.npy")))
            except FileNotFoundError:
                continue  # a nonconforming dump dir: skip it, never abort the scan
            out["dcr"].append(dcr(real, gen, test_real, device=self.device))
            out["nndr"].append(nndr(real, gen, test_real, device=self.device))
            g = as_f32(gen, self.device)
            with torch.no_grad():
                ref = as_f32(real, g.device)
                out["dcr_mean"].append(float(_min_dists(g, ref).mean()))
                out["nndr_mean"].append(float(_nndr_ratio(g, ref).mean()))
        self.scores = {k: (float(np.mean(v)), float(np.std(v))) for k, v in out.items() if v}
        return self.scores

    def report(self) -> dict:
        """Print mean ± std per metric."""
        for k, (m, s) in self.scores.items():
            print(f"{k}: {m:.4f} ± {s:.4f}")
        return self.scores
