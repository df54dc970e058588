"""On-device classifiers with an sklearn-style interface.

Counterpart of `gemm_gan_tpu/eval/classifiers.py`.

`MLPClassifier`: Linear, then (hidden layers) BatchNorm with torch's
semantics (batch moments in training, running mean and unbiased running
variance with momentum 0.1 and eps 1e-5 for prediction), ReLU and dropout;
cross-entropy fit by optax's `adamw` (b1 0.9, b2 0.999, eps 1e-8, the decay
added to the Adam update of every parameter) after clipping by global norm.
With `hidden=()` it is the logistic-regression detector of the suite. Each
epoch's order is `np.random.RandomState(seed)`'s permutation, drawn as the
JAX class draws it; the trailing partial batch trains unless it has fewer
than 2 rows. He-normal weights come from a `torch.Generator` seeded with
`seed` (the JAX class's come from `jax.random`, which torch cannot give:
`fit(init_params=...)` starts from given weights instead), and dropout
masks from a generator of its own, so a fit draws nothing from the
process's default generators.

`KNNClassifier`: majority vote of the k nearest (squared L2) training rows,
ties to the first class.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from gemm_gan_tpu_torch.eval.knn_pr import _pairwise_l2sq
from gemm_gan_tpu_torch.utils.device import DeviceLike, as_f32

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
BN_EPS, BN_MOMENTUM = 1e-5, 0.1


def _init_params(generator: torch.Generator, dims: Sequence[int], device) -> list:
    params = []
    for i in range(len(dims) - 1):
        w = torch.randn(dims[i], dims[i + 1], generator=generator) * np.sqrt(2.0 / dims[i])
        params.append({"w": w.to(device), "b": torch.zeros(dims[i + 1], device=device),
                       "gamma": torch.ones(dims[i + 1], device=device),
                       "beta": torch.zeros(dims[i + 1], device=device)})
    return params


def _forward(params, x, stats, train: bool, dropout: float = 0.0,
             generator: Optional[torch.Generator] = None):
    """Logits. In training the hidden layers normalize with the batch's
    moments and update `stats` (running mean, unbiased running variance) in
    place; otherwise they normalize with `stats`."""
    h = x
    n = len(params)
    for i, layer in enumerate(params):
        h = h @ layer["w"] + layer["b"]
        if i == n - 1:
            break
        st = stats[i]
        if train:
            mean = h.mean(dim=0)
            var = h.var(dim=0, unbiased=False)
            with torch.no_grad():
                m = h.shape[0]
                st["mean"].mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * mean)
                st["var"].mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * var * (m / max(m - 1, 1)))
        else:
            mean, var = st["mean"], st["var"]
        h = (h - mean) / torch.sqrt(var + BN_EPS) * layer["gamma"] + layer["beta"]
        h = torch.relu(h)
        if train and dropout > 0:
            keep = torch.rand(h.shape, generator=generator, device=h.device) < 1 - dropout
            h = torch.where(keep, h / (1 - dropout), 0.0)
    return h


class MLPClassifier:
    def __init__(self, hidden: Tuple[int, ...] = (100,), epochs: int = 30,
                 batch_size: int = 128, lr: float = 1e-3, weight_decay: float = 1e-2,
                 dropout: float = 0.1, clip_grad: float = 1.0, seed: int = 42,
                 device: DeviceLike = None):
        self.hidden = tuple(hidden)
        self.epochs = epochs
        self.batch_size = batch_size
        self.lr = lr
        self.weight_decay = weight_decay
        self.dropout = dropout
        self.clip_grad = clip_grad
        self.seed = seed
        self.device = device
        self.params = None
        self.classes_ = None

    def fit(self, X, y, init_params: Optional[Sequence[dict]] = None):
        """`init_params`: per layer {"w" [d_in, d_out], "b", "gamma",
        "beta"} arrays to start from instead of the seeded He-normal draw."""
        X = as_f32(X, self.device)
        dev = X.device
        y = np.asarray(y)
        self.classes_, y_idx = np.unique(y, return_inverse=True)
        n, d = X.shape
        dims = (d, *self.hidden, len(self.classes_))
        gen = torch.Generator().manual_seed(self.seed)
        if init_params is None:
            params = _init_params(gen, dims, dev)
        else:
            params = [{k: torch.tensor(np.asarray(v, np.float32), device=dev)
                       for k, v in layer.items()} for layer in init_params]
        flat = [p for layer in params for p in layer.values()]
        for p in flat:
            p.requires_grad_(True)
        stats = [{"mean": torch.zeros(dims[i + 1], device=dev),
                  "var": torch.ones(dims[i + 1], device=dev)} for i in range(len(dims) - 2)]
        mu = [torch.zeros_like(p) for p in flat]
        nu = [torch.zeros_like(p) for p in flat]
        drop_gen = torch.Generator(device=dev).manual_seed(self.seed)
        yd = torch.as_tensor(y_idx, device=dev)

        bs = min(self.batch_size, n)
        nb, rem = n // bs, n - (n // bs) * bs
        rng = np.random.RandomState(self.seed)
        perms = [rng.permutation(n) for _ in range(self.epochs)]
        count = 0

        def step(idx):
            nonlocal count
            idx = torch.as_tensor(idx, device=dev)
            logits = _forward(params, X.index_select(0, idx), stats, True,
                              self.dropout, drop_gen)
            loss = torch.nn.functional.cross_entropy(logits, yd.index_select(0, idx))
            # the last layer's gamma / beta are unused (zero gradient), as
            # in the JAX class, whose adamw decays them all the same
            grads = torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True)
            with torch.no_grad():
                norm = torch.sqrt(sum((g * g).sum() for g in grads))
                scale = torch.where(norm < self.clip_grad, torch.ones_like(norm),
                                    self.clip_grad / norm)
                grads = [g * scale for g in grads]
                count += 1
                torch._foreach_mul_(mu, ADAM_B1)
                torch._foreach_add_(mu, grads, alpha=1 - ADAM_B1)
                torch._foreach_mul_(nu, ADAM_B2)
                torch._foreach_addcmul_(nu, grads, grads, value=1 - ADAM_B2)
                mu_hat = torch._foreach_div(mu, 1 - ADAM_B1 ** count)
                denom = torch._foreach_div(nu, 1 - ADAM_B2 ** count)
                torch._foreach_sqrt_(denom)
                torch._foreach_add_(denom, ADAM_EPS)
                upd = torch._foreach_div(mu_hat, denom)
                torch._foreach_add_(upd, flat, alpha=self.weight_decay)
                torch._foreach_add_(flat, upd, alpha=-self.lr)

        for perm in perms:
            # batches below 2 rows are skipped: BatchNorm cannot normalize one
            if bs >= 2:
                for k in range(nb):
                    step(perm[k * bs:(k + 1) * bs])
            if rem >= 2:
                step(perm[nb * bs:])
        self.params = [{k: v.detach() for k, v in layer.items()} for layer in params]
        self.stats = stats
        return self

    def predict_proba(self, X):
        X = as_f32(X, self.params[0]["w"].device)
        with torch.no_grad():
            logits = _forward(self.params, X, self.stats, False)
            return torch.softmax(logits, dim=-1).cpu().numpy()

    def predict(self, X):
        return self.classes_[self.predict_proba(X).argmax(axis=1)]

    def score(self, X, y):
        return float((self.predict(X) == np.asarray(y)).mean())


class KNNClassifier:
    """k-NN on the device (the two-sample tests' classifier)."""

    def __init__(self, n_neighbors: int = 5, device: DeviceLike = None):
        self.k = n_neighbors
        self.device = device

    def fit(self, X, y):
        # a device tensor stays where it is: the in-loop validation proxy
        # passes device-resident features
        self.X = as_f32(X, self.device)
        y = np.asarray(y)
        self.classes_, self.y_idx = np.unique(y, return_inverse=True)
        return self

    def predict(self, X):
        # only the [N, k] neighbour indices leave the device
        with torch.no_grad():
            d = _pairwise_l2sq(as_f32(X, self.X.device), self.X)
            idx = torch.topk(d, self.k, dim=1, largest=False).indices.cpu().numpy()
        votes = self.y_idx[idx]
        n_classes = len(self.classes_)
        counts = np.apply_along_axis(lambda r: np.bincount(r, minlength=n_classes), 1, votes)
        return self.classes_[counts.argmax(axis=1)]
