"""Contrastive projection heads and their cross-modal alignment training.

Counterpart of `gemm_gan_tpu/encoders/contrastive.py`: two linear heads
over the frozen UNI (image) and ModernBERT (text) embeddings into a shared
`emb_dim` space, each output unit-normalized, with a learnable
log-temperature, trained with the symmetric InfoNCE (CLIP) objective.
The optimizer is the port's AdamW with optax's `adamw` defaults (b1 0.9,
b2 0.999, eps 1e-8, decoupled weight decay on every parameter), at a
constant rate.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from gemm_gan_tpu_torch.config import TrainConfig
from gemm_gan_tpu_torch.convert import flax_to_state_dict
from gemm_gan_tpu_torch.encoders.vit import random_init_
from gemm_gan_tpu_torch.train.schedules import ScheduledOptimizer
from gemm_gan_tpu_torch.utils.device import DeviceLike, host, resolve_device

# optax.adamw's defaults
ADAMW_B1, ADAMW_B2 = 0.9, 0.999


@dataclasses.dataclass(frozen=True)
class ContrastiveConfig:
    image_dim: int = 1024   # UNI embedding dim
    text_dim: int = 768     # ModernBERT embedding dim
    emb_dim: int = 128      # shared projection space
    temperature_init: float = 0.07
    learn_temperature: bool = True
    lr: float = 1e-4
    weight_decay: float = 0.01


def _unit(z: torch.Tensor) -> torch.Tensor:
    return z / torch.linalg.vector_norm(z, dim=-1, keepdim=True).clamp_min(1e-8)


class ProjectionPair(nn.Module):
    """Two linear heads into the shared space, and the log-temperature."""

    def __init__(self, cfg: ContrastiveConfig):
        super().__init__()
        self.cfg = cfg
        self.image_proj = nn.Linear(cfg.image_dim, cfg.emb_dim)
        self.text_proj = nn.Linear(cfg.text_dim, cfg.emb_dim)
        self.log_temperature = (nn.Parameter(torch.tensor(float(np.log(cfg.temperature_init))))
                                if cfg.learn_temperature else None)

    def forward(self, image_emb: torch.Tensor, text_emb: torch.Tensor):
        t = (torch.exp(self.log_temperature) if self.log_temperature is not None
             else torch.tensor(self.cfg.temperature_init, device=image_emb.device))
        return self.project_image(image_emb), self.project_text(text_emb), t

    def project_image(self, image_emb: torch.Tensor) -> torch.Tensor:
        return _unit(self.image_proj(image_emb))

    def project_text(self, text_emb: torch.Tensor) -> torch.Tensor:
        return _unit(self.text_proj(text_emb))


def info_nce(zi: torch.Tensor, zt: torch.Tensor, temperature) -> torch.Tensor:
    """Symmetric InfoNCE over in-batch negatives (the CLIP objective)."""
    logits = zi @ zt.T / temperature
    labels = torch.arange(zi.shape[0], device=zi.device)
    return 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))


class ContrastiveEngine:
    """Trains the projection pair on (image_emb, text_emb) pairs on `device`
    (the CUDA card unless "cpu"). A state is {"model", "opt", "step"}."""

    def __init__(self, cfg: ContrastiveConfig, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)

    def _state(self, model: ProjectionPair) -> Dict[str, Any]:
        c = self.cfg
        train = dataclasses.replace(TrainConfig(), optimizer="adamw", adam_b1=ADAMW_B1,
                                    adam_b2=ADAMW_B2, weight_decay=c.weight_decay)
        opt = ScheduledOptimizer(model.parameters(), train, c.lr, 1,
                                 schedule=lambda count: c.lr)
        return {"model": model, "opt": opt, "step": 0}

    def init_state(self, seed: int) -> Dict[str, Any]:
        """A fresh pair (seeded random heads, zero biases)."""
        model = ProjectionPair(self.cfg)
        random_init_(model, torch.Generator().manual_seed(seed))
        return self._state(model.to(self.device))

    def state_from_flax(self, params: Mapping) -> Dict[str, Any]:
        """A state whose pair carries the JAX `ProjectionPair`'s Flax params,
        with a fresh optimizer."""
        model = ProjectionPair(self.cfg)
        model.load_state_dict(flax_to_state_dict(params))
        return self._state(model.to(self.device))

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32) if not isinstance(x, torch.Tensor)
                               else x, dtype=torch.float32, device=self.device)

    def step(self, state: Dict[str, Any], image_emb, text_emb) -> Tuple[Dict[str, Any], float]:
        model = state["model"]
        params = list(model.parameters())
        loss = info_nce(*model(self._tensor(image_emb), self._tensor(text_emb)))
        grads = torch.autograd.grad(loss, params)
        state["opt"].apply(grads)
        return {**state, "step": state["step"] + 1}, float(loss.detach())

    def fit(self, state: Dict[str, Any], epochs: int, batches_fn) -> Dict[str, Any]:
        for _ in range(epochs):
            for img, txt in batches_fn():
                state, _ = self.step(state, img, txt)
        return state

    @torch.no_grad()
    def project(self, state: Dict[str, Any], image_emb=None, text_emb=None):
        """The unit projections (numpy) of the given embeddings: one array,
        or (image, text) when both are given."""
        model = state["model"]
        out = []
        if image_emb is not None:
            out.append(host(model.project_image(self._tensor(image_emb))))
        if text_emb is not None:
            out.append(host(model.project_text(self._tensor(text_emb))))
        return out[0] if len(out) == 1 else tuple(out)
