"""WGAN-GP generator and critic.

Counterpart of `gemm_gan_tpu/models/gan.py`: each owns a fusion module
(selected by config) and an MLP trunk over [z ∥ cond] (generator) or
[x ∥ cond] (critic, one score per sample). The `embed_cond` / `score` split
is kept, so one condition embedding can serve every z drawn for it
(`serving.GeneratorServer.sample_all`), and the gradient penalty
differentiates only the critic's trunk twice (`train/wgan.py`).

Initialisation follows Flax's distributions (the bits cannot match):
lecun-normal kernels (truncated normal, std sqrt(1/fan_in) corrected for
the truncation at two standard deviations), zero biases, unit LayerNorm
scales, a truncated-normal(0.02) CLS token, and embedding tables from
`default_embed_init` (an untruncated normal, std sqrt(1/features)).

Params stay f32. `compute_dtype="bfloat16"` runs the fusion and the
trunks' hidden Linears (and BatchNorms, `use_batchnorm`) in bf16 (the
trunks' heads, LayerNorms and the condition vector `embed_cond` returns
stay f32), as the JAX modules with `dtype=jnp.bfloat16`;
`fusion.flash_mxu_bf16` rounds the flash kernels' product operands to
bf16. Every fusion kind of the JAX package is served.

`mesh` (a `parallel.mesh.Mesh`) places the module on this rank's share of
a (data, model) mesh, as the JAX modules' `mesh`: the gene-dimension
Linears hold their `model` blocks (`parallel.sharding.shard_module_`),
BatchNorms take the global batch's statistics over `data`, and with
`fusion.sequence_parallel` the patch self-attention runs as ring attention
over `model`. The random init is drawn full-size first, so a sharded module
holds the blocks of the unsharded one from the same generator.
Modules are built in train mode (dropout active), as `nn.Module`s are;
`GeneratorServer` switches its generator to eval mode. Dropout follows the
module's mode (JAX's `deterministic`); BatchNorm follows the `train`
argument of `score` / `forward` (JAX's `train`), False by default.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from gemm_gan_tpu_torch.config import ModelConfig
from gemm_gan_tpu_torch.fusion.modules import build_fusion, cond_dim_of
from gemm_gan_tpu_torch.ops.linear import DTYPES
from gemm_gan_tpu_torch.ops.mlp import MLPTrunk
from gemm_gan_tpu_torch.utils.device import DeviceLike, resolve_device

# standard deviation of a unit normal truncated to [-2, 2]
_TRUNCATED_STD = 0.87962566103423978


def check_supported(cfg: ModelConfig) -> None:
    """Raise for settings the port does not serve."""
    if cfg.compute_dtype not in DTYPES:
        raise ValueError(f"compute_dtype={cfg.compute_dtype!r} not in {sorted(DTYPES)}")


def init_flax_like_(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Re-initialise `module` in place with Flax's default distributions."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                std = m.in_features ** -0.5 / _TRUNCATED_STD
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Embedding):
                nn.init.normal_(m.weight, std=m.embedding_dim ** -0.5, generator=generator)
        for name, p in module.named_parameters():
            if name.endswith("cls_token"):
                nn.init.trunc_normal_(p, std=0.02, a=-0.04, b=0.04, generator=generator)


def _place_on_mesh_(module: nn.Module, cfg: ModelConfig, mesh) -> None:
    from gemm_gan_tpu_torch.ops.attention import MaskedMultiHeadAttention
    from gemm_gan_tpu_torch.ops.batchnorm import BatchNorm
    from gemm_gan_tpu_torch.parallel.sharding import shard_module_

    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.mesh = mesh
        elif isinstance(m, MaskedMultiHeadAttention) and cfg.fusion.sequence_parallel:
            m.mesh = mesh
    shard_module_(module, mesh, cfg.n_genes)


class _Conditioned(nn.Module):
    """Shared base: a fusion module and an MLP trunk over [x ∥ cond], built
    on `device` (CUDA unless "cpu" is asked for) with Flax-like random
    weights drawn from `generator` (a CPU `torch.Generator`; the default
    RNG when None)."""

    def __init__(self, cfg: ModelConfig, in_features: int, hidden_dims, out_dim: int,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None, mesh=None):
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device) if mesh is None else mesh.device
        self.cfg = cfg
        dtype = DTYPES[cfg.compute_dtype]
        self.fusion = build_fusion(cfg.fusion, dtype)
        self.trunk = MLPTrunk(in_features + cond_dim_of(cfg.fusion), hidden_dims,
                              out_dim, negative_slope=cfg.negative_slope,
                              use_batchnorm=cfg.use_batchnorm, dtype=dtype)
        init_flax_like_(self, generator)
        self.mesh = mesh
        if mesh is not None:
            _place_on_mesh_(self, cfg, mesh)
        self.to(dev)

    def embed_cond(self, cond: Optional[Dict[str, torch.Tensor]]) -> Optional[torch.Tensor]:
        """Fusion half: conditioning dict -> [B, cond_dim] f32 (or None)."""
        if self.fusion is None:
            return None
        if cond is None:
            raise ValueError(
                f"fusion kind {self.cfg.fusion.kind!r} requires conditioning inputs "
                f"(batch keys like 'tokens'/'patches'), got none")
        return self.fusion(cond).float()

    def score(self, x: torch.Tensor, cvec: Optional[torch.Tensor] = None,
              train: bool = False) -> torch.Tensor:
        """Trunk half: [B, in_features] (+ fixed cond vector) -> [B, out_dim].
        `train` is JAX's flag: a BatchNorm trunk (`use_batchnorm`) then
        normalizes by the batch's statistics and updates its running ones."""
        h = x if cvec is None else torch.cat([x, cvec], dim=-1)
        return self.trunk(h, train)

    def forward(self, x: torch.Tensor, cond: Optional[Dict[str, torch.Tensor]] = None,
                train: bool = False) -> torch.Tensor:
        return self.score(x, self.embed_cond(cond), train)


class Generator(_Conditioned):
    """z [B, latent] (+ cond dict) -> gene-expression vector [B, n_genes]."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None, mesh=None):
        super().__init__(cfg, cfg.latent_dim, cfg.gen_dims, cfg.n_genes,
                         device=device, generator=generator, mesh=mesh)


class Critic(_Conditioned):
    """Gene-expression vector [B, n_genes] (+ cond dict) -> score [B, 1].

    The gradient penalty differentiates w.r.t. the expression only, so the
    engine calls `embed_cond` once outside the penalty's inner grad and only
    the trunk is differentiated twice."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None, mesh=None):
        super().__init__(cfg, cfg.n_genes, cfg.disc_dims, 1,
                         device=device, generator=generator, mesh=mesh)
