"""Vision Transformer in timm's layout (the UNI patch encoder).

Counterpart of `gemm_gan_tpu/encoders/vit.py`: timm's `vision_transformer`
ViT-L/16 with a class token, learned position embeddings and LayerScale,
run over tissue tiles to give 1024-d patch embeddings. The module's
parameter names are timm's (`patch_embed.proj`, `cls_token`, `pos_embed`,
`blocks.{i}.{norm1, attn.qkv, attn.proj, ls1.gamma, norm2, mlp.fc1,
mlp.fc2, ls2.gamma}`, `norm`), so a UNI state dict loads with
`load_state_dict(strict=True)`; `from_hf_state_dict` renames an HF
`ViTModel` one (q, k, v fused into qkv).

Arithmetic as the JAX module's: fused QKV, LayerScale, exact GELU, f32
LayerNorms at eps 1e-6, CLS pooling, NHWC input. Attention is plain
`torch.matmul` with f32 products (the JAX einsums' `preferred_element_type`)
and an f32 softmax; it reaches no kernel. `dtype=torch.bfloat16` computes
the patch embedding and every Dense in bf16 as Flax does (`ops/linear.py`'s
rules: operands cast, product rounded to bf16, bias added in bf16), and the
residual stream follows JAX's type promotion (LayerScale's f32 gamma makes
it f32 after the first block).

At an image size other than `img_size` the grid position embeddings are
resampled as the JAX module does with `jax.image.resize(..., "cubic",
antialias=True)`: Keys' cubic kernel (a = -0.5), weights renormalized over
the in-range taps, the kernel widened on downscale. `F.interpolate`'s
bicubic uses a = -0.75 and clamps at the edges, so it is not used.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from gemm_gan_tpu_torch.utils.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class ViTParams:
    """Architecture hyperparameters. Defaults = ViT-L/16 (UNI)."""

    img_size: int = 224
    patch_size: int = 16
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    layerscale_init: Optional[float] = 1e-5  # UNI uses LayerScale; None disables
    norm_eps: float = 1e-6
    qkv_bias: bool = True

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2


def dense(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
          dtype: torch.dtype) -> torch.Tensor:
    """Flax's `nn.Dense(dtype=dtype)` with f32 params: in f32 one fused
    product; in bf16 the operands cast, the product rounded to bf16, then
    the bias added in bf16."""
    if dtype == torch.float32:
        return F.linear(x.float(), weight, bias)
    y = F.linear(x.to(dtype), weight.to(dtype))
    return y if bias is None else y + bias.to(dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out_dtype: torch.dtype,
              allow: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v over [B, H, L, D], as the JAX encoders'
    einsums: both products of the operands' values in f32, the softmax in
    f32, the weights rounded to v's dtype, the output cast to `out_dtype`.
    `allow` [.., Lq, Lk] bool masks logits to -1e30 where False."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    if allow is not None:
        logits = torch.where(allow, logits, -1e30)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(w.float(), v.float()).to(out_dtype)


class _LayerScale(nn.Module):
    def __init__(self, dim: int, init: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init)))


class _Attention(nn.Module):
    def __init__(self, p: ViTParams):
        super().__init__()
        self.num_heads = p.num_heads
        self.qkv = nn.Linear(p.hidden_size, 3 * p.hidden_size, bias=p.qkv_bias)
        self.proj = nn.Linear(p.hidden_size, p.hidden_size)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        B, L, E = x.shape
        H = self.num_heads
        qkv = dense(x, self.qkv.weight, self.qkv.bias, dtype)
        q, k, v = qkv.reshape(B, L, 3, H, E // H).permute(2, 0, 3, 1, 4)
        out = attention(q, k, v, x.dtype).transpose(1, 2).reshape(B, L, E)
        return dense(out, self.proj.weight, self.proj.bias, dtype)


class _Mlp(nn.Module):
    def __init__(self, p: ViTParams):
        super().__init__()
        hidden = int(p.hidden_size * p.mlp_ratio)
        self.fc1 = nn.Linear(p.hidden_size, hidden)
        self.fc2 = nn.Linear(hidden, p.hidden_size)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h = F.gelu(dense(x, self.fc1.weight, self.fc1.bias, dtype))
        return dense(h, self.fc2.weight, self.fc2.bias, dtype)


class _Block(nn.Module):
    def __init__(self, p: ViTParams):
        super().__init__()
        self.norm1 = nn.LayerNorm(p.hidden_size, eps=p.norm_eps)
        self.attn = _Attention(p)
        self.norm2 = nn.LayerNorm(p.hidden_size, eps=p.norm_eps)
        self.mlp = _Mlp(p)
        scale = p.layerscale_init is not None
        self.ls1 = _LayerScale(p.hidden_size, p.layerscale_init) if scale else None
        self.ls2 = _LayerScale(p.hidden_size, p.layerscale_init) if scale else None

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h = self.attn(self.norm1(x.float()), dtype)
        if self.ls1 is not None:
            h = h * self.ls1.gamma
        x = x + h
        h = self.mlp(self.norm2(x.float()), dtype)
        if self.ls2 is not None:
            h = h * self.ls2.gamma
        return x + h


class _PatchEmbed(nn.Module):
    def __init__(self, p: ViTParams):
        super().__init__()
        self.patch_size = p.patch_size
        self.proj = nn.Conv2d(3, p.hidden_size, p.patch_size, stride=p.patch_size)

    def forward(self, images: torch.Tensor, dtype: torch.dtype):
        """[B, H, W, 3] -> ([B, gh * gw, E], gh, gw): the stride-p conv as
        one Dense over each patch's (channel, row, column) pixels."""
        B, ih, iw, C = images.shape
        s = self.patch_size
        gh, gw = ih // s, iw // s
        x = images[:, :gh * s, :gw * s].reshape(B, gh, s, gw, s, C)
        x = x.permute(0, 1, 3, 5, 2, 4).reshape(B, gh * gw, C * s * s)
        w = self.proj.weight.reshape(self.proj.weight.shape[0], -1)
        return dense(x, w, self.proj.bias, dtype), gh, gw


def cubic_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] float32 weights of `jax.image.resize`'s "cubic" method
    (antialias=True) along one axis: Keys' kernel at a = -0.5 over the
    sample positions (i + 0.5) * n_in / n_out - 0.5, widened by n_in /
    n_out on downscale, each column renormalized to sum to 1, columns whose
    sample falls outside the input zeroed. Computed in float32 as JAX
    computes it."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.0) - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / f32(kernel_scale)
    out = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
    out = np.where(x >= 1.0, ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x + f32(2.0), out)
    w = np.where(x >= 2.0, f32(0.0), out).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resample_grid(grid: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """[g0, g0, E] position embeddings -> [gh, gw, E] (`cubic_resize_matrix`
    along each axis whose size changes)."""
    for axis, n in ((0, gh), (1, gw)):
        if grid.shape[axis] != n:
            w = torch.from_numpy(cubic_resize_matrix(grid.shape[axis], n)).to(grid.device)
            grid = torch.tensordot(grid, w, dims=([axis], [0])).movedim(-1, axis)
    return grid


class ViT(nn.Module):
    """images [B, H, W, 3] (NHWC, `preprocess_tiles`) -> CLS embedding
    [B, E] (`pool="cls"`, UNI's output) or the whole sequence [B, 1+N, E]
    (`pool="none"`), in f32. Built on `device` (the CUDA card unless "cpu")
    with seeded random weights (`generator`: a CPU `torch.Generator`)."""

    def __init__(self, p: ViTParams = ViTParams(), pool: str = "cls",
                 dtype: torch.dtype = torch.float32, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if pool not in ("cls", "none"):
            raise ValueError(f"unknown pool {pool!r}")
        self.p, self.pool, self.dtype = p, pool, dtype
        E = p.hidden_size
        self.patch_embed = _PatchEmbed(p)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, E))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + p.num_patches, E))
        self.blocks = nn.ModuleList(_Block(p) for _ in range(p.num_layers))
        self.norm = nn.LayerNorm(E, eps=p.norm_eps)
        random_init_(self, generator)
        self.to(resolve_device(device))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        p, dtype = self.p, self.dtype
        x, gh, gw = self.patch_embed(images, dtype)
        B, _, E = x.shape
        x = torch.cat([self.cls_token.to(x.dtype).expand(B, 1, E), x], dim=1)
        pos = self.pos_embed
        g0 = p.img_size // p.patch_size
        if (gh, gw) != (g0, g0):
            grid = resample_grid(pos[0, 1:].reshape(g0, g0, E), gh, gw)
            pos = torch.cat([pos[:, :1], grid.reshape(1, gh * gw, E)], dim=1)
        x = x + pos.to(x.dtype)
        for block in self.blocks:
            x = block(x, dtype)
        x = self.norm(x.float())
        return x[:, 0] if self.pool == "cls" else x


def random_init_(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Seeded random weights for an encoder: truncated normal weights (std
    1/sqrt(fan_in)) for Linear, Conv2d and Embedding, zero biases, unit
    norm scales, normal(0.02) class token and position embeddings;
    LayerScale keeps its init."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d, nn.Embedding)):
                embed = isinstance(m, nn.Embedding)
                std = (m.weight.shape[1] if embed else m.weight[0].numel()) ** -0.5
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                if getattr(m, "bias", None) is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
        for name, prm in module.named_parameters(recurse=False):
            if name in ("cls_token", "pos_embed"):
                nn.init.normal_(prm, std=0.02, generator=generator)


# ------------------------------------------------------------ weight loading
def from_hf_state_dict(sd: Mapping[str, torch.Tensor], p: ViTParams) -> Dict[str, torch.Tensor]:
    """An HF `ViTModel` state dict (optionally under "vit.") renamed to this
    module's (timm's) names, q, k, v fused into qkv; the HF model has no
    LayerScale (build `ViTParams(layerscale_init=None)`). The pooler, if
    any, is dropped."""
    pre = "vit." if any(k.startswith("vit.") for k in sd) else ""
    emb, enc = f"{pre}embeddings", f"{pre}encoder.layer"
    t = {k: torch.as_tensor(v) for k, v in sd.items()}
    out = {"patch_embed.proj.weight": t[f"{emb}.patch_embeddings.projection.weight"],
           "patch_embed.proj.bias": t[f"{emb}.patch_embeddings.projection.bias"],
           "cls_token": t[f"{emb}.cls_token"],
           "pos_embed": t[f"{emb}.position_embeddings"],
           "norm.weight": t[f"{pre}layernorm.weight"], "norm.bias": t[f"{pre}layernorm.bias"]}
    for i in range(p.num_layers):
        b, blk = f"{enc}.{i}", f"blocks.{i}"
        att = f"{b}.attention.attention"
        out[f"{blk}.attn.qkv.weight"] = torch.cat(
            [t[f"{att}.{n}.weight"] for n in ("query", "key", "value")])
        if f"{att}.query.bias" in t:
            out[f"{blk}.attn.qkv.bias"] = torch.cat(
                [t[f"{att}.{n}.bias"] for n in ("query", "key", "value")])
        for src, dst in (("layernorm_before", "norm1"), ("attention.output.dense", "attn.proj"),
                         ("layernorm_after", "norm2"), ("intermediate.dense", "mlp.fc1"),
                         ("output.dense", "mlp.fc2")):
            for leaf in ("weight", "bias"):
                out[f"{blk}.{dst}.{leaf}"] = t[f"{b}.{src}.{leaf}"]
    return out


def expected_vit_layout(p: ViTParams) -> Dict[str, tuple]:
    """`name -> shape` of the module's state dict for `p`: for the UNI
    weights (ViT-L/16 with LayerScale, the `ViTParams()` defaults) the
    exact set of tensors a converted checkpoint must hold."""
    E, M, ps = p.hidden_size, int(p.hidden_size * p.mlp_ratio), p.patch_size
    out = {"patch_embed.proj.weight": (E, 3, ps, ps), "patch_embed.proj.bias": (E,),
           "cls_token": (1, 1, E), "pos_embed": (1, 1 + p.num_patches, E),
           "norm.weight": (E,), "norm.bias": (E,)}
    for i in range(p.num_layers):
        b = f"blocks.{i}"
        out.update({f"{b}.norm1.weight": (E,), f"{b}.norm1.bias": (E,),
                    f"{b}.attn.qkv.weight": (3 * E, E), f"{b}.attn.proj.weight": (E, E),
                    f"{b}.attn.proj.bias": (E,), f"{b}.norm2.weight": (E,),
                    f"{b}.norm2.bias": (E,), f"{b}.mlp.fc1.weight": (M, E),
                    f"{b}.mlp.fc1.bias": (M,), f"{b}.mlp.fc2.weight": (E, M),
                    f"{b}.mlp.fc2.bias": (E,)})
        if p.qkv_bias:
            out[f"{b}.attn.qkv.bias"] = (3 * E,)
        if p.layerscale_init is not None:
            out[f"{b}.ls1.gamma"] = (E,)
            out[f"{b}.ls2.gamma"] = (E,)
    return out


def validate_layout(sd: Mapping[str, torch.Tensor], expected: Mapping[str, tuple],
                    what: str) -> int:
    """Check a state dict against `expected` (name -> shape). Raises
    ValueError listing every missing, extra and mis-shaped tensor; returns
    the parameter count."""
    got = {k: tuple(np.shape(v)) for k, v in sd.items()}
    problems = [f"missing tensor {k} (want {v})" for k, v in expected.items() if k not in got]
    problems += [f"unexpected tensor {k} {got[k]}" for k in got if k not in expected]
    problems += [f"shape mismatch {k}: got {got[k]}, want {expected[k]}"
                 for k in got if k in expected and got[k] != expected[k]]
    if problems:
        raise ValueError(f"{what} layout invalid:\n  " + "\n  ".join(problems))
    return int(sum(int(np.prod(s)) for s in got.values()))


def validate_vit_layout(sd: Mapping[str, torch.Tensor], p: ViTParams) -> int:
    """`validate_layout` against `expected_vit_layout(p)`."""
    return validate_layout(sd, expected_vit_layout(p), "ViT")


# UNI preprocessing (timm's default transform for the UNI config: ImageNet
# mean and std)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def preprocess_tiles(tiles_uint8: np.ndarray) -> np.ndarray:
    """[N, H, W, 3] uint8 RGB -> normalized float32 NHWC."""
    x = tiles_uint8.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD
