"""ModernBERT, the clinical text encoder (Clinical ModernBERT).

Counterpart of `gemm_gan_tpu/encoders/modernbert.py`, with HF
`ModernBertModel`'s parameter names (`embeddings.tok_embeddings`,
`embeddings.norm`, `layers.{i}.{attn_norm, attn.Wqkv, attn.Wo, mlp_norm,
mlp.Wi, mlp.Wo}`, `final_norm`), so an HF state dict loads directly
(`from_hf_state_dict` drops a masked-LM's "model." prefix and head):

  * token embedding -> LayerNorm -> layers -> final LayerNorm, every
    LayerNorm without bias at eps 1e-5;
  * pre-norm residual layers; layer 0 has no attention pre-norm;
  * fused QKV without bias, RoPE on q and k: theta 160k on the global
    layers (every `global_every`-th, from layer 0), 10k on the local ones,
    which attend within +-local_window/2 positions;
  * GeGLU MLP: Wi -> split (input, gate) -> gelu(input) * gate -> Wo.

Attention is plain `torch.matmul` with f32 products and an f32 softmax, as
the JAX module's einsums (`encoders/vit.py`'s `attention`); it reaches no
kernel. `dtype=torch.bfloat16` computes the embedding lookup and every
Dense in bf16 (Flax's rules), the LayerNorms in f32; the f32 RoPE tables
make q and k f32, as JAX's type promotion does.

`params_from_config` reads an HF `config.json` (a dict or an object with its
attributes) without `transformers`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from gemm_gan_tpu_torch.encoders.vit import attention, dense, random_init_, validate_layout
from gemm_gan_tpu_torch.utils.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class ModernBertParams:
    """Defaults = ModernBERT-base (the Clinical ModernBERT architecture)."""

    vocab_size: int = 50368
    hidden_size: int = 768
    intermediate_size: int = 1152
    num_layers: int = 22
    num_heads: int = 12
    global_every: int = 3
    local_window: int = 128
    global_rope_theta: float = 160000.0
    local_rope_theta: float = 10000.0
    norm_eps: float = 1e-5


def rope_cos_sin(L: int, D: int, theta: float):
    """[L, D] float32 cos and sin tables, as the JAX module builds them."""
    inv_freq = 1.0 / (theta ** (np.arange(0, D, 2, dtype=np.float32) / D))
    freqs = np.outer(np.arange(L, dtype=np.float32), inv_freq)
    emb = np.concatenate([freqs, freqs], axis=-1)
    return np.cos(emb), np.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    d = x.shape[-1] // 2
    return torch.cat([-x[..., d:], x[..., :d]], dim=-1)


def _layer_norm(dim: int, eps: float) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=eps, bias=False)


class _Attention(nn.Module):
    def __init__(self, p: ModernBertParams, layer_id: int):
        super().__init__()
        self.p = p
        self.is_global = layer_id % p.global_every == 0
        self.Wqkv = nn.Linear(p.hidden_size, 3 * p.hidden_size, bias=False)
        self.Wo = nn.Linear(p.hidden_size, p.hidden_size, bias=False)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        p = self.p
        B, L, E = x.shape
        H = p.num_heads
        D = E // H
        qkv = dense(x, self.Wqkv.weight, None, dtype)
        q, k, v = qkv.reshape(B, L, 3, H, D).permute(2, 0, 3, 1, 4)
        theta = p.global_rope_theta if self.is_global else p.local_rope_theta
        cos, sin = (torch.from_numpy(a).to(x.device) for a in rope_cos_sin(L, D, theta))
        q = q * cos + _rotate_half(q) * sin
        k = k * cos + _rotate_half(k) * sin
        allow = mask[:, None, None, :]                  # padding: True = valid
        if not self.is_global:
            idx = torch.arange(L, device=x.device)
            allow = allow & ((idx[:, None] - idx[None, :]).abs() <= p.local_window // 2)
        out = attention(q, k, v, x.dtype, allow).transpose(1, 2).reshape(B, L, E)
        return dense(out, self.Wo.weight, None, dtype)


class _Mlp(nn.Module):
    def __init__(self, p: ModernBertParams):
        super().__init__()
        self.Wi = nn.Linear(p.hidden_size, 2 * p.intermediate_size, bias=False)
        self.Wo = nn.Linear(p.intermediate_size, p.hidden_size, bias=False)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        inp, gate = dense(x, self.Wi.weight, None, dtype).chunk(2, dim=-1)
        return dense(F.gelu(inp) * gate, self.Wo.weight, None, dtype)


class _Layer(nn.Module):
    def __init__(self, p: ModernBertParams, layer_id: int):
        super().__init__()
        self.attn_norm = None if layer_id == 0 else _layer_norm(p.hidden_size, p.norm_eps)
        self.attn = _Attention(p, layer_id)
        self.mlp_norm = _layer_norm(p.hidden_size, p.norm_eps)
        self.mlp = _Mlp(p)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h = x if self.attn_norm is None else self.attn_norm(x.float())
        x = x + self.attn(h, mask, dtype)
        return x + self.mlp(self.mlp_norm(x.float()), dtype)


class _Embeddings(nn.Module):
    def __init__(self, p: ModernBertParams):
        super().__init__()
        self.tok_embeddings = nn.Embedding(p.vocab_size, p.hidden_size)
        self.norm = _layer_norm(p.hidden_size, p.norm_eps)


class ModernBert(nn.Module):
    """(input_ids [B, L] int, attention_mask [B, L] bool True = valid, or
    None) -> last hidden state [B, L, E] in f32; the CLS vector is
    `out[:, 0]`. Built on `device` (the CUDA card unless "cpu") with seeded
    random weights (`generator`: a CPU `torch.Generator`)."""

    def __init__(self, p: ModernBertParams = ModernBertParams(),
                 dtype: torch.dtype = torch.float32, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.p, self.dtype = p, dtype
        self.embeddings = _Embeddings(p)
        self.layers = nn.ModuleList(_Layer(p, i) for i in range(p.num_layers))
        self.final_norm = _layer_norm(p.hidden_size, p.norm_eps)
        random_init_(self, generator)
        self.to(resolve_device(device))

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if attention_mask is None:
            attention_mask = torch.ones(input_ids.shape, dtype=torch.bool,
                                        device=input_ids.device)
        table = self.embeddings.tok_embeddings.weight.to(self.dtype)
        x = self.embeddings.norm(F.embedding(input_ids.long(), table).float())
        mask = attention_mask.bool()
        for layer in self.layers:
            x = layer(x, mask, self.dtype)
        return self.final_norm(x.float())


# ------------------------------------------------------------ weight loading
def from_hf_state_dict(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """An HF `ModernBertModel` state dict, or a masked LM's (its encoder
    under "model."), as this module's: the prefix stripped, the LM head
    dropped."""
    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
    return {k: torch.as_tensor(v) for k, v in sd.items()}


def expected_modernbert_layout(p: Optional[ModernBertParams] = None) -> Dict[str, tuple]:
    """`name -> shape` of the module's state dict: for Clinical ModernBERT
    (ModernBERT-base, the `ModernBertParams()` defaults) the exact set of
    tensors a converted checkpoint must hold."""
    p = p or ModernBertParams()
    E, inter, V = p.hidden_size, p.intermediate_size, p.vocab_size
    out = {"embeddings.tok_embeddings.weight": (V, E), "embeddings.norm.weight": (E,),
           "final_norm.weight": (E,)}
    for i in range(p.num_layers):
        b = f"layers.{i}"
        out.update({f"{b}.attn.Wqkv.weight": (3 * E, E), f"{b}.attn.Wo.weight": (E, E),
                    f"{b}.mlp_norm.weight": (E,), f"{b}.mlp.Wi.weight": (2 * inter, E),
                    f"{b}.mlp.Wo.weight": (E, inter)})
        if i != 0:  # layer 0 has no attention pre-norm
            out[f"{b}.attn_norm.weight"] = (E,)
    return out


def validate_modernbert_layout(sd: Mapping[str, torch.Tensor],
                               p: Optional[ModernBertParams] = None) -> int:
    """`validate_layout` against `expected_modernbert_layout(p)`."""
    return validate_layout(sd, expected_modernbert_layout(p), "ModernBert")


def params_from_config(cfg) -> ModernBertParams:
    """ModernBertParams from an HF ModernBERT config: its `config.json` as a
    dict, or an object with those attributes."""
    get = cfg.get if isinstance(cfg, Mapping) else (lambda k, d=None: getattr(cfg, k, d))
    local_theta = get("local_rope_theta")
    return ModernBertParams(
        vocab_size=get("vocab_size"), hidden_size=get("hidden_size"),
        intermediate_size=get("intermediate_size"), num_layers=get("num_hidden_layers"),
        num_heads=get("num_attention_heads"),
        global_every=get("global_attn_every_n_layers"), local_window=get("local_attention"),
        global_rope_theta=get("global_rope_theta"),
        local_rope_theta=(local_theta if local_theta is not None
                          else get("global_rope_theta")),
        norm_eps=get("norm_eps"))
