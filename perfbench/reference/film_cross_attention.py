"""The GeMM-GAN flagship (`film_cross_attention`) in plain PyTorch.

The benchmark's yardstick for what the port computes: no kernels of any
kind, written from the published description (francescapia/-GeMM-GAN,
`src/conditional_gan_cross_attention_with_film.py`) and the widths of a
benchmark configuration file, in the configuration's compute dtype. It
imports nothing of the program under test.

In float32 every product and sum is f32. In bfloat16 the configuration
computes as Flax's `Dense(dtype=bfloat16)` does: a Linear rounds its input
and weight to bf16, takes the product with f32 accumulation and stores it
in bf16, then adds the bias in bf16; the trunks' heads stay f32, the
LayerNorms and softmax run in f32 on f32 inputs, and the condition vector
leaves in f32. Attention takes bf16 q, k, v, f32 logits and softmax; a
long query (`KERNEL_MIN_LQ` rows or more, as the flash kernels' contract
has it) takes p.v with p unrounded, a short one (the CLS queries) rounds p
to bf16 first; either output is stored in bf16. Dropout scales in f32 and
stores in the tensor's dtype.

A net (generator or critic) is a dict of float32 tensors keyed by the
names the port gives its parameters (`fusion.film.film_proj.weight`, ...,
`trunk.head.bias`), so the same weights can be handed to both sides.

* FiLM: (gamma, beta) = Linear(text CLS token); patches become
  tanh(gamma) * patches + clamp(beta, +-film_beta_clamp).
* Patch transformer: Linear(patches), a learnable CLS prepended, then
  `num_layers` post-LayerNorm blocks (masked multi-head self-attention,
  ReLU feed-forward, LayerNorm eps 1e-6), dropout after the attention's
  output projection, after the feed-forward's ReLU and after its output.
* Cross-attention both ways, each with one query: the encoded text CLS
  over the patch sequence (patch mask), then that output over the encoded
  tokens (token mask); the condition vector is the sum of the two.
* Trunks: [x | cond] through Linear + LeakyReLU(negative_slope) blocks and
  a Linear head.

The net's interface, which `wgan_step.py` drives for any architecture:
`Net(cfg, params, dropout, precision, dtype)` with `embed(cond)`,
`score(x, cvec)` and `skip_embed(B, patches, device)`; `param_shapes(cfg,
net)` and `init_params(cfg, net, generator, device)`. Dropout masks and
the control's rounding come from `numerics.py`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from perfbench.reference.numerics import Dropout, Precision

LAYER_NORM_EPS = 1e-6
NEG_INF = -1e30
KERNEL_MIN_LQ = 128  # query rows from which the program's flash kernels serve attention

Params = Dict[str, torch.Tensor]


# ------------------------------------------------------------------- params
def param_shapes(cfg: dict, net: str) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every parameter of `net` ("gen" or "critic") of
    the flagship at the widths of configuration `cfg` (its "model" and
    "fusion" groups)."""
    m, f = cfg["model"], cfg["fusion"]
    E, T, P, F = f["cond_dim"], f["text_dim"], f["patch_dim"], f["ff_dim"]
    out: List[Tuple[str, Tuple[int, ...]]] = []

    def linear(name, n_in, n_out):
        out.extend([(f"{name}.weight", (n_out, n_in)), (f"{name}.bias", (n_out,))])

    def attention(name):
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            linear(f"{name}.{proj}", E, E)

    linear("fusion.film.film_proj", T, 2 * P)
    linear("fusion.text_encoder", T, E)
    out.append(("fusion.patch_transformer.cls_token", (1, 1, E)))
    linear("fusion.patch_transformer.patches_encoder", P, E)
    for i in range(f["num_layers"]):
        layer = f"fusion.patch_transformer.patches_transformer.layers.{i}"
        attention(f"{layer}.self_attn")
        out.extend([(f"{layer}.norm1.weight", (E,)), (f"{layer}.norm1.bias", (E,))])
        linear(f"{layer}.linear1", E, F)
        linear(f"{layer}.linear2", F, E)
        out.extend([(f"{layer}.norm2.weight", (E,)), (f"{layer}.norm2.bias", (E,))])
    attention("fusion.patch2text_attention")
    attention("fusion.text2patch_attention")
    if net == "gen":
        n_in, hidden, n_out = m["latent_dim"], m["gen_dims"], m["n_genes"]
    else:
        n_in, hidden, n_out = m["n_genes"], m["disc_dims"], 1
    dims = [n_in + E, *hidden]
    for j, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        linear(f"trunk.blocks.{j}.linear", a, b)
    linear("trunk.head", dims[-1], n_out)
    return out


def init_params(cfg: dict, net: str, generator: torch.Generator,
                device) -> Params:
    """Random weights for `net` from `generator`, in a few calls on
    `device`: lecun-normal matrices (std fan_in^-1/2), zero biases, unit
    LayerNorm scales, a normal(0.02) CLS token, as Flax initialises them
    (untruncated). One normal draw covers every matrix and the CLS token,
    taken in the order of `param_shapes`."""
    shapes = param_shapes(cfg, net)
    drawn = [(n, s) for n, s in shapes if len(s) > 1]
    flat = torch.randn(sum(int(torch.Size(s).numel()) for _, s in drawn),
                       generator=generator, device=device)
    params: Params = {}
    offset = 0
    for name, shape in drawn:
        n = int(torch.Size(shape).numel())
        std = 0.02 if name.endswith("cls_token") else shape[-1] ** -0.5
        params[name] = flat[offset:offset + n].view(shape) * std
        offset += n
    for name, shape in shapes:
        if name not in params:
            fill = 1.0 if (".norm" in name and name.endswith(".weight")) else 0.0
            params[name] = torch.full(shape, fill, device=device)
    return {name: params[name] for name, _ in shapes}


# ------------------------------------------------------------------ forward
class Net:
    """One net of the flagship over `params` (float32 tensors), computing
    in `dtype` (the module's docstring).

    `dropout` draws the transformer's masks (the nets train);
    `precision` rounds every product's operands."""

    def __init__(self, cfg: dict, params: Params, dropout: Dropout,
                 precision: Optional[Precision] = None, dtype: torch.dtype = torch.float32):
        f = cfg["fusion"]
        self.p = params
        self.cd = dtype
        self.heads = f["num_heads"]
        self.layers = f["num_layers"]
        self.clamp = f["film_beta_clamp"]
        self.slope = cfg["model"]["negative_slope"]
        self.hidden = sum(1 for k in params
                          if k.startswith("trunk.blocks.") and k.endswith(".linear.weight"))
        self.drop = dropout
        self.prec = precision or Precision()

    # building blocks ------------------------------------------------------
    def linear(self, x, name, dtype: Optional[torch.dtype] = None):
        """x W^T + b in `dtype` (the net's compute dtype by default)."""
        op, cd = self.prec.op, dtype or self.cd
        w, b = self.p[f"{name}.weight"], self.p[f"{name}.bias"]
        return op(x.to(cd)) @ op(w.to(cd)).t() + b.to(cd)

    def layer_norm(self, x, name):
        return torch.nn.functional.layer_norm(
            x.float(), x.shape[-1:], self.p[f"{name}.weight"], self.p[f"{name}.bias"],
            LAYER_NORM_EPS)

    def attention(self, q_in, kv_in, mask, name, dropout: bool):
        """Masked multi-head attention; `mask` [B, Lk] True = valid."""
        op, H = self.prec.op, self.heads
        q, k, v = (self.linear(x, f"{name}.{proj}")
                   for x, proj in ((q_in, "q_proj"), (kv_in, "k_proj"), (kv_in, "v_proj")))
        B, Lq, E = q.shape
        D = E // H

        def split(x):
            return x.reshape(B, x.shape[1], H, D).transpose(1, 2)

        q, k, v = split(q) * D ** -0.5, split(k), split(v)
        s = op(q).float() @ op(k).float().transpose(-1, -2)
        s = torch.where(mask[:, None, None, :], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        if Lq < KERNEL_MIN_LQ:
            p = p.to(self.cd).float()
        o = (op(p) @ op(v).float()).to(self.cd)
        o = self.linear(o.transpose(1, 2).reshape(B, Lq, E), f"{name}.out_proj")
        return self.drop(o) if dropout else o

    def encoder_layer(self, x, mask, name):
        x = self.layer_norm(x + self.attention(x, x, mask, f"{name}.self_attn", True),
                            f"{name}.norm1")
        h = self.drop(torch.relu(self.linear(x, f"{name}.linear1")))
        h = self.drop(self.linear(h, f"{name}.linear2"))
        return self.layer_norm(x + h, f"{name}.norm2")

    def skip_embed(self, B: int, patches: int, device) -> None:
        """Draw the dropout masks that one `embed` of a batch of B cases
        with `patches` patches draws, without computing it."""
        L = patches + 1
        E = self.p["fusion.patch_transformer.cls_token"].shape[-1]
        F = self.p["fusion.patch_transformer.patches_transformer.layers.0.linear1.weight"].shape[0]
        for _ in range(self.layers):
            for width in (E, F, E):
                self.drop.skip((B, L, width), device)

    # the two halves ---------------------------------------------------------
    def embed(self, cond: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The condition vector [B, cond_dim] of a batch's conditioning:
        tokens [B, T, text_dim] with token_mask, patches [B, P, patch_dim]
        with patch_mask (True = valid)."""
        tokens, patches = cond["tokens"], cond["patches"]
        gamma, beta = self.linear(tokens[:, 0], "fusion.film.film_proj").chunk(2, dim=-1)
        patches = (torch.tanh(gamma)[:, None] * patches
                   + beta.clamp(-self.clamp, self.clamp)[:, None])
        text = self.linear(tokens, "fusion.text_encoder")
        x = self.linear(patches, "fusion.patch_transformer.patches_encoder")
        B = x.shape[0]
        cls = self.p["fusion.patch_transformer.cls_token"].to(x.dtype)
        x = torch.cat([cls.expand(B, 1, -1), x], 1)
        mask = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=x.device),
                          cond["patch_mask"]], dim=1)
        for i in range(self.layers):
            x = self.encoder_layer(
                x, mask, f"fusion.patch_transformer.patches_transformer.layers.{i}")
        p2t = self.attention(text[:, 0:1], x, mask, "fusion.patch2text_attention", False)
        t2p = self.attention(p2t, text, cond["token_mask"], "fusion.text2patch_attention",
                             False)
        return (t2p[:, 0] + p2t[:, 0]).float()

    def score(self, x: torch.Tensor, cvec: torch.Tensor) -> torch.Tensor:
        """The trunk over [x | cvec]: hidden blocks in the compute dtype,
        the head in f32."""
        h = torch.cat([x, cvec], dim=-1)
        for j in range(self.hidden):
            h = torch.nn.functional.leaky_relu(self.linear(h, f"trunk.blocks.{j}.linear"),
                                               self.slope)
        return self.linear(h, "trunk.head", torch.float32)

