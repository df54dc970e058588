"""Weight bridge between Flax param trees and the port's `state_dict`s.

A JAX user hands the port a trained generator with

    from gemm_gan_tpu_torch.convert import save_params_npz
    save_params_npz(jax.device_get(state.g_params), "run/generator_params.npz")

and `serving.GeneratorServer.load("run")` serves it. Nothing here imports
flax or jax: the Flax side is a nested (or "/"-flattened) dict of numpy
arrays.

Mapping (Flax path -> torch key), applied to any subtree:
  Dense `kernel` [in, out]            -> Linear `weight` [out, in]
  LayerNorm `scale`                   -> `weight`
  Embed `embedding` [n, d]            -> Embedding `weight` [n, d] (not transposed)
  `bias`, `cls_token`                 -> kept
  _PatchTransformer_0                 -> patch_transformer
  _PatchTransformer_0/LayerNorm_0     -> patch_transformer.encode_norm
  TransformerEncoderLayer_{i}         -> layers.{i}
  MaskedMultiHeadAttention_0          -> self_attn
  (in a layer) LayerNorm_0/1, Dense_0/1 -> norm1/2, linear1/2
  LinearBlock_{i}/Dense_0             -> blocks.{i}.linear
  LinearBlock_{i}/BatchNorm_0         -> blocks.{i}.norm (`scale` -> `weight`)
  (trunk head) Dense_0                -> head
  (VAE / CVAE) encoder/Dense_{i}      -> encoder.dense.{i}
  (VAE / CVAE) decoder/Dense_{i}      -> decoder.dense.{i}
The VAE's heads (`mu_head`, `logvar_head`, `out_head`, `out_logvar`) and
the CVAE's tables (`disease_embed`, `site_embed`) keep their names.

A BatchNorm trunk's statistics are Flax's `batch_stats` collection
(`LinearBlock_{i}/BatchNorm_0/{mean,var}`), the modules' buffers
`blocks.{i}.norm.running_{mean,var}`: `flax_to_state_dict(params,
batch_stats)` takes them, `state_dict_to_batch_stats(sd)` gives them back
(`state_dict_to_flax` gives the params only).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

_LAYER = r"TransformerEncoderLayer_(\d+)/"

# (flax regex, torch replacement), applied in order to "/"-joined paths
_TO_TORCH = [
    (r"(^|/)(encoder|decoder)/Dense_(\d+)/", r"\1\2/dense/\3/"),
    (r"(^|/)_PatchTransformer_0/LayerNorm_0/", r"\1_PatchTransformer_0/encode_norm/"),
    (r"(^|/)_PatchTransformer_0/", r"\1patch_transformer/"),
    (_LAYER + r"MaskedMultiHeadAttention_0/", r"layers/\1/self_attn/"),
    (_LAYER + r"LayerNorm_0/", r"layers/\1/norm1/"),
    (_LAYER + r"LayerNorm_1/", r"layers/\1/norm2/"),
    (_LAYER + r"Dense_0/", r"layers/\1/linear1/"),
    (_LAYER + r"Dense_1/", r"layers/\1/linear2/"),
    (r"(^|/)LinearBlock_(\d+)/Dense_0/", r"\1blocks/\2/linear/"),
    (r"(^|/)LinearBlock_(\d+)/BatchNorm_0/", r"\1blocks/\2/norm/"),
    (r"(^|/)Dense_0/(kernel|bias)$", r"\1head/\2"),
]
_LAYERS = r"layers/(\d+)/"
_TO_FLAX = [
    (r"(^|/)(encoder|decoder)/dense/(\d+)/", r"\1\2/Dense_\3/"),
    (r"(^|/)patch_transformer/encode_norm/", r"\1patch_transformer/LayerNorm_0/"),
    (r"(^|/)patch_transformer/", r"\1_PatchTransformer_0/"),
    (_LAYERS + r"self_attn/", r"TransformerEncoderLayer_\1/MaskedMultiHeadAttention_0/"),
    (_LAYERS + r"norm1/", r"TransformerEncoderLayer_\1/LayerNorm_0/"),
    (_LAYERS + r"norm2/", r"TransformerEncoderLayer_\1/LayerNorm_1/"),
    (_LAYERS + r"linear1/", r"TransformerEncoderLayer_\1/Dense_0/"),
    (_LAYERS + r"linear2/", r"TransformerEncoderLayer_\1/Dense_1/"),
    (r"(^|/)blocks/(\d+)/linear/", r"\1LinearBlock_\2/Dense_0/"),
    (r"(^|/)blocks/(\d+)/norm/", r"\1LinearBlock_\2/BatchNorm_0/"),
    (r"(^|/)head/", r"\1Dense_0/"),
]
# the modules whose 2-D `weight` is an embedding table, not a Linear's
_EMBEDDINGS = ("disease_embed", "site_embed")
# batch_stats leaf -> buffer name, and back
_STATS = {"mean": "running_mean", "var": "running_var"}
_STATS_BACK = {v: k for k, v in _STATS.items()}


def flatten_params(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> {"a/b/c": array}. A flat "/"-keyed dict passes through."""
    flat = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            flat.update(flatten_params(val, path + "/"))
        else:
            flat[path] = np.asarray(val)
    return flat


def unflatten_params(flat: Mapping[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for path, val in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def _rewrite(path: str, rules) -> str:
    for pattern, repl in rules:
        path = re.sub(pattern, repl, path)
    return path


def flax_to_state_dict(params: Mapping,
                       batch_stats: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
    """Flax param tree (nested or "/"-flattened numpy) -> torch state_dict;
    with `batch_stats` (the `batch_stats` collection of a BatchNorm trunk),
    its `mean` / `var` become the `running_mean` / `running_var` buffers."""
    sd = {}
    for path, val in flatten_params(params).items():
        path = _rewrite(path, _TO_TORCH)
        *parents, leaf = path.split("/")
        if leaf == "kernel":
            leaf, val = "weight", val.T
        elif leaf in ("scale", "embedding"):
            leaf = "weight"
        sd[".".join([*parents, leaf])] = torch.tensor(np.asarray(val),
                                                      dtype=torch.float32)
    for path, val in flatten_params(batch_stats or {}).items():
        *parents, leaf = _rewrite(path, _TO_TORCH).split("/")
        if leaf not in _STATS:
            raise ValueError(f"batch_stats entry {path!r} is not a BatchNorm mean or var")
        sd[".".join([*parents, _STATS[leaf]])] = torch.tensor(np.asarray(val),
                                                              dtype=torch.float32)
    return sd


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """Inverse of :func:`flax_to_state_dict` for the params: a nested
    Flax-layout dict of numpy arrays (BatchNorm running buffers left out:
    :func:`state_dict_to_batch_stats`)."""
    flat = {}
    for key, val in state_dict.items():
        *parents, leaf = key.split(".")
        if leaf in _STATS_BACK:
            continue
        arr = val.detach().cpu().numpy()
        if leaf == "weight" and parents and parents[-1] in _EMBEDDINGS:
            leaf = "embedding"
        elif leaf == "weight":
            leaf, arr = ("kernel", arr.T) if arr.ndim == 2 else ("scale", arr)
        path = _rewrite("/".join([*parents, leaf]), _TO_FLAX)
        flat[path] = np.ascontiguousarray(arr)
    return unflatten_params(flat)


def state_dict_to_batch_stats(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The BatchNorm running buffers of a state dict as Flax's
    `batch_stats` collection (nested, numpy); the inverse of
    :func:`flax_to_state_dict`'s `batch_stats` argument."""
    stats = {}
    for key, val in state_dict.items():
        *parents, leaf = key.split(".")
        if leaf in _STATS_BACK:
            path = _rewrite("/".join([*parents, _STATS_BACK[leaf]]), _TO_FLAX)
            stats[path] = val.detach().cpu().numpy().copy()
    return unflatten_params(stats)


def save_params_npz(params: Mapping, path: str) -> None:
    """Write a Flax param tree (e.g. `jax.device_get(state.g_params)`) as an
    .npz keyed by "/"-joined paths."""
    np.savez(path, **flatten_params(params))


def load_params_npz(path: str) -> Dict:
    """Read an .npz written by :func:`save_params_npz` as a nested dict."""
    with np.load(path) as data:
        return unflatten_params({k: data[k] for k in data.files})


# ------------------------------------------------------------------ encoders
# Flax trees of the JAX encoders (`FlaxViT`, `FlaxModernBert`) -> the port's
# modules' state dicts (timm's and HF's names): (flax regex, torch
# replacement) on "/"-joined paths, then the generic leaf rules above
_VIT_TO_TORCH = [
    (r"^block_(\d+)/", r"blocks/\1/"),
    (r"^(blocks/\d+/)(fc1|fc2)/", r"\1mlp/\2/"),
    (r"^(blocks/\d+/)(ls1|ls2)$", r"\1\2/gamma"),
]
_MODERNBERT_TO_TORCH = [
    (r"^tok_embeddings/", r"embeddings/tok_embeddings/"),
    (r"^emb_norm/", r"embeddings/norm/"),
    (r"^layer_(\d+)/", r"layers/\1/"),
    (r"^(layers/\d+/)(Wi|Wo)/", r"\1mlp/\2/"),
]


def _encoder_state_dict(params: Mapping, rules) -> Dict[str, torch.Tensor]:
    flat = {}
    for path, val in flatten_params(params).items():
        path = _rewrite(path, rules)
        if path == "patch_embed/kernel":  # Conv [k, k, 3, E] -> [E, 3, k, k]
            path, val = "patch_embed/proj/weight", np.asarray(val).transpose(3, 2, 0, 1)
        elif path == "patch_embed/bias":
            path = "patch_embed/proj/bias"
        flat[path] = val
    return flax_to_state_dict(unflatten_params(flat))


def vit_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """`FlaxViT` params -> `encoders.vit.ViT`'s state dict (timm names)."""
    return _encoder_state_dict(params, _VIT_TO_TORCH)


def modernbert_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """`FlaxModernBert` params -> `encoders.modernbert.ModernBert`'s state
    dict (HF names)."""
    return _encoder_state_dict(params, _MODERNBERT_TO_TORCH)
