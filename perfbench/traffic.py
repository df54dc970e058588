"""The one generator of the benchmark's traffic: a training mix's bank of
cases, made on the device from a seed, directly in its stored dtype.

A mix is a data file under `traffic/` (`kind` "train_epochs"): `cases`,
`patch_slots` per case with `min_valid_patches`..`patch_slots` valid,
`num_patches` subsampled a step, `tokens` per case with
`min_valid_tokens`..`tokens` valid (the CLS token always), and
`store_dtype` of the embeddings. Genes are N(0, 1) in f32 (standardized
expression), patches and tokens N(0, 1) in the stored dtype, invalid slots
zero. Every seed gives the same sizes; only the values and the valid
lengths differ.
"""

from __future__ import annotations

from typing import Dict

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_bank(cfg: dict, traffic: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    n, f = traffic["cases"], cfg["fusion"]
    store = DTYPES[traffic["store_dtype"]]
    g = torch.Generator(device=device).manual_seed(seed)

    def ragged(width: int, lo: int) -> torch.Tensor:
        lens = torch.randint(lo, width + 1, (n,), generator=g, device=device)
        return torch.arange(width, device=device)[None, :] < lens[:, None]

    patch_mask = ragged(traffic["patch_slots"], traffic["min_valid_patches"])
    token_mask = ragged(traffic["tokens"], traffic["min_valid_tokens"])
    patches = torch.randn(n, traffic["patch_slots"], f["patch_dim"], generator=g,
                          device=device, dtype=store)
    tokens = torch.randn(n, traffic["tokens"], f["text_dim"], generator=g, device=device,
                         dtype=store)
    genes = torch.randn(n, cfg["model"]["n_genes"], generator=g, device=device)
    return {"genes": genes,
            "patches": patches.mul_(patch_mask[..., None]), "patch_mask": patch_mask,
            "tokens": tokens.mul_(token_mask[..., None]), "token_mask": token_mask}


def steps_per_epoch(cfg: dict, traffic: dict) -> int:
    return traffic["cases"] // cfg["train"]["batch_size"]
