"""The floating-point operations of the flagship's sampling
(`film_cross_attention`), from the configuration's shapes: one batch of a
generate cell, and the attentions that the port routes to its flash
kernels there. A generate cell finds this module as
`flops/<architecture>_generate.py`.

A batch embeds its conditioning once (`fusion_flops` without gradient, at
the batch's `patch_slots` patches and `tokens` tokens: every slot is
handed to the generator) and runs the trunk once for each of its
`num_repeats` z draws. Nothing is counted for elementwise work, softmax or
norms. `perfbench/tests/test_perfbench_generate.py` holds it equal to
`torch.utils.flop_counter.FlopCounterMode` over the reference's forward.
"""

from __future__ import annotations

from perfbench.flops import dims, expected_valid, mm
from perfbench.flops.film_cross_attention import fusion_flops


def generate_batch_flops(cfg: dict, traffic: dict) -> int:
    """One batch of a generate cell: the embedding and every repeat's trunk."""
    m, f = cfg["model"], cfg["fusion"]
    B = traffic["batch_size"]
    gen = dims(m["latent_dim"] + f["cond_dim"], m["gen_dims"], m["n_genes"])
    trunk = sum(mm(B, a, b) for a, b in gen)
    return (fusion_flops(cfg, B, traffic["patch_slots"], traffic["tokens"], grad=False)
            + traffic["num_repeats"] * trunk)


def generate_kernel_sites(cfg: dict, traffic: dict) -> list:
    """The attentions of a batch that the port routes to its flash kernels:
    the patch transformer's self-attention over the CLS and the batch's
    patch slots (the CLS-query cross-attentions take plain PyTorch), with
    its valid keys summed over the batch and its `launches` a batch: one
    forward per layer, no backward."""
    f, B = cfg["fusion"], traffic["batch_size"]
    slots = traffic["patch_slots"]
    valid = 1 + expected_valid(traffic["min_valid_patches"], slots, slots)
    return [{"name": "patch_self_attention", "B": B, "H": f["num_heads"], "Lq": slots + 1,
             "Lk": slots + 1, "D": f["cond_dim"] // f["num_heads"], "valid_keys": B * valid,
             "launches": {"fwd": f["num_layers"], "bwd": 0}}]
