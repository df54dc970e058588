"""The floating-point operations of the flagship (`film_cross_attention`),
from the configuration's shapes: one training step, and the attentions
that the port routes to its flash kernels.

The count is of the products (2 FLOP a multiply-add) that the algorithm of
`reference/wgan_step.py` takes, whatever implements it: the generator's
embedding once a step; n_critic critic updates, each with fresh fakes
(the generator's trunk, no gradient), the critic's embedding with its
backward, one [3B] trunk call over real, fake and interpolates, the
penalty's gradient w.r.t. the interpolates and the backward through both
(the double backward); the generator update with the critic's embedding
(no gradient), the generator's embedding and trunk with their backward,
and the critic's trunk differentiated w.r.t. its input only. Elementwise
work, softmax and norms are not counted; nothing is counted twice
(no recomputation). A backward counts a product for each operand that
needs a gradient: the weights, and an input that depends on a weight
(the token and patch embeddings of the bank need none).
`perfbench/tests/test_perfbench_flops.py` holds it equal to
`torch.utils.flop_counter.FlopCounterMode` over the reference's step.
"""

from __future__ import annotations

from perfbench.flops import dims, expected_valid, mm


def fusion_flops(cfg: dict, B: int, patches: int, tokens: int, grad: bool) -> int:
    """One embedding of a batch; with `grad` its backward too."""
    f = cfg["fusion"]
    E, T, Pd, F, H = f["cond_dim"], f["text_dim"], f["patch_dim"], f["ff_dim"], f["num_heads"]
    L = patches + 1
    D = E // H
    # (forward FLOPs, backward multiplier): 1 for the weight's gradient
    # alone (an input from the bank), 2 for the weight's and the input's
    linears = [(mm(B, T, 2 * Pd), 1),            # FiLM from the text CLS token
               (mm(B * tokens, T, E), 1),        # text encoder
               (mm(B * patches, Pd, E), 2)]      # patch encoder (after FiLM)
    products = []                                 # attention products: both operands
    for _ in range(f["num_layers"]):
        linears += [(mm(B * L, E, E), 2)] * 4 + [(mm(B * L, E, F), 2), (mm(B * L, F, E), 2)]
        products += [2 * B * H * L * L * D] * 2
    # CLS-query cross-attentions: the text CLS over the patch sequence, then
    # that over the tokens
    for kv_rows in (L, tokens):
        linears += [(mm(B, E, E), 2), (mm(B * kv_rows, E, E), 2), (mm(B * kv_rows, E, E), 2),
                    (mm(B, E, E), 2)]
        products += [2 * B * H * kv_rows * D] * 2
    fwd = sum(n for n, _ in linears) + sum(products)
    if not grad:
        return fwd
    return fwd + sum(n * k for n, k in linears) + 2 * sum(products)


def train_step_flops(cfg: dict, traffic: dict) -> int:
    """One step of the training cell (`cond_embed_reuse="per_update"`,
    batched scores)."""
    m, t, f = cfg["model"], cfg["train"], cfg["fusion"]
    if t["cond_embed_reuse"] != "per_update" or not t["batched_scores"]:
        raise ValueError("the count is written for per_update with batched scores")
    B, N, E = t["batch_size"], t["n_critic"], f["cond_dim"]
    P, Tk = traffic["num_patches"], traffic["tokens"]
    gen = dims(m["latent_dim"] + E, m["gen_dims"], m["n_genes"])
    critic = dims(m["n_genes"] + E, m["disc_dims"], 1)

    def trunk(layers, rows):
        return sum(mm(rows, a, b) for a, b in layers)

    # critic update: forward over [3B]; the penalty's gradient w.r.t. the
    # input (every layer's input product, the head's too); the outer
    # backward: each forward product's weight and input gradients, and the
    # penalty's products' gradients (w.r.t. the weight, and w.r.t. the
    # incoming gradient except at the head, where it is a constant)
    D3 = trunk(critic, 3 * B)
    head = mm(3 * B, *critic[-1])
    critic_trunk = D3 + D3 + 2 * D3 + (2 * D3 - head)
    critic_update = (trunk(gen, B) + fusion_flops(cfg, B, P, Tk, grad=True) + critic_trunk)
    # generator update: the critic's embedding (no gradient), the
    # generator's embedding and trunk with their backward, the critic's
    # trunk forward and its input gradients
    generator_update = (fusion_flops(cfg, B, P, Tk, grad=False)
                        + fusion_flops(cfg, B, P, Tk, grad=True)
                        + 3 * trunk(gen, B) + 2 * trunk(critic, B))
    return fusion_flops(cfg, B, P, Tk, grad=False) + N * critic_update + generator_update


def kernel_sites(cfg: dict, traffic: dict) -> list:
    """The attentions of a training step that the port routes to its flash
    kernels: the patch transformer's self-attention (the CLS-query
    cross-attentions have one query row and take plain PyTorch). Each site
    gives B, H, Lq, Lk, D and the valid keys of one launch, summed over
    the batch (the CLS and the kept patches), and its `launches` a step:
    "fwd" a forward, one per layer of each embedding (the generator's, each
    critic update's, the generator update's two); "bwd" a backward, one per
    layer of each embedding with a gradient (each critic update's, the
    generator's in its update)."""
    f, t, B = cfg["fusion"], cfg["train"], cfg["train"]["batch_size"]
    L = traffic["num_patches"] + 1
    valid = 1 + expected_valid(traffic["min_valid_patches"], traffic["patch_slots"],
                               traffic["num_patches"])
    layers = f["num_layers"]
    return [{"name": "patch_self_attention", "B": B, "H": f["num_heads"], "Lq": L, "Lk": L,
             "D": f["cond_dim"] // f["num_heads"], "valid_keys": B * valid,
             "launches": {"fwd": (t["n_critic"] + 3) * layers,
                          "bwd": (t["n_critic"] + 1) * layers}}]
