"""The analytic FLOPs of a step (`train_step_flops` of
`flops/film_cross_attention.py`) against
`torch.utils.flop_counter.FlopCounterMode` over the reference's step, at
tiny widths on the CPU and at the published ones on the meta device."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import spec
from perfbench.flops import expected_valid
from perfbench.reference.film_cross_attention import init_params, param_shapes
from perfbench.reference.wgan_step import WGANGPReference
from perfbench.tests._tiny import tiny_cell

flops = spec.architecture_flops("film_cross_attention")


def counted(cell, device) -> int:
    cfg, tr = cell.config, cell.traffic
    if device == "meta":
        w = {n: {k: torch.empty(s, device=device) for k, s in param_shapes(cfg, n)}
             for n in ("gen", "critic")}
    else:
        g = torch.Generator().manual_seed(0)
        w = {n: init_params(cfg, n, g, device) for n in ("gen", "critic")}
    ref = WGANGPReference(cfg, w["gen"], w["critic"], 800, torch.float32)
    B, f, m = cfg["train"]["batch_size"], cfg["fusion"], cfg["model"]
    P, T, N = tr["num_patches"], tr["tokens"], cfg["train"]["n_critic"]
    batch = {"genes": torch.randn(B, m["n_genes"], device=device),
             "tokens": torch.randn(B, T, f["text_dim"], device=device),
             "token_mask": torch.ones(B, T, dtype=torch.bool, device=device),
             "patches": torch.randn(B, P, f["patch_dim"], device=device),
             "patch_mask": torch.ones(B, P, dtype=torch.bool, device=device)}
    draws = {"z": torch.randn(N, B, m["latent_dim"], device=device),
             "alpha": torch.rand(N, B, 1, device=device),
             "z_gen": torch.randn(B, m["latent_dim"], device=device)}
    with FlopCounterMode(display=False) as counter:
        ref.step(batch, draws)
    return counter.get_total_flops()


def test_tiny_widths_on_the_cpu():
    cell = tiny_cell()
    assert flops.train_step_flops(cell.config, cell.traffic) == counted(cell, "cpu")


@pytest.mark.parametrize("workload", ["film_xattn_bf16.train_cohort",
                                      "film_xattn_bf16.train_wholeslide"])
def test_published_widths_on_meta(workload):
    cell = spec.load_cell(workload)
    assert flops.train_step_flops(cell.config, cell.traffic) == counted(cell, "meta")


def test_kernel_site_counts_the_kept_patches():
    cell = spec.load_cell("film_xattn_bf16.train_cohort")
    site, = flops.kernel_sites(cell.config, cell.traffic)
    assert (site["Lq"], site["Lk"], site["D"], site["valid_keys"]) == (257, 257, 64, 8 * 257)
    assert site["launches"] == {"fwd": 16, "bwd": 12}
    assert expected_valid(2, 4, 3) == (2 + 3 + 3) / 3
