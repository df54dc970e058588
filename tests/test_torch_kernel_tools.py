"""The parts of the port's on-card tools that need no card.

`chip_smoke.py` names every kernel template instantiation in nvcc's ptxas
report by its entry point (both layouts of the forward template and of the
fused backward template, the dq (Q4) and dk/dv (Q5) kernels, the bf16
product modes of every kernel, and the wgmma kernels of every kernel's
bf16-ref modes), and must fail on one it does not know rather than leave
it out;
`scripts/torch_kernel_variants.py` builds its variants by text
substitution of the sources under `csrc/`, so every substitution must
still find its target there (Q2's and Q4's variants included).
"""

import _torch_test_threads  # noqa: F401  (one torch thread per test process)
import importlib.util
import os
from pathlib import Path

import pytest

import chip_smoke
from gemm_gan_tpu_torch.kernels import build
from gemm_gan_tpu_torch.kernels import flash_attention as tfa

ROOT = Path(__file__).resolve().parents[1]


def _variants_module():
    spec = importlib.util.spec_from_file_location(
        "torch_kernel_variants", ROOT / "scripts" / "torch_kernel_variants.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ptxas' names for one instantiation of every kernel template in csrc/
MANGLED = {
    "_ZN12_GLOBAL__N_116flash_fwd_kernelILi64ELb1EEEvNS_4ArgsE": ("flash_fwd_ble", 64),
    "_ZN12_GLOBAL__N_116flash_fwd_kernelILi8ELb0EEEvNS_4ArgsE": ("flash_fwd_bhld", 8),
    "_ZN12_GLOBAL__N_122flash_bwd_fused_kernelILi64ELb1EEEvN12flash_bwd_tc4ArgsEi":
        ("flash_bwd_ble", 64),
    "_ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi128EEEvN12flash_bwd_tc4ArgsE":
        ("flash_bwd_dq", 128),
    "_ZN12_GLOBAL__N_120flash_bwd_dkv_kernelILi64EEEvN12flash_bwd_tc4ArgsE":
        ("flash_bwd_dkv", 64),
    "_ZN12_GLOBAL__N_122flash_bwd_fused_kernelILi16ELb0EEEvN12flash_bwd_tc4ArgsEi":
        ("flash_bwd_bhld_fused", 16),
    # the templates with their product mode (csrc/flash_ops.cuh): f32 is mode 0
    "_ZN12_GLOBAL__N_116flash_fwd_kernelILi64ELb1ELi0EEEvNS_4ArgsIfEE": ("flash_fwd_ble", 64),
    "_ZN12_GLOBAL__N_116flash_fwd_kernelILi64ELb1ELi1EEEvNS_4ArgsI13__nv_bfloat16EE":
        ("flash_fwd_ble_bf16", 64),
    "_ZN12_GLOBAL__N_116flash_fwd_kernelILi8ELb1ELi2EEEvNS_4ArgsIfEE": ("flash_fwd_ble_mxu", 8),
    "_ZN12_GLOBAL__N_116flash_fwd_kernelILi128ELb1ELi3EEEvNS_4ArgsI13__nv_bfloat16EE":
        ("flash_fwd_ble_mxu", 128),
    "_ZN12_GLOBAL__N_122flash_bwd_fused_kernelILi64ELb1ELi1EEEvN12flash_bwd_tc4ArgsI13__nv_bfloat16EEi":
        ("flash_bwd_ble_bf16", 64),
    "_ZN12_GLOBAL__N_122flash_bwd_fused_kernelILi32ELb1ELi2EEEvN12flash_bwd_tc4ArgsIfEEi":
        ("flash_bwd_ble_mxu", 32),
    "_ZN12_GLOBAL__N_122flash_bwd_fused_kernelILi64ELb1ELi3EEEvN12flash_bwd_tc4ArgsI13__nv_bfloat16EEi":
        ("flash_bwd_ble_mxu", 64),
    "_ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi64EEEvN12flash_bwd_tc4ArgsIfEE":
        ("flash_bwd_dq", 64),
    # the classic layout's kernels with their product mode
    "_ZN12_GLOBAL__N_116flash_fwd_kernelILi64ELb0ELi1EEEvNS_4ArgsI13__nv_bfloat16EE":
        ("flash_fwd_bhld_bf16", 64),
    "_ZN12_GLOBAL__N_116flash_fwd_kernelILi8ELb0ELi2EEEvNS_4ArgsIfEE": ("flash_fwd_bhld_mxu", 8),
    "_ZN12_GLOBAL__N_116flash_fwd_kernelILi64ELb0ELi3EEEvNS_4ArgsI13__nv_bfloat16EE":
        ("flash_fwd_bhld_mxu", 64),
    "_ZN12_GLOBAL__N_122flash_bwd_fused_kernelILi64ELb0ELi1EEEvN12flash_bwd_tc4ArgsI13__nv_bfloat16EEi":
        ("flash_bwd_bhld_fused_bf16", 64),
    "_ZN12_GLOBAL__N_122flash_bwd_fused_kernelILi128ELb0ELi2EEEvN12flash_bwd_tc4ArgsIfEEi":
        ("flash_bwd_bhld_fused_mxu", 128),
    "_ZN12_GLOBAL__N_122flash_bwd_fused_kernelILi64ELb0ELi3EEEvN12flash_bwd_tc4ArgsI13__nv_bfloat16EEi":
        ("flash_bwd_bhld_fused_mxu", 64),
    "_ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi64ELi0EEEvN12flash_bwd_tc4ArgsIfEE":
        ("flash_bwd_dq", 64),
    "_ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi64ELi1EEEvN12flash_bwd_tc4ArgsI13__nv_bfloat16EE":
        ("flash_bwd_dq_bf16", 64),
    "_ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi16ELi2EEEvN12flash_bwd_tc4ArgsIfEE":
        ("flash_bwd_dq_mxu", 16),
    "_ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi64ELi3EEEvN12flash_bwd_tc4ArgsI13__nv_bfloat16EE":
        ("flash_bwd_dq_mxu", 64),
    "_ZN12_GLOBAL__N_120flash_bwd_dkv_kernelILi32ELi0EEEvN12flash_bwd_tc4ArgsIfEE":
        ("flash_bwd_dkv", 32),
    "_ZN12_GLOBAL__N_120flash_bwd_dkv_kernelILi64ELi1EEEvN12flash_bwd_tc4ArgsI13__nv_bfloat16EE":
        ("flash_bwd_dkv_bf16", 64),
    "_ZN12_GLOBAL__N_120flash_bwd_dkv_kernelILi8ELi2EEEvN12flash_bwd_tc4ArgsIfEE":
        ("flash_bwd_dkv_mxu", 8),
    "_ZN12_GLOBAL__N_120flash_bwd_dkv_kernelILi64ELi3EEEvN12flash_bwd_tc4ArgsI13__nv_bfloat16EE":
        ("flash_bwd_dkv_mxu", 64),
    # the bf16-ref modes of the single-block backward on the wgmma tiles
    "_ZN12_GLOBAL__N_119flash_bwd_wg_kernelILi64ELb1ELi1EEEvN12flash_bwd_tc4ArgsI13__nv_bfloat16EEi":
        ("flash_bwd_ble_bf16", 64),
    "_ZN12_GLOBAL__N_119flash_bwd_wg_kernelILi32ELb1ELi3EEEvN12flash_bwd_tc4ArgsI13__nv_bfloat16EEi":
        ("flash_bwd_ble_mxu", 32),
    "_ZN12_GLOBAL__N_119flash_bwd_wg_kernelILi16ELb0ELi1EEEvN12flash_bwd_tc4ArgsI13__nv_bfloat16EEi":
        ("flash_bwd_bhld_fused_bf16", 16),
    "_ZN12_GLOBAL__N_119flash_bwd_wg_kernelILi64ELb0ELi3EEEvN12flash_bwd_tc4ArgsI13__nv_bfloat16EEi":
        ("flash_bwd_bhld_fused_mxu", 64),
    # the bf16-ref modes of Q1, Q3, Q4 and Q5 on the wgmma tiles (the
    # forward's in either layout)
    "_ZN12_GLOBAL__N_119flash_fwd_wg_kernelILi64ELb0ELi1EEEvNS_4ArgsI13__nv_bfloat16EE":
        ("flash_fwd_bhld_bf16", 64),
    "_ZN12_GLOBAL__N_119flash_fwd_wg_kernelILi16ELb0ELi3EEEvNS_4ArgsI13__nv_bfloat16EE":
        ("flash_fwd_bhld_mxu", 16),
    "_ZN12_GLOBAL__N_119flash_fwd_wg_kernelILi64ELb1ELi1EEEvNS_4ArgsI13__nv_bfloat16EE":
        ("flash_fwd_ble_bf16", 64),
    "_ZN12_GLOBAL__N_119flash_fwd_wg_kernelILi32ELb1ELi3EEEvNS_4ArgsI13__nv_bfloat16EE":
        ("flash_fwd_ble_mxu", 32),
    "_ZN12_GLOBAL__N_122flash_bwd_dq_wg_kernelILi64ELi1EEEvN12flash_bwd_tc4ArgsI13__nv_bfloat16EE":
        ("flash_bwd_dq_bf16", 64),
    "_ZN12_GLOBAL__N_122flash_bwd_dq_wg_kernelILi16ELi3EEEvN12flash_bwd_tc4ArgsI13__nv_bfloat16EE":
        ("flash_bwd_dq_mxu", 16),
    "_ZN12_GLOBAL__N_123flash_bwd_dkv_wg_kernelILi32ELi1EEEvN12flash_bwd_tc4ArgsI13__nv_bfloat16EE":
        ("flash_bwd_dkv_bf16", 32),
    "_ZN12_GLOBAL__N_123flash_bwd_dkv_wg_kernelILi64ELi3EEEvN12flash_bwd_tc4ArgsI13__nv_bfloat16EE":
        ("flash_bwd_dkv_mxu", 64),
}


@pytest.mark.parametrize("mangled", sorted(MANGLED))
def test_ptxas_names_map_to_entry_points(mangled):
    assert chip_smoke.ptxas_entry(mangled) == MANGLED[mangled]


def test_every_kernel_has_a_ptxas_name():
    assert {v[0] for v in MANGLED.values()} == {k.__name__ for k in tfa.KERNELS}
    assert set(chip_smoke.PTXAS_ENTRIES.values()) == set(chip_smoke.KERNELS)


@pytest.mark.parametrize("mangled", [
    # the CUDA-core backward template of earlier sources (flash_bwd.cu), gone
    "_ZN12_GLOBAL__N_116flash_bwd_kernelILi64ELb1ELb1ELb1EEEvNS_4ArgsEi",
    "_ZN12_GLOBAL__N_121flash_fwd_bhld_kernelILi64EEEvNS_4ArgsE",
    # a product mode that flash_ops.cuh does not define
    "_ZN12_GLOBAL__N_116flash_fwd_kernelILi64ELb0ELi4EEEvNS_4ArgsI13__nv_bfloat16EE",
    # the classic forward's wgmma kernel before it took a layout flag
    "_ZN12_GLOBAL__N_119flash_fwd_wg_kernelILi64ELi1EEEvNS_4ArgsI13__nv_bfloat16EE",
    "_Z6helperv",
])
def test_unknown_ptxas_names_raise(mangled):
    with pytest.raises(ValueError, match="does not know"):
        chip_smoke.ptxas_entry(mangled)


def test_ptxas_report_labels_every_kernel_and_its_advice():
    """Phase 1's report: a label per instantiation, its registers and
    spills, and ptxas' advice under the label of the function it names
    (which ptxas prints before that function's own lines)."""
    wg = "_ZN12_GLOBAL__N_119flash_bwd_wg_kernelILi64ELb1ELi1EEEvN12flash_bwd_tc4ArgsI13__nv_bfloat16EEi"
    fused = "_ZN12_GLOBAL__N_122flash_bwd_fused_kernelILi8ELb1ELi1EEEvN12flash_bwd_tc4ArgsI13__nv_bfloat16EEi"
    log = "\n".join([
        "ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async instructions are "
        f"serialized due to insufficient register resources for the function '{wg}'",
        f"ptxas info    : Compiling entry function '{fused}' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 72 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{wg}' for 'sm_90a'",
        "ptxas info    : Used 163 registers, used 1 barriers",
        "ptxas info    : Compile time = 700.0 ms"])
    assert chip_smoke.ptxas_report(log) == [
        "    flash_bwd_ble_bf16 D=64: ptxas C7512 Potential Performance Loss: wgmma.mma_async "
        "instructions are serialized due to insufficient register resources",
        "    flash_bwd_ble_bf16 D=8:",
        "      0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "      Used 72 registers, used 1 barriers",
        "    flash_bwd_ble_bf16 D=64:",
        "      Used 163 registers, used 1 barriers"]


def test_chip_smoke_names_existing_sources():
    for name, (source, replaces) in chip_smoke.KERNELS.items():
        assert (ROOT / source).is_file(), (name, source)
        path, line = replaces.split(":")
        text = (ROOT / path).read_text().splitlines()[int(line) - 1]
        assert text.startswith("def _"), (name, text)
    assert set(build.TENSOR_CORE_KERNELS) <= set(chip_smoke.KERNELS)


def test_variant_substitutions_find_their_targets():
    tkv = _variants_module()
    for name, (tree, source, entry, subs) in tkv.VARIANTS.items():
        assert entry in tkv.SHAPES, name
        if tree != "new":
            continue
        assert os.path.isfile(os.path.join(tkv.CSRC, source)), name
        for fname, file_subs in subs.items():  # raises on a target not found
            tkv.substitute((Path(tkv.CSRC) / fname).read_text(), file_subs)


def _gate_model():
    """The flagship in the bench configuration at tiny widths, dropout 0,
    130 patches (Q1's bf16 plain version runs), phase 9's step setting."""
    import dataclasses

    from gemm_gan_tpu_torch.config import variant_config

    exp = variant_config("film_cross_attention", n_genes=24, fusion_kw=dict(
        cond_dim=16, text_dim=12, patch_dim=16, ff_dim=32, num_heads=2, num_layers=1))
    exp = dataclasses.replace(exp, model=dataclasses.replace(
        exp.model, gen_dims=(32, 32), disc_dims=(32, 32), latent_dim=16,
        compute_dtype="bfloat16"))
    return chip_smoke.train_cfg(exp, dropout=0.0)


def test_bf16_gradient_gate_accepts_plain_versions_and_rejects_both_controls():
    """Phase 9 (b)'s gradient gate, run on the CPU: the kernels' plain
    versions (what a wrapper runs on the CPU) land exactly on the CPU's
    gradients and pass; Q1 wrong by its output scaled by 1 + 2^-5, or by
    its last valid key of every row masked out, is rejected (the gate
    raises unless both are): both controls move both nets' fusion
    gradients."""
    from gemm_gan_tpu_torch.data.synthetic import synthetic_dataset

    cfg = _gate_model()
    d = synthetic_dataset(n=chip_smoke.BATCH, n_genes=24, num_patches=130, patch_dim=16,
                          num_tokens=6, text_dim=12, seed=1)
    batch = {k: d[k] for k in ("genes", "tokens", "token_mask", "patches", "patch_mask")}
    args = (chip_smoke.flax_param_tree(cfg.model, seed=0),
            chip_smoke.flax_param_tree(cfg.model, seed=1, critic=True), batch,
            chip_smoke.random_draws(cfg, seed=9))
    gate = chip_smoke.grad_gate(tfa, cfg, "cpu", args, "flash_fwd_ble_bf16")
    assert gate["plain"] == {"D": 0.0, "G": 0.0}, gate
    assert gate["kernels"]["D"] == gate["kernels"]["G"] == 0.0, gate
    assert gate["kernels"]["largest ratio to its limit"][0] == 0.0, gate
    for how in ("scaled", "last_key_masked"):  # beyond the floor: every limit is the floor
        assert gate[how]["largest ratio to its limit"][0] > 1, (how, gate)
        assert min(gate[how]["D"], gate[how]["G"]) > 0, (how, gate)
    assert gate["launches"] == {}  # CPU tensors launch nothing
    assert tfa.flash_fwd_ble_bf16.__name__ == "flash_fwd_ble_bf16"  # the wrapper is back


def test_attention_gate_accepts_plain_versions_and_rejects_its_control():
    """Phase 11 (b)'s attention gate, run on the CPU at the f32 flagship's
    tiny widths: the plain versions land exactly on the CPU's outputs and
    gradients (ratio 0); Q1's output scaled by 1 + 2^-12, 2.4 times the
    floor, and Q1 with the last valid key of every row masked out are
    rejected."""
    import dataclasses

    from gemm_gan_tpu_torch.data.synthetic import synthetic_dataset

    cfg = _gate_model()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                             compute_dtype="float32"))
    d = synthetic_dataset(n=chip_smoke.BATCH, n_genes=24, num_patches=130, patch_dim=16,
                          num_tokens=6, text_dim=12, seed=1)
    batch = {k: d[k] for k in ("genes", "tokens", "token_mask", "patches", "patch_mask")}
    gate = chip_smoke.attention_gate(tfa, cfg, "cpu", chip_smoke.flax_param_tree(cfg.model, 0),
                                     chip_smoke.flax_param_tree(cfg.model, 1, critic=True),
                                     batch)
    assert gate["attentions"] == 2 and gate["launches"] == {}  # one layer in each net
    assert gate["plain_largest"] == 0.0 and gate["kernels"][0] == 0.0, gate
    for how in ("scaled", "last_key_masked"):
        assert gate[how][0] > 1, (how, gate)
    assert tfa.flash_mha_ble.__name__ == "flash_mha_ble"  # the recorder is gone


def test_batchnorm_trees_have_the_jax_paths():
    """`flax_param_tree` / `flax_batch_stats` of a `use_batchnorm` model
    give the paths and shapes of the JAX generator's and critic's init."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from gemm_gan_tpu import config as jconfig
    from gemm_gan_tpu.models.gan import Critic, Generator

    exp = jconfig.variant_config("film_cross_attention", n_genes=24, fusion_kw=dict(
        cond_dim=16, text_dim=12, patch_dim=16, ff_dim=32, num_heads=2, num_layers=1))
    m = dataclasses.replace(exp.model, gen_dims=(32, 16), disc_dims=(16,), latent_dim=8,
                            use_batchnorm=True)
    cond = {"tokens": jnp.zeros((2, 6, 12)), "token_mask": jnp.ones((2, 6), bool),
            "patches": jnp.zeros((2, 8, 16)), "patch_mask": jnp.ones((2, 8), bool)}
    for net, x, critic in ((Generator(m), jnp.zeros((2, 8)), False),
                           (Critic(m), jnp.zeros((2, 24)), True)):
        want = jax.tree.map(jnp.shape, net.init(jax.random.key(0), x, cond))
        got = jax.tree.map(jnp.shape, {"params": chip_smoke.flax_param_tree(m, 0, critic),
                                       "batch_stats": chip_smoke.flax_batch_stats(m, 0, critic)})
        assert got == want
    stats = chip_smoke.flax_batch_stats(m, 0)
    assert all(v["BatchNorm_0"]["var"].min() >= 0.5 for v in stats["trunk"].values())


def test_tensor_distances_hold_zero_gradient_params_to_their_net():
    """A k projection's bias (exact gradient 0: ZERO_GRAD_SUFFIX) is measured
    against NEGLIGIBLE_GRAD of its net's norm when its own gradient is
    smaller; any other param, however small its gradient, against its own."""
    import math

    import torch

    ref = {"D": {"w": torch.ones(100, dtype=torch.float64),
                 "attn.k_proj.bias": torch.full((3,), 1e-9, dtype=torch.float64),
                 "attn.q_proj.bias": torch.full((3,), 1e-9, dtype=torch.float64)}}
    got = {"D": {"w": ref["D"]["w"] * (1 + 1e-3),
                 **{n: -ref["D"][n] for n in ("attn.k_proj.bias", "attn.q_proj.bias")}}}
    d = chip_smoke.tensor_distances(got, ref)["D"]
    net = math.sqrt(100 + 6 * 1e-18)
    assert d["w"] == pytest.approx(1e-3)
    assert d["attn.k_proj.bias"] == pytest.approx(
        2e-9 * math.sqrt(3) / (chip_smoke.NEGLIGIBLE_GRAD * net))
    assert d["attn.q_proj.bias"] == pytest.approx(2.0)


def test_label_agreement():
    import numpy as np

    y = np.array([[0.0, 0.0], [0.1, 0.0], [0.0, 0.1], [5.0, 5.0], [5.1, 5.0], [5.0, 5.1]])
    assert chip_smoke.label_agreement(y, np.array([0, 0, 0, 1, 1, 1]), 2) == 1.0
    assert chip_smoke.label_agreement(y, np.array([0, 1, 0, 1, 0, 1]), 2) == pytest.approx(1 / 3)


def test_drop_last_valid_key():
    import torch

    mask = torch.tensor([[True, True, False, False], [True, True, True, True],
                         [False, False, False, False]])
    assert chip_smoke.drop_last_valid_key(mask).tolist() == [
        [True, False, False, False], [True, True, True, False], [False] * 4]


def test_kernel_attentions_follow_masked_mha_routes():
    """How many attentions of one fusion forward reach a kernel, by route,
    at the canonical and the whole-slide patch counts (300 tokens)."""
    from gemm_gan_tpu_torch.config import variant_config

    want = {"film_cross_attention": ({"ble": 2}, {"bhld": 2}),
            "cross_attention": ({"ble": 4}, {"bhld": 3, "ble": 1}),
            "img_transformer": ({"ble": 2}, {"bhld": 2}), "film": ({"ble": 2}, {"bhld": 2}),
            "attention": ({}, {}), "concat_image": ({}, {}), "benchmark": ({}, {}),
            "vanilla": ({}, {})}
    for variant, (canonical, whole_slide) in want.items():
        cfg = variant_config(variant)
        assert chip_smoke.kernel_attentions(cfg) == canonical, variant
        assert chip_smoke.kernel_attentions(cfg, patches=4096) == whole_slide, variant
    assert chip_smoke.step_launches(variant_config("cross_attention")) == (4 * 8, 4 * 6)


A, B = {"gemm": 4, "copy": 1}, {"gemm": 4}  # B: a reading that lost a record


@pytest.mark.parametrize("readings, settled", [
    ([(True, A), (True, A)], 1),
    ([(True, B), (True, A), (True, A)], 2),
    ([(True, A), (False, B), (True, A)], 2),  # a reading that is not whole is passed over
    ([(False, A), (False, A), (True, A)], None),  # two readings that are not whole never agree
    ([(True, {}), (True, {})], None),  # a reading with no records settles nothing
    ([(True, A), (True, B), (True, A), (True, B)], None),
])
def test_agreeing_reading(readings, settled):
    assert chip_smoke.agreeing_reading(readings) == settled
