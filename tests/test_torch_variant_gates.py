"""The torch twins of tests/test_dynamics_acceptance.py's per-variant
conditioning gate, on its data seed, dims, epochs and bars, for the six
fusion variants of the reference's ablation (512 cases, 10 epochs, 64
genes, 4 classes, chance 0.25): the disease label is never an input, only
recoverable from the class-correlated text / patch embeddings the variant
reads, so TSTR > 0.7 and aligned < 0.75 x shuffled fail if its fusion
ignores them. The flagship's twin is in tests/test_torch_experiment.py,
the label oracle's in tests/test_torch_variants.py.
"""

import _torch_test_threads  # noqa: F401  (one torch thread per test process)
import dataclasses

import pytest
import torch

from gemm_gan_tpu_torch.config import variant_config
from gemm_gan_tpu_torch.data.loader import Batches
from gemm_gan_tpu_torch.data.synthetic import structured_dataset
from gemm_gan_tpu_torch.eval.utility import class_mean_alignment, tstr_transfer_accuracy
from gemm_gan_tpu_torch.train.wgan import WGANGPEngine
from test_torch_variants import _standardized, one_thread

assert one_thread  # the autouse fixture runs here too

# conditioning inputs each fusion variant consumes
# (tests/test_dynamics_acceptance.py::_VARIANT_COND)
_VARIANT_COND = {
    "concat_text": ("text_emb",),
    "concat_image": ("patches", "patch_mask"),
    "attention": ("text_emb", "patches", "patch_mask"),
    "img_transformer": ("patches", "patch_mask"),
    "film": ("text_emb", "patches", "patch_mask"),
    "cross_attention": ("tokens", "token_mask", "patches", "patch_mask"),
}


@pytest.mark.parametrize("variant", sorted(_VARIANT_COND))
def test_fusion_variant_conditioning_steers_generation(variant):
    """The torch twin of the per-variant gate (512 cases, 10 epochs, 64
    genes, 4 classes, chance 0.25): above-chance TSTR needs the variant's
    fusion to carry the class-correlated text / patch embeddings into
    generation."""
    n_tr, n_te = 512, 256
    data = structured_dataset(n_tr + n_te, n_genes=64, rank=8, n_classes=4, n_sites=3,
                              num_patches=4, patch_dim=8, num_tokens=4, text_dim=8, seed=7)
    data["text_emb"] = data["tokens"][:, 0, :]  # the text CLS stand-in, as in JAX
    std = _standardized(data, n_tr)
    keys = _VARIANT_COND[variant] + ("disease",)
    tr = {"genes": std[:n_tr], **{k: data[k][:n_tr] for k in keys}}
    te_genes, te_y = std[n_tr:], data["disease"][n_tr:]

    cfg = variant_config(variant, n_genes=64,
                         fusion_kw=dict(cond_dim=32, text_dim=8, patch_dim=8, ff_dim=64,
                                        num_heads=2, num_layers=1, use_pallas=False))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=32, drift_epsilon=1e-3, critic_scan=True))
    loader = Batches(tr, batch_size=32, seed=0)
    torch.manual_seed(0)
    eng = WGANGPEngine(cfg, steps_per_epoch=loader.n_full_batches, device="cpu")
    state = eng.init_state(0, next(iter(loader)))
    for e in range(10):
        state, _ = eng.step_many(state, loader.stacked_epoch(e))
    out = eng.generate_samples_all(state, Batches(tr, 32, seed=0, shuffle=False).epoch(0), 1,
                                   torch.Generator().manual_seed(123))
    tstr = tstr_transfer_accuracy(out["fake"], out["disease"], te_genes, te_y)
    aligned, shuffled = class_mean_alignment(out["fake"], out["disease"], te_genes, te_y)
    assert tstr > 0.7, (variant, tstr)
    assert aligned < 0.75 * shuffled, (variant, aligned, shuffled)
