"""The paper's other GAN variants through the port's training engine and
`cli.train`, on the CPU.

* Two engine steps (per_update, batched_scores) of `cross_attention` and
  of the `benchmark` label oracle against the JAX engine from the same
  Flax params and draws, held as tests/test_torch_train.py holds the
  flagship's (metrics rtol 2e-3 / atol 2e-4, params atol 5e-5 but for
  entries whose gradient is rounding). cross_attention runs 130 patches
  and 130 tokens, so the patch self-attention and both text-query
  attentions reach Q1 / Q2's plain versions behind their autograd Function.
* The torch twin of tests/test_dynamics_acceptance.py's label-oracle
  conditioning gate, on its data seed, dims, epochs and bars (TSTR > 0.7
  and > TSTR before training + 0.3, aligned < 0.7 x shuffled); the
  per-variant gates are in tests/test_torch_variant_gates.py.
* `cli.train` end to end for `cross_attention` (tokens) and `concat_image`
  (the multi_patch schema, which also reads the text-CLS table).
"""

import _torch_test_threads  # noqa: F401  (one torch thread per test process)
import dataclasses
import json
import os
import pickle

import jax
import numpy as np
import pandas as pd
import pytest
import torch

import gemm_gan_tpu as gg
from gemm_gan_tpu.train.wgan import WGANGPEngine as JEngine
from gemm_gan_tpu_torch.cli import experiment as expmod
from gemm_gan_tpu_torch.cli import train as cli_train
from gemm_gan_tpu_torch.config import variant_config
from gemm_gan_tpu_torch.data.loader import Batches
from gemm_gan_tpu_torch.data.synthetic import structured_dataset, synthetic_dataset
from gemm_gan_tpu_torch.eval.utility import class_mean_alignment, tstr_transfer_accuracy
from gemm_gan_tpu_torch.kernels import flash_attention as tfa
from gemm_gan_tpu_torch.train.wgan import WGANGPEngine
from test_torch_train import (STEP_ATOL, STEP_RTOL, _assert_params_match, _close, _jax_draws,
                              _port_cfg)

B = 4
# the conditioning keys each variant's batches carry (labels for the dumps)
VARIANT_KEYS = {"cross_attention": ("tokens", "token_mask", "patches", "patch_mask"),
                "benchmark": ("disease", "site")}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: a training run of tiny widths is many small ops,
    which torch's thread pool only slows (and the suite runs files side by
    side)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    tfa.reset_launch_counts()
    yield
    assert not any(tfa.launch_counts().values()), "CPU tensors must never launch a kernel"


def _jax_cfg(variant):
    cfg = gg.variant_config(variant, n_genes=24, fusion_kw=dict(
        cond_dim=16, text_dim=12, patch_dim=16, ff_dim=32, num_heads=2, num_layers=1,
        dropout=0.0, use_pallas=False, n_disease_types=3, n_primary_sites=2,
        label_embed_dim=8))
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, gen_dims=(32, 32), disc_dims=(32, 32),
                                  latent_dim=16),
        train=dataclasses.replace(cfg.train, n_critic=2, cond_embed_reuse="per_update",
                                  batched_scores=True, lr_halve_every_epochs=1))


@pytest.mark.parametrize("variant", sorted(VARIANT_KEYS))
def test_two_engine_steps_match_jax_engine(variant, monkeypatch):
    """Two fused steps of the port's engine against the JAX engine's: the
    metrics after each step, the params and optimizer counts after each."""
    jcfg = _jax_cfg(variant)
    d = synthetic_dataset(n=2 * B, n_genes=24, n_classes=3, n_sites=2, num_patches=130,
                          patch_dim=16, num_tokens=130, text_dim=12, seed=1)
    batches = [{k: d[k][i * B:(i + 1) * B] for k in ("genes", *VARIANT_KEYS[variant])}
               for i in range(2)]
    calls = []
    inner = tfa.flash_mha_ble
    monkeypatch.setattr(tfa, "flash_mha_ble",
                        lambda *a, **kw: calls.append(1) or inner(*a, **kw))
    jeng = JEngine(jcfg, steps_per_epoch=2)
    jstate = jeng.init_state(0, batches[0])
    peng = WGANGPEngine(_port_cfg(jcfg), steps_per_epoch=2, device="cpu")
    pstate = peng.state_from_flax(jax.device_get(jstate.g_params),
                                  jax.device_get(jstate.d_params))
    for step, batch in enumerate(batches):
        draws = _jax_draws(jstate, jcfg, B)
        jstate, jm = jeng.step(jstate, batch)
        pstate, pm = peng.step(pstate, batch, draws=draws)
        assert pm.keys() == jm.keys() and pstate.step == step + 1
        for k in jm:
            _close(pm[k], jm[k], STEP_RTOL, STEP_ATOL, f"{variant} step {step}, {k}")
        _assert_params_match(pstate.gen, pstate.g_opt, jstate.g_params,
                             jstate.g_opt_state, f"{variant} step {step}, generator")
        _assert_params_match(pstate.critic, pstate.d_opt, jstate.d_params,
                             jstate.d_opt_state, f"{variant} step {step}, critic")
    # per step: 1 + n_critic + 2 fusion forwards, 3 ble attentions each
    assert len(calls) == (2 * (5 * 3) if variant == "cross_attention" else 0), len(calls)


# ------------------------------------------------- the label oracle's gate
def _standardized(data, n_tr):
    g = data["genes"]
    mu, sd = g[:n_tr].mean(0), g[:n_tr].std(0) + 1e-8
    return ((g - mu) / sd).astype(np.float32)


def test_conditioning_steers_generation_fast_gate():
    """The torch twin of the label oracle's gate (1,024 cases, 40 epochs, 4
    classes): TSTR before training near chance, after it above 0.7, and the
    per-class means aligned far better than a label-shuffled control."""
    n_tr, n_te, n_classes = 1024, 512, 4
    data = structured_dataset(n_tr + n_te, n_genes=64, rank=8, n_classes=n_classes,
                              n_sites=3, num_patches=4, patch_dim=8, num_tokens=4,
                              text_dim=8, seed=7)
    std = _standardized(data, n_tr)
    tr = {"genes": std[:n_tr], "disease": data["disease"][:n_tr], "site": data["site"][:n_tr]}
    te_genes, te_y = std[n_tr:], data["disease"][n_tr:]

    cfg = variant_config("benchmark", n_genes=64,
                         fusion_kw=dict(n_disease_types=n_classes, n_primary_sites=3,
                                        label_embed_dim=16))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=32, drift_epsilon=1e-3))
    loader = Batches(tr, batch_size=32, seed=0)
    torch.manual_seed(0)
    eng = WGANGPEngine(cfg, steps_per_epoch=loader.n_full_batches, device="cpu")
    state = eng.init_state(0, next(iter(loader)))
    gen_tr = Batches(tr, 32, seed=0, shuffle=False)

    def measure(e):
        out = eng.generate_samples_all(state, gen_tr.epoch(0), 1,
                                       torch.Generator().manual_seed(123 + e))
        return (tstr_transfer_accuracy(out["fake"], out["disease"], te_genes, te_y),
                *class_mean_alignment(out["fake"], out["disease"], te_genes, te_y))

    tstr0, _, _ = measure(0)
    for e in range(40):
        state, last = eng.step_many(state, loader.stacked_epoch(e))
    d_loss = float(last["d_loss"])
    tstr1, aligned1, shuffled1 = measure(41)
    assert np.isfinite(d_loss) and abs(d_loss) < 50, d_loss
    assert tstr0 < 0.45, tstr0
    assert tstr1 > 0.7 and tstr1 > tstr0 + 0.3, (tstr0, tstr1)
    assert aligned1 < 0.7 * shuffled1, (aligned1, shuffled1)


# --------------------------------------------------------------- cli.train
N_CASES, N_GENES, PATCH_DIM, TEXT_DIM, TOKENS = 30, 40, 16, 12, 6


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """tests/test_cli_train.py's layout: expression, the text-CLS table
    (the multi_patch schema's `text_emb`), per-case patches and tokens with
    their masks, labels."""
    d = tmp_path_factory.mktemp("tcga_variants")
    rng = np.random.RandomState(0)
    cases = [f"case-{i:03d}" for i in range(N_CASES)]
    index = pd.Index(cases, name="case_id")
    pd.DataFrame(rng.rand(N_CASES, N_GENES) * 8, index=index,
                 columns=[f"ENSG{i:05d}" for i in range(N_GENES)]
                 ).to_parquet(os.path.join(d, "rna_seq.parquet"))
    cls = pd.DataFrame(rng.randn(N_CASES, TEXT_DIM).astype(np.float32), index=index)
    cls.columns = [str(c) for c in cls.columns]
    cls.to_parquet(os.path.join(d, "clinical_modernbert_embeddings.parquet"))
    pdir = os.path.join(d, "patch_embeddings_uni")
    tdir = os.path.join(d, "clinical_modernbert_embeddings")
    os.makedirs(pdir)
    os.makedirs(tdir)
    for c in cases:
        np.save(os.path.join(pdir, f"{c}.npy"),
                rng.randn(rng.randint(2, 12), PATCH_DIM).astype(np.float32))
        np.save(os.path.join(tdir, f"{c}.npy"), rng.randn(TOKENS, TEXT_DIM).astype(np.float32))
        np.save(os.path.join(tdir, f"{c}_attention_mask.npy"),
                np.arange(TOKENS) < rng.randint(2, TOKENS + 1))
    metainfos = {c: {"disease_type": ["Adeno", "Squamous", "Glioma"][i % 3],
                     "primary_site": ["Lung", "Brain"][i % 2]} for i, c in enumerate(cases)}
    with open(os.path.join(d, "metainfos.pkl"), "wb") as f:
        pickle.dump(metainfos, f)
    return str(d)


@pytest.mark.parametrize("variant,keys", [
    ("cross_attention", ("tokens", "token_mask", "patches", "patch_mask")),
    ("concat_image", ("text_emb", "patches", "patch_mask"))])
def test_cli_train_variant_end_to_end(variant, keys, data_dir, tmp_path):
    """fit with validation every epoch (the on-device proxy), one test run
    with its dumps and labels, the post-hoc suites, then `--evaluate_only
    --evaluate_which best`; the fusion is sized from the data and the bank
    holds what the variant reads."""
    out = str(tmp_path / "out")
    args = ["--variant", variant, "--data_dir", data_dir, "--output_path", out,
            "--run_name", "cli", "--batch_size", "8", "--latent_dim", "8", "--hidden_dim", "16",
            "--n_critic", "2", "--critic_scan", "--device", "cpu", "--epochs", "2",
            "--num_patches", "8", "--freq_compute_test", "1", "--on_device_validation",
            "--n_runs", "1"]
    banks = []
    init = expmod.Experiment.__init__

    def spy(self, cfg, splits, *a, **kw):
        init(self, cfg, splits, *a, **kw)
        banks.append({k: a.dtype for k, a in self.loaders["train"].arrays.items()})

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(expmod.Experiment, "__init__", spy)
        res = cli_train.main(args)
    assert np.isfinite(res["gamma_mean"]) and "utility" in res and "privacy" in res
    # the bank holds what the variant reads, the labels for the dumps in
    # their integer dtype
    assert sorted(banks[0]) == sorted(("genes", "disease", "site", *keys)), banks
    assert banks[0]["disease"] == banks[0]["site"] == torch.int32, banks
    run_dir = os.path.join(out, "cli")
    with open(os.path.join(run_dir, "config.json")) as f:
        saved = json.load(f)
    fusion = saved["model"]["fusion"]
    assert (fusion["text_dim"], fusion["patch_dim"]) == (TEXT_DIM, PATCH_DIM)
    dumps = [p for p in os.listdir(run_dir) if p.startswith("test_")]
    assert dumps and "test_labels_gen.npy" in os.listdir(os.path.join(run_dir, dumps[0])), dumps
    with open(os.path.join(run_dir, "best.json")) as f:
        best = json.load(f)
    res = cli_train.main(args + ["--evaluate_only", "--evaluate_which", "best"])
    assert np.isfinite(res["gamma_mean"])
    assert os.path.isdir(os.path.join(run_dir, f"test_0_epoch_{best['epoch']}"))


def test_cli_train_takes_the_variant_presets_as_jax_does(data_dir, tmp_path, monkeypatch):
    """`cli.train --variant benchmark` resolves the same test-block and
    validation cadence as the JAX package's `cli.train`: the preset's
    `n_runs` 10 passes through, and the `--freq_compute_test` flag
    (default 50) replaces the preset's 100 in both."""
    import gemm_gan_tpu.cli.experiment as jexpmod
    from gemm_gan_tpu.cli import train as jcli_train

    seen = {}

    def fake(name):
        class Experiment:
            def __init__(self, cfg, splits, **kw):
                seen[name] = cfg
                self.out_dir = str(tmp_path / name)
                os.makedirs(self.out_dir, exist_ok=True)

            def fit(self, **kw):
                return {"gamma_mean": 0.0}

            def posthoc_utility(self):
                return {}

            def posthoc_privacy(self):
                return {}
        return Experiment

    monkeypatch.setattr(expmod, "Experiment", fake("port"))
    monkeypatch.setattr(jexpmod, "Experiment", fake("jax"))
    args = ["--variant", "benchmark", "--data_dir", data_dir, "--output_path", str(tmp_path),
            "--epochs", "1"]
    cli_train.main(args + ["--device", "cpu"])
    jcli_train.main(args)
    for name in ("port", "jax"):
        assert seen[name].eval.n_runs == 10, name
        assert seen[name].train.freq_compute_test == 50, name
        assert seen[name].model.fusion.kind == "labels", name
    assert seen["port"].model.fusion.n_disease_types == seen["jax"].model.fusion.n_disease_types
