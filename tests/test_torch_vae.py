"""The port's VAE family (`models/vae.py`, `train/vae.py`,
`cli/vae_experiment.py`, `warmup_exp_decay`, the checkpoint and `convert.py`
rules) against the JAX package on the same numpy inputs, at tiny widths:

* the VAE and CVAE forward in f32 and bf16 given JAX's reparameterization
  noise, the losses, the weight bridge both ways;
* `warmup_exp_decay` across the warmup boundary;
* five engine steps given JAX's draws (params within 1e-5 relative), the
  graphed body against sequential steps (bitwise), exact resume;
* `VAEExperiment`'s dump contract and gate-best tracking beside JAX's, and
  `cli.train --variant vae|cvae`;
* the twins of tests/test_dynamics_acceptance.py's VAE and CVAE gates, on
  the port only, with the same data, budget and bars.
"""

import _torch_test_threads  # noqa: F401  (one torch thread per test process)
import dataclasses
import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from gemm_gan_tpu.cli.vae_experiment import VAEExperiment as JVAEExperiment
from gemm_gan_tpu.config import variant_config as jax_variant_config
from gemm_gan_tpu.data.loader import Batches as JBatches
from gemm_gan_tpu.models import vae as jvae
from gemm_gan_tpu.train.schedules import warmup_exp_decay as jax_warmup_exp_decay
from gemm_gan_tpu.train.vae import VAEEngine as JVAEEngine
from gemm_gan_tpu_torch.cli.train import main as train_main
from gemm_gan_tpu_torch.cli.vae_experiment import VAEExperiment
from gemm_gan_tpu_torch.config import variant_config
from gemm_gan_tpu_torch.convert import flatten_params, flax_to_state_dict, state_dict_to_flax
from gemm_gan_tpu_torch.data.loader import Batches
from gemm_gan_tpu_torch.data.synthetic import structured_dataset
from gemm_gan_tpu_torch.eval.detection import detection
from gemm_gan_tpu_torch.eval.gamma import gamma_coef_np
from gemm_gan_tpu_torch.eval.utility import class_mean_alignment, tstr_transfer_accuracy
from gemm_gan_tpu_torch.models import vae as tvae
from gemm_gan_tpu_torch.train import checkpoint
from gemm_gan_tpu_torch.train.schedules import ScheduledOptimizer, warmup_exp_decay
from gemm_gan_tpu_torch.train.vae import VAEEngine
from test_torch_experiment import data_dir
from test_torch_variants import one_thread

assert data_dir and one_thread  # the fixtures run here too

N_GENES, LATENT, B = 24, 6, 8
FUSION_KW = dict(n_disease_types=3, n_primary_sites=2, label_embed_dim=8)
# f32: one engine step's params within this of JAX's, relative to each
# param's largest entry, after five Adam updates
PARAM_RTOL = 1e-5


def _cfgs(variant, dtype="float32", recon="mse", **train):
    """The same tiny configuration for both packages."""
    out = []
    for vc in (jax_variant_config, variant_config):
        c = vc(variant, n_genes=N_GENES, fusion_kw=FUSION_KW)
        out.append(dataclasses.replace(
            c, model=dataclasses.replace(c.model, vae_latent_dim=LATENT,
                                         vae_encoder_dims=(32, 16),
                                         vae_decoder_dims=(16, 32),
                                         vae_recon=recon, compute_dtype=dtype),
            train=dataclasses.replace(c.train, batch_size=B, **train)))
    return out


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [{"genes": rng.randn(B, N_GENES).astype(np.float32),
             "disease": rng.randint(0, 3, B), "site": rng.randint(0, 2, B)}
            for _ in range(n)]


def _model_args(variant, batch):
    return ((batch["genes"], batch["disease"], batch["site"]) if variant == "cvae"
            else (batch["genes"],))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _assert_params_close(jparams, model, rtol):
    want = flatten_params(jax.device_get(jparams))
    got = flatten_params(state_dict_to_flax(model.state_dict()))
    assert sorted(got) == sorted(want)
    for k in want:
        assert _rel(got[k], want[k]) <= rtol, (k, _rel(got[k], want[k]))


# ---------------------------------------------------------------- the model
@pytest.mark.parametrize("variant,dtype,recon", [
    ("vae", "float32", "mse"), ("vae", "bfloat16", "mse"), ("vae", "float32", "gaussian_nll"),
    ("cvae", "float32", "mse"), ("cvae", "bfloat16", "mse")])
def test_forward_matches_flax_given_jax_eps(variant, dtype, recon):
    """The forward (reconstruction, mu, logvar) and the prior decode, given
    JAX's eps and z, on Flax's params; f32 within 2e-6 of the largest
    entry, bf16 within one bf16 ulp of it (both compute the MLPs in bf16
    with f32 heads, as Flax's `Dense(dtype=bf16)`)."""
    jcfg, tcfg = _cfgs(variant, dtype, recon)
    jm = (jvae.CVAE if variant == "cvae" else jvae.VAE)(jcfg.model)
    batch = _batches(1)[0]
    args = _model_args(variant, batch)
    params = jm.init(jax.random.key(0), *args, jax.random.key(1))["params"]
    tm = (tvae.CVAE if variant == "cvae" else tvae.VAE)(tcfg.model, device="cpu")
    tm.load_state_dict(flax_to_state_dict(jax.device_get(params)))
    key = jax.random.key(7)
    jout, jmu, jlv = jm.apply({"params": params}, *args, key)
    eps = np.asarray(jax.random.normal(key, (B, LATENT)))
    with torch.no_grad():
        tout, tmu, tlv = tm(*(torch.tensor(a) for a in args), torch.tensor(eps))
    tol = 2e-6 if dtype == "float32" else 2.0 ** -7
    jouts = jout if isinstance(jout, tuple) else (jout,)
    touts = tout if isinstance(tout, tuple) else (tout,)
    for j, t in zip((*jouts, jmu, jlv), (*touts, tmu, tlv), strict=True):
        assert _rel(t, j) <= tol, _rel(t, j)
    # sampling decodes the caller's z (JAX draws it inside)
    if variant == "cvae":
        jsample = jm.apply({"params": params}, key, batch["disease"], batch["site"],
                           method=jm.sample)
        z = np.asarray(jax.random.normal(key, (B, LATENT)))
        tsample = tm.sample(torch.tensor(z), torch.tensor(batch["disease"]),
                            torch.tensor(batch["site"]))
    else:
        jsample = jm.apply({"params": params}, key, 5, method=jm.sample)
        z = np.asarray(jax.random.normal(key, (5, LATENT)))
        tsample = tm.sample(torch.tensor(z))
    assert _rel(tsample.detach(), jsample) <= tol


def test_losses_match_jax():
    rng = np.random.RandomState(3)
    x, out, mu, logvar = (rng.randn(5, k).astype(np.float32) for k in (4, 4, 2, 2))
    t = [torch.tensor(a) for a in (x, out, mu, logvar)]
    for recon, jo, to in (("mse", out, t[1]), ("gaussian_nll", (out, x), (t[1], t[0]))):
        for beta in (1.0, 0.1):
            jl, (jr, jk) = jvae.elbo_loss(x, jo, mu, logvar, beta, recon)
            tl, (tr, tk) = tvae.elbo_loss(t[0], to, t[2], t[3], beta, recon)
            for a, b in ((tl, jl), (tr, jr), (tk, jk)):
                assert float(a) == pytest.approx(float(b), rel=1e-6)


@pytest.mark.parametrize("variant,recon", [("vae", "mse"), ("vae", "gaussian_nll"),
                                           ("cvae", "mse")])
def test_convert_round_trip(variant, recon):
    """Flax tree -> state_dict -> Flax tree is the identity, and every
    port parameter is reached (encoder/decoder `Dense_i`, the heads, the
    CVAE's untransposed tables)."""
    jcfg, tcfg = _cfgs(variant, recon=recon)
    jm = (jvae.CVAE if variant == "cvae" else jvae.VAE)(jcfg.model)
    args = _model_args(variant, _batches(1)[0])
    params = jax.device_get(jm.init(jax.random.key(0), *args, jax.random.key(1))["params"])
    tm = (tvae.CVAE if variant == "cvae" else tvae.VAE)(tcfg.model, device="cpu")
    sd = flax_to_state_dict(params)
    assert sorted(sd) == sorted(tm.state_dict())
    tm.load_state_dict(sd)
    back = flatten_params(state_dict_to_flax(tm.state_dict()))
    want = flatten_params(params)
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    if variant == "cvae":
        np.testing.assert_array_equal(sd["disease_embed.weight"].numpy(),
                                      params["disease_embed"]["embedding"])


# ----------------------------------------------------------------- the rate
def test_warmup_exp_decay_across_the_warmup_boundary():
    """JAX's schedule at every count from 0 to past the boundary (7 steps
    an epoch, 3 warmup epochs), on the host and from a device count, and as
    the optimizer's rate."""
    counts = np.arange(0, 40)
    want = np.asarray(jax.vmap(jax_warmup_exp_decay(1e-3, 7, 3, 0.9))(counts))
    sched = warmup_exp_decay(1e-3, 7, 3, 0.9)
    np.testing.assert_array_equal(sched(torch.tensor(counts)).numpy(), want)
    for c in (0, 20, 21, 22, 39):
        assert sched(c) == float(want[c])
    assert want[0] == 0.0 and want[20] < 1e-3 and want[21] == np.float32(1e-3) > want[22]
    _, tcfg = _cfgs("vae")
    opt = ScheduledOptimizer([torch.nn.Parameter(torch.zeros(2))], tcfg.train, 1e-3, 7,
                             schedule=sched)
    for c in (0, 21, 22):
        opt.count = c
        opt.count_t.fill_(c)
        assert opt.lr == float(want[c]) == float(opt._lr_t())


# --------------------------------------------------------------- the engine
@pytest.mark.parametrize("variant", ["vae", "cvae"])
def test_five_steps_match_jax_given_its_draws(variant):
    """Five engine steps (clip 10, Adam under warmup_exp_decay with a
    1-epoch warmup of 2 steps, so the rate crosses the boundary) from JAX's
    initial params with JAX's eps: metrics within 1e-5 and params within
    PARAM_RTOL of JAX's after each."""
    jcfg, tcfg = _cfgs(variant, vae_lr=1e-2, vae_warmup_epochs=1, vae_clip_grad=1.0)
    batches = _batches(5)
    je = JVAEEngine(jcfg, steps_per_epoch=2)
    js = je.init_state(0, batches[0])
    te = VAEEngine(tcfg, steps_per_epoch=2, device="cpu")
    ts = te.state_from_flax(jax.device_get(js.params))
    for i, b in enumerate(batches):
        eps = np.asarray(jax.random.normal(jax.random.fold_in(js.key, i), (B, LATENT)))
        js, jm = je.step(js, b)
        ts, tm = te.step(ts, b, eps=eps)
        for k in ("loss", "recon", "kl"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5, abs=1e-6), (i, k)
        _assert_params_close(js.params, ts.model, PARAM_RTOL)
    assert ts.step == 5 and ts.opt.count == 5 and int(ts.opt.count_t) == 5


@pytest.mark.parametrize("variant", ["vae", "cvae"])
def test_step_many_matches_sequential_steps_bitwise(variant):
    """`step_many` (the graphed body, run in a loop on the CPU) against the
    same steps one by one, from the same state and generator: params,
    moments and metrics bitwise equal; with and without given eps."""
    _, tcfg = _cfgs(variant, vae_lr=1e-2, vae_warmup_epochs=1)
    batches = _batches(4, seed=1)
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    eps = np.random.RandomState(2).randn(4, B, LATENT).astype(np.float32)
    for given in (None, eps):
        e1, e2 = (VAEEngine(tcfg, steps_per_epoch=2, device="cpu") for _ in range(2))
        s1, s2 = e1.init_state(0, batches[0]), e2.init_state(0, batches[0])
        for i, b in enumerate(batches):
            s1, m1 = e1.step(s1, b, eps=None if given is None else given[i])
        s2, m2 = e2.step_many(s2, stacked, eps=given)
        for a, b in zip(s1.model.state_dict().values(), s2.model.state_dict().values()):
            assert torch.equal(a, b)
        for a, b in zip(s1.opt.nu + s1.opt.mu, s2.opt.nu + s2.opt.mu):
            assert torch.equal(a, b)
        for k in m1:
            assert torch.equal(m1[k], m2[k])
        assert s2.step == 4 and s2.opt.count == 4


def test_checkpoint_resume_is_exact(tmp_path):
    """Save after two steps, run two more; restore into a fresh state and
    run the same two: bitwise equal params, moments, counts and draws."""
    _, tcfg = _cfgs("cvae", vae_lr=1e-2, vae_warmup_epochs=1)
    batches = _batches(4, seed=4)
    eng = VAEEngine(tcfg, steps_per_epoch=2, device="cpu")
    state = eng.init_state(0, batches[0])
    for b in batches[:2]:
        state, _ = eng.step(state, b)
    checkpoint.save_state(str(tmp_path), state)
    for b in batches[2:]:
        state, _ = eng.step(state, b)
    restored = checkpoint.restore_state(str(tmp_path), eng.init_state(1, batches[0]))
    assert restored.step == 2 and restored.opt.count == 2
    for b in batches[2:]:
        restored, _ = eng.step(restored, b)
    for a, b in zip(state.model.state_dict().values(), restored.model.state_dict().values()):
        assert torch.equal(a, b)
    for a, b in zip(state.opt.nu + state.opt.mu, restored.opt.nu + restored.opt.mu):
        assert torch.equal(a, b)
    assert torch.equal(state.rng.get_state(), restored.rng.get_state())
    with pytest.raises(ValueError, match="different engines"):
        from gemm_gan_tpu_torch.train.wgan import WGANGPEngine

        gcfg = variant_config("vanilla", n_genes=N_GENES)
        geng = WGANGPEngine(gcfg, device="cpu")
        checkpoint.restore_state(str(tmp_path), geng.init_state(0, {"genes": batches[0]["genes"]}))


# ------------------------------------------------------------- the protocol
def _experiment_cfgs(tmp, variant, epochs, name):
    out = []
    for c in _cfgs(variant, epochs=epochs, freq_compute_test=2, vae_lr=3e-3,
                   vae_warmup_epochs=1):
        out.append(dataclasses.replace(
            c, output_dir=str(tmp), run_name=name,
            eval=dataclasses.replace(c.eval, n_runs=1, pca_components=4, nearest_k=3)))
    return out


@pytest.mark.parametrize("variant", ["vae", "cvae"])
def test_experiment_dump_contract_and_gate_best_match_jax(tmp_path, variant):
    """Both packages' `VAEExperiment` on the same splits (32 / 8 / 8 cases):
    the same dump files and shapes, the same validation epochs (1 and 3 of
    6), `best.json` with the same keys at the lowest val ELBO, the same
    test-block summary keys; `evaluate("best")` restores best.json's step
    and names its dumps by its epoch; a fresh fit clears stale best state."""
    rng = np.random.RandomState(5)
    data = {"genes": rng.randn(48, N_GENES).astype(np.float32),
            "disease": rng.randint(0, 3, 48), "site": rng.randint(0, 2, 48)}
    keys = ("genes", "disease", "site") if variant == "cvae" else ("genes",)
    idx = {"train": np.arange(0, 32), "val": np.arange(32, 40), "test": np.arange(40, 48)}
    splits = {s: {k: data[k][i] for k in keys} for s, i in idx.items()}
    jcfg, tcfg = _experiment_cfgs(tmp_path / "jax", variant, 6, "v")
    _, tcfg = _experiment_cfgs(tmp_path / "port", variant, 6, "v")
    jexp, texp = JVAEExperiment(jcfg, splits), VAEExperiment(tcfg, splits, device="cpu")
    jres, tres = jexp.fit(), texp.fit()
    assert sorted(tres) == sorted(jres)
    assert sorted(tres["runs"][0]) == sorted(jres["runs"][0])
    assert np.isfinite(tres["gamma_mean"])
    jdirs = sorted(os.path.basename(d) for d in glob.glob(os.path.join(jexp.out_dir, "test_*")))
    tdirs = sorted(os.path.basename(d) for d in glob.glob(os.path.join(texp.out_dir, "test_*")))
    assert tdirs == jdirs == ["test_0_epoch_6"]
    for d in tdirs:
        jf = sorted(glob.glob(os.path.join(jexp.out_dir, d, "*.npy")))
        tf = sorted(glob.glob(os.path.join(texp.out_dir, d, "*.npy")))
        assert [os.path.basename(f) for f in tf] == [os.path.basename(f) for f in jf]
        for a, b in zip(tf, jf):
            assert np.load(a).shape == np.load(b).shape, a
            assert np.isfinite(np.load(a)).all() if np.load(a).dtype.kind == "f" else True
    assert ([r["epoch"] for r in texp.val_metrics_history]
            == [r["epoch"] for r in jexp.val_metrics_history] == [1, 3])
    with open(os.path.join(texp.out_dir, "best.json")) as f:
        best = json.load(f)
    with open(os.path.join(jexp.out_dir, "best.json")) as f:
        assert sorted(best) == sorted(json.load(f))
    assert best["val_loss"] == pytest.approx(min(r["loss"] for r in texp.val_metrics_history))
    assert best["eval_epoch"] in (1, 3) and best["epoch"] == best["eval_epoch"] + 1
    assert best["score"] == pytest.approx(-best["val_loss"])
    assert checkpoint.latest_step(os.path.join(texp.out_dir, "ckpt_best")) == best["step"]
    texp.evaluate("best")
    assert os.path.isdir(os.path.join(texp.out_dir, f"test_0_epoch_{best['epoch']}"))
    # a fresh fit without validation into the same dir clears the stale best
    _, short = _experiment_cfgs(tmp_path / "port", variant, 2, "v")
    VAEExperiment(short, splits, device="cpu").fit()
    assert not os.path.exists(os.path.join(texp.out_dir, "best.json"))
    assert not os.path.isdir(os.path.join(texp.out_dir, "ckpt_best"))


def test_experiment_ragged_split_takes_the_per_batch_path(tmp_path):
    """A train split smaller than a batch (no full batch) trains through
    `step` on its ragged tail, as JAX's drop_remainder=False loaders do."""
    rng = np.random.RandomState(6)
    splits = {s: {"genes": rng.randn(n, N_GENES).astype(np.float32)}
              for s, n in (("train", 5), ("val", 3), ("test", 4))}
    _, tcfg = _experiment_cfgs(tmp_path, "vae", 2, "ragged")
    exp = VAEExperiment(tcfg, splits, device="cpu")
    res = exp.fit()
    assert exp.state.step == 2 and np.isfinite(res["gamma_mean"])
    assert np.load(os.path.join(exp.out_dir, "test_0_epoch_2", "data_gen.npy")).shape == (5, 24)


@pytest.mark.parametrize("variant", ["vae", "cvae"])
def test_cli_train_vae_variants(data_dir, tmp_path, variant):
    """`cli.train --variant vae|cvae` on the TCGA layout: fit with a
    validation, results with privacy (and utility for the CVAE), dumps;
    then `--evaluate_only --evaluate_which best`; `--resume` continues."""
    out = str(tmp_path)
    base = ["--variant", variant, "--data_dir", data_dir, "--output_path", out,
            "--run_name", variant, "--batch_size", "8", "--epochs", "3",
            "--freq_compute_test", "1", "--n_runs", "1", "--device", "cpu"]
    res = train_main(base)
    assert np.isfinite(res["gamma_mean"])
    assert "privacy" in res and ("utility" in res) == (variant == "cvae")
    run = os.path.join(out, variant)
    with open(os.path.join(run, "config.json")) as f:
        assert json.load(f)["variant"] == variant
    with open(os.path.join(run, "best.json")) as f:
        best = json.load(f)
    labels = glob.glob(os.path.join(run, "test_0_epoch_3", "*labels*.npy"))
    assert len(labels) == (8 if variant == "cvae" else 0)
    res = train_main(base + ["--evaluate_only", "--evaluate_which", "best"])
    assert os.path.isdir(os.path.join(run, f"test_0_epoch_{best['epoch']}"))
    assert np.isfinite(res["gamma_mean"])
    with pytest.raises(ValueError, match="VAE variants"):
        train_main(base + ["--shard_bank"])


# --------------------------------------------------- the statistical gates
def _gate_data():
    """tests/test_dynamics_acceptance.py's VAE gate data."""
    n_tr, n_te = 1024, 512
    data = structured_dataset(n_tr + n_te, n_genes=64, rank=8, n_classes=4, n_sites=3,
                              num_patches=4, patch_dim=8, num_tokens=4, text_dim=8, seed=7)
    g = data["genes"]
    mu, sd = g[:n_tr].mean(0), g[:n_tr].std(0) + 1e-8
    std = ((g - mu) / sd).astype(np.float32)
    return data, std, n_tr, n_te


def test_vae_learns_structure_fast_gate():
    """The twin of tests/test_dynamics_acceptance.py::
    test_vae_learns_structure_fast_gate (1,024 cases x 20 epochs, 64 genes,
    β 0.1, latent 16, lr 2e-3): prior samples go from trivially detectable
    and structure-free to LR detection <= 0.85 (and 0.2 below the start)
    and Γ > 0.4 (and 0.4 above the start)."""
    _, std, n_tr, n_te = _gate_data()
    tr, te = {"genes": std[:n_tr]}, {"genes": std[n_tr:]}
    cfg = variant_config("vae", n_genes=64)
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, vae_latent_dim=16),
        train=dataclasses.replace(cfg.train, batch_size=32, vae_lr=2e-3,
                                  vae_warmup_epochs=2, vae_beta=0.1))
    loader = Batches(tr, batch_size=32, seed=0)
    eng = VAEEngine(cfg, steps_per_epoch=loader.n_full_batches, device="cpu")
    state = eng.init_state(0, next(iter(loader)))

    def measure(state):
        gen = torch.Generator().manual_seed(99)
        f_tr = eng.sample(state, gen, num=n_tr)
        f_te = eng.sample(state, gen, num=n_te)
        det = detection(tr["genes"], f_tr, te["genes"], f_te, device="cpu")
        return det["LR"]["accuracy"], float(gamma_coef_np(te["genes"], f_te))

    det0, gamma0 = measure(state)
    for e in range(20):
        state, m = eng.step_many(state, loader.stacked_epoch(e))
    assert np.isfinite(float(m["loss"]))
    det1, gamma1 = measure(state)
    assert det0 > 0.95 and abs(gamma0) < 0.3, (det0, gamma0)
    assert det1 <= det0 - 0.2 and det1 < 0.85, (det0, det1)
    assert gamma1 > 0.4 and gamma1 > gamma0 + 0.4, (gamma0, gamma1)


def test_cvae_conditioning_steers_generation_fast_gate():
    """The twin of tests/test_dynamics_acceptance.py::
    test_cvae_conditioning_steers_generation_fast_gate (β 1, latent 64,
    lr 1e-3, 20 epochs, 4 classes, chance 0.25): TSTR from < 0.45 to >
    0.7 (and 0.3 above the start), aligned < 0.5 x shuffled."""
    data, std, n_tr, _ = _gate_data()
    tr = {"genes": std[:n_tr], "disease": data["disease"][:n_tr],
          "site": data["site"][:n_tr]}
    te_genes, te_y = std[n_tr:], data["disease"][n_tr:]
    cfg = variant_config("cvae", n_genes=64, fusion_kw=dict(
        n_disease_types=4, n_primary_sites=3, label_embed_dim=16))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=32, vae_lr=1e-3, vae_warmup_epochs=2))
    loader = Batches(tr, batch_size=32, seed=0)
    eng = VAEEngine(cfg, steps_per_epoch=loader.n_full_batches, device="cpu")
    state = eng.init_state(0, next(iter(loader)))

    def measure(state):
        fake = eng.sample(state, torch.Generator().manual_seed(99),
                          disease=tr["disease"], site=tr["site"])
        tstr = float(np.atleast_1d(tstr_transfer_accuracy(fake, tr["disease"], te_genes,
                                                          te_y))[0])
        aligned, shuffled = class_mean_alignment(fake, tr["disease"], te_genes, te_y)
        return tstr, float(aligned), float(shuffled)

    tstr0, _, _ = measure(state)
    for e in range(20):
        state, m = eng.step_many(state, loader.stacked_epoch(e))
    assert np.isfinite(float(m["loss"]))
    tstr1, aligned1, shuffled1 = measure(state)
    assert tstr0 < 0.45, tstr0
    assert tstr1 > 0.7 and tstr1 > tstr0 + 0.3, (tstr0, tstr1)
    assert aligned1 < 0.5 * shuffled1, (aligned1, shuffled1)


def test_jax_batches_and_port_batches_agree():
    """The protocol comparisons above rest on both packages' loaders giving
    the same epochs: the same order and the ragged tail."""
    rng = np.random.RandomState(8)
    data = {"genes": rng.randn(21, 4).astype(np.float32)}
    jl = JBatches(data, 8, seed=3, shuffle=True, drop_remainder=False)
    tl = Batches(data, 8, seed=3, shuffle=True, drop_remainder=False)
    for e in range(2):
        for a, b in zip(jl.epoch(e), tl.epoch(e), strict=True):
            np.testing.assert_array_equal(np.asarray(a["genes"]), b["genes"])
