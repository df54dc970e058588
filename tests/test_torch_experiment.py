"""The port's experiment protocol and `cli.train`, end to end on the CPU.

Torch twins of tests/test_experiment.py and tests/test_cli_train.py at tiny
widths (the flagship `film_cross_attention` and `vanilla`; the port serves
no other fusion), the dump contract held to the JAX `Experiment`'s for the
same config and splits (file names, array shapes and dtypes, JSON keys),
and the torch twin of the flagship conditioning gate of
tests/test_dynamics_acceptance.py (a statistical bar: TSTR > 0.7 and
aligned < 0.75 x shuffled).
"""

import _torch_test_threads  # noqa: F401  (one torch thread per test process)
import dataclasses
import glob
import json
import os
import pickle

import numpy as np
import pandas as pd
import pytest
import torch

from gemm_gan_tpu.cli.experiment import Experiment as JExperiment
from gemm_gan_tpu.data.synthetic import synthetic_dataset
from gemm_gan_tpu.eval.knn_pr import get_precision_recall as j_get_precision_recall
from _torch_dist_worker import run_ranks
from gemm_gan_tpu_torch.cli import experiment as expmod
from gemm_gan_tpu_torch.cli.experiment import Experiment
from gemm_gan_tpu_torch.cli.train import main as train_main
from gemm_gan_tpu_torch.config import config_from_dict, variant_config
from gemm_gan_tpu_torch.data.device_cache import ShardedDeviceCache
from gemm_gan_tpu_torch.data.loader import Batches
from gemm_gan_tpu_torch.parallel.mesh import make_mesh
from gemm_gan_tpu_torch.data.synthetic import structured_dataset
from gemm_gan_tpu_torch.eval.knn_pr import get_precision_recall
from gemm_gan_tpu_torch.eval.utility import (UtilityEvaluator, class_mean_alignment,
                                             tstr_transfer_accuracy)
from gemm_gan_tpu_torch.train.checkpoint import latest_step
from gemm_gan_tpu_torch.train.wgan import WGANGPEngine
from gemm_gan_tpu_torch.utils.metrics import TRACER, aggregate_device_trace
from tests.conftest import tiny_cfg as jax_tiny_cfg

CPU = "cpu"


def _data():
    return synthetic_dataset(n=48, n_genes=24, n_classes=3, n_sites=2, num_patches=8,
                             patch_dim=16, num_tokens=6, text_dim=12, seed=1)


def _splits(data, keys=None):
    idx = {"train": np.arange(0, 32), "val": np.arange(32, 40), "test": np.arange(40, 48)}
    keys = keys or list(data)
    out = {s: {k: data[k][i] for k in keys} for s, i in idx.items()}
    out["meta"] = {"n_genes": 24}
    return out


def _cfgs(variant, out_dir, run_name, eval_kw=None, **train_kw):
    """(JAX config, the same config for the port): tests/conftest.py's tiny
    config with n_runs 1, PCA 4, k 3 unless `eval_kw` says otherwise."""
    kw = dict(n_critic=2, batch_size=8)
    kw.update(train_kw)
    jcfg = jax_tiny_cfg(variant, train_kw=kw)
    ev = dict(n_runs=1, pca_components=4, nearest_k=3)
    ev.update(eval_kw or {})
    jcfg = dataclasses.replace(jcfg, output_dir=str(out_dir), run_name=run_name,
                               eval=dataclasses.replace(jcfg.eval, **ev))
    return jcfg, config_from_dict(dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The flagship at tiny widths, 2 epochs, validation after epoch 0 (the
    host suites), 2 test runs: the port's run and the JAX package's."""
    out = tmp_path_factory.mktemp("exp")
    jcfg, cfg = _cfgs("film_cross_attention", out / "port", "t", eval_kw=dict(n_runs=2),
                      epochs=2, freq_compute_test=1)
    torch.manual_seed(0)
    exp = Experiment(cfg, _splits(_data()), device=CPU)
    results = exp.fit()
    jexp = JExperiment(dataclasses.replace(jcfg, output_dir=str(out / "jax")), _splits(_data()))
    jresults = jexp.fit()
    return exp, results, jexp, jresults


def _keys(tree):
    """The nested key structure of a JSON-like tree (lists by their first
    element)."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and tree and isinstance(tree[0], (dict, list)):
        return [_keys(tree[0])]
    return None


def test_fit_produces_summary_and_val_history(runs):
    exp, results, _, _ = runs
    assert np.isfinite(results["gamma_mean"])
    assert len(results["runs"]) == 2
    # freq_compute_test=1 with 2 epochs: one validation (the last epoch goes
    # to the test block)
    assert len(exp.val_metrics_history) == 1
    rec = exp.val_metrics_history[0]
    assert "LR" in rec["detection"] and "precision" in rec["metrics"]
    assert os.path.exists(os.path.join(exp.out_dir, "validation_metrics.png"))
    assert latest_step(os.path.join(exp.out_dir, "ckpt")) == 2 * 4


def test_dump_contract_matches_jax(runs):
    """The same files, npy names, shapes and dtypes, and JSON keys as the
    JAX Experiment writes for the same config and splits."""
    exp, results, jexp, jresults = runs
    assert sorted(os.listdir(exp.out_dir)) == sorted(os.listdir(jexp.out_dir))
    dirs = sorted(os.path.basename(d) for d in glob.glob(os.path.join(exp.out_dir, "test_*")))
    assert dirs == ["test_0_epoch_2", "test_1_epoch_2"]
    for d in dirs:
        got = sorted(os.listdir(os.path.join(exp.out_dir, d)))
        assert got == sorted(os.listdir(os.path.join(jexp.out_dir, d)))
        assert len(got) == 12
        for f in got:
            a = np.load(os.path.join(exp.out_dir, d, f))
            b = np.load(os.path.join(jexp.out_dir, d, f))
            assert (a.shape, a.dtype) == (b.shape, b.dtype), f
    for f in ("val_metrics.json", "best.json"):
        with open(os.path.join(exp.out_dir, f)) as g, open(os.path.join(jexp.out_dir, f)) as h:
            assert _keys(json.load(g)) == _keys(json.load(h)), f
    assert _keys(results) == _keys(jresults)
    with open(os.path.join(exp.out_dir, "t_metrics.jsonl")) as g, \
            open(os.path.join(jexp.out_dir, "t_metrics.jsonl")) as h:
        assert [sorted(json.loads(r)) for r in g] == [sorted(json.loads(r)) for r in h]


def test_evaluate_restores_checkpoint(runs):
    """evaluate() restores the final checkpoint and reruns the test block:
    the dumps are overwritten with bitwise-equal arrays."""
    exp, _, _, _ = runs
    dirs = sorted(glob.glob(os.path.join(exp.out_dir, "test_*_epoch_*")))
    before = {d: {f: np.load(os.path.join(d, f)) for f in os.listdir(d)} for d in dirs}
    results = exp.evaluate()
    assert np.isfinite(results["gamma_mean"])
    assert sorted(glob.glob(os.path.join(exp.out_dir, "test_*_epoch_*"))) == dirs
    for d, files in before.items():
        for f, arr in files.items():
            np.testing.assert_array_equal(arr, np.load(os.path.join(d, f)), err_msg=f"{d}/{f}")


def test_posthoc_utility_and_privacy(runs):
    exp, _, _, _ = runs
    util = exp.posthoc_utility()
    assert "disease" in util and "primary_site" in util
    assert any("TSTR" in s for s in util["disease"])
    priv = exp.posthoc_privacy()
    assert set(priv) == {"dcr", "nndr"}
    for mean, std in priv.values():
        assert np.isfinite(mean) and np.isfinite(std)


def test_generate_balanced_oversamples(runs):
    exp, _, _, _ = runs
    out = exp.generate_balanced(exp.state, torch.Generator().manual_seed(0))
    counts = np.bincount(out["disease"])
    counts = counts[counts > 0]
    raw = np.bincount(exp.splits["train"]["disease"])
    assert counts.max() - counts.min() <= raw.max() - raw.min()
    assert out["fake"].shape == (len(out["disease"]), 24)


def test_best_checkpoint_selection(tmp_path, monkeypatch):
    """A run whose validation quality peaks mid-run (`val_score` pinned to a
    peak at the middle eval): `evaluate("best")` reloads the peak, the
    default "last" the final one, and a fresh fit into the same out_dir
    clears the old best."""
    _, cfg = _cfgs("vanilla", tmp_path, "best", epochs=4, freq_compute_test=1)
    splits = _splits(_data(), ["genes"])
    scores = {0: 1.0, 1: 5.0, 2: 2.0}
    monkeypatch.setattr(expmod, "val_score", lambda rec: scores[rec["epoch"]])
    exp = Experiment(cfg, splits, device=CPU)
    exp.fit()
    spe = len(exp.loaders["train"])
    with open(os.path.join(exp.out_dir, "best.json")) as f:
        best = json.load(f)
    assert best == {"score": 5.0, "epoch": 2, "eval_epoch": 1, "step": 2 * spe}
    assert latest_step(os.path.join(exp.out_dir, "ckpt_best")) == 2 * spe

    res_best = exp.evaluate(which="best")
    assert np.isfinite(res_best["gamma_mean"])
    assert glob.glob(os.path.join(exp.out_dir, "test_*_epoch_2"))
    ev = UtilityEvaluator(exp.out_dir, pattern=f"test_*_epoch_{best['epoch']}", device=CPU)
    assert len(ev.results_dirs) == 1
    assert np.isfinite(exp.evaluate()["gamma_mean"])
    assert glob.glob(os.path.join(exp.out_dir, "test_*_epoch_4"))

    scores.update({0: 0.5, 1: 0.2, 2: 0.1})
    exp2 = Experiment(cfg, splits, device=CPU)
    exp2.fit()
    with open(os.path.join(exp2.out_dir, "best.json")) as f:
        best2 = json.load(f)
    assert best2["eval_epoch"] == 0 and best2["score"] == 0.5
    assert latest_step(os.path.join(exp2.out_dir, "ckpt_best")) == spe


def test_validation_max_cases_caps_train_regen(tmp_path, monkeypatch):
    """The cap applies to the train-side regeneration of validation only."""
    _, cfg = _cfgs("vanilla", tmp_path, "cap", eval_kw=dict(validation_max_cases=16),
                   epochs=2, freq_compute_test=1)
    exp = Experiment(cfg, _splits(_data(), ["genes"]), device=CPU)  # 32 train cases
    seen = []
    orig = exp.engine.generate_samples_all

    def spy(state, batches, *args, **kw):
        batches = list(batches() if callable(batches) else batches)
        seen.append(sum(b["genes"].shape[0] for b in batches))
        return orig(state, batches, *args, **kw)

    monkeypatch.setattr(exp.engine, "generate_samples_all", spy)
    exp.fit()
    assert seen[0] == 16 and seen[1] == 8, seen
    assert 32 in seen[2:], seen


def test_evaluate_best_without_validation_raises(tmp_path):
    _, cfg = _cfgs("vanilla", tmp_path, "nb", epochs=1, freq_compute_test=100)
    exp = Experiment(cfg, _splits(_data(), ["genes"]), device=CPU)
    with pytest.raises(FileNotFoundError, match="best"):
        exp.evaluate(which="best")
    with pytest.raises(ValueError, match="which"):
        exp.evaluate(which="newest")


def test_multi_device_settings_raise(tmp_path):
    """`data.shard_bank` needs a mesh (ValueError, as the JAX package's
    `cli.train`); with a one-rank mesh the Experiment takes host batches
    and a `ShardedDeviceCache`, as the JAX multi-process one."""
    _, cfg = _cfgs("vanilla", tmp_path, "m")
    sharded = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, shard_bank=True))
    with pytest.raises(ValueError, match="needs a mesh"):
        Experiment(sharded, _splits(_data(), ["genes"]), device=CPU)
    mesh = make_mesh(device=CPU)
    exp = Experiment(cfg, _splits(_data(), ["genes"]), mesh=mesh)
    assert isinstance(exp.loaders["train"], Batches) and exp.engine.mesh is mesh
    exp = Experiment(sharded, _splits(_data(), ["genes"]), mesh=mesh)
    assert isinstance(exp.loaders["train"], ShardedDeviceCache)
    assert all(isinstance(v, Batches) for v in exp.gen_loaders.values())


def test_vanilla_test_block_reports_pr_at_k(tmp_path):
    """kNN precision/recall@k per test run; sizes >= the manifold are
    dropped; the values equal a direct call, the port's and the JAX
    package's, on the dumped arrays."""
    assert variant_config("vanilla").eval.pr_nhood_sizes == (10, 20, 50)
    _, cfg = _cfgs("vanilla", tmp_path, "pr", eval_kw=dict(pr_nhood_sizes=(3, 64)),
                   epochs=1, freq_compute_test=5)
    exp = Experiment(cfg, _splits(_data(), ["genes"]), device=CPU)
    run = exp.fit()["runs"][0]
    assert "precision@64" not in run and "recall@64" not in run
    d = os.path.join(exp.out_dir, "test_0_epoch_1")
    real, gen = (np.load(os.path.join(d, f)) for f in ("test_real.npy", "test_gen.npy"))
    p, r = get_precision_recall(real, gen, nb_nn=(3,), device=CPU)
    assert (run["precision@3"], run["recall@3"]) == (p, r)
    jp, jr = j_get_precision_recall(real, gen, nb_nn=(3,))
    assert run["precision@3"] == pytest.approx(jp, abs=1e-6)
    assert run["recall@3"] == pytest.approx(jr, abs=1e-6)


def test_on_device_validation_proxy(tmp_path):
    """eval.on_device_validation: validation generates into device tensors
    and records the kNN-detection + PRDC proxy."""
    _, cfg = _cfgs("film_cross_attention", tmp_path, "proxy",
                   eval_kw=dict(on_device_validation=True), epochs=2, freq_compute_test=1)
    exp = Experiment(cfg, _splits(_data()), device=CPU)
    assert np.isfinite(exp.fit()["gamma_mean"])
    assert len(exp.val_metrics_history) == 1
    rec = exp.val_metrics_history[0]
    assert set(rec["detection"]) == {"KNN"}
    assert 0.0 <= rec["detection"]["KNN"]["accuracy"] <= 1.0
    for k in ("precision", "recall", "density", "coverage"):
        assert np.isfinite(rec["metrics"][k])
    assert os.path.exists(os.path.join(exp.out_dir, "validation_metrics.png"))


def test_fit_profile_window_writes_trace(tmp_path):
    _, cfg = _cfgs("vanilla", tmp_path, "p", epochs=3, freq_compute_test=10)
    prof_dir = str(tmp_path / "prof")
    exp = Experiment(cfg, _splits(_data(), ["genes"]), device=CPU)
    exp.fit(profile_dir=prof_dir, profile_epochs=1)
    assert exp.profile_captured
    agg = aggregate_device_trace(prof_dir)
    assert os.path.exists(agg["trace_path"])
    assert agg["by_op"] and agg["by_category"]
    # the tracer was on over the fit, and is off after it
    assert exp.trace_summary["counters"]["epochs"] == 3 and exp.trace_summary["stage_ms"]
    assert not TRACER.on


# --------------------------------------------------------------- cli.train
N_CASES, N_GENES, PATCH_DIM, TEXT_DIM, TOKENS = 30, 40, 16, 12, 6


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """The layout of tests/test_cli_train.py's fixture."""
    d = tmp_path_factory.mktemp("tcga_cli_port")
    rng = np.random.RandomState(0)
    cases = [f"case-{i:03d}" for i in range(N_CASES)]
    expr = rng.rand(N_CASES, N_GENES) * 8
    pd.DataFrame(expr, index=pd.Index(cases, name="case_id"),
                 columns=[f"ENSG{i:05d}" for i in range(N_GENES)]
                 ).to_parquet(os.path.join(d, "rna_seq.parquet"))
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


def _cli_args(variant, data_dir, out, run_name, *extra):
    return ["--variant", variant, "--data_dir", data_dir, "--output_path", out,
            "--run_name", run_name, "--batch_size", "8", "--latent_dim", "8",
            "--hidden_dim", "16", "--n_critic", "2", "--critic_scan", "--device", "cpu",
            *extra]


def test_cli_train_film_cross_attention_end_to_end(data_dir, tmp_path):
    """fit with validation every epoch (so ckpt_best exists), the post-hoc
    suites, then `--evaluate_only --evaluate_which best`."""
    out = str(tmp_path / "out")
    args = _cli_args("film_cross_attention", data_dir, out, "cli", "--epochs", "2",
                     "--num_patches", "8", "--freq_compute_test", "1")
    res = train_main(args)
    assert np.isfinite(res["gamma_mean"]) and "utility" in res and "privacy" in res
    run_dir = os.path.join(out, "cli")
    with open(os.path.join(run_dir, "results.json")) as f:
        assert np.isfinite(json.load(f)["gamma_mean"])
    with open(os.path.join(run_dir, "config.json")) as f:
        saved = json.load(f)
    assert saved["model"]["fusion"]["text_dim"] == TEXT_DIM
    assert saved["model"]["fusion"]["patch_dim"] == PATCH_DIM
    assert saved["train"]["checkpoint_every_eval"] is True
    assert [p for p in os.listdir(run_dir) if p.startswith("test_")]
    with open(os.path.join(run_dir, "best.json")) as f:
        best = json.load(f)
    res = train_main(args + ["--evaluate_only", "--evaluate_which", "best"])
    assert np.isfinite(res["gamma_mean"])
    assert os.path.isdir(os.path.join(run_dir, f"test_0_epoch_{best['epoch']}"))


def test_cli_train_on_two_ranks_shards_model_and_bank(data_dir, tmp_path):
    """`cli.train --mesh_model 2 --shard_bank` on two gloo ranks (as under
    torchrun): the gene matmuls sharded over `model`, the training bank a
    `ShardedDeviceCache`; fit with validation, the post-hoc suites and the
    results on rank 0, `{}` on rank 1."""
    out = str(tmp_path / "out")
    args = _cli_args("film_cross_attention", data_dir, out, "mesh", "--epochs", "2",
                     "--num_patches", "8", "--freq_compute_test", "1", "--mesh_data", "1",
                     "--mesh_model", "2", "--shard_bank")
    run_ranks("cli_train", 2, tmp_path, argv=args)
    with open(tmp_path / "cli_0.json") as f:
        res = json.load(f)
    with open(tmp_path / "cli_1.json") as f:
        assert json.load(f) == {}
    assert np.isfinite(res["gamma_mean"]) and "utility" in res and "privacy" in res
    run_dir = os.path.join(out, "mesh")
    with open(os.path.join(run_dir, "config.json")) as f:
        assert json.load(f)["data"]["shard_bank"] is True
    with open(os.path.join(run_dir, "results.json")) as f:
        assert np.isfinite(json.load(f)["gamma_mean"])
    assert os.path.isdir(os.path.join(run_dir, "test_0_epoch_2"))
    assert os.listdir(os.path.join(run_dir, "ckpt"))


def test_cli_train_evaluate_only(data_dir, tmp_path):
    """--evaluate_only restores the checkpoint a previous run wrote."""
    out = str(tmp_path / "out2")
    args = _cli_args("vanilla", data_dir, out, "cli_eval", "--epochs", "2",
                     "--freq_compute_test", "10")
    train_main(args)
    train_main(args + ["--evaluate_only"])
    with open(os.path.join(out, "cli_eval", "results.json")) as f:
        assert np.isfinite(json.load(f)["gamma_mean"])


@pytest.mark.parametrize("extra,error,match", [
    (["--variant", "vae", "--mesh_model", "2"], AssertionError, "not divisible by model=2"),
    (["--variant", "cvae", "--mesh_model", "2"], AssertionError, "not divisible by model=2"),
    (["--mesh_model", "2"], AssertionError, "not divisible by model=2"),
    (["--shard_bank"], ValueError, "needs more than one rank")])
def test_cli_train_unported_options_raise(tmp_path, extra, error, match):
    """What the JAX `cli.train` refuses on one device: a model axis wider
    than the ranks (make_mesh's assert), and `--shard_bank` without a
    mesh."""
    with pytest.raises(error, match=match):
        train_main(["--data_dir", str(tmp_path), "--output_path", str(tmp_path),
                    "--device", "cpu", *extra])


# ------------------------------------------------- the flagship conditioning gate
def test_flagship_conditioning_steers_generation_fast_gate():
    """The torch twin of tests/test_dynamics_acceptance.py's gate for the
    flagship fusion, on the same data seed, dims and epochs: the disease
    label is never an input, only recoverable from the class-correlated
    token and patch embeddings, so above-chance TSTR (chance 0.25) needs the
    fusion stack to carry the condition into generation."""
    n_tr, n_te = 512, 256
    data = structured_dataset(n_tr + n_te, n_genes=64, rank=8, n_classes=4, n_sites=3,
                              num_patches=4, patch_dim=8, num_tokens=4, text_dim=8, seed=7)
    g = data["genes"]
    mu, sd = g[:n_tr].mean(0), g[:n_tr].std(0) + 1e-8
    std = ((g - mu) / sd).astype(np.float32)
    cond_keys = ("tokens", "token_mask", "patches", "patch_mask", "disease")
    tr = {"genes": std[:n_tr], **{k: data[k][:n_tr] for k in cond_keys}}
    te_genes, te_y = std[n_tr:], data["disease"][n_tr:]

    cfg = variant_config("film_cross_attention", n_genes=64,
                         fusion_kw=dict(cond_dim=32, text_dim=8, patch_dim=8, ff_dim=64,
                                        num_heads=2, num_layers=1, use_pallas=False))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=32, drift_epsilon=1e-3, critic_scan=True))
    loader = Batches(tr, batch_size=32, seed=0)
    torch.manual_seed(0)
    eng = WGANGPEngine(cfg, steps_per_epoch=loader.n_full_batches, device=CPU)
    state = eng.init_state(0, next(iter(loader)))
    for e in range(10):
        state, _ = eng.step_many(state, loader.stacked_epoch(e))
    out = eng.generate_samples_all(state, Batches(tr, 32, seed=0, shuffle=False).epoch(0), 1,
                                   torch.Generator().manual_seed(123))
    tstr = tstr_transfer_accuracy(out["fake"], out["disease"], te_genes, te_y)
    aligned, shuffled = class_mean_alignment(out["fake"], out["disease"], te_genes, te_y)
    assert tstr > 0.7, tstr
    assert aligned < 0.75 * shuffled, (aligned, shuffled)
