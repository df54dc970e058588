"""The port's serving artifacts and `cli.sample` against the JAX package's,
on the CPU: the twin of tests/test_serving.py, then `cli.sample`'s data
sources.

`export_generator` (`torch.export`, the attention as the op
`gemm_gan_tpu_torch::masked_mha`) exported at batch 4 and served at 1, 4
and 7, at a doubled half-padded patch count and above 512 tokens (the
classic route), against JAX's live generator and JAX's own
`export_generator(platforms=("cpu",))` artifact; the unconditional and
labels variants, a static batch and its errors, `cond_keys_for`,
`cli.export` from a port `cli.train` run dir (`--which last` / `best`,
`--use_ema`), the VAE and CVAE decoders; `cli.sample` over a TCGA layout
(shapes, the balanced counts, `--host_dtype float16`, `--scan` bit for
bit). Tolerance: the serving one, rtol 1e-4 / atol 1e-5 (f32, different
summation order); the artifact against the port's eager generator on the
CPU is bitwise.
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

from gemm_gan_tpu.data.loader import Batches
from gemm_gan_tpu.serving import GeneratorArtifact as JArtifact
from gemm_gan_tpu.serving import cond_keys_for as j_cond_keys_for
from gemm_gan_tpu.serving import export_generator as j_export_generator
from gemm_gan_tpu.train.wgan import WGANGPEngine as JEngine
from gemm_gan_tpu.train.wgan import cond_of
from gemm_gan_tpu_torch.cli.export import main as export_main
from gemm_gan_tpu_torch.cli.sample import main as sample_main
from gemm_gan_tpu_torch.cli.train import main as train_main
from gemm_gan_tpu_torch.config import config_from_dict, load_config
from gemm_gan_tpu_torch.kernels import flash_attention as tfa
from gemm_gan_tpu_torch.serving import (GeneratorArtifact, cond_keys_for, export_generator,
                                        export_vae_decoder)
from gemm_gan_tpu_torch.train.checkpoint import resolve_ckpt_dir, restore_state
from gemm_gan_tpu_torch.train.vae import VAEEngine
from gemm_gan_tpu_torch.train.wgan import WGANGPEngine
from test_torch_variants import one_thread

RTOL, ATOL = 1e-4, 1e-5
FLAGSHIP_KEYS = ("genes", "tokens", "token_mask", "patches", "patch_mask")
OP = "gemm_gan_tpu_torch.masked_mha.default"


def _port_cfg(jcfg, use_pallas=True):
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, fusion=dataclasses.replace(cfg.model.fusion, use_pallas=use_pallas)))


def _jax_and_port(make_tiny_cfg, data, variant, keys, batch_size=4, use_pallas=True, **cfg_kw):
    """JAX engine and state, and the port's engine and state carrying the
    same params, and a batch of `data`."""
    jcfg = make_tiny_cfg(variant, **cfg_kw)
    batch = next(iter(Batches({k: data[k] for k in keys}, batch_size=batch_size, seed=0,
                              shuffle=False)))
    jeng = JEngine(jcfg, steps_per_epoch=1)
    jstate = jeng.init_state(0, batch)
    teng = WGANGPEngine(_port_cfg(jcfg, use_pallas), device="cpu")
    tstate = teng.state_from_flax(jax.device_get(jstate.g_params),
                                  jax.device_get(jstate.d_params))
    return jeng, jstate, teng, tstate, batch


def _jax_profiles(jeng, jstate, z, cond):
    fn = jax.jit(lambda p, z, c: jeng.gen.apply({"params": p}, z, c, deterministic=True))
    return np.asarray(fn(jstate.g_params, z, cond))


def _ops(artifact) -> int:
    return sum(str(n.target) == OP for n in artifact.program.graph.nodes)


assert one_thread  # one intra-op thread: the autouse fixture runs here too


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    tfa.reset_launch_counts()
    yield
    assert not any(tfa.launch_counts().values())


@pytest.fixture(scope="module")
def flagship_data():
    from gemm_gan_tpu.data.synthetic import synthetic_dataset

    return synthetic_dataset(n=8, n_genes=24, n_classes=3, n_sites=2, num_patches=130,
                             patch_dim=16, num_tokens=6, text_dim=12, seed=1)


def test_roundtrip_matches_generator_flagship(tmp_path, flagship_data, make_tiny_cfg):
    """Exported at B 4 with 130 patches (the ble route), saved, loaded,
    served at B 1, 4 and 7, at 260 patches of which half are padding, and
    at 600 (the classic route): equal to JAX's live generator and to JAX's
    own artifact; bitwise equal to the port's eager generator."""
    jeng, jstate, teng, tstate, batch = _jax_and_port(
        make_tiny_cfg, flagship_data, "film_cross_attention", FLAGSHIP_KEYS,
        fusion_kw=dict(num_layers=2))
    art = export_generator(teng, tstate, batch)
    loaded = GeneratorArtifact.load(art.save(str(tmp_path / "art")))
    assert _ops(loaded) == 2 + 2  # two patch layers, two cross-attentions
    jart = JArtifact.load(j_export_generator(jeng, jstate, batch, platforms=("cpu",)).save(
        str(tmp_path / "jax")))
    latent = jeng.cfg.model.latent_dim
    for n in (1, 4, 7):
        sub = {k: np.repeat(np.asarray(batch[k])[:2], 4, axis=0)[:n] for k in batch}
        z = np.random.RandomState(n).randn(n, latent).astype(np.float32)
        got = loaded(z, cond_of(sub)).numpy()
        assert got.shape == (n, 24)
        np.testing.assert_allclose(got, _jax_profiles(jeng, jstate, z, cond_of(sub)),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, np.asarray(jart(z, cond_of(sub))), rtol=RTOL, atol=ATOL)
        with torch.no_grad():
            eager = teng._sampler(tstate, None)(z, cond_of(sub))
        assert torch.equal(loaded(z, cond_of(sub)), eager)
    sub = {k: np.asarray(batch[k]) for k in batch}
    pad = {**sub,
           "patches": np.concatenate([sub["patches"], np.zeros_like(sub["patches"])], axis=1),
           "patch_mask": np.concatenate([sub["patch_mask"], np.zeros_like(sub["patch_mask"])],
                                        axis=1)}
    z = np.random.RandomState(9).randn(4, latent).astype(np.float32)
    np.testing.assert_allclose(loaded(z, cond_of(pad)).numpy(),
                               loaded(z, cond_of(sub)).numpy(), rtol=RTOL, atol=ATOL)
    long = {k: np.asarray(v) for k, v in sub.items()}
    long["patches"] = np.random.RandomState(2).randn(4, 600, 16).astype(np.float32)
    long["patch_mask"] = np.arange(600)[None, :] < np.array([600, 550, 10, 1])[:, None]
    np.testing.assert_allclose(loaded(z, cond_of(long)).numpy(),
                               _jax_profiles(jeng, jstate, z, cond_of(long)),
                               rtol=RTOL, atol=ATOL)
    assert loaded.manifest["batch"] == "dynamic"
    assert loaded.manifest["platforms"] == ["cpu"]
    assert [s["key"] for s in loaded.manifest["cond_spec"]] == [
        "tokens", "token_mask", "patches", "patch_mask"]
    assert loaded.manifest["cond_spec"][2]["shape"] == ["b", "p", 16]


def test_kernel_op_only_with_use_pallas(flagship_data, make_tiny_cfg):
    """With `use_pallas` off the attention is traced into ATen ops (the
    plain reference): no custom op, the same profiles."""
    outs = []
    for use_pallas in (True, False):
        _, _, teng, tstate, batch = _jax_and_port(
            make_tiny_cfg, flagship_data, "film_cross_attention", FLAGSHIP_KEYS,
            use_pallas=use_pallas)
        art = export_generator(teng, tstate, batch)
        assert _ops(art) == (3 if use_pallas else 0)
        outs.append(art(np.ones((4, teng.cfg.model.latent_dim), np.float32), cond_of(batch)))
    torch.testing.assert_close(outs[0], outs[1], rtol=RTOL, atol=ATOL)


def test_unconditional_and_labels_variants(tiny_data, make_tiny_cfg, tmp_path):
    _, _, teng, tstate, batch = _jax_and_port(make_tiny_cfg, tiny_data, "vanilla", ("genes",))
    loaded = GeneratorArtifact.load(export_generator(teng, tstate, batch).save(
        str(tmp_path / "v")))
    with pytest.raises(ValueError, match="pass n"):
        loaded.sample(torch.Generator().manual_seed(0))
    assert loaded.sample(torch.Generator().manual_seed(0), n=5).shape == (5, 24)

    jeng, jstate, teng, tstate, batch = _jax_and_port(
        make_tiny_cfg, tiny_data, "benchmark", ("genes", "disease", "site"))
    loaded = GeneratorArtifact.load(export_generator(teng, tstate, batch).save(
        str(tmp_path / "l")))
    assert loaded.sample(torch.Generator().manual_seed(1), cond=cond_of(batch)).shape == (4, 24)
    z = np.random.RandomState(0).randn(4, jeng.cfg.model.latent_dim).astype(np.float32)
    np.testing.assert_allclose(loaded(z, cond_of(batch)).numpy(),
                               _jax_profiles(jeng, jstate, z, cond_of(batch)),
                               rtol=RTOL, atol=ATOL)


def test_static_batch_and_errors(tiny_data, make_tiny_cfg, tmp_path):
    _, _, teng, tstate, batch = _jax_and_port(make_tiny_cfg, tiny_data, "concat_text",
                                              ("genes", "text_emb"))
    loaded = GeneratorArtifact.load(export_generator(teng, tstate, batch, batch_size=4).save(
        str(tmp_path / "s")))
    assert loaded.manifest["batch"] == 4
    z = np.zeros((4, teng.cfg.model.latent_dim), np.float32)
    assert loaded(z, cond_of(batch)).shape == (4, 24)
    with pytest.raises(Exception):  # the exported signature's static batch
        loaded(np.zeros((3, teng.cfg.model.latent_dim), np.float32),
               {"text_emb": np.asarray(batch["text_emb"])[:3]})
    with pytest.raises(ValueError, match="requires conditioning"):
        loaded(z, None)
    with pytest.raises(ValueError, match="missing key"):
        loaded(z, {"patches": np.zeros((4, 8, 16), np.float32)})
    with pytest.raises(ValueError, match="lacks conditioning keys"):
        export_generator(teng, tstate, {"genes": batch["genes"]})


def test_cond_keys_for_every_kind(make_tiny_cfg):
    for variant in ("vanilla", "concat_text", "concat_image", "attention", "img_transformer",
                    "film", "cross_attention", "film_cross_attention", "benchmark"):
        jcfg = make_tiny_cfg(variant)
        assert cond_keys_for(_port_cfg(jcfg).model.fusion) == \
            j_cond_keys_for(jcfg.model.fusion), variant


def test_vae_and_cvae_decoder_export(tmp_path, tiny_data, make_tiny_cfg):
    """The decoders of a JAX VAE / CVAE carried into the port: the artifact
    reproduces JAX's decode on the same z (and labels)."""
    from gemm_gan_tpu.train.vae import VAEEngine as JVAEEngine

    for variant, keys in (("vae", ("genes",)), ("cvae", ("genes", "disease", "site"))):
        jcfg = make_tiny_cfg(variant)
        batch = next(iter(Batches({k: tiny_data[k] for k in keys}, batch_size=4, seed=0,
                                  shuffle=False)))
        jeng = JVAEEngine(jcfg)
        jstate = jeng.init_state(0, batch)
        teng = VAEEngine(_port_cfg(jcfg), device="cpu")
        tstate = teng.state_from_flax(jax.device_get(jstate.params))
        loaded = GeneratorArtifact.load(export_vae_decoder(teng, tstate, batch).save(
            str(tmp_path / variant)))
        labels = [np.asarray(batch[k]) for k in keys[1:]]
        z = np.random.RandomState(1).randn(4, jcfg.model.vae_latent_dim).astype(np.float32)
        want = np.asarray(jeng.model.apply({"params": jax.device_get(jstate.params)}, z,
                                           *labels, method="decode"))
        cond = dict(zip(keys[1:], labels)) or None
        np.testing.assert_allclose(loaded(z, cond).numpy(), want, rtol=RTOL, atol=ATOL)
        assert [s["key"] for s in loaded.manifest["cond_spec"]] == list(keys[1:])
        assert loaded.manifest["latent_dim"] == jcfg.model.vae_latent_dim
        assert loaded.sample(torch.Generator().manual_seed(0), n=None if labels else 3,
                             cond=cond).shape == (4 if labels else 3, 24)


# ------------------------------------------------------- from a cli.train run
N_CASES, N_GENES, PATCH_DIM, TEXT_DIM, TOKENS = 30, 40, 16, 12, 6


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """The layout of tests/test_torch_experiment.py's fixture."""
    d = tmp_path_factory.mktemp("tcga_export")
    rng = np.random.RandomState(0)
    cases = [f"case-{i:03d}" for i in range(N_CASES)]
    pd.DataFrame(rng.rand(N_CASES, N_GENES) * 8, index=pd.Index(cases, name="case_id"),
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


@pytest.fixture(scope="module")
def run_dir(data_dir, tmp_path_factory):
    """A port `cli.train` run of the flagship with an EMA generator and
    validation every epoch (so `ckpt_best/` and best.json exist), on one
    intra-op thread as `one_thread` gives each test."""
    out = str(tmp_path_factory.mktemp("runs"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train_main(["--variant", "film_cross_attention", "--data_dir", data_dir,
                    "--output_path", out, "--run_name", "run", "--batch_size", "8",
                    "--latent_dim", "8", "--hidden_dim", "16", "--n_critic", "2",
                    "--critic_scan", "--device", "cpu", "--epochs", "2", "--num_patches", "8",
                    "--freq_compute_test", "1", "--ema_decay", "0.9", "--n_runs", "1"])
    finally:
        torch.set_num_threads(threads)
    return os.path.join(out, "run")


def _restored(run, which):
    cfg = load_config(os.path.join(run, "config.json"))
    eng = WGANGPEngine(cfg, device="cpu")
    from gemm_gan_tpu_torch.cli.export import _example_batch

    ckpt_dir, step = resolve_ckpt_dir(os.path.join(run, "ckpt"), which)
    return cfg, eng, restore_state(ckpt_dir, eng.init_state(0, _example_batch(cfg)), step)


@pytest.mark.parametrize("which,ema", [("last", False), ("best", True)])
def test_export_cli_end_to_end(which, ema, run_dir, tmp_path):
    """`cli.export` of a port run dir reproduces the checkpointed generator
    (the EMA one with --use_ema; by default the engine's rule, EMA too)."""
    out = str(tmp_path / "artifact")
    export_main(["--ckpt_dir", os.path.join(run_dir, "ckpt"), "--out", out, "--which", which,
                 "--device", "cpu"] + (["--use_ema"] if ema else ["--use_pallas", "off"]))
    loaded = GeneratorArtifact.load(out)
    with open(os.path.join(out, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["variant"] == "film_cross_attention" and manifest["ema"] is True
    assert set(manifest) == {"format_version", "variant", "fusion_kind", "latent_dim",
                             "n_genes", "batch", "platforms", "ema", "cond_spec"}
    cfg, eng, state = _restored(run_dir, which)
    assert _ops(loaded) == (cfg.model.fusion.num_layers + 2 if ema else 0)
    rng = np.random.RandomState(0)
    cond = {"tokens": rng.randn(5, TOKENS, TEXT_DIM).astype(np.float32),
            "token_mask": np.arange(TOKENS)[None] < np.array([6, 2, 3, 4, 5])[:, None],
            "patches": rng.randn(5, 9, PATCH_DIM).astype(np.float32),
            "patch_mask": np.arange(9)[None] < np.array([9, 1, 4, 8, 2])[:, None]}
    z = rng.randn(5, cfg.model.latent_dim).astype(np.float32)
    with torch.no_grad():
        want = eng._sampler(state, True)(z, cond)
    torch.testing.assert_close(loaded(z, cond), want, rtol=RTOL, atol=ATOL)


def test_export_cli_vae_variant(tmp_path, tiny_data, make_tiny_cfg):
    from gemm_gan_tpu_torch.config import save_config
    from gemm_gan_tpu_torch.train.checkpoint import save_state

    cfg = _port_cfg(make_tiny_cfg("cvae"))
    eng = VAEEngine(cfg, device="cpu")
    batch = {k: tiny_data[k][:4] for k in ("genes", "disease", "site")}
    state = eng.init_state(0, batch)
    run = tmp_path / "run"
    run.mkdir()
    save_config(cfg, str(run / "config.json"))
    save_state(str(run / "ckpt"), state)
    out = str(tmp_path / "artifact")
    export_main(["--ckpt_dir", str(run / "ckpt"), "--out", out, "--device", "cpu"])
    loaded = GeneratorArtifact.load(out)
    assert loaded.manifest["variant"] == "cvae" and loaded.manifest["fusion_kind"] == "labels"
    z = np.random.RandomState(0).randn(4, cfg.model.vae_latent_dim).astype(np.float32)
    cond = {"disease": batch["disease"], "site": batch["site"]}
    want = eng.sample(state, None, z=z, disease=batch["disease"], site=batch["site"])
    np.testing.assert_array_equal(loaded(z, cond).numpy(), want)


def _sample(data_dir, run, *extra):
    return sample_main(["--data_dir", data_dir, "--ckpt_dir", os.path.join(run, "ckpt"),
                        "--device", "cpu", "--seed", "3", *extra])


def test_cli_sample_reads_the_run_and_the_data(data_dir, run_dir, tmp_path):
    """Shapes and labels from the train split; `--scan` equal to the
    per-call path bit for bit (on the CPU nothing is captured: the card's
    phase holds the graph); `--host_dtype float16` the f32 output cast."""
    out_file = str(tmp_path / "g.npy")
    per_call = _sample(data_dir, run_dir, "--which", "best", "--num_repeats", "2",
                       "--out", out_file)
    from gemm_gan_tpu.data.tcga import load_tcga as j_load_tcga

    cfg = load_config(os.path.join(run_dir, "config.json"))
    jsplits = j_load_tcga(data_dir, schema=cfg.data.batch_schema, num_patches=8,
                          normalization=cfg.data.normalization, seed=cfg.train.seed)
    n = len(jsplits["train"]["genes"])
    assert per_call["fake"].shape == (2 * n, N_GENES) and np.isfinite(per_call["fake"]).all()
    assert np.load(out_file).shape == (2 * n, N_GENES)
    np.testing.assert_array_equal(np.sort(per_call["disease"][:n]),
                                  np.sort(jsplits["train"]["disease"]))
    scan = _sample(data_dir, run_dir, "--which", "best", "--num_repeats", "2", "--scan",
                   "--out", out_file)
    np.testing.assert_array_equal(scan["fake"], per_call["fake"])
    half = _sample(data_dir, run_dir, "--which", "best", "--num_repeats", "2",
                   "--host_dtype", "float16", "--out", out_file)
    assert half["fake"].dtype == np.float16 and np.load(out_file).dtype == np.float16
    np.testing.assert_array_equal(half["fake"], per_call["fake"].astype(np.float16))
    np.testing.assert_array_equal(half["real"], per_call["real"].astype(np.float16))
    last = _sample(data_dir, run_dir, "--out", out_file)
    assert last["fake"].shape == (n, N_GENES)


def test_cli_sample_balanced_counts_equal_jax(data_dir, run_dir, tmp_path):
    """`--balanced`: the train split oversampled as JAX's
    `Experiment.generate_balanced` does, the same labels in the same
    order."""
    from gemm_gan_tpu.cli.experiment import _balanced_indices
    from gemm_gan_tpu.data.tcga import load_tcga as j_load_tcga

    out = _sample(data_dir, run_dir, "--which", "best", "--balanced",
                  "--out", str(tmp_path / "b.npy"))
    cfg = load_config(os.path.join(run_dir, "config.json"))
    train = j_load_tcga(data_dir, schema=cfg.data.batch_schema, num_patches=8,
                        normalization=cfg.data.normalization, seed=cfg.train.seed)["train"]
    idx = _balanced_indices(train["disease"], cfg.eval.balanced_max_oversample,
                            np.random.RandomState(cfg.train.seed))
    np.testing.assert_array_equal(out["disease"], train["disease"][idx])
    np.testing.assert_array_equal(out["site"], train["site"][idx])
    assert out["fake"].shape == (len(idx), N_GENES)
    counts = np.bincount(out["disease"])
    assert counts.min() == counts.max()
