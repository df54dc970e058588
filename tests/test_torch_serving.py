"""The port's serving slice against the JAX package, end to end on the CPU.

`GeneratorServer(z, cond)` (gemm_gan_tpu_torch) against the JAX generator's
`embed_cond` then `score`, with the same z and the Flax params carried
across by `convert.py`; `sample_all`, `cli.sample`, the weight bridge, the
device rule and the import boundary. Tolerance atol 1e-5 / rtol 1e-4 (f32,
different summation order; see tests/test_torch_modules.py).
"""

import _torch_test_threads  # noqa: F401  (one torch thread per test process)
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import gemm_gan_tpu as gg
from gemm_gan_tpu.config import save_config
from gemm_gan_tpu.data.synthetic import structured_dataset as j_structured_dataset
from gemm_gan_tpu.data.synthetic import synthetic_dataset as j_synthetic_dataset
from gemm_gan_tpu.kernels import flash_attention as jfa
from gemm_gan_tpu.models.gan import Generator as JGenerator
from gemm_gan_tpu_torch import config as tcfg
from gemm_gan_tpu_torch.cli import sample as tsample
from gemm_gan_tpu_torch.convert import (flax_to_state_dict, load_params_npz,
                                        save_params_npz, state_dict_to_flax)
from gemm_gan_tpu_torch.data.synthetic import structured_dataset, synthetic_dataset
from gemm_gan_tpu_torch.kernels import flash_attention as tfa
from gemm_gan_tpu_torch.models.gan import Generator
from gemm_gan_tpu_torch.parallel.mesh import make_mesh
from gemm_gan_tpu_torch.serving import GeneratorServer, cond_keys_for
from gemm_gan_tpu_torch.utils.device import resolve_device

RTOL, ATOL = 1e-4, 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("tokens", "token_mask", "patches", "patch_mask")


def _jax_cfg(use_pallas=False, num_layers=2):
    cfg = gg.variant_config(
        "film_cross_attention", n_genes=24,
        fusion_kw=dict(cond_dim=16, text_dim=12, patch_dim=16, ff_dim=32,
                       num_heads=2, num_layers=num_layers, use_pallas=use_pallas))
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, gen_dims=(32, 32), latent_dim=16))


def _port_cfg(jcfg):
    return tcfg.config_from_dict(dataclasses.asdict(jcfg))


def _data(n, P, seed=1):
    d = synthetic_dataset(n=n, n_genes=24, num_patches=P, patch_dim=16, num_tokens=6,
                          text_dim=12, seed=seed)
    d["patch_mask"][0] = False  # only the CLS token stays valid for sample 0
    return d


@pytest.fixture(scope="module")
def jax_params():
    """Flax params of the 2-layer tiny generator. No param depends on the
    batch size, the sequence lengths or `use_pallas`, so one init serves
    every test here."""
    jcfg = _jax_cfg()
    d = _data(4, 8)
    z = np.zeros((4, jcfg.model.latent_dim), np.float32)
    return jax.device_get(JGenerator(jcfg.model).init(
        jax.random.key(0), z, {k: d[k] for k in KEYS})["params"])


def _jax_profiles(gen, params, z, cond):
    cvec = gen.apply({"params": params}, cond, method="embed_cond")
    return np.asarray(gen.apply({"params": params}, z, cvec, method="score"))


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    tfa.reset_launch_counts()
    yield
    assert tfa.flash_fwd_ble.launches == 0 and tfa.flash_fwd_bhld.launches == 0


# > BLE_MAX_L patches (the blocked kernel) is covered module by module in
# tests/test_torch_modules.py
@pytest.mark.parametrize("P,use_pallas", [(8, False), (130, True)])
def test_generator_server_matches_jax_generator(P, use_pallas, jax_params, monkeypatch):
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    jcfg = _jax_cfg(use_pallas=use_pallas)
    d = _data(4, P)
    cond = {k: d[k] for k in KEYS}
    z = np.random.RandomState(3).randn(4, jcfg.model.latent_dim).astype(np.float32)
    want = _jax_profiles(JGenerator(jcfg.model), jax_params, z, cond)
    server = GeneratorServer.from_flax(_port_cfg(jcfg).model, jax_params, device="cpu")
    got = server(z, cond)
    assert got.shape == (4, jcfg.model.n_genes) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_sample_all_embeds_each_batch_once_and_matches_per_call_path(jax_params):
    d = _data(6, 8)
    batches = [{k: d[k][s:s + 4] for k in (*KEYS, "genes", "disease")}
               for s in (0, 4)]  # 4 + 2: a ragged last batch
    server = GeneratorServer.from_flax(_port_cfg(_jax_cfg()).model, jax_params,
                                       device="cpu")
    calls = []
    embed = server.gen.embed_cond
    server.gen.embed_cond = lambda c: calls.append(1) or embed(c)
    R = 3
    out = server.sample_all(batches, R, torch.Generator().manual_seed(7))
    assert len(calls) == len(batches)
    assert out["fake"].shape == (R * 6, 24)
    np.testing.assert_array_equal(out["real"], np.concatenate([d["genes"]] * R))
    np.testing.assert_array_equal(out["disease"], np.concatenate([d["disease"]] * R))
    # z for (batch k, repeat r) comes from the generator in batch-major order;
    # the output is repeat-major, as the JAX engine's. The per-call path
    # (held against JAX above) must give the same profiles.
    g = torch.Generator().manual_seed(7)
    zs = {(k, r): torch.randn(len(b["genes"]), 16, generator=g)
          for k, b in enumerate(batches) for r in range(R)}
    want = np.concatenate([server(zs[k, r], b).numpy()
                           for r in range(R) for k, b in enumerate(batches)])
    np.testing.assert_allclose(out["fake"], want, rtol=RTOL, atol=ATOL)


def test_sample_draws_z_from_the_generator(jax_params):
    d = _data(3, 8)
    cond = {k: d[k] for k in KEYS}
    server = GeneratorServer.from_flax(_port_cfg(_jax_cfg()).model, jax_params,
                                       device="cpu")
    a = server.sample(cond, torch.Generator().manual_seed(0))
    z = torch.randn(3, 16, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, server(z, cond))
    assert server.sample(cond, torch.Generator().manual_seed(0), n=3).shape == (3, 24)
    with pytest.raises(ValueError, match="conditioning"):
        server(z, None)


def _run_dir(path, jcfg, params, cond):
    """A JAX run dir as the port reads it: the JAX package's config.json
    writer and the bridge's params file, plus a conditioning .npz."""
    path.mkdir(exist_ok=True)
    save_config(jcfg, str(path / "config.json"))
    save_params_npz(params, str(path / "generator_params.npz"))
    np.savez(path / "cond.npz", **cond)
    return path


def test_cli_sample_round_trips_a_run_dir(tmp_path, jax_params):
    jcfg = _jax_cfg()
    d = _data(4, 8)  # the shapes of the first test: JAX reuses its compiles
    cond = {k: d[k] for k in KEYS}
    run = _run_dir(tmp_path / "run", jcfg, jax_params, cond)
    out = tmp_path / "generated.npy"
    tsample.main(["--run_dir", str(run), "--cond", str(run / "cond.npz"),
                  "--num_repeats", "2", "--out", str(out), "--device", "cpu",
                  "--seed", "5"])
    fake = np.load(out)
    assert fake.shape == (2 * 4, 24) and jcfg.train.batch_size == 8
    # batch_size 8 > 4 cases: one batch, its z drawn for repeat 0 then 1
    g = torch.Generator().manual_seed(5)
    gen = JGenerator(jcfg.model)
    for r in range(2):
        z = torch.randn(4, 16, generator=g).numpy()
        np.testing.assert_allclose(fake[4 * r:4 * (r + 1)],
                                   _jax_profiles(gen, jax_params, z, cond),
                                   rtol=RTOL, atol=ATOL)


def test_weight_bridge_round_trips(tmp_path, jax_params):
    params = jax_params
    sd = flax_to_state_dict(params)
    gen = Generator(_port_cfg(_jax_cfg()).model, device="cpu")
    assert set(sd) == set(gen.state_dict())
    gen.load_state_dict(sd)  # strict: every key and shape matches
    back = state_dict_to_flax(gen.state_dict())
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    save_params_npz(params, str(tmp_path / "p.npz"))
    loaded = load_params_npz(str(tmp_path / "p.npz"))
    for (_, a), (_, b) in zip(flat_a, jax.tree_util.tree_flatten_with_path(loaded)[0]):
        np.testing.assert_array_equal(a, b)
    # a "/"-flattened tree converts the same
    sd2 = flax_to_state_dict({"/".join(k.key for k in p): v for p, v in flat_a})
    assert all(torch.equal(sd[k], sd2[k]) for k in sd)


def test_config_json_from_jax_loads_unchanged(tmp_path):
    jcfg = gg.variant_config("film_cross_attention")
    save_config(jcfg, str(tmp_path / "config.json"))
    loaded = tcfg.load_config(str(tmp_path / "config.json"))
    assert dataclasses.asdict(loaded) == dataclasses.asdict(jcfg)
    assert tcfg.config_to_dict(tcfg.variant_config("film_cross_attention")) \
        == dataclasses.asdict(jcfg)
    assert cond_keys_for(loaded.model.fusion) == KEYS


def test_synthetic_copies_match_jax_package():
    for a, b in ((synthetic_dataset(n=5, seed=3), j_synthetic_dataset(n=5, seed=3)),
                 (structured_dataset(4, n_genes=20, num_patches=6, patch_dim=8,
                                     num_tokens=5, text_dim=4),
                  j_structured_dataset(4, n_genes=20, num_patches=6, patch_dim=8,
                                       num_tokens=5, text_dim=4))):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_init_follows_flax_distributions():
    cfg = dataclasses.replace(_port_cfg(_jax_cfg(num_layers=1)).model, n_genes=4000)
    gen = Generator(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    head = gen.trunk.head.weight.detach()  # [n_genes, 32]: fan_in 32
    std = 32 ** -0.5
    assert abs(float(head.std()) / std - 1) < 0.03
    assert float(head.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert float(gen.trunk.head.bias.detach().abs().max()) == 0.0
    cls = gen.fusion.patch_transformer.cls_token.detach()
    assert cls.shape == (1, 1, 16) and float(cls.abs().max()) <= 0.04
    ln = gen.fusion.patch_transformer.patches_transformer.layers[0].norm1
    assert torch.all(ln.weight == 1) and torch.all(ln.bias == 0)


def test_unsupported_settings_raise():
    """What the port still does not serve raises; bf16 compute,
    `flash_mxu_bf16` (tests/test_torch_bf16.py) and every fusion kind
    (tests/test_torch_fusions.py) are served."""
    m = _port_cfg(_jax_cfg()).model
    # sequence parallelism is served: on a one-rank mesh the patch
    # self-attention keeps masked_mha (ring attention needs model > 1)
    sp = dataclasses.replace(m, fusion=dataclasses.replace(m.fusion, sequence_parallel=True))
    ref = Generator(m, device="cpu", generator=torch.Generator().manual_seed(0))
    gen = Generator(sp, generator=torch.Generator().manual_seed(0), mesh=make_mesh(device="cpu"))
    attn = gen.fusion.patch_transformer.patches_transformer.layers[0].self_attn
    assert attn.mesh is not None and gen.trunk.head.parallel is None
    for a, b in zip(ref.state_dict().values(), gen.state_dict().values()):
        assert torch.equal(a, b)
    for kind in ("film", "concat", "xattn"):
        fusion = dataclasses.replace(m.fusion, kind=kind)
        gen = Generator(dataclasses.replace(m, fusion=fusion), device="cpu")
        assert gen.trunk.blocks[0].linear.in_features == m.latent_dim + fusion.cond_dim
    with pytest.raises(ValueError, match="compute_dtype"):
        Generator(dataclasses.replace(m, compute_dtype="float16"), device="cpu")
    for served in (dataclasses.replace(m, compute_dtype="bfloat16"),
                   dataclasses.replace(m, fusion=dataclasses.replace(m.fusion,
                                                                     flash_mxu_bf16=True))):
        Generator(served, device="cpu")


def test_entry_points_need_cuda_unless_cpu_is_asked(tmp_path, jax_params):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    jcfg = _jax_cfg()
    d = _data(2, 8)
    run = _run_dir(tmp_path, jcfg, jax_params, {k: d[k] for k in KEYS})
    assert resolve_device("cpu") == torch.device("cpu")
    for call in (lambda: resolve_device(),
                 lambda: resolve_device("cuda"),
                 lambda: Generator(_port_cfg(jcfg).model),
                 lambda: GeneratorServer.load(str(run)),
                 lambda: tsample.main(["--run_dir", str(run), "--cond",
                                       str(run / "cond.npz"),
                                       "--out", str(tmp_path / "o.npy")])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not (tmp_path / "o.npy").exists()


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import gemm_gan_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'gemm_gan_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'gemm_gan_tpu', 'sklearn', "
        "'matplotlib')]\n"
        "assert len(mods) >= 78, mods\n"
        "new = {'gemm_gan_tpu_torch.' + m for m in "
        "('data.splits', 'data.loader', 'data.tcga', 'data.device_cache', "
        "'train.checkpoint', 'utils.metrics', 'eval.gamma', 'eval.knn_pr', 'eval.prdc', "
        "'eval.classifiers', 'native.forest', 'eval._sklearn_free', 'eval.detection', "
        "'eval.privacy', 'eval.utility', 'viz', 'cli.experiment', 'cli.train', "
        "'native.build', 'native.ot', 'eval.distances', 'eval.heatmap', 'utils.umap_lite', "
        "'cli.evaluate', 'models.vae', 'train.vae', 'cli.vae_experiment', 'cli.export', "
        "'encoders', 'encoders.vit', 'encoders.modernbert', 'encoders.contrastive', "
        "'encoders.cache', 'cli.convert_encoders', 'cli.preprocess', 'cli.ingest', "
        "'data.tiles', 'data.ingest', 'data.descriptions', 'data.gdc', 'utils.prng', "
        "'utils.tsne', 'ops.batchnorm', 'bench', 'parallel', 'parallel.mesh', "
        "'parallel.sharding', 'parallel.comm', 'kernels.ring_attention', "
        "'utils.threefry')}\n"
        "assert new <= set(mods), sorted(new - set(mods))\n"
        "assert not bad, bad\n"
        "from gemm_gan_tpu_torch.native import forest, ot\n"
        "assert forest._lib is None and ot._lib is None  # nothing built or loaded\n"
        "print('ok', len(mods))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")
