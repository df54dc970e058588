"""The port's mesh (gemm_gan_tpu_torch.parallel) and its sharded training
step vs the JAX package's, over gloo ranks on the CPU.

One JAX mesh device is one rank: JAX runs on the virtual CPU mesh, the port
on spawned ranks (`tests/_torch_dist_worker.py`), from the same Flax
params (converted), the same global batch and JAX's draws (`_jax_draws`,
as in tests/test_torch_train.py). Two spawns: four ranks for the flagship
step on a 2x2 mesh with `sequence_parallel` (ring attention over `model`,
the gene matmuls sharded), its optimizer state, a checkpoint of it and
sharded sampling; two ranks for a (2, 1) and a (1, 2) step against the
port's single-rank step and a BatchNorm trunk under data = 2.

Tolerances: metrics rtol 2e-4 / atol 1e-5 and params rtol 2e-3 / atol
2e-5, tests/test_sharding.py's for the same comparison in JAX. RMSprop's
first update is ±10 lr sign(g), so an entry whose gradient is at rounding
level may move either way on either side; as in tests/test_torch_train.py
such entries (accumulator below 1e-4 of the net's RMS) are held to
RMSprop's bound of 10 lr per update, and those with a nonzero accumulator
must be few. Entries whose accumulator is exactly 0 (no gradient on the
reference side) are held to the same bound: one side may sum a dead unit's
gradient to 0 and the other to ~1e-9 (JAX's own 2x2 mesh and one device
differ so, by 9e-5 on a critic bias). The step takes
one critic update (n_critic 1): with two, an entry flipped by the first
(a dead unit's bias) moves the second update's ReLU boundaries, and the
difference spreads to entries with clear gradients (1.6e-4 on a critic
bias after two updates on a 2x1 mesh; JAX's own 2x2 mesh and one device
differ by 2e-5 there).
"""

import _torch_test_threads  # noqa: F401  (one torch thread per test process)
import dataclasses
import glob
import json
import os
import pickle

import jax
import numpy as np
import optax
import pytest
import torch

import gemm_gan_tpu as gg
from _torch_dist_worker import run_ranks
from gemm_gan_tpu.parallel.mesh import make_mesh as j_make_mesh
from gemm_gan_tpu.train.wgan import WGANGPEngine as JEngine
from gemm_gan_tpu_torch import config as tcfg
from gemm_gan_tpu_torch.convert import flax_to_state_dict
from gemm_gan_tpu_torch.data.device_cache import DeviceCache
from gemm_gan_tpu_torch.data.synthetic import synthetic_dataset
from gemm_gan_tpu_torch.models.gan import Critic, Generator
from gemm_gan_tpu_torch.parallel import make_mesh, param_shardings
from gemm_gan_tpu_torch.parallel.sharding import place_batch, spec_for_param
from gemm_gan_tpu_torch.train.checkpoint import restore_state
from gemm_gan_tpu_torch.train.wgan import WGANGPEngine

METRIC_RTOL, METRIC_ATOL = 2e-4, 1e-5
PARAM_RTOL, PARAM_ATOL = 2e-3, 2e-5
NEGLIGIBLE_GRAD = 1e-4
KEYS = ("tokens", "token_mask", "patches", "patch_mask")
B, P = 8, 12


def _jax_cfg(sequence_parallel=True):
    cfg = gg.variant_config(
        "film_cross_attention", n_genes=24,
        fusion_kw=dict(cond_dim=16, text_dim=12, patch_dim=16, ff_dim=32, num_heads=2,
                       num_layers=1, dropout=0.0, use_pallas=False,
                       sequence_parallel=sequence_parallel))
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, gen_dims=(32, 32), disc_dims=(32, 32),
                                  latent_dim=16),
        train=dataclasses.replace(cfg.train, n_critic=1, cond_embed_reuse="per_update",
                                  ema_decay=0.999))


def _batch():
    d = synthetic_dataset(n=B, n_genes=24, num_patches=P, patch_dim=16, num_tokens=6,
                          text_dim=12, seed=1)
    return {k: d[k] for k in (*KEYS, "genes")}


def _jax_draws(jstate, jcfg, batch_size):
    """The step's z and α as the JAX engine draws them (as
    tests/test_torch_train.py::_jax_draws)."""
    t, m = jcfg.train, jcfg.model
    key = jax.random.fold_in(jstate.key, jstate.step)
    keys = jax.random.split(key, t.n_critic + 2)
    z, alpha = [], []
    for i in range(t.n_critic):
        kz, ka = jax.random.split(keys[i], 9)[:2]
        z.append(jax.random.normal(kz, (batch_size, m.latent_dim)))
        alpha.append(jax.random.uniform(ka, (batch_size, 1)))
    kz = jax.random.split(keys[t.n_critic], 3)[0]
    return {"z": np.stack(z), "alpha": np.stack(alpha),
            "z_gen": np.asarray(jax.random.normal(kz, (batch_size, m.latent_dim)))}


def _rms_nu(opt_state):
    leaves = jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByRmsState))
    return next(x.nu for x in leaves if isinstance(x, optax.ScaleByRmsState))


def _assert_params_close(got, want, nu, lr, what):
    """`got` and `want` state dicts; `nu` the JAX side's RMSprop
    accumulators (a state dict), or None to hold every entry."""
    rms = None if nu is None else {k: v.sqrt() for k, v in nu.items()}
    net = (None if rms is None else
           float(torch.cat([r.flatten() for r in rms.values()]).square().mean().sqrt()))
    negligible = total = 0
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, (what, name)
        if rms is None or name not in rms:
            torch.testing.assert_close(g, w, rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       msg=f"{what} {name}")
            continue
        sure = rms[name] > NEGLIGIBLE_GRAD * net
        torch.testing.assert_close(g[sure], w[sure], rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   msg=f"{what} {name}")
        assert float((g - w).abs().max()) <= 2 * 10 * lr, (what, name)
        negligible += int(((rms[name] > 0) & ~sure).sum())
        total += w.numel()
    assert negligible < 0.05 * max(total, 1), (what, negligible, total)


def _inputs(tmp, jcfg, jstate, batch, draws, **extra):
    x = {"cfg": dataclasses.asdict(jcfg), "g_params": jax.device_get(jstate.g_params),
         "d_params": jax.device_get(jstate.d_params), "batch": batch, "draws": draws,
         **extra}
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(x, f)


@pytest.fixture(scope="module")
def flagship_run(tmp_path_factory):
    """JAX's step on the 2x2 virtual mesh and the port's on four ranks."""
    tmp = tmp_path_factory.mktemp("flagship")
    jcfg, batch = _jax_cfg(), _batch()
    jeng = JEngine(jcfg, steps_per_epoch=2,
                   mesh=j_make_mesh(data=2, model=2, devices=jax.devices()[:4]))
    jstate = jeng.init_state(0, batch)
    draws = _jax_draws(jstate, jcfg, B)
    _inputs(tmp, jcfg, jstate, batch, draws)
    run_ranks("flagship", 4, tmp)
    before = jax.device_get((jstate.g_params, jstate.d_params))
    jstate, jm = jeng.step(jstate, batch)
    outs = [torch.load(os.path.join(tmp, f"out_{r}.pt"), weights_only=False)
            for r in range(4)]
    return jcfg, jstate, jm, before, batch, draws, outs, tmp


def test_make_mesh_shapes_and_asserts():
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.coords == {"data": 0, "model": 0}
    assert mesh.ranks == {"data": [0], "model": [0]}
    assert mesh.groups == {"data": None, "model": None}
    with pytest.raises(AssertionError, match="devices not divisible"):
        make_mesh(model=2, device="cpu")
    with pytest.raises(AssertionError, match="mesh 2x1 != 1 devices"):
        make_mesh(2, 1, device="cpu")


def test_mesh_shapes_on_four_ranks(flagship_run):
    outs = flagship_run[6]
    assert [o["coords"] for o in outs] == [{"data": d, "model": m}
                                          for d in range(2) for m in range(2)]
    assert all(o["mesh_shape"] == {"data": 2, "model": 2} for o in outs)


@pytest.mark.parametrize("variant", ["vanilla", "film_cross_attention"])
def test_tp_rules_target_gene_matmuls(variant):
    """The rule picks the generator's output projection (its rows) and the
    critic's input projection (its columns), as JAX's picks their kernels'
    out and in dimensions (tests/test_sharding.py)."""
    jcfg = gg.variant_config(variant, n_genes=600, fusion_kw=dict(
        cond_dim=16, text_dim=12, patch_dim=16, ff_dim=32, num_heads=2, num_layers=1))
    m = tcfg.config_from_dict(dataclasses.asdict(jcfg)).model
    gs = param_shardings(None, Generator(m, device="cpu"), m.n_genes)
    ds = param_shardings(None, Critic(m, device="cpu"), m.n_genes)
    assert gs["trunk.head.weight"] == ("model", None) and gs["trunk.head.bias"] == ("model",)
    assert ds["trunk.blocks.0.linear.weight"] == (None, "model")
    assert ds["trunk.blocks.0.linear.bias"] == ()
    assert {k for k, v in gs.items() if v} == {"trunk.head.weight", "trunk.head.bias"}
    assert {k for k, v in ds.items() if v} == {"trunk.blocks.0.linear.weight"}
    assert spec_for_param("x.weight", 2, 64, (64, 32)) == ("model", None)  # [out, in]
    assert spec_for_param("x.weight", 2, 64, (32, 80)) == (None, "model")
    assert spec_for_param("x.bias", 1, 64, (32,)) == ()


def test_flagship_2x2_step_matches_jax(flagship_run):
    jcfg, jstate, jm, _, _, _, outs, _ = flagship_run
    lr = jcfg.train.lr_gen
    g_nu = flax_to_state_dict(jax.device_get(_rms_nu(jstate.g_opt_state)))
    d_nu = flax_to_state_dict(jax.device_get(_rms_nu(jstate.d_opt_state)))
    want_g = flax_to_state_dict(jax.device_get(jstate.g_params))
    want_d = flax_to_state_dict(jax.device_get(jstate.d_params))
    for rank, out in enumerate(outs):
        assert out["metrics"].keys() == jm.keys()
        for k in jm:
            np.testing.assert_allclose(out["metrics"][k], float(jm[k]), rtol=METRIC_RTOL,
                                       atol=METRIC_ATOL, err_msg=f"rank {rank} {k}")
        _assert_params_close(out["full"]["gen"], want_g, g_nu, lr, f"rank {rank} gen")
        _assert_params_close(out["full"]["critic"], want_d, d_nu, lr,
                             f"rank {rank} critic")
        # the EMA, sharded like the generator: 1e-3 of the step's moves
        _assert_params_close(out["full"]["g_ema"],
                             flax_to_state_dict(jax.device_get(jstate.g_ema)), None, lr,
                             f"rank {rank} EMA")


def test_opt_state_accumulators_shard_like_params(flagship_run):
    """Every moment has its parameter's (sharded) shape, and the sharded
    ones are exactly the gene matmuls' blocks."""
    jcfg, outs = flagship_run[0], flagship_run[6]
    m = tcfg.config_from_dict(dataclasses.asdict(jcfg)).model
    want = [v != () for net in (Generator(m, device="cpu"), Critic(m, device="cpu"))
            for v in param_shardings(None, net, m.n_genes).values()]
    full = [v.shape for net in ("gen", "critic") for k, v in outs[0]["full"][net].items()
            if not k.endswith(("running_mean", "running_var"))]
    for out in outs:
        s = out["shapes"]
        assert s["nu"] == s["params"] and s["sharded"] == want
        for shape, whole, sharded in zip(s["params"], full, want):
            assert (tuple(shape) != tuple(whole)) == sharded
            assert np.prod(shape) * (2 if sharded else 1) == np.prod(whole)


def test_checkpoint_from_2x2_restores_on_one_rank_bitwise(flagship_run):
    jcfg, _, _, before, batch, _, outs, tmp = flagship_run
    eng = WGANGPEngine(tcfg.config_from_dict(dataclasses.asdict(jcfg)), steps_per_epoch=2,
                       device="cpu")
    state = restore_state(os.path.join(tmp, "ckpt"), eng.state_from_flax(*before))
    n = jcfg.train.n_critic
    assert state.step == 1 and state.g_opt.count == 1 and state.d_opt.count == n
    for net, module in (("gen", state.gen), ("critic", state.critic), ("g_ema", state.g_ema)):
        for k, v in module.state_dict().items():
            assert torch.equal(v, outs[0]["full"][net][k]), (net, k)
    for got, want in zip(state.g_opt.nu + state.d_opt.nu, outs[0]["nu"]):
        assert torch.equal(got, want)


def test_sampling_on_mesh_matches_single_rank(flagship_run):
    """Sharded sampling (rows over data, gathered) from the 2x2 state equals
    the single-rank sampler on the same (restored) weights and z."""
    jcfg, _, _, before, batch, _, outs, tmp = flagship_run
    eng = WGANGPEngine(tcfg.config_from_dict(dataclasses.asdict(jcfg)), steps_per_epoch=2,
                       device="cpu")
    state = restore_state(os.path.join(tmp, "ckpt"), eng.state_from_flax(*before))
    want = eng.generate_samples_all(state, [batch], 2, torch.Generator().manual_seed(5))
    for out in outs:
        np.testing.assert_allclose(out["fake"], want["fake"], rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module")
def small_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("small")
    jcfg, batch = _jax_cfg(), _batch()
    jeng = JEngine(jcfg, steps_per_epoch=2)
    jstate = jeng.init_state(0, batch)
    draws = _jax_draws(jstate, jcfg, B)
    bn_cfg = gg.variant_config("vanilla", n_genes=24)
    bn_cfg = dataclasses.replace(bn_cfg, model=dataclasses.replace(
        bn_cfg.model, use_batchnorm=True, gen_dims=(16, 16), latent_dim=8))
    bn_model = tcfg.config_from_dict(dataclasses.asdict(bn_cfg)).model
    bn_gen = Generator(bn_model, device="cpu", generator=torch.Generator().manual_seed(3))
    rng = np.random.RandomState(4)
    _inputs(tmp, jcfg, jstate, batch, draws, bn_cfg=dataclasses.asdict(bn_cfg),
            bn_state=bn_gen.state_dict(),
            bn_z=rng.standard_normal((B, 8)).astype(np.float32),
            bn_w=rng.standard_normal((B, 24)).astype(np.float32))
    run_ranks("small_meshes", 2, tmp)
    outs = [torch.load(os.path.join(tmp, f"out_{r}.pt"), weights_only=False)
            for r in range(2)]
    return jcfg, jstate, batch, draws, outs, tmp


@pytest.mark.parametrize("shape", ["2x1", "1x2"])
def test_small_meshes_match_single_rank_step(small_run, shape):
    jcfg, jstate, batch, draws, outs, _ = small_run
    eng = WGANGPEngine(tcfg.config_from_dict(dataclasses.asdict(jcfg)), steps_per_epoch=2,
                       device="cpu")
    state = eng.state_from_flax(jax.device_get(jstate.g_params),
                                jax.device_get(jstate.d_params))
    state, m = eng.step(state, batch, draws=draws)
    g_nu = dict(zip([n for n, _ in state.gen.named_parameters()], state.g_opt.nu))
    d_nu = dict(zip([n for n, _ in state.critic.named_parameters()], state.d_opt.nu))
    for rank, out in enumerate(outs):
        got = out[shape]
        for k in m:
            np.testing.assert_allclose(got["metrics"][k], float(m[k]), rtol=METRIC_RTOL,
                                       atol=METRIC_ATOL, err_msg=f"{shape} rank {rank} {k}")
        _assert_params_close(got["full"]["gen"], state.gen.state_dict(), g_nu,
                             jcfg.train.lr_gen, f"{shape} rank {rank} gen")
        _assert_params_close(got["full"]["critic"], state.critic.state_dict(), d_nu,
                             jcfg.train.lr_disc, f"{shape} rank {rank} critic")


def test_step_many_cached_on_mesh_matches_single_rank(small_run):
    """The streaming epoch from a replicated `DeviceCache` on two data ranks
    (each gathering its rows of every batch, in the step) equals the
    single-rank streaming epoch, as tests/test_sharding.py holds JAX's."""
    jcfg, jstate, batch, _, outs, _ = small_run
    eng = WGANGPEngine(tcfg.config_from_dict(dataclasses.asdict(jcfg)), steps_per_epoch=1,
                       device="cpu")
    state = eng.state_from_flax(jax.device_get(jstate.g_params),
                                jax.device_get(jstate.d_params))
    cache = DeviceCache(batch, batch_size=B, seed=0, device="cpu")
    state, m = eng.step_many_cached(state, cache, 0)
    g_nu = dict(zip([n for n, _ in state.gen.named_parameters()], state.g_opt.nu))
    d_nu = dict(zip([n for n, _ in state.critic.named_parameters()], state.d_opt.nu))
    for rank, out in enumerate(outs):
        got = out["cached"]
        for k in m:
            np.testing.assert_allclose(got["metrics"][k], float(m[k]), rtol=METRIC_RTOL,
                                       atol=METRIC_ATOL, err_msg=f"rank {rank} {k}")
        _assert_params_close(got["full"]["gen"], state.gen.state_dict(), g_nu,
                             jcfg.train.lr_gen, f"rank {rank} gen")
        _assert_params_close(got["full"]["critic"], state.critic.state_dict(), d_nu,
                             jcfg.train.lr_disc, f"rank {rank} critic")


def test_batchnorm_trunk_under_data_axis(small_run):
    """A BatchNorm generator on two data ranks takes the global batch's
    statistics: its output rows, running buffers and (summed) parameter
    gradients equal one process's over the whole batch."""
    _, _, _, _, outs, tmp = small_run
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        x = pickle.load(f)
    gen = Generator(tcfg.config_from_dict(x["bn_cfg"]).model, device="cpu")
    gen.load_state_dict(x["bn_state"])
    y = gen(torch.tensor(x["bn_z"]), None, train=True)
    (y * torch.tensor(x["bn_w"])).sum().backward()
    for out in outs:
        bn = out["bn"]
        torch.testing.assert_close(bn["y"], y.detach(), rtol=1e-4, atol=1e-5)
        for k, v in gen.named_buffers():
            torch.testing.assert_close(bn["buffers"][k], v, rtol=1e-5, atol=1e-6)
        for k, p in gen.named_parameters():
            torch.testing.assert_close(bn["grads"][k], p.grad, rtol=5e-4, atol=5e-5)


def test_place_batch_refuses_a_global_batch_as_a_shard():
    class _M:
        shape = {"data": 2, "model": 1}

        @staticmethod
        def index(axis):
            return 1

    batch = _batch()
    with pytest.raises(ValueError, match="OWN shard"):
        place_batch(_M, batch, expected_global_rows=B)
    rows = place_batch(_M, batch, local=False)
    np.testing.assert_array_equal(rows["genes"], batch["genes"][B // 2:])


# ------------------------------------------------------------ the experiment
def _exp_splits():
    d = synthetic_dataset(n=48, n_genes=24, n_classes=3, n_sites=2, num_patches=P,
                          patch_dim=16, num_tokens=6, text_dim=12, seed=1)
    idx = {"train": np.arange(0, 32), "val": np.arange(32, 40), "test": np.arange(40, 48)}
    out = {s: {k: d[k][i] for k in d} for s, i in idx.items()}
    out["meta"] = {"n_genes": 24}
    return out


def _exp_cfg(out_dir, run_name):
    jcfg = _jax_cfg(sequence_parallel=False)
    return dataclasses.replace(
        jcfg, output_dir=str(out_dir), run_name=run_name,
        train=dataclasses.replace(jcfg.train, batch_size=8, epochs=2, freq_compute_test=1),
        eval=dataclasses.replace(jcfg.eval, n_runs=1, pca_components=4, nearest_k=3))


def _dumps(run_dir):
    return {os.path.basename(p): np.load(p)
            for p in sorted(glob.glob(os.path.join(run_dir, "*.npy")))}


@pytest.fixture(scope="module")
def experiment_runs(tmp_path_factory):
    """The port's Experiment on two data ranks, on one rank (no mesh), and
    the JAX Experiment on a two-device mesh, on one config and split."""
    from gemm_gan_tpu.cli.experiment import Experiment as JExperiment
    from gemm_gan_tpu_torch.cli.experiment import Experiment

    tmp = tmp_path_factory.mktemp("experiment")
    splits = _exp_splits()
    jcfg = _exp_cfg(tmp / "mp", "proto")
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump({"cfg": dataclasses.asdict(jcfg), "splits": splits}, f)
    run_ranks("experiment", 2, tmp)
    torch.manual_seed(0)
    one = Experiment(tcfg.config_from_dict(dataclasses.asdict(_exp_cfg(tmp / "sp", "proto"))),
                     splits, device="cpu")
    one_fit = one.fit()
    one_dumps = _dumps(os.path.join(one.out_dir, "test_0_epoch_2"))
    jexp = JExperiment(_exp_cfg(tmp / "jax", "proto"), splits,
                       mesh=j_make_mesh(data=2, model=1, devices=jax.devices()[:2]))
    jfit = jexp.fit()
    return tmp, one, one_fit, one_dumps, jexp, jfit


def test_two_rank_experiment_matches_one_rank(experiment_runs):
    """Rank 0's dumps (fit's, then evaluate's regeneration) match a one-rank
    run of the same config (tests/test_multihost_experiment.py's
    tolerance: the reals exactly, the generated profiles rtol 5e-3 / atol
    5e-4); rank 1 returns {} and writes nothing of its own."""
    tmp, one, one_fit, one_dumps, _, _ = experiment_runs
    with open(os.path.join(tmp, "mp_0.json")) as f:
        mp = json.load(f)
    with open(os.path.join(tmp, "mp_1.json")) as f:
        assert json.load(f) == {"fit": {}, "eval": {}}
    fit_dumps = dict(np.load(os.path.join(tmp, "fit_dumps_0.npz")))
    eval_dumps = _dumps(os.path.join(tmp, "mp", "proto", "test_0_epoch_2"))
    for dumps in (fit_dumps, eval_dumps):
        assert dumps.keys() == one_dumps.keys()
        for name, want in one_dumps.items():
            got = dumps[name]
            assert got.shape == want.shape and got.dtype == want.dtype, name
            if name.endswith("_gen.npy") and "labels" not in name:
                np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-4, err_msg=name)
            else:
                np.testing.assert_array_equal(got, want, err_msg=name)
    assert mp["fit"].keys() == one_fit.keys() and np.isfinite(mp["fit"]["gamma_mean"])
    assert abs(mp["fit"]["gamma_mean"] - one_fit["gamma_mean"]) < 0.2
    assert np.isfinite(mp["eval"]["gamma_mean"])
    assert os.path.exists(os.path.join(tmp, "mp", "proto", "val_metrics.json"))


def test_two_rank_experiment_dump_contract_is_jax(experiment_runs):
    """File names, array shapes and dtypes, and the results' JSON keys of
    the two-rank run equal the JAX Experiment's on a two-device mesh."""
    tmp, _, _, _, jexp, jfit = experiment_runs
    with open(os.path.join(tmp, "mp_0.json")) as f:
        mp = json.load(f)
    got = _dumps(os.path.join(tmp, "mp", "proto", "test_0_epoch_2"))
    want = _dumps(os.path.join(jexp.out_dir, "test_0_epoch_2"))
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].shape == want[name].shape, name
        assert got[name].dtype == want[name].dtype, name
    assert set(mp["fit"]) == set(jfit)
    assert set(mp["fit"]["runs"][0]) == set(jfit["runs"][0])
    port_files = {os.path.basename(p) for p in glob.glob(os.path.join(tmp, "mp", "proto", "*"))}
    jax_files = {os.path.basename(p) for p in glob.glob(os.path.join(jexp.out_dir, "*"))}
    assert {"val_metrics.json", "best.json", "test_0_epoch_2"} <= port_files & jax_files
