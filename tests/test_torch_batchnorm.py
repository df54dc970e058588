"""BatchNorm trunks (`model.use_batchnorm=True`) against the JAX package on
the CPU: `ops.batchnorm.BatchNorm` in `ops.mlp.MLPTrunk` and in the
generator, in eval mode (the running statistics) and in train mode (the
batch's statistics, the running ones updated as Flax's
`mutable=["batch_stats"]` apply does), in f32 and bf16; the weight bridge
with `batch_stats`; the WGAN-GP engine's refusal; and the server's
behaviour where JAX's serving fails for want of `batch_stats`.

Params, and the statistics (`mean`, `var` > 0), are seeded random numbers
in Flax's layout carried over by `convert.py`.

Tolerances: f32 outputs rtol 1e-4 / atol 1e-5 (another summation order),
the updated statistics rtol 1e-5 / atol 1e-6 (one mean over the batch);
in bf16 each output within 1 bf16 ulp of its largest entry (as
tests/test_torch_bf16.py holds the bf16 modules), the statistics (f32,
reduced from the bf16 hidden values) within rtol 1e-5 / atol 1e-6. The
weight bridge's round trip is exact.
"""

import _torch_test_threads  # noqa: F401  (one torch thread per test process)
import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemm_gan_tpu.models.gan import Generator as JGenerator
from gemm_gan_tpu.ops.mlp import MLPTrunk as JMLPTrunk
from gemm_gan_tpu.train.wgan import WGANGPEngine as JEngine
from gemm_gan_tpu_torch.convert import (flax_to_state_dict, state_dict_to_batch_stats,
                                        state_dict_to_flax)
from gemm_gan_tpu_torch.models.gan import Generator
from gemm_gan_tpu_torch.ops.mlp import MLPTrunk
from gemm_gan_tpu_torch.serving import GeneratorServer
from gemm_gan_tpu_torch.train.wgan import WGANGPEngine
from test_torch_bf16 import _ulp_of_max
from test_torch_train import KEYS, _batches, _cond, _jax_cfg, _port_cfg

RTOL, ATOL = 1e-4, 1e-5
STATS_RTOL, STATS_ATOL = 1e-5, 1e-6
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: tiny shapes are many small ops, which torch's
    thread pool only slows (and the suite runs files side by side)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _randomize(tree, rng):
    """Params moved off their init (scales around 1, nonzero biases) and
    statistics with var > 0, so every term of the normalisation counts."""
    def move(path, a):
        name = path[-1].key
        a = np.asarray(a, np.float32)
        if name == "var":
            return (0.5 + rng.rand(*a.shape)).astype(np.float32)
        if name in ("mean", "bias"):
            return (0.3 * rng.randn(*a.shape)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.2 * rng.randn(*a.shape)).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(move, jax.device_get(tree))


def _hold(got, want, dtype, what):
    got = got.detach().float()
    want = torch.from_numpy(np.asarray(jnp.asarray(want, jnp.float32)).copy())
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL, msg=what)
    else:
        diff = float((got - want).abs().max())
        assert diff <= float(_ulp_of_max(want.flatten())), (what, diff)


def _hold_stats(module, want_stats, what):
    got = state_dict_to_batch_stats(module.state_dict())
    want = flax.traverse_util.flatten_dict(jax.device_get(want_stats), sep="/")
    got = flax.traverse_util.flatten_dict(got, sep="/")
    assert got.keys() == want.keys(), (what, sorted(got), sorted(want))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=STATS_RTOL, atol=STATS_ATOL,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_trunk_matches_flax(dtype, train):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(3)
    x = rng.randn(16, 20).astype(np.float32)
    jm = JMLPTrunk(hidden_dims=(32, 24), out_dim=7, negative_slope=0.2,
                   use_batchnorm=True, dtype=jdt)
    v = _randomize(jm.init(jax.random.key(1), x), rng)
    tm = MLPTrunk(20, (32, 24), 7, 0.2, use_batchnorm=True, dtype=tdt)
    tm.load_state_dict(flax_to_state_dict(v["params"], v["batch_stats"]))
    got = tm(torch.from_numpy(x), train)
    if train:
        want, updated = jm.apply(v, x, train=True, mutable=["batch_stats"])
        _hold_stats(tm, updated["batch_stats"], f"trunk {dtype}")
        assert not np.allclose(updated["batch_stats"]["LinearBlock_0"]["BatchNorm_0"]["var"],
                               v["batch_stats"]["LinearBlock_0"]["BatchNorm_0"]["var"])
    else:
        want = jm.apply(v, x, train=False)
        _hold_stats(tm, v["batch_stats"], f"trunk {dtype} (unchanged)")
    assert got.dtype == torch.float32  # the head stays f32
    _hold(got, want, dtype, f"trunk {dtype} train={train}")


def _bn_cfg(dtype="float32"):
    jcfg = _jax_cfg()
    return dataclasses.replace(jcfg, model=dataclasses.replace(
        jcfg.model, use_batchnorm=True, compute_dtype=dtype))


@pytest.fixture(scope="module")
def bn_generator():
    """Flax variables of the tiny flagship generator with BatchNorm trunk
    blocks (no variable depends on the compute dtype)."""
    jcfg = _bn_cfg()
    batch = _batches(1, 8)[0]
    z = np.random.RandomState(4).randn(4, jcfg.model.latent_dim).astype(np.float32)
    v = JGenerator(jcfg.model).init(jax.random.key(2), z, _cond(batch))
    return _randomize(v, np.random.RandomState(5)), z, batch


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_generator_matches_jax(dtype, train, bn_generator):
    v, z, batch = bn_generator
    jcfg = _bn_cfg(dtype)
    jgen = JGenerator(jcfg.model)
    gen = Generator(_port_cfg(jcfg).model, device="cpu")
    gen.load_state_dict(flax_to_state_dict(v["params"], v["batch_stats"]))
    gen.eval()  # dropout off (JAX's deterministic=True); BatchNorm follows `train`
    tcond = {k: torch.from_numpy(np.asarray(batch[k])) for k in KEYS}
    got = gen(torch.from_numpy(z), tcond, train=train)
    if train:
        want, updated = jgen.apply(v, z, _cond(batch), deterministic=True, train=True,
                                   mutable=["batch_stats"])
        _hold_stats(gen, updated["batch_stats"], f"generator {dtype}")
    else:
        want = jgen.apply(v, z, _cond(batch), deterministic=True, train=False)
    _hold(got, want, dtype, f"generator {dtype} train={train}")


def test_batch_stats_round_trip_through_the_weight_bridge(bn_generator):
    v = bn_generator[0]
    gen = Generator(_port_cfg(_bn_cfg()).model, device="cpu")
    sd = flax_to_state_dict(v["params"], v["batch_stats"])
    gen.load_state_dict(sd)  # strict: every param and buffer has its entry
    params, stats = (f(gen.state_dict()) for f in (state_dict_to_flax, state_dict_to_batch_stats))
    for want, got in ((v["params"], params), (v["batch_stats"], stats)):
        want = flax.traverse_util.flatten_dict(jax.device_get(want), sep="/")
        got = flax.traverse_util.flatten_dict(got, sep="/")
        assert got.keys() == want.keys()
        assert all(np.array_equal(got[k], want[k]) for k in want)
    assert "trunk.blocks.0.norm.running_var" in sd and "trunk.blocks.1.norm.weight" in sd
    assert state_dict_to_batch_stats(Generator(_port_cfg(_jax_cfg()).model,
                                               device="cpu").state_dict()) == {}
    with pytest.raises(ValueError, match="mean or var"):
        flax_to_state_dict(v["params"], {"trunk": {"LinearBlock_0": {"BatchNorm_0": {
            "scale": np.ones(3, np.float32)}}}})


def test_engines_refuse_batchnorm():
    jcfg = _bn_cfg()
    with pytest.raises(ValueError, match="use_batchnorm"):
        JEngine(jcfg)
    with pytest.raises(ValueError, match="use_batchnorm"):
        WGANGPEngine(_port_cfg(jcfg), device="cpu")


def test_server_needs_the_batch_stats_as_jax_does(bn_generator):
    """JAX's serving applies {"params": ...} alone, which a BatchNorm
    generator refuses for want of its batch_stats; the port raises a
    ValueError that names them, and serves them when they are given."""
    v, z, batch = bn_generator
    jcfg = _bn_cfg()
    with pytest.raises(flax.errors.ScopeCollectionNotFound, match="batch_stats"):
        JGenerator(jcfg.model).apply({"params": v["params"]}, z, _cond(batch),
                                     deterministic=True)
    cfg = _port_cfg(jcfg).model
    with pytest.raises(ValueError, match="batch_stats"):
        GeneratorServer.from_flax(cfg, jax.device_get(v["params"]), device="cpu")
    server = GeneratorServer(cfg, flax_to_state_dict(v["params"], v["batch_stats"]),
                             device="cpu")
    got = server(z, batch)
    want = JGenerator(jcfg.model).apply(v, z, _cond(batch), deterministic=True)
    _hold(got, want, "float32", "served")
