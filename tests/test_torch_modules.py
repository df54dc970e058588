"""Each module of the port against its Flax twin, params carried across by
`gemm_gan_tpu_torch.convert`.

Same numpy inputs through both, on the CPU. With `use_pallas=True` the JAX
side runs its Pallas kernels in interpret mode (>= 128 patch tokens reach
`flash_mha_ble`, > 512 reach the blocked `flash_mha`) while the port takes
its kernels' plain versions. Tolerance atol 1e-5 / rtol 1e-4: f32 with a
different summation order, and Flax's LayerNorm computes its variance as
E[x^2] - E[x]^2 where torch takes E[(x - mean)^2] (a few ulps apart).
"""

import _torch_test_threads  # noqa: F401  (one torch thread per test process)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemm_gan_tpu.config import FusionConfig as JFusionConfig
from gemm_gan_tpu.fusion import modules as jfusion
from gemm_gan_tpu.kernels import flash_attention as jfa
from gemm_gan_tpu.ops import attention as jattn
from gemm_gan_tpu.ops.film import FiLM as JFiLM
from gemm_gan_tpu.ops.mlp import MLPTrunk as JMLPTrunk
from gemm_gan_tpu_torch import config as tcfg
from gemm_gan_tpu_torch.convert import flax_to_state_dict
from gemm_gan_tpu_torch.fusion import modules as tfusion
from gemm_gan_tpu_torch.kernels import flash_attention as tfa
from gemm_gan_tpu_torch.ops import attention as tattn
from gemm_gan_tpu_torch.ops.film import FiLM
from gemm_gan_tpu_torch.ops.mlp import MLPTrunk

RTOL, ATOL = 1e-4, 1e-5


def _randn(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _mask(rng, B, L, fully_masked_first=False):
    lens = rng.randint(1, L + 1, B)
    if fully_masked_first:
        lens[0] = 0
    return np.arange(L)[None, :] < lens[:, None]


def _torch_twin(module, flax_params):
    module.load_state_dict(flax_to_state_dict(jax.device_get(flax_params)))
    return module.eval()


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    tfa.reset_launch_counts()
    yield
    assert tfa.flash_fwd_ble.launches == 0 and tfa.flash_fwd_bhld.launches == 0


def test_film_matches_flax():
    rng = np.random.RandomState(0)
    text, patches = _randn(rng, 3, 12) * 3, _randn(rng, 3, 7, 16)
    jm = JFiLM(16, beta_clamp=5.0)
    p = jm.init(jax.random.key(0), text, patches)["params"]
    # push some beta past the clamp
    p = jax.tree.map(lambda x: x * 4, p)
    want = jm.apply({"params": p}, text, patches)
    tm = _torch_twin(FiLM(12, 16, beta_clamp=5.0), p)
    _close(tm(_t(text), _t(patches)), want)


@pytest.mark.parametrize("negative_slope", [0.0, 0.2])
def test_mlp_trunk_matches_flax(negative_slope):
    rng = np.random.RandomState(1)
    x = _randn(rng, 5, 20)
    jm = JMLPTrunk(hidden_dims=(32, 32), out_dim=24, negative_slope=negative_slope)
    p = jm.init(jax.random.key(1), x)["params"]
    tm = _torch_twin(MLPTrunk(20, (32, 32), 24, negative_slope=negative_slope), p)
    _close(tm(_t(x)), jm.apply({"params": p}, x))


def test_mlp_trunk_batchnorm_not_ported():
    """Named when `use_batchnorm=True` raised; BatchNorm trunks are ported
    now, so this holds the smallest one (eval mode, Flax's initial
    statistics) to its Flax twin. tests/test_torch_batchnorm.py holds
    train mode, bf16 and moved statistics."""
    rng = np.random.RandomState(2)
    x = _randn(rng, 6, 4)
    jm = JMLPTrunk(hidden_dims=(8,), out_dim=2, use_batchnorm=True)
    v = jm.init(jax.random.key(2), x)
    tm = MLPTrunk(4, (8,), 2, use_batchnorm=True)
    tm.load_state_dict(flax_to_state_dict(v["params"], v["batch_stats"]))
    _close(tm(_t(x)), jm.apply(v, x))


@pytest.mark.parametrize("Lq,Lk,use_pallas,layout", [
    (1, 9, True, "ble"),         # CLS query: plain reference on both sides
    (130, 130, True, "ble"),     # ble kernel
    (130, 130, True, "bhld"),    # classic layout: the blocked kernel
    (600, 600, True, "ble"),     # > BLE_MAX_L: blocked kernel
    (130, 130, False, "ble"),    # kernels off
])
def test_masked_multi_head_attention_matches_flax(Lq, Lk, use_pallas, layout, monkeypatch):
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    rng = np.random.RandomState(2)
    B, E, H = 2, 16, 2
    q_in, kv_in = _randn(rng, B, Lq, E), _randn(rng, B, Lk, E)
    mask = _mask(rng, B, Lk, fully_masked_first=True)
    jm = jattn.MaskedMultiHeadAttention(E, H, use_pallas=use_pallas, flash_layout=layout)
    p = jm.init(jax.random.key(2), q_in, kv_in, mask)["params"]
    tm = _torch_twin(tattn.MaskedMultiHeadAttention(E, H, use_pallas=use_pallas,
                                                    flash_layout=layout), p)
    _close(tm(_t(q_in), _t(kv_in), _t(mask)), jm.apply({"params": p}, q_in, kv_in, mask))


@pytest.mark.parametrize("L,use_pallas", [(9, False), (130, True), (600, True)])
def test_transformer_encoder_matches_flax(L, use_pallas, monkeypatch):
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    rng = np.random.RandomState(3)
    B, E = 2, 16
    x, mask = _randn(rng, B, L, E), _mask(rng, B, L)
    jm = jattn.TransformerEncoder(num_layers=2, embed_dim=E, num_heads=2, ff_dim=32,
                                  dropout=0.1, use_pallas=use_pallas)
    p = jm.init(jax.random.key(3), x, mask)["params"]
    # non-trivial LayerNorm params, so scale/bias placement is checked too
    p = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.1 * jnp.asarray(
            np.random.RandomState(len(path)).randn(*a.shape), a.dtype), p)
    tm = _torch_twin(tattn.TransformerEncoder(2, E, 2, 32, dropout=0.1,
                                              use_pallas=use_pallas), p)
    _close(tm(_t(x), _t(mask)), jm.apply({"params": p}, x, mask, deterministic=True))


def test_layer_norm_eps_is_flax_value():
    layer = tattn.TransformerEncoderLayer(8, 2, 16)
    assert layer.norm1.eps == layer.norm2.eps == 1e-6


def _fusion_cfg(**kw):
    base = dict(kind="film_xattn", cond_dim=16, text_dim=12, patch_dim=16, ff_dim=32,
                num_heads=2, num_layers=1)
    base.update(kw)
    return JFusionConfig(**base)


def _cond(seed, B, P, T=6):
    rng = np.random.RandomState(seed)
    patch_mask = _mask(rng, B, P)
    token_mask = _mask(rng, B, T)
    token_mask[:, 0] = True
    return {"tokens": _randn(rng, B, T, 12), "token_mask": token_mask,
            "patches": _randn(rng, B, P, 16) * patch_mask[..., None],
            "patch_mask": patch_mask}


@pytest.mark.parametrize("P,use_pallas,num_layers", [(8, False, 1), (130, True, 2),
                                                     (600, True, 1)])
def test_film_cross_attention_fusion_matches_flax(P, use_pallas, num_layers, monkeypatch):
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    jc = _fusion_cfg(use_pallas=use_pallas, num_layers=num_layers)
    cond = _cond(4, 3, P)
    jm = jfusion.FiLMCrossAttentionFusion(jc)
    p = jm.init(jax.random.key(4), cond)["params"]
    tm = _torch_twin(tfusion.FiLMCrossAttentionFusion(
        tcfg.FusionConfig(**dataclasses.asdict(jc))), p)
    got = tm({k: _t(v) for k, v in cond.items()})
    assert got.shape == (3, jc.cond_dim)
    _close(got, jm.apply({"params": p}, cond))


def test_masked_mean_matches_flax():
    rng = np.random.RandomState(5)
    x, mask = _randn(rng, 3, 7, 4), _mask(rng, 3, 7, fully_masked_first=True)
    _close(tfusion._masked_mean(_t(x), _t(mask)), jfusion._masked_mean(x, mask))


def test_cond_dim_and_unported_kinds():
    for kind in ("none", "concat", "attention", "img_transformer", "film", "xattn",
                 "film_xattn", "labels"):
        jc = _fusion_cfg(kind=kind, n_disease_types=3, n_primary_sites=2)
        tc = tcfg.FusionConfig(**dataclasses.asdict(jc))
        assert tfusion.cond_dim_of(tc) == jfusion.cond_dim_of(jc)
        if kind == "none":
            assert tfusion.build_fusion(tc) is None
        else:  # every kind is ported: it builds, under its JAX class's name
            built = tfusion.build_fusion(tc)
            assert type(built).__name__ == jfusion._FUSIONS[kind].__name__
    with pytest.raises(ValueError, match="unknown fusion kind"):
        tfusion.build_fusion(tcfg.FusionConfig(kind="bogus"))
