"""Every fusion kind of the port against its Flax twin, params carried
across by `gemm_gan_tpu_torch.convert`, on the CPU.

The kinds of the reference's ablation: concat (text and image), pooled
attention, img_transformer, film, token cross-attention and the label
oracle (the flagship `film_xattn` is held in tests/test_torch_modules.py).
Same numpy inputs through both. With `use_pallas=True` at 130 patches (and
130 tokens) the JAX side runs its Pallas kernels in interpret mode while
the port takes Q1's plain version (`flash_mha_ble` is counted): the
patch self-attention of img_transformer and film, and both of
cross-attention's attentions (text queries over the patch sequence, then
over the ragged tokens).

Tolerances: f32 rtol 1e-4 / atol 1e-5 (tests/test_torch_modules.py); bf16
as tests/test_torch_bf16.py states for its modules (`_hold_to_jax`: within
1 bf16 ulp of the output's largest entry, and at most half of JAX bf16's
own gap to JAX f32); the label oracle's output is f32 in either dtype and
exact. Padded patches and tokens must not move the output (atol 1e-4, the
JAX twins' in tests/test_fusion.py).
"""

import _torch_test_threads  # noqa: F401  (one torch thread per test process)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gemm_gan_tpu as gg
from gemm_gan_tpu.config import FusionConfig as JFusionConfig
from gemm_gan_tpu.fusion import modules as jfusion
from gemm_gan_tpu.kernels import flash_attention as jfa
from gemm_gan_tpu.models.gan import Critic as JCritic
from gemm_gan_tpu.models.gan import Generator as JGenerator
from gemm_gan_tpu_torch import config as tcfg
from gemm_gan_tpu_torch.convert import (flatten_params, flax_to_state_dict,
                                        state_dict_to_flax)
from gemm_gan_tpu_torch.fusion import modules as tfusion
from gemm_gan_tpu_torch.kernels import flash_attention as tfa
from gemm_gan_tpu_torch.models.gan import Critic, Generator, init_flax_like_
import chip_smoke
from test_torch_bf16 import BF16, _hold_to_jax

RTOL, ATOL = 1e-4, 1e-5
MASK_ATOL = 1e-4
# name -> (kind, condition_type)
KINDS = {"concat_text": ("concat", "text"), "concat_image": ("concat", "image"),
         "attention": ("attention", "text"), "img_transformer": ("img_transformer", "text"),
         "film": ("film", "text"), "xattn": ("xattn", "text"), "labels": ("labels", "text")}
# flash_mha_ble calls per forward at 130 patches / tokens with num_layers 1
Q1_CALLS = {"img_transformer": 1, "film": 1, "xattn": 3}


def _jc(name, **kw):
    kind, condition_type = KINDS[name]
    base = dict(kind=kind, condition_type=condition_type, cond_dim=16, text_dim=12,
                patch_dim=16, ff_dim=32, num_heads=2, num_layers=1, n_disease_types=3,
                n_primary_sites=2, label_embed_dim=8)
    base.update(kw)
    return JFusionConfig(**base)


def _tc(jc):
    return tcfg.FusionConfig(**dataclasses.asdict(jc))


def _mask(rng, B, L):
    lens = rng.randint(1, L + 1, B)
    return np.arange(L)[None, :] < lens[:, None]


def _cond(seed, B, P, T):
    """Every conditioning key at tiny widths, masks ragged (the CLS token
    always valid), padded entries zero."""
    rng = np.random.RandomState(seed)
    patch_mask, token_mask = _mask(rng, B, P), _mask(rng, B, T)
    token_mask[:, 0] = True
    return {"text_emb": rng.randn(B, 12).astype(np.float32),
            "tokens": rng.randn(B, T, 12).astype(np.float32) * token_mask[..., None],
            "token_mask": token_mask,
            "patches": rng.randn(B, P, 16).astype(np.float32) * patch_mask[..., None],
            "patch_mask": patch_mask,
            "disease": rng.randint(0, 3, B).astype(np.int32),
            "site": rng.randint(0, 2, B).astype(np.int32)}


def _tensors(cond):
    return {k: torch.from_numpy(np.array(v)) for k, v in cond.items()}


def _jax_params(jm, cond):
    """Flax params, every leaf moved off its init (LayerNorm scales off 1,
    biases off 0), so a misplaced mapping shows."""
    p = jm.init(jax.random.key(4), cond)["params"]
    rng = np.random.RandomState(0)
    return jax.tree.map(lambda a: a + 0.1 * jnp.asarray(rng.randn(*a.shape), a.dtype), p)


def _twin(module, flax_params):
    module.load_state_dict(flax_to_state_dict(jax.device_get(flax_params)))
    return module.eval()


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    tfa.reset_launch_counts()
    yield
    assert not any(tfa.launch_counts().values())


@pytest.fixture
def q1_calls(monkeypatch):
    """Counts the port's calls of the ble flash path (Q1 / Q2 behind it)."""
    calls = []
    inner = tfa.flash_mha_ble
    monkeypatch.setattr(tfa, "flash_mha_ble",
                        lambda *a, **kw: calls.append(1) or inner(*a, **kw))
    return calls


@pytest.mark.parametrize("P,T,use_pallas", [(8, 6, False), (130, 130, True)])
@pytest.mark.parametrize("name", sorted(KINDS))
def test_fusion_matches_flax(name, P, T, use_pallas, monkeypatch, q1_calls):
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    jc = _jc(name, use_pallas=use_pallas)
    cond = _cond(1, 3, P, T)
    jm = jfusion._FUSIONS[jc.kind](jc)
    p = _jax_params(jm, cond)
    tm = _twin(tfusion.build_fusion(_tc(jc)), p)
    assert type(tm).__name__ == type(jm).__name__
    got = tm(_tensors(cond))
    assert got.shape == (3, tfusion.cond_dim_of(_tc(jc))) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jm.apply({"params": p}, cond)),
                               rtol=RTOL, atol=ATOL)
    assert len(q1_calls) == (Q1_CALLS.get(name, 0) if use_pallas else 0), q1_calls


# mxu_bf16 only where the kind reaches an attention kernel
BF16_CASES = [(name, *case) for name in sorted(KINDS)
              for case in ((8, 6, False, False), (130, 130, True, False),
                           *(((130, 130, True, True),) if name in Q1_CALLS else ()))]


@pytest.mark.parametrize("name,P,T,use_pallas,mxu", BF16_CASES)
def test_fusion_matches_flax_in_bf16(name, P, T, use_pallas, mxu, monkeypatch):
    """The bench configuration's fusion: bf16 Linears and attention (Q1's
    bf16 or mxu_bf16 plain version at 130), f32 LayerNorms; the
    img_transformer's sequence enters its encoder in f32."""
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    jc = _jc(name, use_pallas=use_pallas, flash_mxu_bf16=mxu)
    cond = _cond(2, 3, P, T)
    jm16 = jfusion._FUSIONS[jc.kind](jc, dtype=jnp.bfloat16)
    p = _jax_params(jm16, cond)
    tm = _twin(tfusion.build_fusion(_tc(jc), BF16), p)
    got = tm(_tensors(cond))
    want16 = jm16.apply({"params": p}, cond)
    want32 = jfusion._FUSIONS[jc.kind](jc).apply({"params": p}, cond)
    if name == "labels":  # embedding lookups: f32 and exact in either dtype
        assert got.dtype == torch.float32 and want16.dtype == jnp.float32
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want16))
        return
    _hold_to_jax(f"{name} P {P} mxu {mxu}", got, want16, want32)


def test_img_transformer_sequence_enters_the_encoder_in_f32():
    """Under bf16 the encoder MLP's f32 LayerNorm sets the sequence's dtype
    (and the CLS token's), unlike the other patch transformers."""
    seen = {}
    for encode_mlp in (True, False):
        pt = tfusion._PatchTransformer(_tc(_jc("img_transformer")), 16, BF16,
                                       encode_mlp=encode_mlp).eval()
        pt.patches_transformer.register_forward_pre_hook(
            lambda mod, args, key=encode_mlp: seen.__setitem__(key, args[0].dtype))
        c = _tensors(_cond(3, 2, 8, 6))
        pt(c["patches"], c["patch_mask"])
    assert seen == {True: torch.float32, False: BF16}


def _port_module(name, seed=0):
    m = tfusion.build_fusion(_tc(_jc(name)))
    init_flax_like_(m, torch.Generator().manual_seed(seed))
    return m.eval()


@pytest.mark.parametrize("name", ["attention", "img_transformer", "film", "xattn"])
def test_padded_patches_do_not_affect_output(name):
    """Twin of tests/test_fusion.py::test_padded_patches_do_not_affect_output."""
    m = _port_module(name)
    cond = _tensors(_cond(5, 6, 8, 6))
    mask = cond["patch_mask"]
    assert (~mask).any(), "the inputs must hold padded patches"
    moved = dict(cond, patches=cond["patches"] + 1e3 * (~mask)[..., None])
    with torch.no_grad():
        torch.testing.assert_close(m(moved), m(cond), rtol=0, atol=MASK_ATOL)


def test_concat_image_uses_masked_mean():
    """Twin of tests/test_fusion.py::test_concat_image_uses_masked_mean."""
    m = _port_module("concat_image")
    cond = _tensors(_cond(5, 6, 8, 6))
    moved = dict(cond, patches=cond["patches"] + 1e3 * (~cond["patch_mask"])[..., None])
    with torch.no_grad():
        torch.testing.assert_close(m(moved), m(cond), rtol=0, atol=1e-3)
        enc = m.encoder(cond["patches"])
        w = cond["patch_mask"].float()[..., None]
        torch.testing.assert_close(m(cond), (enc * w).sum(1) / w.sum(1), rtol=1e-6, atol=1e-6)


def test_token_mask_respected():
    """Twin of tests/test_fusion.py::test_token_mask_respected: padded
    tokens are only keys of text2patch (and queries whose rows are not
    read), so moving them leaves the output."""
    m = _port_module("xattn")
    cond = _tensors(_cond(6, 6, 8, 6))
    tm = cond["token_mask"]
    assert (~tm).any() and bool(tm[:, 0].all())
    moved = dict(cond, tokens=cond["tokens"] + 1e3 * (~tm)[..., None])
    with torch.no_grad():
        torch.testing.assert_close(m(moved), m(cond), rtol=0, atol=MASK_ATOL)


def test_fully_masked_patches_give_finite_output():
    """A sample whose patches are all padding still conditions (on the CLS
    token alone, or the masked mean's 0): fully-masked rows give 0."""
    cond = _tensors(_cond(7, 3, 8, 6))
    cond["patch_mask"][0] = False
    cond["patches"][0] = 0
    for name in ("concat_image", "attention", "img_transformer", "film", "xattn"):
        with torch.no_grad():
            out = _port_module(name)(cond)
        assert bool(torch.isfinite(out).all()), name
    with torch.no_grad():
        assert float(_port_module("concat_image")(cond)[0].abs().max()) == 0.0


@pytest.mark.parametrize("name", sorted(KINDS))
def test_weight_bridge_round_trips(name):
    """Flax tree -> state_dict -> Flax tree gives the same paths and arrays;
    the embedding tables keep their [n, d] layout (not transposed)."""
    jc = _jc(name)
    cond = _cond(1, 2, 8, 6)
    p = jax.device_get(_jax_params(jfusion._FUSIONS[jc.kind](jc), cond))
    sd = flax_to_state_dict(p)
    module = tfusion.build_fusion(_tc(jc))
    module.load_state_dict(sd)  # strict: every key maps, none is left over
    back = flatten_params(state_dict_to_flax(module.state_dict()))
    want = flatten_params(p)
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    if name == "labels":
        assert sd["disease_embed.weight"].shape == (3, 8)
        np.testing.assert_array_equal(sd["site_embed.weight"].numpy(),
                                      want["site_embed/embedding"])
    if name == "img_transformer":
        np.testing.assert_array_equal(sd["patch_transformer.encode_norm.weight"].numpy(),
                                      want["_PatchTransformer_0/LayerNorm_0/scale"])


def test_embedding_init_follows_flax_default_embed_init():
    """Flax's `default_embed_init`: an untruncated normal with std
    1/sqrt(label_embed_dim); torch's own default (std 1) is replaced."""
    cfg = tcfg.variant_config("benchmark", n_genes=16,
                              fusion_kw=dict(n_disease_types=40, n_primary_sites=24))
    gen = Generator(cfg.model, device="cpu", generator=torch.Generator().manual_seed(0))
    std = cfg.model.fusion.label_embed_dim ** -0.5
    for table in (gen.fusion.disease_embed.weight, gen.fusion.site_embed.weight):
        w = table.detach()
        assert abs(float(w.std()) / std - 1) < 0.1, float(w.std())
        assert abs(float(w.mean())) < 0.1 * std
        assert float(w.abs().max()) > 2.5 * std  # not truncated at 2 std
    critic = Critic(cfg.model, device="cpu", generator=torch.Generator().manual_seed(1))
    assert not torch.equal(critic.fusion.disease_embed.weight, gen.fusion.disease_embed.weight)


GAN_VARIANTS = ("vanilla", "concat_text", "concat_image", "attention", "img_transformer",
                "film", "cross_attention", "film_cross_attention", "benchmark")


@pytest.mark.parametrize("variant", GAN_VARIANTS)
def test_generator_and_critic_match_jax_for_every_variant(variant):
    """`Generator` / `Critic` built from `variant_config(variant)` carry the
    JAX nets' params and give their outputs."""
    jcfg = gg.variant_config(variant, n_genes=24, fusion_kw=dict(
        cond_dim=16, text_dim=12, patch_dim=16, ff_dim=32, num_heads=2, num_layers=1,
        n_disease_types=3, n_primary_sites=2, label_embed_dim=8, use_pallas=False))
    jm = dataclasses.replace(jcfg.model, gen_dims=(32, 32), disc_dims=(32, 32), latent_dim=16)
    tm = tcfg.config_from_dict(dataclasses.asdict(
        dataclasses.replace(jcfg, model=jm))).model
    cond = _cond(8, 4, 8, 6)
    rng = np.random.RandomState(9)
    z = rng.randn(4, 16).astype(np.float32)
    x = rng.randn(4, 24).astype(np.float32)
    jcond = None if jm.fusion.kind == "none" else cond
    tcond = None if jcond is None else _tensors(cond)
    for jnet, tnet, inp in ((JGenerator(jm), Generator(tm, device="cpu"), z),
                            (JCritic(jm), Critic(tm, device="cpu"), x)):
        p = jnet.init(jax.random.key(6), inp, jcond)["params"]
        tnet = _twin(tnet, p)
        got = tnet(torch.from_numpy(inp), tcond)
        np.testing.assert_allclose(got.detach().numpy(),
                                   np.asarray(jnet.apply({"params": p}, inp, jcond)),
                                   rtol=RTOL, atol=ATOL, err_msg=f"{variant} {type(tnet)}")


@pytest.mark.parametrize("variant", GAN_VARIANTS)
def test_chip_smoke_flax_trees_have_the_jax_paths(variant):
    """chip_smoke.py's random Flax-layout weights (phases 3-11) have the
    paths and shapes `Generator.init` / `Critic.init` give every variant,
    so `convert.py` carries them into the port's nets."""
    jcfg = gg.variant_config(variant, n_genes=24, fusion_kw=dict(
        cond_dim=16, text_dim=12, patch_dim=16, ff_dim=32, num_heads=2, num_layers=2,
        n_disease_types=3, n_primary_sites=2, label_embed_dim=8, use_pallas=False))
    jm = dataclasses.replace(jcfg.model, gen_dims=(32, 32), disc_dims=(32, 32), latent_dim=16)
    cond = _cond(8, 2, 8, 6)
    jcond = None if jm.fusion.kind == "none" else cond
    for critic, jnet, inp in ((False, JGenerator(jm), np.zeros((2, 16), np.float32)),
                              (True, JCritic(jm), np.zeros((2, 24), np.float32))):
        want = flatten_params(jax.device_get(jnet.init(jax.random.key(0), inp, jcond)["params"]))
        got = flatten_params(chip_smoke.flax_param_tree(jm, seed=0, critic=critic))
        assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
