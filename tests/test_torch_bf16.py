"""The port in the JAX package's bf16 production configuration, on the CPU.

`compute_dtype="bfloat16"` (bench.py's configuration) and
`fusion.flash_mxu_bf16=True`: the ble kernels' plain versions (Q1, Q2),
`mha_reference`, every module of the flagship, the generator, the critic,
`cli.sample` on a bf16 run dir and the engine, held against the JAX
package in bf16 on the same numpy
inputs, with the Flax params carried across by `convert.py`. Params stay
f32 on both sides, so the weight bridge needs no rule of its own
(`test_bf16_params_stay_f32_and_convert_needs_no_rule`). The JAX side runs
its Pallas kernels in interpret mode where `use_pallas` is on.

Tolerances:
* Q1 / Q2 plain versions against the Pallas ble kernels: each output (o,
  dq, dk, dv; bf16, or f32 under `mxu_bf16` with f32 inputs) within
  `ULPS` = 1 bf16 ulp of the largest entry of its row (one head's D
  entries): both sides sum in f32 in different orders and round once.
  lse (f32) within `LSE_ATOL` = 1e-5.
* Modules, generator and critic against their Flax twins with
  `dtype=bf16`: the same output dtype, and within 1 bf16 ulp of the
  output's largest entry (`ULPS`; f32 outputs behind bf16 layers move by
  less). The Dense rounding is Flax's (`ops/linear.py`: product rounded to
  bf16, then the bias added in bf16), so most outputs agree bit for bit.
  And the port's gap to JAX bf16 is at most `GAP_RATIO` = 0.5 of JAX
  bf16's own gap to JAX f32 (max abs over the output), which shows that
  the port computes in bf16; the ratio is printed.
* Two engine steps against the JAX bf16 engine (dropout 0, the same z and
  alpha): bf16 rounding is amplified by RMSprop, whose first update moves
  each entry by +-sqrt(10) lr whatever the size of its gradient, so that a
  gradient whose sign is rounding moves the other way. Held relative to
  JAX's own f32 step from the same params and draws: per net, at most
  `STEP_LOOSE_FACTOR` = 2 times as many entries beyond `PARAM_ATOL` as
  JAX bf16 vs JAX f32 (measured: 0.85-1.55 times), every entry within
  RMSprop's bound of 10 lr per update, and each metric within
  `STEP_METRIC_TOL` = 5e-2 abs + 5e-2 rel (JAX bf16 vs f32: up to 2.3e-2 on
  the second step).
* The graphed epoch body on the CPU (`step_many_cached`) against eager
  steps: bit for bit.
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
from gemm_gan_tpu.models.gan import Critic as JCritic
from gemm_gan_tpu.models.gan import Generator as JGenerator
from gemm_gan_tpu.ops import attention as jattn
from gemm_gan_tpu.ops.film import FiLM as JFiLM
from gemm_gan_tpu.ops.mlp import MLPTrunk as JMLPTrunk
from gemm_gan_tpu.train.wgan import WGANGPEngine as JEngine
from gemm_gan_tpu_torch import config as tcfg
from gemm_gan_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from gemm_gan_tpu_torch.data.synthetic import synthetic_dataset
from gemm_gan_tpu_torch.fusion import modules as tfusion
from gemm_gan_tpu_torch.kernels import flash_attention as tfa
from gemm_gan_tpu_torch.models.gan import Critic, Generator
from gemm_gan_tpu_torch.ops import attention as tattn
from gemm_gan_tpu_torch.ops.film import FiLM
from gemm_gan_tpu_torch.ops.linear import Linear
from gemm_gan_tpu_torch.ops.mlp import MLPTrunk
from gemm_gan_tpu_torch.train.wgan import WGANGPEngine
from test_torch_epoch import _assert_same, _cache
from test_torch_serving import KEYS as SERVING_KEYS
from test_torch_serving import _data, _jax_profiles, _run_dir, jax_params
from test_torch_serving import _jax_cfg as _serving_jax_cfg
from test_torch_train import (KEYS, PARAM_ATOL, B, _batches, _cond, _jax_cfg, _jax_draws,
                              _no_launches_on_cpu, _port_cfg, _rms_state)

assert _no_launches_on_cpu and jax_params  # fixtures used here too

ULPS = 1
LSE_ATOL = 1e-5
GAP_RATIO = 0.5
STEP_LOOSE_FACTOR = 2
STEP_METRIC_TOL = 5e-2
BF16 = torch.bfloat16


def _t(x):
    """numpy or JAX array -> torch tensor of the same dtype (bf16 kept)."""
    x = jnp.asarray(x)
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(x.astype(jnp.float32))).to(BF16)
    return torch.from_numpy(np.array(x))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _ulp_of_max(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of |x|'s largest entry along the last dim (0 for 0)."""
    top = x.abs().amax(-1, keepdim=True)
    _, e = torch.frexp(top)
    return torch.where(top > 0, torch.ldexp(torch.ones_like(top), e - 8), torch.zeros_like(top))


def _assert_rows_within_ulps(got, want, num_heads, what=""):
    """Each row (one head's D entries) of got within ULPS bf16 ulps of
    want's largest entry of that row."""
    got, want = got.float(), want.float()
    shape = (*want.shape[:-1], num_heads, want.shape[-1] // num_heads)
    g, w = got.reshape(shape), want.reshape(shape)
    diff = (g - w).abs()
    bound = ULPS * _ulp_of_max(w)
    assert bool((diff <= bound).all()), (what, float((diff - bound).max()))


def _bf16_model(jcfg, mxu=False):
    m = jcfg.model
    return dataclasses.replace(jcfg, model=dataclasses.replace(
        m, compute_dtype="bfloat16",
        fusion=dataclasses.replace(m.fusion, flash_mxu_bf16=mxu)))


# ------------------------------------------------------------------ kernels
def _attention_inputs(seed, B_, Lq, Lk, H, D, dtype):
    rng = np.random.RandomState(seed)
    q = rng.randn(B_, Lq, H * D).astype(np.float32) * np.float32(D ** -0.5)
    k = rng.randn(B_, Lk, H * D).astype(np.float32)
    v = rng.randn(B_, Lk, H * D).astype(np.float32)
    do = rng.randn(B_, Lq, H * D).astype(np.float32)
    lens = rng.randint(1, Lk + 1, B_)
    lens[0] = 0  # sample 0 has no valid key
    mask = np.arange(Lk)[None, :] < lens[:, None]
    return [jnp.asarray(x, dtype) for x in (q, k, v, do)] + [jnp.asarray(mask)]


@pytest.mark.parametrize("dtype,mxu", [(jnp.bfloat16, False), (jnp.bfloat16, True),
                                       (jnp.float32, True)])
@pytest.mark.parametrize("Lq,Lk,D", [(130, 130, 8), (128, 260, 16), (136, 200, 16)])
def test_ble_plain_versions_match_pallas_ble_kernels_in_bf16(dtype, mxu, Lq, Lk, D,
                                                             monkeypatch):
    """Q1 (`flash_fwd_ble_bf16` / `_mxu`) and Q2 (`flash_bwd_ble_bf16` /
    `_mxu`) plain versions against `_fwd_kernel_ble` and `_bwd_kernel_ble`
    with bf16 refs (and f32 refs under mxu_bf16), ragged masks and a
    fully-masked sample; the backward from the JAX forward's o and lse."""
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    H = 2
    q, k, v, do, mask = _attention_inputs(Lq + D, 2, Lq, Lk, H, D, dtype)
    o, res = jfa._flash_core_ble_fwd(q, k, v, mask, 1.0, H, mxu)
    lse = np.ascontiguousarray(np.asarray(res[5])[:, :, ::jfa._LANES].transpose(0, 2, 1))
    grads = jfa._flash_core_ble_bwd(1.0, H, mxu, res, do)
    fwd, bwd = tfa._ble_kernels(_t(q).dtype, mxu)
    tq, tk, tv, tdo, tmask = (_t(x) for x in (q, k, v, do, mask))
    to, tlse = fwd(tq, tk, tv, tmask, H)
    assert to.dtype == _t(o).dtype and tlse.dtype == torch.float32
    _assert_rows_within_ulps(to, _t(o), H, "o")
    np.testing.assert_allclose(tlse.numpy(), lse, rtol=0, atol=LSE_ATOL)
    assert float(to[0].abs().max()) == 0.0  # no valid key: 0
    got = bwd(tq, tk, tv, tmask, _t(o), torch.from_numpy(lse), tdo, H)
    for name, g, want in zip(("dq", "dk", "dv"), got, grads[:3]):
        assert g.dtype == _t(want).dtype
        _assert_rows_within_ulps(g, _t(want), H, name)


def test_mha_reference_matches_jax_in_bf16():
    """The CLS-query cross-attentions' path: weights cast to v's dtype,
    output to q's, f32 accumulation."""
    rng = np.random.RandomState(7)
    q, k, v = (jnp.asarray(rng.randn(2, 2, Lq, 8), jnp.bfloat16) for Lq in (1, 9, 9))
    mask = jnp.asarray(np.arange(9)[None, :] < np.array([[0], [5]]))
    want = jfa.mha_reference(q, k, v, mask)
    got = tfa.mha_reference(_t(q), _t(k), _t(v), _t(mask))
    assert got.dtype == BF16
    _assert_rows_within_ulps(got, _t(want), 1)
    assert float(got[0].abs().max()) == 0.0


# ------------------------------------------------------------------ modules
def _twin(module, flax_params):
    module.load_state_dict(flax_to_state_dict(jax.device_get(flax_params)))
    return module.eval()


def _hold_to_jax(name, got, want_bf16, want_f32):
    """got within 1 bf16 ulp of want's largest entry, with its dtype; its gap
    to JAX bf16 at most GAP_RATIO of JAX bf16's gap to JAX f32."""
    assert got.dtype == _t(want_bf16).dtype, (name, got.dtype, want_bf16.dtype)
    w = _np(want_bf16)
    gap = float(np.abs(_np(got) - w).max())
    assert gap <= ULPS * float(_ulp_of_max(torch.from_numpy(w.copy()).flatten())), (name, gap)
    jax_gap = float(np.abs(w - _np(want_f32)).max())
    ratio = gap / jax_gap
    print(f"{name}: |port - JAX bf16| {gap:.3e}, |JAX bf16 - JAX f32| {jax_gap:.3e}, "
          f"ratio {ratio:.3f}")
    assert jax_gap > 0 and ratio <= GAP_RATIO, (name, gap, jax_gap)


def _mask(rng, B_, L, fully_masked_first=False):
    lens = rng.randint(1, L + 1, B_)
    if fully_masked_first:
        lens[0] = 0
    return np.arange(L)[None, :] < lens[:, None]


@pytest.mark.parametrize("negative_slope", [0.0, 0.2])
def test_mlp_trunk_matches_flax_in_bf16(negative_slope):
    """Hidden blocks in bf16, the head in f32: the output leaves in f32."""
    rng = np.random.RandomState(1)
    x = rng.randn(5, 20).astype(np.float32)
    kw = dict(hidden_dims=(32, 32), out_dim=24, negative_slope=negative_slope)
    jm = JMLPTrunk(**kw, dtype=jnp.bfloat16)
    p = jm.init(jax.random.key(1), x)["params"]
    tm = _twin(MLPTrunk(20, (32, 32), 24, negative_slope, dtype=BF16), p)
    got = tm(torch.from_numpy(x))
    assert got.dtype == torch.float32
    _hold_to_jax(f"MLPTrunk slope {negative_slope}", got, jm.apply({"params": p}, x),
                 JMLPTrunk(**kw).apply({"params": p}, x))


def test_film_matches_flax_in_bf16():
    """film_proj in bf16; gamma * patches + beta promotes to f32."""
    rng = np.random.RandomState(0)
    text, patches = rng.randn(3, 12).astype(np.float32) * 3, rng.randn(3, 7, 16).astype(np.float32)
    jm = JFiLM(16, dtype=jnp.bfloat16)
    p = jax.tree.map(lambda a: a * 4, jm.init(jax.random.key(0), text, patches)["params"])
    got = _twin(FiLM(12, 16, dtype=BF16), p)(torch.from_numpy(text), torch.from_numpy(patches))
    _hold_to_jax("FiLM", got, jm.apply({"params": p}, text, patches),
                 JFiLM(16).apply({"params": p}, text, patches))


@pytest.mark.parametrize("Lq,Lk,use_pallas,layout,mxu", [
    (1, 9, True, "ble", False),       # CLS query: mha_reference on both sides
    (130, 130, True, "ble", False),   # Q1's bf16 mode
    (130, 130, True, "ble", True),    # Q1's mxu_bf16 mode
    (130, 130, True, "bhld", False),  # the classic layout's plain version
    (600, 600, True, "ble", True),    # > BLE_MAX_L: the blocked classic path
    (600, 600, True, "ble", False),   # > BLE_MAX_L in bf16: Q3, Q4, Q5's bf16 modes
    (600, 600, True, "bhld", False),  # the classic layout, three key blocks
    (130, 130, False, "ble", False),  # kernels off
])
def test_masked_multi_head_attention_matches_flax_in_bf16(Lq, Lk, use_pallas, layout, mxu,
                                                          monkeypatch):
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    rng = np.random.RandomState(2)
    B_, E, H = 2, 16, 2
    q_in, kv_in = rng.randn(B_, Lq, E).astype(np.float32), rng.randn(B_, Lk, E).astype(np.float32)
    mask = _mask(rng, B_, Lk, fully_masked_first=True)
    kw = dict(use_pallas=use_pallas, flash_layout=layout, mxu_bf16=mxu)
    jm = jattn.MaskedMultiHeadAttention(E, H, dtype=jnp.bfloat16, **kw)
    p = jm.init(jax.random.key(2), q_in, kv_in, mask)["params"]
    tm = _twin(tattn.MaskedMultiHeadAttention(E, H, dtype=BF16, **kw), p)
    got = tm(torch.from_numpy(q_in), torch.from_numpy(kv_in), torch.from_numpy(mask))
    _hold_to_jax(f"MaskedMultiHeadAttention {Lq} {layout} pallas {use_pallas} mxu {mxu}", got,
                 jm.apply({"params": p}, q_in, kv_in, mask),
                 jattn.MaskedMultiHeadAttention(E, H, **kw).apply({"params": p}, q_in, kv_in,
                                                                   mask))


@pytest.mark.parametrize("L,use_pallas", [(9, False), (130, True)])
def test_transformer_encoder_matches_flax_in_bf16(L, use_pallas, monkeypatch):
    """bf16 projections and FFN, both LayerNorms in f32 (the output f32)."""
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    rng = np.random.RandomState(3)
    B_, E = 2, 16
    x, mask = rng.randn(B_, L, E).astype(np.float32), _mask(rng, B_, L)
    kw = dict(num_layers=2, embed_dim=E, num_heads=2, ff_dim=32, dropout=0.1,
              use_pallas=use_pallas)
    jm = jattn.TransformerEncoder(**kw, dtype=jnp.bfloat16)
    p = jm.init(jax.random.key(3), x, mask)["params"]
    p = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.1 * jnp.asarray(
            np.random.RandomState(len(path)).randn(*a.shape), a.dtype), p)
    tm = _twin(tattn.TransformerEncoder(2, E, 2, 32, dropout=0.1, use_pallas=use_pallas,
                                        dtype=BF16), p)
    got = tm(torch.from_numpy(x), torch.from_numpy(mask))
    assert got.dtype == torch.float32
    _hold_to_jax(f"TransformerEncoder L {L}", got, jm.apply({"params": p}, x, mask),
                 jattn.TransformerEncoder(**kw).apply({"params": p}, x, mask))


def _fusion_cond(seed, B_, P, T=6):
    rng = np.random.RandomState(seed)
    patch_mask = _mask(rng, B_, P)
    token_mask = _mask(rng, B_, T)
    token_mask[:, 0] = True
    return {"tokens": rng.randn(B_, T, 12).astype(np.float32), "token_mask": token_mask,
            "patches": rng.randn(B_, P, 16).astype(np.float32) * patch_mask[..., None],
            "patch_mask": patch_mask}


@pytest.mark.parametrize("P,use_pallas,mxu", [(8, False, False), (130, True, False),
                                              (130, True, True)])
def test_film_cross_attention_fusion_matches_flax_in_bf16(P, use_pallas, mxu, monkeypatch):
    """The CLS token cast to the sequence's bf16; the output bf16."""
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    jc = JFusionConfig(kind="film_xattn", cond_dim=16, text_dim=12, patch_dim=16, ff_dim=32,
                       num_heads=2, num_layers=2, use_pallas=use_pallas, flash_mxu_bf16=mxu)
    cond = _fusion_cond(4, 3, P)
    jm = jfusion.FiLMCrossAttentionFusion(jc, dtype=jnp.bfloat16)
    p = jm.init(jax.random.key(4), cond)["params"]
    tm = _twin(tfusion.FiLMCrossAttentionFusion(tcfg.FusionConfig(**dataclasses.asdict(jc)),
                                                dtype=BF16), p)
    got = tm({k: torch.from_numpy(v) for k, v in cond.items()})
    _hold_to_jax(f"FiLMCrossAttentionFusion P {P} mxu {mxu}", got, jm.apply({"params": p}, cond),
                 jfusion.FiLMCrossAttentionFusion(jc).apply({"params": p}, cond))


@pytest.mark.parametrize("mxu", [False, True])
def test_generator_and_critic_match_jax_in_bf16(mxu, monkeypatch):
    """The bench configuration's nets at tiny widths, 128 patches (so the
    patch self-attention reaches Q1's bf16 plain versions): embed_cond
    returns f32, the heads f32."""
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    jcfg = _bf16_model(_jax_cfg(use_pallas=True), mxu)
    j32 = dataclasses.replace(jcfg.model, compute_dtype="float32")
    batch = _batches(1)[0]
    cond = _cond(batch)
    tcond = {k: torch.from_numpy(np.asarray(batch[k])) for k in KEYS}
    z = np.random.RandomState(5).randn(B, 16).astype(np.float32)
    x = np.asarray(batch["genes"])
    for name, jnet, jnet32, tnet, inp in (
            ("Generator", JGenerator(jcfg.model), JGenerator(j32),
             Generator(_port_cfg(jcfg).model, device="cpu"), z),
            ("Critic", JCritic(jcfg.model), JCritic(j32),
             Critic(_port_cfg(jcfg).model, device="cpu"), x)):
        p = jnet.init(jax.random.key(6), inp, cond)["params"]
        tnet = _twin(tnet, p)
        cvec = tnet.embed_cond(tcond)
        assert cvec.dtype == torch.float32
        got = tnet.score(torch.from_numpy(inp), cvec)
        assert got.dtype == torch.float32
        _hold_to_jax(f"{name} mxu {mxu}", got, jnet.apply({"params": p}, inp, cond),
                     jnet32.apply({"params": p}, inp, cond))


def test_bf16_params_stay_f32_and_convert_needs_no_rule():
    """Under bf16 compute every param (Linear, LayerNorm, CLS token) stays
    f32 and keeps its Flax path: the bridge round-trips as in f32."""
    cfg = _port_cfg(_bf16_model(_jax_cfg()))
    gen = Generator(cfg.model, device="cpu", generator=torch.Generator().manual_seed(0))
    sd = gen.state_dict()
    assert all(v.dtype == torch.float32 for v in sd.values())
    back = flax_to_state_dict(state_dict_to_flax(sd))
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)
    linears = [m for m in gen.modules() if isinstance(m, Linear)]
    assert {m.compute_dtype for m in linears} == {BF16, torch.float32}
    assert gen.trunk.head.compute_dtype == torch.float32


def test_cli_sample_serves_a_bf16_run_dir(tmp_path, jax_params):
    """`cli.sample` on a JAX run dir whose config.json says
    `compute_dtype="bfloat16"`: f32 profiles, those of the JAX bf16
    generator on the same z."""
    from gemm_gan_tpu_torch.cli import sample as tsample

    jcfg = _bf16_model(_serving_jax_cfg())
    d = _data(4, 8)
    cond = {k: d[k] for k in SERVING_KEYS}
    run = _run_dir(tmp_path / "run", jcfg, jax_params, cond)
    out = tmp_path / "generated.npy"
    tsample.main(["--run_dir", str(run), "--cond", str(run / "cond.npz"), "--num_repeats",
                  "2", "--out", str(out), "--device", "cpu", "--seed", "5"])
    fake = np.load(out)
    assert fake.dtype == np.float32 and fake.shape == (2 * 4, 24)
    g = torch.Generator().manual_seed(5)
    gen = JGenerator(jcfg.model)
    for r in range(2):
        z = torch.randn(4, 16, generator=g).numpy()
        want = _jax_profiles(gen, jax_params, z, cond)
        assert float(np.abs(fake[4 * r:4 * (r + 1)] - want).max()) <= ULPS * float(
            _ulp_of_max(torch.from_numpy(want.copy()).flatten()))


# ------------------------------------------------------------------- engine
def test_bf16_production_preset_trains_and_keeps_f32_params():
    """Twin of tests/test_engine.py::test_bf16_production_preset_trains_and_keeps_f32_params:
    the production preset (`compute_dtype="bfloat16"`, per_update) trains
    with finite moving metrics, keeps its params f32 and samples f32."""
    cfg = _port_cfg(_bf16_model(_jax_cfg("per_update", dropout=0.1)))
    d = synthetic_dataset(n=8, n_genes=24, num_patches=8, patch_dim=16, num_tokens=6,
                          text_dim=12, seed=1)
    batch = {k: d[k] for k in (*KEYS, "genes")}
    eng = WGANGPEngine(cfg, steps_per_epoch=2, device="cpu")
    torch.manual_seed(0)
    state = eng.init_state(0, batch)
    losses = []
    for _ in range(3):
        state, m = eng.step(state, batch)
        assert all(np.isfinite(float(v)) for v in m.values())
        losses.append(float(m["d_loss"]))
    assert len(set(losses)) > 1, f"metrics frozen: {losses}"
    for net in (state.gen, state.critic):
        assert all(p.dtype == torch.float32 for p in net.parameters())
    fake = eng.generate_samples(state, torch.Generator().manual_seed(0), batch)
    assert fake.dtype == torch.float32 and fake.shape == (8, 24)
    assert torch.isfinite(fake).all()


def _param_gap(module, want_params):
    """{param name: |module's - want's|} (want a Flax tree)."""
    want = flax_to_state_dict(jax.device_get(want_params))
    return {n: (p.detach() - want[n]).abs() for n, p in module.named_parameters()}


def test_two_engine_steps_match_jax_bf16_engine(monkeypatch):
    """Two dropout-free per_update steps of the port's bf16 engine (kernels'
    plain versions) against the JAX bf16 engine (Pallas in interpret mode)
    from the same params and draws, held relative to JAX's own f32 engine
    on the same steps (the module docstring's step tolerances)."""
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    jcfg = _bf16_model(_jax_cfg("per_update", use_pallas=True))
    j32cfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model,
                                                                 compute_dtype="float32"))
    batches = _batches()
    jeng, jeng32 = JEngine(jcfg, steps_per_epoch=2), JEngine(j32cfg, steps_per_epoch=2)
    jstate = jeng.init_state(0, batches[0])
    jstate32 = jeng32.init_state(0, batches[0])
    peng = WGANGPEngine(_port_cfg(jcfg), steps_per_epoch=2, device="cpu")
    pstate = peng.state_from_flax(jax.device_get(jstate.g_params),
                                  jax.device_get(jstate.d_params))
    for step, batch in enumerate(batches):
        draws = _jax_draws(jstate, jcfg, B)
        jstate, jm = jeng.step(jstate, batch)
        jstate32, jm32 = jeng32.step(jstate32, batch)
        pstate, pm = peng.step(pstate, batch, draws=draws)
        for k in jm:
            got, want = float(pm[k]), float(jm[k])
            assert abs(got - want) <= STEP_METRIC_TOL * (1 + abs(want)), (step, k, got, want)
        for net, opt, p_bf16, p_f32, opt_state in (
                ("generator", pstate.g_opt, jstate.g_params, jstate32.g_params,
                 jstate.g_opt_state),
                ("critic", pstate.d_opt, jstate.d_params, jstate32.d_params,
                 jstate.d_opt_state)):
            module = pstate.gen if net == "generator" else pstate.critic
            _, count = _rms_state(jax.device_get(opt_state))
            assert opt.count == count
            port = _param_gap(module, p_bf16)
            want32 = flax_to_state_dict(jax.device_get(p_f32))
            want16 = flax_to_state_dict(jax.device_get(p_bf16))
            loose = sum(int((d > PARAM_ATOL).sum()) for d in port.values())
            jax_loose = sum(int(((want16[n] - want32[n]).abs() > PARAM_ATOL).sum())
                            for n in port)
            print(f"step {step} {net}: port vs JAX bf16 {loose} entries beyond {PARAM_ATOL}, "
                  f"JAX bf16 vs JAX f32 {jax_loose}")
            assert loose <= STEP_LOOSE_FACTOR * max(jax_loose, 1), (step, net, loose, jax_loose)
            bound = 2 * 10 * opt.base_lr * count
            assert all(float(d.max()) <= bound for d in port.values()), (step, net)


def test_bf16_graphed_epoch_body_matches_eager_steps_bit_for_bit():
    """On the CPU `step_many_cached` runs the body a CUDA graph captures on
    the card; in bf16 (dropout 0.1) two of its epochs equal the eager steps
    over `cache.epoch(e)` bit for bit."""
    cfg = _port_cfg(_bf16_model(_jax_cfg(dropout=0.1)))
    cache = _cache()
    batch = next(iter(cache.epoch(0)))
    runs = []
    for cached in (True, False):
        eng = WGANGPEngine(cfg, steps_per_epoch=3, device="cpu")
        torch.manual_seed(0)
        state = eng.init_state(0, batch)
        for e in (0, 1):
            if cached:
                state, m = eng.step_many_cached(state, cache, e)
            else:
                for b in cache.epoch(e):
                    state, m = eng.step(state, b)
        runs.append((state, m))
    _assert_same(*runs)
    assert all(np.isfinite(float(v)) for v in runs[0][1].values())
