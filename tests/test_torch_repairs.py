"""Three faults of the port against the JAX package, each pinned here.

* F1: float64 conditioning goes to the card as float32, as the JAX package
  (64-bit off) takes it; masks and labels keep their dtype. Held to the JAX
  generator and the JAX engine on the same float64 arrays (rtol 1e-4 / atol
  1e-5 for the generator, the step tolerances of tests/test_torch_train.py
  for the step).
* F2: `fusion.remat_layers=True` recomputes each encoder layer in the
  backward (fewer saved activations) and changes no number: one step with
  and one without, dropout 0, agree within 1e-6, as
  tests/test_fusion.py::test_remat_layers_step_matches holds the JAX engine.
* F3: the blocked reference saves O(block) activations under autograd at
  L 2,048, and its output and gradients equal `mha_reference`'s (rtol 1e-5
  / atol 1e-6: the same arithmetic per block, summed in another order).
"""

import _torch_test_threads  # noqa: F401  (one torch thread per test process)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gemm_gan_tpu.models.gan import Generator as JGenerator
from gemm_gan_tpu.train.wgan import WGANGPEngine as JEngine
from gemm_gan_tpu_torch.kernels import flash_attention as tfa
from gemm_gan_tpu_torch.serving import GeneratorServer
from gemm_gan_tpu_torch.train.wgan import WGANGPEngine
from test_torch_train import (ATOL, KEYS, RTOL, STEP_ATOL, STEP_RTOL, B, _assert_params_match,
                              _batches, _close, _cond, _jax_cfg, _jax_draws, _port_cfg, _t)


def _float64(batch):
    return {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in batch.items()}


def test_float64_conditioning_serves_as_jax():
    jcfg = _jax_cfg()
    batch = _batches(1, 130)[0]
    z = np.random.RandomState(6).randn(B, 16).astype(np.float32)
    gen = JGenerator(jcfg.model)
    params = jax.device_get(gen.init(jax.random.key(5), jnp.asarray(z), _cond(batch))["params"])
    cond = {k: v for k, v in _float64(batch).items() if k in KEYS}
    assert cond["tokens"].dtype == np.float64 and cond["patch_mask"].dtype == bool
    want = gen.apply({"params": params}, z, cond)
    server = GeneratorServer.from_flax(_port_cfg(jcfg).model, params, device="cpu")
    tensors = server.cond_tensors(cond)
    assert tensors["tokens"].dtype == tensors["patches"].dtype == torch.float32
    assert tensors["patch_mask"].dtype == torch.bool
    _close(server(z, cond), want, RTOL, ATOL)


def test_float64_conditioning_trains_as_jax():
    jcfg = _jax_cfg()
    batch = _float64(_batches(1)[0])
    jeng = JEngine(jcfg, steps_per_epoch=1)
    jstate = jeng.init_state(0, batch)
    peng = WGANGPEngine(_port_cfg(jcfg), steps_per_epoch=1, device="cpu")
    pstate = peng.state_from_flax(jax.device_get(jstate.g_params),
                                  jax.device_get(jstate.d_params))
    draws = _jax_draws(jstate, jcfg, B)
    jstate, jm = jeng.step(jstate, batch)
    pstate, pm = peng.step(pstate, batch, draws=draws)
    for k in jm:
        _close(pm[k], jm[k], STEP_RTOL, STEP_ATOL, k)
    _assert_params_match(pstate.critic, pstate.d_opt, jstate.d_params, jstate.d_opt_state,
                         "critic")


def _saved_bytes(fn):
    """Bytes of the tensors autograd saves for the backward while `fn` runs."""
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return sum(saved)


def test_remat_layers_recomputes_and_steps_match():
    jcfg = _jax_cfg()
    batch = _batches(1)[0]
    jstate = JEngine(jcfg, steps_per_epoch=1).init_state(0, batch)
    g_params, d_params = jax.device_get(jstate.g_params), jax.device_get(jstate.d_params)
    draws = _jax_draws(jstate, jcfg, B)

    def run(remat):
        cfg = _port_cfg(jcfg)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, fusion=dataclasses.replace(cfg.model.fusion, remat_layers=remat)))
        eng = WGANGPEngine(cfg, steps_per_epoch=1, device="cpu")
        state = eng.state_from_flax(g_params, d_params)
        cond = {k: _t(batch[k]) for k in KEYS}
        saved = _saved_bytes(lambda: state.critic.train()(_t(batch["genes"]), cond))
        state, metrics = eng.step(state, batch, draws=draws)
        return saved, state, metrics

    saved0, s0, m0 = run(False)
    saved1, s1, m1 = run(True)
    assert saved1 < saved0, (saved1, saved0)
    for k in m0:
        _close(m1[k], m0[k].numpy(), 1e-6, 1e-6, k)
    for a, b in zip([*s0.gen.parameters(), *s0.critic.parameters()],
                    [*s1.gen.parameters(), *s1.critic.parameters()]):
        _close(b, a.detach().numpy(), 1e-6, 1e-6)


def test_blocked_reference_saves_o_block_activations():
    B_, H, L, D = 1, 1, 2048, 4
    rng = np.random.RandomState(7)
    q, k, v = (torch.tensor(rng.randn(B_, H, L, D).astype(np.float32), requires_grad=True)
               for _ in range(3))
    mask = torch.from_numpy(np.arange(L)[None, :] < 1500)
    do = torch.from_numpy(rng.randn(B_, H, L, D).astype(np.float32))
    out = {}
    saved = _saved_bytes(lambda: out.setdefault("o", tfa.mha_reference_blocked(q, k, v, mask)))
    block_logits = B_ * H * tfa._REF_BLOCK_Q * L * 4
    assert saved <= 4 * block_logits, (saved, block_logits)
    got = torch.autograd.grad(out["o"], (q, k, v), do)
    want_o = tfa.mha_reference(q, k, v, mask)
    want = torch.autograd.grad(want_o, (q, k, v), do)
    _close(out["o"], want_o.detach().numpy(), 1e-5, 1e-6)
    for g, w in zip(got, want):
        _close(g, w.numpy(), 1e-5, 1e-6)
