"""The step's options that the port took over in its epoch-loop slice,
against the JAX package on the CPU: Adam and AdamW under the halving
schedule with clipping (against optax), the generator's EMA, instance
noise (`p_aug`) and gradient accumulation (`grad_accum`) (against the JAX
engine, with the draws rebuilt from its key schedule, dropout 0).

Tolerances: optimizer trajectories on identical gradients rtol 1e-5 / atol
1e-8; the EMA's closed form rtol 1e-6 / atol 1e-7 (tests/test_engine.py);
whole steps as tests/test_torch_train.py holds them, also the accumulated
step against the port's own full-batch step (the full-batch run's RMSprop
accumulator tells the entries whose gradient is rounding: a reordered sum
flips their +-10 lr move; the second step's metrics come from params moved
apart so: measured 1.3e-3 relative in g_loss).
"""

import _torch_test_threads  # noqa: F401  (one torch thread per test process)
import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from gemm_gan_tpu.train.schedules import make_optimizer
from gemm_gan_tpu.train.wgan import WGANGPEngine as JEngine
from gemm_gan_tpu_torch.train.schedules import ScheduledOptimizer
from gemm_gan_tpu_torch.train.wgan import WGANGPEngine
from test_torch_train import (NEGLIGIBLE_GRAD, PARAM_ATOL, STEP_ATOL, STEP_RTOL, B,
                              _assert_params_match, _batches, _close, _jax_cfg, _jax_draws,
                              _no_launches_on_cpu, _port_cfg, _t)

assert _no_launches_on_cpu  # the autouse fixture applies here too


def _with_train(jcfg, **kw):
    return dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train, **kw))


def jax_draws(jstate, jcfg, step=None):
    """`step`'s draws (default: the state's next) as the JAX engine makes
    them: z and α (`test_torch_train._jax_draws`) and, with p_aug > 0, each
    critic update's gate and unscaled noise (wgan.py:227-230, :153-157)."""
    t = jcfg.train
    step = int(jstate.step) if step is None else step
    jstate = jstate.replace(step=step)
    draws = _jax_draws(jstate, jcfg, B)
    if t.p_aug > 0:
        keys = jax.random.split(jax.random.fold_in(jstate.key, step), t.n_critic + 2)
        gate, fake, real = [], [], []
        for i in range(t.n_critic):
            kgate, kn1, kn2 = jax.random.split(keys[i], 9)[2:5]
            gate.append(jax.random.bernoulli(kgate, t.p_aug))
            fake.append(jax.random.normal(kn1, (B, jcfg.model.n_genes)))
            real.append(jax.random.normal(kn2, (B, jcfg.model.n_genes)))
        draws.update(gate=np.asarray(gate, np.float32), noise_fake=np.stack(fake),
                     noise_real=np.stack(real))
    return draws


@pytest.mark.parametrize("optimizer", ["adam", "adamw"])
def test_adam_and_adamw_match_make_optimizer_across_halving_and_clipping(optimizer):
    """As test_torch_train's RMSprop test: six updates of the same
    gradients, two halvings, clipping on some updates and not on others."""
    jcfg = _with_train(_jax_cfg(), optimizer=optimizer, adam_b2=0.999, weight_decay=0.05)
    rng = np.random.RandomState(5)
    params = {"a": rng.randn(3, 4).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    tx = make_optimizer(jcfg.train, 5e-4, 2, clip_grad=2.0)
    jstate, jparams = tx.init(params), params
    tparams = [torch.nn.Parameter(_t(params[k])) for k in ("a", "b")]
    opt = ScheduledOptimizer(tparams, _port_cfg(jcfg).train, 5e-4, 2, clip_grad=2.0)
    clipped = []
    for i, scale in enumerate((0.1, 3.0, 0.2, 5.0, 0.05, 1.0)):
        g = {k: (scale * rng.randn(*v.shape)).astype(np.float32) for k, v in params.items()}
        clipped.append(optax.global_norm(g) > 2.0)
        assert opt.lr == 5e-4 * 0.5 ** (i // 2)
        updates, jstate = tx.update(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.apply([_t(g["a"]), _t(g["b"])])
        for p, k in zip(tparams, ("a", "b")):
            _close(p, jparams[k], 1e-5, 1e-8, f"update {i}, {k}")
    assert any(clipped) and not all(clipped)
    assert opt.count == int(opt.count_t) == 6


def _engines(jcfg, batch, seed=0):
    jeng = JEngine(jcfg, steps_per_epoch=2)
    jstate = jeng.init_state(seed, batch)
    peng = WGANGPEngine(_port_cfg(jcfg), steps_per_epoch=2, device="cpu")
    pstate = peng.state_from_flax(jax.device_get(jstate.g_params),
                                  jax.device_get(jstate.d_params))
    return jeng, jstate, peng, pstate


def _two_steps_match(jcfg, seed=0):
    batches = _batches()
    jeng, jstate, peng, pstate = _engines(jcfg, batches[0], seed)
    all_draws = []
    for step, batch in enumerate(batches):
        draws = jax_draws(jstate, jcfg)
        all_draws.append(draws)
        jstate, jm = jeng.step(jstate, batch)
        pstate, pm = peng.step(pstate, batch, draws=draws)
        for k in jm:
            _close(pm[k], jm[k], STEP_RTOL, STEP_ATOL, f"step {step}, {k}")
        _assert_params_match(pstate.gen, pstate.g_opt, jstate.g_params, jstate.g_opt_state,
                             f"step {step}, generator")
        _assert_params_match(pstate.critic, pstate.d_opt, jstate.d_params,
                             jstate.d_opt_state, f"step {step}, critic")
    return jstate, pstate, all_draws


def test_ema_steps_match_jax_engine():
    jcfg = _with_train(_jax_cfg(), ema_decay=0.9)
    jstate, pstate, _ = _two_steps_match(jcfg)
    _assert_params_match(pstate.g_ema, pstate.g_opt, jstate.g_ema, jstate.g_opt_state, "EMA")


def test_ema_generator_tracks_params():
    """Twin of tests/test_engine.py::test_ema_generator_tracks_params: the
    EMA starts at the generator, follows e = 0.9 e + 0.1 p, and sampling
    decodes with it by default."""
    cfg = _port_cfg(_with_train(_jax_cfg(), ema_decay=0.9))
    batch = _batches(1)[0]
    eng = WGANGPEngine(cfg, steps_per_epoch=2, device="cpu")
    state = eng.init_state(0, batch)
    g0 = [p.detach().clone() for p in state.gen.parameters()]
    for a, b in zip(state.g_ema.parameters(), g0):
        assert torch.equal(a, b)
    state, _ = eng.step(state, batch)
    for e, a, b in zip(state.g_ema.parameters(), g0, state.gen.parameters()):
        _close(e, (0.9 * a + 0.1 * b.detach()).numpy(), 1e-6, 1e-7)

    def sample(**kw):
        return eng.generate_samples(state, torch.Generator().manual_seed(0), batch, **kw)

    assert torch.equal(sample(), sample(use_ema=True))
    assert not torch.allclose(sample(), sample(use_ema=False))
    out = eng.generate_samples_all(state, [batch], 1, torch.Generator().manual_seed(0))
    assert np.array_equal(out["fake"], sample().numpy())


def test_ema_off_by_default():
    batch = _batches(1)[0]
    eng = WGANGPEngine(_port_cfg(_jax_cfg()), steps_per_epoch=2, device="cpu")
    state = eng.init_state(0, batch)
    assert state.g_ema is None
    with pytest.raises(ValueError, match="use_ema"):
        eng.generate_samples(state, torch.Generator().manual_seed(0), batch, use_ema=True)


def test_instance_noise_steps_match_jax_engine():
    """Two steps with p_aug 0.5: the gate and both noises of every critic
    update from the JAX key schedule; from seed 3 two of the four updates
    are gated."""
    jcfg = _with_train(_jax_cfg(), p_aug=0.5)
    _, _, draws = _two_steps_match(jcfg, seed=3)
    gates = np.concatenate([d["gate"] for d in draws])
    assert 0 < gates.sum() < len(gates), gates


def test_instance_noise_draws_from_the_state_rng():
    """Without `draws` the gate and the noise come from `state.rng`: the
    same seed repeats a step, and p_aug 1 changes it."""
    batch = _batches(1)[0]

    def step(p_aug):
        eng = WGANGPEngine(_port_cfg(_with_train(_jax_cfg(), p_aug=p_aug)), device="cpu")
        return eng.step(eng.init_state(0, batch), batch)[1]["d_loss"]

    assert torch.equal(step(1.0), step(1.0))
    assert not torch.equal(step(1.0), step(0.0))


@pytest.mark.parametrize("reuse,train_kw", [
    ("per_update", {}),              # the production path: batched_scores, per_update
    ("per_call", {}),                # the library default
    ("per_update", dict(p_aug=0.5)),  # instance noise sliced per microbatch
])
def test_grad_accum_steps_match_jax_engine(reuse, train_kw):
    """Two steps with `grad_accum=2` (batch 4: two strided microbatches of
    2) against the JAX engine's accumulated steps, the same full-batch draws
    (`jax_draws`, unchanged by accumulation)."""
    jcfg = _with_train(_jax_cfg(reuse), grad_accum=2, **train_kw)
    _two_steps_match(jcfg, seed=3)


@pytest.mark.parametrize("reuse", ["per_update", "per_call"])
def test_grad_accum_step_equals_full_batch_step(reuse):
    """Twin of tests/test_grad_accum.py: at dropout 0 the accumulated step
    is the full-batch step, up to the summation order."""
    batches = _batches()
    runs = []
    for accum in (1, 2):
        cfg = _port_cfg(_with_train(_jax_cfg(reuse), grad_accum=accum, p_aug=0.5))
        eng = WGANGPEngine(cfg, steps_per_epoch=2, device="cpu")
        state = eng.init_state(0, batches[0])
        for batch in batches:
            state, metrics = eng.step(state, batch)
        runs.append((state, metrics))
    (full, m_full), (acc, m_acc) = runs
    for k in m_full:
        _close(m_acc[k], m_full[k].numpy(), STEP_RTOL, STEP_ATOL, k)
    for net, got, want in (("generator", acc.g_opt, full.g_opt),
                           ("critic", acc.d_opt, full.d_opt)):
        rms = [nu.sqrt() for nu in want.nu]
        net_rms = float(torch.cat([r.flatten() for r in rms]).square().mean().sqrt())
        negligible, total = 0, 0
        for p_got, p_want, r in zip(got.params, want.params, rms):
            diff = (p_got - p_want).detach().abs()
            sure = (r > NEGLIGIBLE_GRAD * net_rms) | (r == 0)
            assert not bool((diff[sure] > PARAM_ATOL).any()), (net, float(diff.max()))
            assert float(diff.max()) <= 2 * 10 * want.base_lr * want.count, net
            negligible += int((~sure).sum())
            total += diff.numel()
        assert negligible < 0.05 * total, (net, negligible, total)


def test_grad_accum_rejects_an_indivisible_batch():
    cfg = _port_cfg(_with_train(_jax_cfg(), grad_accum=3))
    eng = WGANGPEngine(cfg, device="cpu")
    batch = _batches(1)[0]
    with pytest.raises(ValueError, match="not divisible"):
        eng.init_state(0, batch)
    state = WGANGPEngine(_port_cfg(_jax_cfg()), device="cpu").init_state(0, batch)
    with pytest.raises(ValueError, match="not divisible"):
        eng.step(state, batch)

