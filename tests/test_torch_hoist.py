"""`train.hoist_fakes=True` in the port's engine on the CPU: all n_critic
fake batches from one generator trunk forward over [n_critic * B] rows
(the per_update batched path, `grad_accum` 1), against the per-update
fakes of the same engine, against the JAX engine's hoisted step with the
same draws, through `step_many` against eager steps, and as a no-op off
its path (as in JAX).

Tolerances: hoisted against per-update, the first critic update's metrics
rtol 1e-4 / atol 1e-6 (tests/test_engine.py's twin for JAX) and every
param within PARAM_ATOL; against the JAX engine as tests/test_torch_train.py
holds whole steps (metrics rtol 2e-3 / atol 2e-4, params atol 5e-5);
`step_many` against eager steps and the no-op cases bit for bit.
"""

import _torch_test_threads  # noqa: F401  (one torch thread per test process)
import numpy as np
import pytest
import torch

from gemm_gan_tpu_torch.train.wgan import WGANGPEngine
from test_torch_step_options import _two_steps_match, _with_train
from test_torch_train import PARAM_ATOL, _batches, _jax_cfg, _no_launches_on_cpu, _port_cfg

assert _no_launches_on_cpu  # the autouse fixture applies here too


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: tiny shapes are many small ops, which torch's
    thread pool only slows (and the suite runs files side by side)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _step(cfg, n_steps=1, seed=0):
    """`n_steps` eager steps from the seeded init; (state, last metrics)."""
    batches = _batches(n_steps)
    eng = WGANGPEngine(cfg, steps_per_epoch=2, device="cpu")
    torch.manual_seed(seed)  # dropout
    state = eng.init_state(seed, batches[0])
    for b in batches:
        state, metrics = eng.step(state, b)
    return eng, state, {k: float(v) for k, v in metrics.items()}


def _params(state):
    return [p.detach() for net in (state.gen, state.critic) for p in net.parameters()]


@pytest.mark.parametrize("n_critic", [1, 5])
def test_hoisted_step_matches_the_per_update_step(n_critic):
    """The same z rows (`draws["z"][i]`) and the tiled embedding: the
    hoisted fakes are the per-update ones up to the product's summation
    order, so the first update's terms agree tightly; at n_critic 5 the
    later updates see them too."""
    runs = {}
    for hoist in (False, True):
        cfg = _port_cfg(_with_train(_jax_cfg(), n_critic=n_critic, hoist_fakes=hoist))
        eng, state, metrics = _step(cfg)
        assert eng.hoist is hoist
        runs[hoist] = (state, metrics)
    for k, v in runs[False][1].items():
        np.testing.assert_allclose(runs[True][1][k], v, rtol=1e-4, atol=1e-6, err_msg=k)
    for a, b in zip(_params(runs[True][0]), _params(runs[False][0])):
        assert float((a - b).abs().max()) <= PARAM_ATOL


@pytest.mark.parametrize("p_aug", [0.0, 0.5])
def test_hoisted_step_matches_jax_hoisted_step(p_aug):
    """Two steps of both engines with `hoist_fakes=True` from the same Flax
    params and the JAX key schedule's z, alpha (and, with instance noise,
    each update's gate and noise, applied per update after the hoist)."""
    jcfg = _with_train(_jax_cfg(), hoist_fakes=True, p_aug=p_aug)
    assert jcfg.train.batched_scores and jcfg.train.cond_embed_reuse == "per_update"
    _two_steps_match(jcfg)


def test_hoisted_step_many_matches_eager_steps():
    """The graphed body (`step_many`, a loop on the CPU) with the hoist and
    dropout 0.1 against eager steps from the same state and seeds."""
    cfg = _port_cfg(_with_train(_jax_cfg(dropout=0.1), hoist_fakes=True))
    _, eager, m_eager = _step(cfg, n_steps=2)
    batches = _batches(2)
    eng = WGANGPEngine(cfg, steps_per_epoch=2, device="cpu")
    torch.manual_seed(0)
    state = eng.init_state(0, batches[0])
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    state, m = eng.step_many(state, stacked)
    assert state.step == eager.step == 2
    assert {k: float(v) for k, v in m.items()} == m_eager
    assert all(torch.equal(a, b) for a, b in zip(_params(state), _params(eager)))


@pytest.mark.parametrize("train_kw", [dict(grad_accum=2), dict(cond_embed_reuse="per_call"),
                                      dict(batched_scores=False)])
def test_hoist_fakes_changes_nothing_off_its_path(train_kw):
    """Off the per_update batched path, or with microbatches, the knob is a
    no-op, as in the JAX engine (`train_step`'s condition)."""
    jcfg = _with_train(_jax_cfg(), **train_kw)
    runs = {}
    for hoist in (False, True):
        eng, state, metrics = _step(_port_cfg(_with_train(jcfg, hoist_fakes=hoist)))
        assert not eng.hoist
        runs[hoist] = (state, metrics)
    assert runs[True][1] == runs[False][1]
    assert all(torch.equal(a, b) for a, b in zip(_params(runs[True][0]),
                                                  _params(runs[False][0])))
