"""The port's training step (gemm_gan_tpu_torch.train) vs the JAX package's.

Same numpy inputs and Flax params through both, on the CPU, at tiny widths
(one layer, n_critic 2, 128 patches so the patch self-attention reaches the
kernels' plain versions behind their autograd Functions). The JAX side runs
its kernels in interpret mode where a test says so, else its jnp reference,
which tests/test_kernels.py pins to the Pallas kernels. z and α are rebuilt
from the JAX key schedule and handed to the port as `draws`; dropout is 0
wherever bits are compared (the two frameworks' random bits differ).

Tolerances: module outputs rtol 1e-4 / atol 1e-5 (f32, another summation
order); losses and their parameter gradients rtol 5e-4 / atol 5e-5 (the
gradient tolerance of tests/test_kernels.py); optimizer trajectories on
identical gradients rtol 1e-5 / atol 1e-8; whole steps: metrics rtol 2e-3 /
atol 2e-4 (tests/test_kernels.py:145-146), params atol 5e-5, 1% of
RMSprop's largest single update (10 lr). RMSprop's first updates are
±10 lr sign(g), so an entry whose gradient is at rounding level (the k
projection's bias, which the softmax ignores; the critic head's bias,
which the Wasserstein loss cancels) may move either way on either side:
entries whose RMSprop accumulator on the JAX side is not 0 but below 1e-4
of the net's RMS are held only to RMSprop's bound of 10 lr per update, and
the test asserts they are few.
"""

import _torch_test_threads  # noqa: F401  (one torch thread per test process)
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gemm_gan_tpu as gg
from gemm_gan_tpu.kernels import flash_attention as jfa
from gemm_gan_tpu.models.gan import Critic as JCritic
from gemm_gan_tpu.ops import attention as jattn
from gemm_gan_tpu.train import losses as jlosses
from gemm_gan_tpu.train.schedules import halving_schedule, make_optimizer
from gemm_gan_tpu.train.wgan import WGANGPEngine as JEngine
from gemm_gan_tpu_torch import config as tcfg
from gemm_gan_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from gemm_gan_tpu_torch.data.synthetic import synthetic_dataset
from gemm_gan_tpu_torch.kernels import flash_attention as tfa
from gemm_gan_tpu_torch.models.gan import Critic
from gemm_gan_tpu_torch.ops import attention as tattn
from gemm_gan_tpu_torch.serving import GeneratorServer
from gemm_gan_tpu_torch.train import losses as tlosses
from gemm_gan_tpu_torch.train.schedules import (ScheduledOptimizer, clip_by_global_norm_,
                                                halving_lr)
from gemm_gan_tpu_torch.train.wgan import WGANGPEngine

RTOL, ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5
STEP_RTOL, STEP_ATOL = 2e-3, 2e-4
PARAM_ATOL = 5e-5
NEGLIGIBLE_GRAD = 1e-4
KEYS = ("tokens", "token_mask", "patches", "patch_mask")
B, P = 4, 128
FLAGSHIP = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "perfbench", "configs", "film_xattn_bf16.json")


def _jax_cfg(reuse="per_update", use_pallas=False, dropout=0.0):
    cfg = gg.variant_config(
        "film_cross_attention", n_genes=24,
        fusion_kw=dict(cond_dim=16, text_dim=12, patch_dim=16, ff_dim=32, num_heads=2,
                       num_layers=1, dropout=dropout, use_pallas=use_pallas))
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, gen_dims=(32, 32), disc_dims=(32, 32),
                                  latent_dim=16),
        train=dataclasses.replace(cfg.train, n_critic=2, cond_embed_reuse=reuse,
                                  lr_halve_every_epochs=1))


def _port_cfg(jcfg, use_pallas=True):
    cfg = tcfg.config_from_dict(dataclasses.asdict(jcfg))
    fusion = dataclasses.replace(cfg.model.fusion, use_pallas=use_pallas)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, fusion=fusion))


def _batches(n_batches=2, num_patches=P):
    d = synthetic_dataset(n=B * n_batches, n_genes=24, num_patches=num_patches,
                          patch_dim=16, num_tokens=6, text_dim=12, seed=1)
    return [{k: d[k][i * B:(i + 1) * B] for k in (*KEYS, "genes")}
            for i in range(n_batches)]


def _cond(batch):
    return {k: batch[k] for k in KEYS}


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rtol, atol, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.fixture(autouse=True)
def _no_launches_on_cpu():
    tfa.reset_launch_counts()
    yield
    assert not any(tfa.launch_counts().values()), "CPU tensors must never launch a kernel"


@pytest.fixture(scope="module")
def critic_params():
    """Flax params of the tiny critic; no param depends on the batch size,
    the sequence lengths or `use_pallas`."""
    jcfg = _jax_cfg()
    batch = _batches(1, 8)[0]
    return jax.device_get(JCritic(jcfg.model).init(
        jax.random.key(3), jnp.asarray(batch["genes"]), _cond(batch))["params"])


def _port_critic(jcfg, params):
    critic = Critic(_port_cfg(jcfg).model, device="cpu")
    critic.load_state_dict(flax_to_state_dict(params))
    return critic


@pytest.mark.parametrize("num_patches,use_pallas", [(8, False), (130, True)])
def test_critic_matches_jax_after_convert(num_patches, use_pallas, critic_params,
                                          monkeypatch):
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    jcfg = _jax_cfg(use_pallas=use_pallas, dropout=0.1)
    batch = _batches(1, num_patches)[0]
    want = JCritic(jcfg.model).apply({"params": critic_params},
                                     jnp.asarray(batch["genes"]), _cond(batch))
    critic = _port_critic(jcfg, critic_params).eval()
    got = critic(_t(batch["genes"]), {k: _t(batch[k]) for k in KEYS})
    assert got.shape == (B, 1)
    _close(got, want, RTOL, ATOL)


def test_critic_weight_bridge_round_trips(critic_params):
    critic = _port_critic(_jax_cfg(), critic_params)
    assert set(flax_to_state_dict(critic_params)) == set(critic.state_dict())
    back = state_dict_to_flax(critic.state_dict())
    flat_a = jax.tree_util.tree_flatten_with_path(critic_params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def test_dropout_sits_where_the_jax_modules_put_it():
    """At rate 1 both frameworks' dropouts output zeros, so a train-mode
    layer pins the placement without comparing random bits: the attention
    output and both FFN dropouts vanish and the layer is norm2(norm1(x))."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 8).astype(np.float32)
    mask = np.ones((2, 5), bool)
    jl = jattn.TransformerEncoder(num_layers=1, embed_dim=8, num_heads=2, ff_dim=16,
                                  dropout=1.0)
    p = jl.init(jax.random.key(0), x, mask)["params"]
    p = jax.tree.map(lambda a: a + 0.1, p)  # non-trivial LayerNorm params
    want = jl.apply({"params": p}, x, mask, deterministic=False,
                    rngs={"dropout": jax.random.key(1)})
    tl = tattn.TransformerEncoder(1, 8, 2, 16, dropout=1.0)
    tl.load_state_dict(flax_to_state_dict(jax.device_get(p)))
    _close(tl.train()(_t(x), _t(mask)), want, RTOL, ATOL)
    assert not np.allclose(tl.eval()(_t(x), _t(mask)).detach().numpy(), want, atol=1e-3)


@pytest.mark.parametrize("batched", [True, False])
def test_critic_loss_and_its_gradients_match_jax(batched, critic_params):
    """One critic update's loss (Wasserstein + 10 GP + drift) and its
    gradient w.r.t. every critic param, the GP taken through
    `batched_scores_and_gp` (per_update) or `gradient_penalty`, with the
    condition embedded once on the graph: the port's kernels (plain
    versions) against the JAX jnp reference."""
    jcfg = _jax_cfg()
    batch = _batches(1, 130)[0]
    rng = np.random.RandomState(4)
    real = batch["genes"]
    fake = rng.randn(B, 24).astype(np.float32)
    alpha = rng.rand(B, 1).astype(np.float32)
    disc = JCritic(jcfg.model)
    cond = _cond(batch)

    def jax_loss(params):
        cvec = disc.apply({"params": params}, cond, method="embed_cond")
        if batched:
            cv = jnp.concatenate([cvec] * 3, axis=0)
            d_real, d_fake, gp = jlosses.batched_scores_and_gp(
                lambda x: disc.apply({"params": params}, x, cv, method="score"),
                real, fake, None, alpha=alpha)
        else:
            d_real = disc.apply({"params": params}, real, cond)
            d_fake = disc.apply({"params": params}, fake, cond)
            gp = jlosses.gradient_penalty(
                lambda x: disc.apply({"params": params}, x, cvec, method="score"),
                real, fake, None, alpha=alpha)
        total = (jlosses.d_loss(d_real, d_fake)[0] + 10.0 * gp
                 + 1e-3 * jlosses.drift_penalty(d_real, d_fake))
        return total, (gp, jlosses.g_loss(d_fake))

    (want, (want_gp, want_gl)), want_grads = jax.jit(jax.value_and_grad(
        jax_loss, has_aux=True))(critic_params)

    critic = _port_critic(jcfg, critic_params).train()  # dropout 0: train mode is exact
    tcond = {k: _t(v) for k, v in cond.items()}
    treal, tfake, talpha = _t(real), _t(fake), _t(alpha)
    cvec = critic.embed_cond(tcond)
    if batched:
        cv = torch.cat([cvec] * 3, dim=0)
        d_real, d_fake, gp = tlosses.batched_scores_and_gp(
            lambda x: critic.score(x, cv), treal, tfake, talpha)
    else:
        d_real, d_fake = critic(treal, tcond), critic(tfake, tcond)
        gp = tlosses.gradient_penalty(lambda x: critic.score(x, cvec), treal, tfake, talpha)
    total = (tlosses.d_loss(d_real, d_fake)[0] + 10.0 * gp
             + 1e-3 * tlosses.drift_penalty(d_real, d_fake))
    grads = torch.autograd.grad(total, list(critic.parameters()))
    for got, w in ((total, want), (gp, want_gp), (tlosses.g_loss(d_fake), want_gl)):
        _close(got, w, GRAD_RTOL, GRAD_ATOL)
    want_sd = flax_to_state_dict(jax.device_get(want_grads))
    for (name, _), g in zip(critic.named_parameters(), grads):
        _close(g, want_sd[name].numpy(), GRAD_RTOL, GRAD_ATOL, name)


def test_optimizer_matches_make_optimizer_across_halving_and_clipping():
    """ScheduledOptimizer vs `make_optimizer` (RMSprop under optax's
    `clip_by_global_norm`) over six updates of the same gradients, crossing
    two halvings (steps_per_epoch 2, halve every epoch) with clipping active
    on some updates and not on others."""
    jcfg = _jax_cfg()
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
    assert opt.count == 6


@functools.lru_cache(maxsize=None)
def _flagship_critic_shapes():
    """The parameter shapes of the critic of the benchmark's flagship
    configuration (`perfbench/configs/film_xattn_bf16.json`): 61 tensors,
    8.58 M entries."""
    with open(FLAGSHIP) as f:
        spec = json.load(f)
    cfg = tcfg.variant_config(spec["architecture"], n_genes=spec["model"]["n_genes"],
                              fusion_kw=dict(spec["fusion"]))
    model = dataclasses.replace(cfg.model, **{k: tuple(v) if isinstance(v, list) else v
                                              for k, v in spec["model"].items()})
    return tuple(tuple(p.shape) for p in Critic(model, device="cpu").parameters())


def _grads(shapes, norm, seed):
    """N(0, 1) gradients of `shapes` scaled to the global norm `norm` (in
    f64)."""
    rng = np.random.RandomState(seed)
    g = [rng.randn(*s).astype(np.float32) for s in shapes]
    total = np.sqrt(sum(float(np.sum(np.square(x, dtype=np.float64))) for x in g))
    return [(x * (norm / total)).astype(np.float32) for x in g]


def _clip_per_tensor_(grads, max_norm):
    """The clip one tensor at a time: each tensor's sum of squares, their
    sum, the same scale, one in-place multiply per tensor."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)


@pytest.mark.parametrize("ratio", (0.5, 1.0, 4.0))  # the global norm over max_norm
@pytest.mark.parametrize("grads,max_norm", (("constant", 2.0), ("constant", 1e-5),
                                            ("flagship_critic", 10.0),
                                            ("flagship_critic", 2.0)))
def test_clip_and_schedule_follow_optax(grads, max_norm, ratio):
    """`clip_by_global_norm_` against optax's `clip_by_global_norm` and the
    per-tensor formula, below, at and above `max_norm`: a constant vector
    (at a norm of 1e-5 too, where an epsilon added to the norm would show),
    and gradients of the flagship critic's 61 shapes."""
    if grads == "constant":
        g = [np.full((4,), ratio * max_norm / 2, np.float32)]
    else:
        g = _grads(_flagship_critic_shapes(), ratio * max_norm, seed=int(10 * ratio + max_norm))
    want, _ = optax.clip_by_global_norm(max_norm).update(g, None)
    got = [_t(x) for x in g]
    clip_by_global_norm_(got, max_norm)
    per_tensor = [_t(x) for x in g]
    _clip_per_tensor_(per_tensor, max_norm)
    for i, (a, w, b) in enumerate(zip(got, want, per_tensor)):
        _close(a, w, 1e-6, 0, f"optax, tensor {i}")
        _close(a, b.numpy(), 1e-6, 0, f"per tensor, tensor {i}")
    if ratio < 1:
        for a, x in zip(got, g):
            np.testing.assert_array_equal(a.numpy(), x)
    schedule = halving_schedule(1e-3, 3, 2)
    for count in range(20):
        assert halving_lr(1e-3, count, 3, 2) == pytest.approx(float(schedule(count)))


def test_clip_makes_the_same_few_ops_for_any_number_of_tensors():
    """The ATen ops one `clip_by_global_norm_` dispatches: as many for the
    first 6 of the flagship critic's tensors as for all 61, and at most 12
    (each one a launch or a few on the card; the per-tensor formula makes
    four a tensor)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func)
            return func(*args, **(kwargs or {}))

    shapes = _flagship_critic_shapes()
    counts = {}
    for n in (6, 61):
        grads = [torch.randn(s) for s in shapes[:n]]
        with Count() as c:
            clip_by_global_norm_(grads, 1e-3)  # active: every tensor is scaled
        counts[n] = c.ops
    assert len(shapes) == 61
    assert counts[6] == counts[61] and len(counts[61]) <= 12, counts


def _jax_draws(jstate, jcfg, batch_size):
    """The step's z and α as the JAX engine draws them (wgan.py:416-419,
    :236-240, :339-340, losses.py:65/94)."""
    t, m = jcfg.train, jcfg.model
    reuse = t.cond_embed_reuse == "per_update"
    key = jax.random.fold_in(jstate.key, jstate.step)
    keys = jax.random.split(key, t.n_critic + (2 if reuse else 1))
    z, alpha = [], []
    for i in range(t.n_critic):
        kz, ka = jax.random.split(keys[i], 9)[:2]
        z.append(jax.random.normal(kz, (batch_size, m.latent_dim)))
        alpha.append(jax.random.uniform(ka, (batch_size, 1)))
    kz = jax.random.split(keys[t.n_critic], 3)[0]
    return {"z": np.stack(z), "alpha": np.stack(alpha),
            "z_gen": np.asarray(jax.random.normal(kz, (batch_size, m.latent_dim)))}


def _rms_state(opt_state):
    """(nu, count) of the RMSprop inside a chain(clip, rmsprop) state."""
    leaves = jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, (optax.ScaleByRmsState,
                                                    optax.ScaleByScheduleState)))
    nu = next(x.nu for x in leaves if isinstance(x, optax.ScaleByRmsState))
    count = next(x.count for x in leaves if isinstance(x, optax.ScaleByScheduleState))
    return nu, int(count)


def _assert_params_match(module, opt, jparams, jopt_state, what):
    nu, count = _rms_state(jax.device_get(jopt_state))
    assert opt.count == count, (what, opt.count, count)
    want = flax_to_state_dict(jax.device_get(jparams))
    rms = {k: v.sqrt() for k, v in flax_to_state_dict(nu).items()}
    net_rms = float(torch.cat([r.flatten() for r in rms.values()]).square().mean().sqrt())
    negligible, total = 0, 0
    for name, p in module.named_parameters():
        diff = (p.detach() - want[name]).abs()
        # held: a clear gradient, or none at all (a dead ReLU unit)
        sure = (rms[name] > NEGLIGIBLE_GRAD * net_rms) | (rms[name] == 0)
        assert not bool((diff[sure] > PARAM_ATOL).any()), (what, name, float(diff.max()))
        assert float(diff.max()) <= 2 * 10 * opt.base_lr * count, (what, name)
        negligible += int((~sure).sum())
        total += p.numel()
    assert negligible < 0.05 * total, (what, negligible, total)


@pytest.mark.parametrize("reuse", ["per_update", "per_call"])
def test_two_engine_steps_match_jax_engine(reuse):
    """Two fused steps of the port's engine vs `WGANGPEngine.step` of the
    JAX package from the same Flax params and the same z/α, in both
    embedding-reuse modes (per_update with batched_scores is the production
    path, per_call the library default): metrics after each step, params
    and optimizer counts after each step."""
    jcfg = _jax_cfg(reuse)
    batches = _batches()
    jeng = JEngine(jcfg, steps_per_epoch=2)
    jstate = jeng.init_state(0, batches[0])
    peng = WGANGPEngine(_port_cfg(jcfg), steps_per_epoch=2, device="cpu")
    pstate = peng.state_from_flax(jax.device_get(jstate.g_params),
                                  jax.device_get(jstate.d_params))
    for step, batch in enumerate(batches):
        draws = _jax_draws(jstate, jcfg, B)
        jstate, jm = jeng.step(jstate, batch)
        pstate, pm = peng.step(pstate, batch, draws=draws)
        assert pm.keys() == jm.keys() and pstate.step == step + 1
        for k in jm:
            _close(pm[k], jm[k], STEP_RTOL, STEP_ATOL, f"step {step}, {k}")
        _assert_params_match(pstate.gen, pstate.g_opt, jstate.g_params,
                             jstate.g_opt_state, f"step {step}, generator")
        _assert_params_match(pstate.critic, pstate.d_opt, jstate.d_params,
                             jstate.d_opt_state, f"step {step}, critic")


def test_fit_trains_and_each_optimizer_keys_its_own_schedule():
    """`fit` runs the loop and records each epoch; the critic's rate halves
    n_critic times sooner, in steps, than the generator's (each optimizer
    counts its own updates, as optax's schedule does)."""
    cfg = _port_cfg(_jax_cfg(dropout=0.1))
    batches = _batches()
    eng = WGANGPEngine(cfg, steps_per_epoch=len(batches), device="cpu")
    torch.manual_seed(0)
    state = eng.init_state(0, batches[0])
    before = [p.detach().clone() for p in state.critic.parameters()]
    state = eng.fit(state, 2, lambda: batches)
    assert state.step == 4 and state.g_opt.count == 4 and state.d_opt.count == 8
    assert state.g_opt.lr == 5e-4 * 0.5 ** 2 and state.d_opt.lr == 5e-4 * 0.5 ** 4
    assert len(eng.history["d_loss"]) == len(eng.history["g_loss"]) == 2
    assert np.isfinite(eng.history["d_loss"] + eng.history["g_loss"]).all()
    assert any(not torch.equal(a, b) for a, b in zip(before, state.critic.parameters()))
    fakes = eng.generate_samples(state, torch.Generator().manual_seed(2), batches[0])
    assert not state.gen.training  # sampling is deterministic
    server = GeneratorServer.for_module(state.gen)
    want = server(torch.randn(B, 16, generator=torch.Generator().manual_seed(2)),
                  _cond(batches[0]))
    assert torch.equal(fakes, want)
    out = eng.generate_samples_all(state, batches, 2, torch.Generator().manual_seed(2))
    assert out["fake"].shape == (2 * len(batches) * B, 24)
    eng.step(state, batches[0])
    assert state.gen.training and state.critic.training


@pytest.mark.parametrize("train_kw,error", [
    (dict(grad_accum=3), ValueError),  # batch 4 in 3 microbatches
    (dict(optimizer="sgd"), ValueError),
    (dict(n_critic=0), ValueError),
    (dict(cond_embed_reuse="sometimes"), ValueError),
])
def test_unported_options_raise(train_kw, error):
    cfg = _port_cfg(_jax_cfg())
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **train_kw))
    with pytest.raises(error):
        eng = WGANGPEngine(cfg, device="cpu")
        eng.init_state(0, _batches(1, 8)[0])


def test_engine_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        WGANGPEngine(_port_cfg(_jax_cfg()))
