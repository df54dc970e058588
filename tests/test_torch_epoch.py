"""The port's epoch loop on the CPU: `step_many`, `step_many_cached` over a
`DeviceCache`, `fit` and its resume, and the launch count of a replayed
graph.

On the CPU `step_many` and `step_many_cached` run the body that a CUDA graph
captures on the card (inputs read from static buffers through a device step
index), in a loop. Held to sequential `step`s of the port, bit for bit
(the same operations in the same order, dropout 0.1 from one seed), and
`step_many` to the JAX engine's `step_many` with the JAX draws at dropout
0, with tests/test_torch_train.py's step tolerances.
"""

import _torch_test_threads  # noqa: F401  (one torch thread per test process)
import collections
import gc

import jax
import numpy as np
import torch

from gemm_gan_tpu.train.wgan import WGANGPEngine as JEngine
from gemm_gan_tpu_torch.data.device_cache import DeviceCache
from gemm_gan_tpu_torch.data.synthetic import synthetic_dataset
from gemm_gan_tpu_torch.kernels import flash_attention as tfa
from gemm_gan_tpu_torch.train.wgan import WGANGPEngine
from test_torch_step_options import _with_train, jax_draws
from test_torch_train import (KEYS, STEP_ATOL, STEP_RTOL, B, _assert_params_match, _batches,
                              _close, _jax_cfg, _no_launches_on_cpu, _port_cfg)

assert _no_launches_on_cpu  # the autouse fixture applies here too


def _params(state):
    nets = [state.gen, state.critic] + ([state.g_ema] if state.g_ema is not None else [])
    return [p.detach().clone() for net in nets for p in net.parameters()]


def _assert_same(a, b):
    (sa, ma), (sb, mb) = a, b
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for x, y in zip(_params(sa), _params(sb)):
        assert torch.equal(x, y)
    assert (sa.step, sa.g_opt.count, sa.d_opt.count) == (sb.step, sb.g_opt.count, sb.d_opt.count)
    assert int(sa.g_opt.count_t) == sa.g_opt.count and int(sa.d_opt.count_t) == sa.d_opt.count


def _engine(cfg, batch, seed=0):
    eng = WGANGPEngine(cfg, steps_per_epoch=3, device="cpu")
    torch.manual_seed(seed)  # dropout
    return eng, eng.init_state(seed, batch)


def test_step_many_matches_sequential():
    """Twin of tests/test_engine.py::test_step_many_matches_sequential, with
    dropout, instance noise and the EMA on: K = 3 `step_many` steps equal 3
    `step`s."""
    cfg = _port_cfg(_with_train(_jax_cfg(dropout=0.1), p_aug=0.5, ema_decay=0.9))
    batches = _batches(3)
    eng, state = _engine(cfg, batches[0])
    for b in batches:
        state, m = eng.step(state, b)
    sequential = state, m
    eng, state = _engine(cfg, batches[0])
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    state, m = eng.step_many(state, stacked)
    _assert_same((state, m), sequential)
    assert state.step == 3 and state.d_opt.count == 6


def test_step_many_matches_jax_step_many():
    """K = 2 `step_many` steps with the JAX draws against the JAX engine's
    `step_many` (one `lax.scan`), dropout 0; then 2 more on the same graph
    (its buffers are reused for any K up to theirs)."""
    jcfg = _jax_cfg()
    batches = _batches(2)
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    jeng = JEngine(jcfg, steps_per_epoch=2)
    jstate = jeng.init_state(0, batches[0])
    peng = WGANGPEngine(_port_cfg(jcfg), steps_per_epoch=2, device="cpu")
    pstate = peng.state_from_flax(jax.device_get(jstate.g_params),
                                  jax.device_get(jstate.d_params))
    for rnd in range(2):
        draws = [jax_draws(jstate, jcfg, int(jstate.step) + k) for k in range(2)]
        draws = {k: np.stack([d[k] for d in draws]) for k in draws[0]}
        jstate, jm = jeng.step_many(jstate, stacked)
        pstate, pm = peng.step_many(pstate, stacked, draws=draws)
        assert pstate.step == int(jstate.step) == 2 * (rnd + 1)
        for k in jm:
            _close(pm[k], jm[k], STEP_RTOL, STEP_ATOL, k)
        _assert_params_match(pstate.gen, pstate.g_opt, jstate.g_params, jstate.g_opt_state,
                             "generator")
        _assert_params_match(pstate.critic, pstate.d_opt, jstate.d_params,
                             jstate.d_opt_state, "critic")
    assert len(peng._graphs) == 1


def _cache(n=12, bank_patches=160, num_patches=128, seed=0):
    """A bank of `bank_patches` ragged patch slots subsampled to 128, so the
    patch self-attention (129 queries) reaches the kernels' plain versions."""
    d = synthetic_dataset(n=n, n_genes=24, num_patches=bank_patches, patch_dim=16,
                          num_tokens=6, text_dim=12, seed=2)
    return DeviceCache({k: d[k] for k in (*KEYS, "genes")}, batch_size=B,
                       num_patches=num_patches, seed=seed, device="cpu")


def test_step_many_cached_matches_stacked_and_eager():
    """Twin of tests/test_device_cache.py::test_step_many_cached_matches_stacked:
    two epochs of `step_many_cached` equal `step_many(cache.stacked_epoch(e))`
    and the eager steps over `cache.epoch(e)`, bit for bit."""
    cfg = _port_cfg(_jax_cfg(dropout=0.1))
    cache = _cache()
    batch = next(iter(cache.epoch(0)))
    runs = []
    for path in ("cached", "stacked", "eager"):
        eng, state = _engine(cfg, batch)
        for e in (0, 1):
            if path == "cached":
                state, m = eng.step_many_cached(state, cache, e)
            elif path == "stacked":
                state, m = eng.step_many(state, cache.stacked_epoch(e))
            else:
                for b in cache.epoch(e):
                    state, m = eng.step(state, b)
        runs.append((state, m))
    _assert_same(runs[0], runs[1])
    _assert_same(runs[0], runs[2])
    assert runs[0][0].step == 2 * cache.n_full_batches


def test_step_many_cached_keeps_one_graph_per_cache():
    """Twin of tests/test_device_cache.py::test_step_many_cached_rebuilds_for_new_cache:
    each cache gets its own graph (another subsampling), and a dropped
    cache releases it."""
    cfg = _port_cfg(_jax_cfg())
    cache4, cache6 = _cache(num_patches=128), _cache(num_patches=130)
    eng, state = _engine(cfg, next(iter(cache4.epoch(0))))
    for cache in (cache4, cache6):
        state, m = eng.step_many_cached(state, cache, 0)
        assert np.isfinite(float(m["d_loss"]))
    assert cache4 in eng._cached_graphs and cache6 in eng._cached_graphs
    assert eng._cached_graphs[cache4] is not eng._cached_graphs[cache6]
    del cache, cache6
    gc.collect()
    assert len(eng._cached_graphs) == 1


def test_fit_resumes_from_start_epoch():
    """`fit(start_epoch=1)` from epoch 1's state trains epochs 1-2 as the
    uninterrupted 3-epoch run does, on the cache path and the stacked path;
    `history` holds the epochs trained."""
    cfg = _port_cfg(_jax_cfg(dropout=0.1))
    cache = _cache()
    batch = next(iter(cache.epoch(0)))
    for kw in (dict(scan_cache=cache), dict(stacked_fn=cache.stacked_epoch)):
        eng, state = _engine(cfg, batch)
        state = eng.fit(state, 3, **kw)
        full, history = _params(state), eng.history
        assert len(history["d_loss"]) == 3 and np.isfinite(history["d_loss"]).all()
        eng, state = _engine(cfg, batch)
        state = eng.fit(state, 1, **kw)
        assert state.step == cache.n_full_batches
        state = eng.fit(state, 3, start_epoch=1, **kw)
        assert state.step == 3 * cache.n_full_batches
        for a, b in zip(_params(state), full):
            assert torch.equal(a, b)
        assert eng.history == {k: v[1:] for k, v in history.items()}


def test_launch_counts_of_a_replayed_graph():
    """What a capture records is taken back off the counters (nothing ran)
    and added once per replay."""
    tfa.reset_launch_counts()
    with tfa.recorded_launches() as recorded:
        tfa.flash_fwd_ble.launches += 16
        tfa.flash_bwd_ble.launches += 12
    assert recorded == {"flash_fwd_ble": 16, "flash_bwd_ble": 12}
    assert not any(tfa.launch_counts().values())
    tfa.flash_fwd_ble.launches += 16  # an eager step
    tfa.count_replays(recorded, 3)
    assert tfa.launch_counts() == {**dict.fromkeys(tfa.launch_counts(), 0),
                                   "flash_fwd_ble": 64, "flash_bwd_ble": 36}
    tfa.reset_launch_counts()


def test_grad_accum_graphed_epoch_body_matches_eager_steps_bit_for_bit():
    """On the CPU `step_many_cached` runs the body a CUDA graph captures on
    the card, the microbatch loop inside it; with `grad_accum=2` (dropout
    0.1) an epoch of it equals the eager steps over `cache.epoch(0)` bit for
    bit."""
    cfg = _port_cfg(_with_train(_jax_cfg(dropout=0.1), grad_accum=2))
    cache = _cache()
    batch = next(iter(cache.epoch(0)))
    runs = []
    for cached in (True, False):
        eng = WGANGPEngine(cfg, steps_per_epoch=3, device="cpu")
        torch.manual_seed(0)
        state = eng.init_state(0, batch)
        if cached:
            state, m = eng.step_many_cached(state, cache, 0)
        else:
            for b in cache.epoch(0):
                state, m = eng.step(state, b)
        runs.append((state, m))
    _assert_same(*runs)
    assert all(np.isfinite(float(v)) for v in runs[0][1].values())


def test_whole_slide_graphed_epoch_body_matches_eager_steps_bit_for_bit(monkeypatch):
    """A bank subsampled to more patches than `BLE_MAX_L` (520 of 600 slots):
    the patch self-attention (521 queries) takes the classic layout's
    forward and blocked backward, Q3, Q4 and Q5 (their plain versions on the
    CPU, counted here), never the ble pair; an epoch of `step_many_cached`'s
    graphed body (dropout 0.1) equals the eager steps over `cache.epoch(0)`
    bit for bit."""
    names = ("flash_fwd_ble", "flash_bwd_ble", "flash_fwd_bhld", "flash_bwd_bhld_fused",
             "flash_bwd_dq", "flash_bwd_dkv")
    calls = collections.Counter()
    for name in names:
        def counted(*args, _kernel=getattr(tfa, name), _name=name):
            calls[_name] += 1
            return _kernel(*args)
        monkeypatch.setattr(tfa, name, counted)
    cfg = _port_cfg(_jax_cfg(dropout=0.1))
    cache = _cache(n=8, bank_patches=600, num_patches=520)
    assert cache.num_patches + 1 > tfa.BLE_MAX_L
    batch = next(iter(cache.epoch(0)))
    runs, counts = [], []
    for cached in (True, False):
        calls.clear()
        eng = WGANGPEngine(cfg, steps_per_epoch=cache.n_full_batches, device="cpu")
        torch.manual_seed(0)
        state = eng.init_state(0, batch)
        calls.clear()
        if cached:
            state, m = eng.step_many_cached(state, cache, 0)
        else:
            for b in cache.epoch(0):
                state, m = eng.step(state, b)
        runs.append((state, m))
        counts.append(dict(calls))
    _assert_same(*runs)
    assert all(np.isfinite(float(v)) for v in runs[0][1].values())
    assert counts[0] == counts[1]
    assert counts[0]["flash_fwd_bhld"] > 0
    assert counts[0]["flash_bwd_dq"] == counts[0]["flash_bwd_dkv"] > 0
    assert not any(counts[0].get(n) for n in ("flash_fwd_ble", "flash_bwd_ble",
                                               "flash_bwd_bhld_fused"))
