"""The port's tracer (`gemm_gan_tpu_torch/utils/metrics.py`'s `TRACER`) in
the epoch loop and the step (`train/wgan.py`), on the CPU: off, it records
nothing and makes no event; on, `fit`'s spans nest in order, a step marks
its stages in the order it runs them, a gap between replays goes to the
host span whose own time covers most of it, and a span's stamps lie on the
clock of the profiler's records. One test needs the card: there a replay's
stages, timed by events that the graph capture recorded, sum to the
replay's own interval.
"""

import _torch_test_threads  # noqa: F401  (one torch thread per test process)
import dataclasses
import statistics

import numpy as np
import pytest
import torch

from gemm_gan_tpu_torch.config import variant_config
from gemm_gan_tpu_torch.data.device_cache import DeviceCache
from gemm_gan_tpu_torch.data.synthetic import synthetic_dataset
from gemm_gan_tpu_torch.train.wgan import WGANGPEngine
from gemm_gan_tpu_torch.utils import metrics
from gemm_gan_tpu_torch.utils.metrics import NO_SPAN, TRACER, MetricLogger, Tracer

KEYS = ("tokens", "token_mask", "patches", "patch_mask")
FIT_CHILDREN = ["fit.epoch_spec", "fit.feed", "fit.replays", "fit.sync", "tracer.read",
                "fit.log", "fit.on_epoch_end"]


@pytest.fixture(autouse=True)
def _tracer_off():
    TRACER.disable()
    TRACER.reset()
    yield
    TRACER.disable()
    TRACER.reset()


def _cfg(n_critic=5, grad_accum=1, use_pallas=False):
    cfg = variant_config("film_cross_attention", n_genes=24, fusion_kw=dict(
        cond_dim=16, text_dim=12, patch_dim=16, ff_dim=32, num_heads=2, num_layers=1,
        dropout=0.0, use_pallas=use_pallas))
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, gen_dims=(32, 32), disc_dims=(32, 32),
                                       latent_dim=16),
        train=dataclasses.replace(cfg.train, n_critic=n_critic, grad_accum=grad_accum,
                                  batch_size=4, ema_decay=0.9))


def _fit(epochs=2, device="cpu", logger=None, **cfg_kw):
    """`fit` over a 12-case `DeviceCache` (3 steps an epoch); the engine."""
    d = synthetic_dataset(n=12, n_genes=24, num_patches=10, patch_dim=16, num_tokens=6,
                          text_dim=12, seed=2)
    cache = DeviceCache({k: d[k] for k in (*KEYS, "genes")}, batch_size=4, num_patches=8,
                        seed=0, device=device)
    eng = WGANGPEngine(_cfg(**cfg_kw), steps_per_epoch=len(cache), device=device)
    torch.manual_seed(0)
    state = eng.init_state(0, next(iter(cache.epoch(0))))
    eng.fit(state, epochs, scan_cache=cache, logger=logger,
            on_epoch_end=lambda engine, state, epoch: None)
    return eng


def _children(tracer, parent):
    return [sp for sp in tracer.spans if sp[1] == parent]


def test_off_span_is_the_shared_no_op():
    assert not TRACER.on
    assert TRACER.span("fit.epoch") is NO_SPAN and TRACER.span("graph.record") is NO_SPAN
    assert TRACER.marking(None) is NO_SPAN
    TRACER.count("epochs")
    TRACER.stage("gather")
    TRACER.read()
    assert TRACER.spans == [] and set(TRACER.counters.values()) == {0}


def test_off_fit_leaves_no_record_and_makes_no_event(monkeypatch):
    made = []

    class Event:
        def __init__(self, *a, **k):
            made.append("event")

    def record_function(*a, **k):
        made.append("record_function")
        raise AssertionError("a span was entered with the tracer off")

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    eng = _fit(epochs=2)
    assert len(eng.history["d_loss"]) == 2
    assert made == []
    assert TRACER.spans == [] and TRACER.runs == [] and TRACER.steps == []
    assert set(TRACER.counters.values()) == {0} and not TRACER._unread
    assert all(g.timing is None for g in eng._cached_graphs.values())


def test_on_fit_spans_come_in_order_inside_each_epoch():
    TRACER.enable()
    _fit(epochs=3, logger=MetricLogger(None))
    epochs = [i for i, sp in enumerate(TRACER.spans) if sp[0] == "fit.epoch"]
    assert len(epochs) == 3 and all(TRACER.spans[i][1] == -1 for i in epochs)
    for i in epochs:
        _, _, start, end = TRACER.spans[i]
        children = _children(TRACER, i)
        assert [c[0] for c in children] == FIT_CHILDREN
        for a, b in zip(children, children[1:]):
            assert a[3] <= b[2]  # one after another
        assert start <= children[0][2] and children[-1][3] <= end
    # three eager epochs of 3 steps, each step clipping its 5 critic updates
    # and its generator update once
    assert TRACER.counters == {"replays": 0, "captures": 0, "epochs": 3,
                               "clip_norms": 3 * 3 * (5 + 1)}
    assert not TRACER._stack
    summary = TRACER.summary()
    assert summary["spans"]["fit.epoch"]["n"] == 3 and summary["graph_capture_s"] == 0.0
    assert "replays" not in summary  # the CPU times no replay on a device


@pytest.mark.parametrize("n_critic,grad_accum", [(5, 1), (2, 2)])
def test_on_a_step_marks_its_stages_in_order(n_critic, grad_accum):
    """At n_critic 5: gather, embed, 5 x (critic_forward, critic_backward,
    optimizer), generator, optimizer; each critic update's microbatches
    alternate forward and backward before its optimizer."""
    TRACER.enable()
    _fit(epochs=2, n_critic=n_critic, grad_accum=grad_accum)
    critic = ["critic_forward", "critic_backward"] * grad_accum + ["optimizer"]
    want = ["gather", "embed"] + critic * n_critic + ["generator", "optimizer"]
    assert len(TRACER.steps) == 2  # each epoch's last step
    for step in TRACER.steps:
        assert [name for name, _ in step] == want
        assert all(ms >= 0 for _, ms in step)
    stage_ms = TRACER.summary()["stage_ms"]
    assert list(stage_ms) == list(metrics.STAGES)
    assert stage_ms["critic_backward"] > 0 and stage_ms["optimizer"] > 0


@pytest.mark.parametrize("n_critic,grad_accum", [(5, 1), (2, 2)])
def test_on_an_eager_step_counts_one_clip_an_update(n_critic, grad_accum):
    """One eager `_fused_step` clips each of its n_critic critic updates and
    its generator update once (`clip_norms`), whatever the microbatches."""
    d = synthetic_dataset(n=4, n_genes=24, num_patches=10, patch_dim=16, num_tokens=6,
                          text_dim=12, seed=2)
    batch = {k: d[k] for k in (*KEYS, "genes")}
    eng = WGANGPEngine(_cfg(n_critic=n_critic, grad_accum=grad_accum), device="cpu")
    torch.manual_seed(0)
    state = eng.init_state(0, batch)
    real, cond = eng._tensors(batch)
    TRACER.enable()
    eng._fused_step(state, real, cond)
    assert TRACER.counters["clip_norms"] == n_critic + 1


def test_an_idle_gap_goes_to_the_span_whose_own_time_covers_most_of_it():
    """Synthetic records (ms): epoch 0 [0, 100] holds sync [90, 95] and
    on_epoch_end [95, 100]; epoch 1 [100, 200] holds epoch_spec [100, 110],
    feed [110, 112] and replays [112, 200]. Run A's replays leave 2 ms idle
    inside it, run B's 1 ms, and the 26 ms from A's end (89) to B's start
    (115) lie mostly in epoch_spec's own time (10 ms; epoch 0's own time
    holds 1 ms of it, epoch 1's none)."""
    ms = 1_000_000
    t = Tracer()
    t.spans = [["fit.epoch", -1, 0, 100 * ms], ["fit.sync", 0, 90 * ms, 95 * ms],
               ["fit.on_epoch_end", 0, 95 * ms, 100 * ms], ["fit.epoch", -1, 100 * ms, 200 * ms],
               ["fit.epoch_spec", 3, 100 * ms, 110 * ms], ["fit.feed", 3, 110 * ms, 112 * ms],
               ["fit.replays", 3, 112 * ms, 200 * ms]]
    t.runs = [("fit.replays", np.array([[10, 30], [32, 50], [50, 89]]) * ms),
              ("fit.replays", np.array([[115, 150], [151, 190]]) * ms)]
    s = t.summary()
    assert s["idle_ms_by_span"] == {"fit.epoch_spec": 26.0, "fit.replays": 3.0}
    assert s["replay_idle_share"] == pytest.approx(100 * 29 / 180)
    assert s["replays"] == {"n": 5, "interval_s": 0.18, "device_ms": 35.0}
    # a gap that falls wholly in a child goes to the child, not its parent
    assert t._own_time_at(91 * ms, 94 * ms, {0: [1, 2], 3: [4, 5, 6]},
                          [sp[2] for sp in t.spans], 200 * ms) == "fit.sync"


def test_span_stamps_lie_on_the_profiler_clock():
    """Each span's start and end against its `record_function` record in a
    `torch.profiler` trace: the median distance is under 50 us."""
    from torch.autograd import DeviceType

    TRACER.enable()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    for i in range(20):
        with TRACER.span(f"probe.{i}"):
            torch.ones(64).sum()
    prof.stop()
    records = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CPU and e.name().startswith("probe.")}
    dist = [max(abs(s - records[n][0]), abs(e - records[n][1])) for n, _, s, e in TRACER.spans]
    assert len(dist) == 20 and statistics.median(dist) < 50_000, dist


@pytest.mark.card
def test_fit_on_the_card_stages_sum_to_the_replay():
    """On the card: the tracer on at capture, each epoch's last replay (of
    the graph whose event nodes mark the stages) has stages that sum to the
    replay's interval between its before and after events within 2%; and
    the epochs train as with the tracer off."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: graph replays and their events run only on one")
    off = _fit(epochs=3, device="cuda").history
    TRACER.enable()
    on = _fit(epochs=3, device="cuda").history
    for k in off:
        np.testing.assert_allclose(on[k], off[k], rtol=1e-3, atol=1e-5, err_msg=k)
    assert TRACER.counters["captures"] == 1 and TRACER.counters["replays"] == 2 + 3 + 3
    # the capture's eager step, its graph and the graph that marks stages
    # each clip the 5 critic updates and the generator's once
    assert TRACER.counters["clip_norms"] == 3 * (5 + 1)
    assert len(TRACER.runs) == 3 and len(TRACER.steps) == 3
    for (_, ns), step in zip(TRACER.runs, TRACER.steps):
        replay_ms = (ns[-1, 1] - ns[-1, 0]) / 1e6
        assert sum(ms for _, ms in step) == pytest.approx(replay_ms, rel=0.02)
    s = TRACER.summary()
    assert 0 <= s["replay_idle_share"] < 100 and s["graph_capture_s"] > 0
