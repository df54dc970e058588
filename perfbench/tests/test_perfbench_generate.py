"""The generate cell at tiny widths on the CPU: a sound run of the port's
serving path is correct; each fault a generate cell can have, planted in
the port under the harness, makes it incorrect; the control and the
reference's planted faults fail the cell's numbers; a batch's FLOPs equal
`FlopCounterMode` over the reference's forward; the cell finds its
metrics, and its readers read made-up trace records."""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import calibrate_generate, generate_check, spec
from perfbench.cells.generate import SPAN, spanned, without
from perfbench.reference.film_cross_attention import Net, init_params, param_shapes
from perfbench.reference.numerics import Dropout
from perfbench.run import forbidden_modules, run_cell
from perfbench.tests._tiny import TINY_FUSION, TINY_MODEL
from perfbench.trace import reduce_events

CELL = "film_xattn_bf16.generate_cohort"
HELD = os.path.join(spec.HERE, "held.json")  # the cell is held out of BENCHMARK.json
SEED = 2 ** 31 + 12345  # more than 32 signed bits, as a run's --seed may be
TINY_GENERATE = dict(cases=40, patch_slots=12, min_valid_patches=6, num_patches=12, tokens=10,
                     min_valid_tokens=3, batch_size=8)
# the cell's head dim, 64: there the port's CPU path and the reference
# scale q alike, and a sound run reads 0
TINY_FUSION_D64 = dict(TINY_FUSION, cond_dim=64, num_heads=1, ff_dim=64)
flops = spec.architecture_flops("film_cross_attention_generate")


def tiny_generate_cell(**traffic):
    cell = spec.load_cell(CELL, HELD)
    cell.config["model"].update(TINY_MODEL)
    cell.config["fusion"].update(TINY_FUSION_D64)
    cell.traffic.update(TINY_GENERATE, **traffic)
    return cell


# ------------------------------------------------------------- the faults
def on_graph_output(change):
    """A fault planted where the graph's profiles [R, rows, n_genes] come
    out of each batch's `_SampleGraph.run`."""
    def fault(server):
        make = server._sample_graph

        def sample_graph(cond, zs):
            graph = make(cond, zs)
            if "run" not in vars(graph):
                run = graph.run
                graph.run = lambda c, z: change(run(c, z))
            return graph

        server._sample_graph = sample_graph

    fault.__name__ = change.__name__
    return fault


def stale_output():
    """Every replay after the first returns the first batch's profiles, as
    a graph whose output buffer is never rewritten."""
    first = []

    def stale_output(f):
        if not first:
            first.append(f.clone())
        return first[0].clone()

    return stale_output


def half_batch(f):
    """The second half of each batch's profiles are the first half's."""
    f, h = f.clone(), f.shape[1] // 2
    f[:, h:2 * h] = f[:, :h]
    return f


def profile_altered(f):
    """One profile of each batch altered where it is produced: the first
    row's is the second's."""
    f = f.clone()
    f[:, 0] = f[:, 1]
    return f


def train_mode(server):
    """The served generator left in training mode: its dropout on."""
    server.gen.train()


def test_a_sound_run_is_correct():
    cell = tiny_generate_cell()
    result = run_cell(cell, SEED, 1.0, False, "cpu")
    assert result["correct"] is True
    assert list(result)[-1] == "check"
    assert set(result["check"]) == set(generate_check.compared(cell.limits)) == {
        "gen_rel_gap", "gen_profile_gap"}
    assert result["failed"] == 0 and result["attempted"] % cell.traffic["cases"] == 0
    assert set(result["metrics"]) == {"infer_samples_per_s", "setup_s"}
    assert forbidden_modules() == []


@pytest.mark.parametrize("fault", [on_graph_output(stale_output()), on_graph_output(half_batch),
                                   on_graph_output(profile_altered), train_mode],
                         ids=lambda f: f.__name__)
def test_a_fault_under_the_harness_is_incorrect(fault):
    result = run_cell(tiny_generate_cell(), SEED, 1.0, False, "cpu", wrap=fault)
    assert result["correct"] is False


@pytest.mark.parametrize("seed", [7, SEED])
def test_the_control_and_the_reference_faults_are_incorrect(seed):
    cell = tiny_generate_cell()
    out = calibrate_generate.readings(cell, seed, "cpu", calls=2)
    assert generate_check.verdict(out["program"], cell.limits)
    for side in ("control", *generate_check.FAULTS):
        assert not generate_check.verdict(out[side], cell.limits), side


def test_the_patch_mask_fault_needs_a_ragged_mask():
    """With every patch slot valid, as in the cell's traffic, ignoring the
    patch mask changes nothing: the fault cannot occur there."""
    cell = tiny_generate_cell(min_valid_patches=12)
    out = calibrate_generate.readings(cell, 7, "cpu", faults=("patch_mask_ignored",))
    assert out["patch_mask_ignored"] == {"gen_rel_gap": 0.0, "gen_profile_gap": 0.0}


def test_numbers_read_a_wrong_shape_or_a_nan_as_inf_and_one_profile_alone():
    ref = {(0, 0): np.ones((1, 4, 3), np.float32)}
    assert generate_check.numbers({(0, 0): np.ones((1, 3, 3))}, ref)["gen_rel_gap"] == np.inf
    nan = np.ones((1, 4, 3), np.float32)
    nan[0, 1, 2] = np.nan
    assert generate_check.numbers({(0, 0): nan}, ref) == {"gen_rel_gap": np.inf,
                                                          "gen_profile_gap": np.inf}
    one = np.ones((1, 4, 3), np.float32)
    one[0, 2] = 2.0
    got = generate_check.numbers({(0, 0): one}, ref)
    assert got == {"gen_rel_gap": pytest.approx(0.25), "gen_profile_gap": pytest.approx(1.0)}


# ------------------------------------------------------------------ FLOPs
def counted(cell, device) -> int:
    cfg, tr = cell.config, cell.traffic
    if device == "meta":
        w = {k: torch.empty(s, device=device) for k, s in param_shapes(cfg, "gen")}
    else:
        w = init_params(cfg, "gen", torch.Generator().manual_seed(0), device)
    B, f = tr["batch_size"], cfg["fusion"]
    P, T = tr["patch_slots"], tr["tokens"]
    cond = {"tokens": torch.randn(B, T, f["text_dim"], device=device),
            "token_mask": torch.ones(B, T, dtype=torch.bool, device=device),
            "patches": torch.randn(B, P, f["patch_dim"], device=device),
            "patch_mask": torch.ones(B, P, dtype=torch.bool, device=device)}
    net = Net(cfg, w, Dropout(0.0, torch.float32))
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        cvec = net.embed(cond)
        for _ in range(tr["num_repeats"]):
            net.score(torch.randn(B, cfg["model"]["latent_dim"], device=device), cvec)
    return counter.get_total_flops()


@pytest.mark.parametrize("repeats", [1, 3])
def test_batch_flops_at_tiny_widths_on_the_cpu(repeats):
    cell = tiny_generate_cell(num_repeats=repeats)
    assert flops.generate_batch_flops(cell.config, cell.traffic) == counted(cell, "cpu")


def test_batch_flops_at_the_published_widths_on_meta():
    cell = spec.load_cell(CELL, HELD)
    assert flops.generate_batch_flops(cell.config, cell.traffic) == counted(cell, "meta")


def test_kernel_site_of_a_batch():
    cell = spec.load_cell(CELL, HELD)
    site, = flops.generate_kernel_sites(cell.config, cell.traffic)
    assert (site["B"], site["Lq"], site["Lk"], site["D"], site["valid_keys"]) == (
        64, 257, 257, 64, 64 * 257)
    assert site["launches"] == {"fwd": 2, "bwd": 0}


# ------------------------------------------------------------ the metrics
def test_the_cells_find_their_end_to_end_metrics():
    names = {w: {m["name"] for m in spec.load_cell(w).end_to_end}
             for w in ("film_xattn_bf16.train_cohort", "film_xattn_f32.train_cohort",
                       "film_xattn_bf16.train_wholeslide")}
    assert all(n == {"train_steps_per_s", "setup_s"} for n in names.values())
    assert {m["name"] for m in spec.load_cell(CELL, HELD).end_to_end} == {
        "infer_samples_per_s", "setup_s"}
    with pytest.raises(KeyError):
        spec.load_cell(CELL)


def test_the_cells_find_their_per_layer_metrics():
    new = {"infer_mfu", "batch_device_ms.generate", "batch_device_events.generate",
           "flash_attn_roofline.generate", "flash_attn_device_share.generate", "d2h_ms.generate",
           "call_idle_ms.generate"}
    assert {m["name"] for m in spec.load_cell(CELL, HELD).per_layer} == new
    assert all(m["moves"] == "infer_samples_per_s" for m in spec.load_cell(CELL, HELD).per_layer)
    train = {"train_mfu", "step_device_ms.train", "step_device_events.train",
             "flash_attn_roofline.train", "flash_attn_device_share.train", "epoch_gap_ms.train"}
    assert {m["name"] for m in spec.load_cell("film_xattn_bf16.train_cohort").per_layer} == train


class Event:
    def __init__(self, name, start, end, device=True):
        from torch.autograd import DeviceType

        self._n, self._s, self._d = name, start, end - start
        self._t = DeviceType.CUDA if device else DeviceType.CPU

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._t


FLASH = "void (anonymous namespace)::flash_fwd_wg_kernel<64, true, 1>(Args<__nv_bfloat16>)"
COPY = "Memcpy DtoH (Device -> Pageable)"
# sentinels, then two batches: each a span (and the profiler's copy of it
# on the device's timeline), a graph's flash kernel, another kernel and the
# copy of its profiles to the host; a last kernel ends the pass
EVENTS = [Event("void spin_kernel(long)", 0, 100),
          Event(SPAN, 150, 500, device=False), Event("cudaGraphLaunch", 160, 170, device=False),
          Event(SPAN, 180, 460), Event(FLASH, 200, 300), Event("void at::native::copy", 300, 350),
          Event(COPY, 400, 450),
          Event(SPAN, 520, 600, device=False), Event(SPAN, 590, 860), Event(FLASH, 600, 700),
          Event(COPY, 800, 850), Event("void at::native::cat", 950, 990)]


def traced(events):
    return without(reduce_events(events, spanned(SPAN)), SPAN)


def test_the_readers_of_a_traced_pass():
    reduced = traced(EVENTS)
    assert reduced.window == (200, 990)
    assert reduced.busy_s == pytest.approx(390e-9)
    assert SPAN not in reduced.by_name
    peaks = spec.peaks("NVIDIA H100 80GB HBM3")
    site = {"B": 64, "H": 4, "Lq": 257, "Lk": 257, "D": 64, "valid_keys": 64 * 257,
            "launches": {"fwd": 2, "bwd": 0}}
    ctx = SimpleNamespace(trace=reduced, trace_batches=2, window_batches=10, window_s=1e-6,
                          batch_flops=1e6, peak_flops=1e12, peaks=peaks,
                          kernels=spec.kernel_bounds(), sites=[site])
    read = {m["name"]: spec.metric_reader(m["name"]).read(ctx)
            for m in spec.load_cell(CELL, HELD).per_layer}
    assert read["infer_mfu"] == pytest.approx(100 * 1e6 * 10 / 1e-6 / 1e12)
    assert read["batch_device_ms.generate"] == pytest.approx(390e-9 * 1e3 / 2)
    assert read["batch_device_events.generate"] == 3
    assert read["flash_attn_device_share.generate"] == pytest.approx(100 * 200 / 390)
    assert read["d2h_ms.generate"] == pytest.approx(100e-9 * 1e3 / 2)
    assert read["call_idle_ms.generate"] == pytest.approx((790 - 390) * 1e-9 * 1e3)
    bound = spec.kernel_bounds()["flash_fwd_wg_kernel"].bound_s(site, ["64", "true", "1"], peaks)
    assert read["flash_attn_roofline.generate"] == pytest.approx(100 * 2 * bound / 200e-9)


def test_a_reader_with_nothing_to_read_returns_none():
    events = [e for e in EVENTS if e.name() not in (FLASH, COPY)]
    ctx = SimpleNamespace(trace=traced(events), trace_batches=2,
                          kernels=spec.kernel_bounds(), sites=[])
    for name in ("d2h_ms.generate", "flash_attn_roofline.generate",
                 "flash_attn_device_share.generate"):
        assert spec.metric_reader(name).read(ctx) is None


def test_the_roofline_refuses_a_backward_in_sampling():
    events = EVENTS + [Event("void flash_bwd_wg_kernel<64, true, 1>(Args)", 700, 720)]
    site = {"B": 64, "H": 4, "Lq": 257, "Lk": 257, "D": 64, "valid_keys": 64 * 257,
            "launches": {"fwd": 2, "bwd": 0}}
    ctx = SimpleNamespace(trace=traced(events), kernels=spec.kernel_bounds(),
                          peaks=spec.peaks("NVIDIA H100 80GB HBM3"), sites=[site])
    with pytest.raises(ValueError, match="no site"):
        spec.metric_reader("flash_attn_roofline.generate").read(ctx)
