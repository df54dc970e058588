"""The trace's reduction and the per-layer readers, on records made up for
the test: sentinels, one traced epoch of two kernels launched by a graph
replay, the benchmark's epoch-end span, the next epoch's first kernel."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from perfbench import spec
from perfbench.trace import first_epoch, reduce_events


class Event:
    def __init__(self, name, start, end, device=True):
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
EVENTS = [Event("void spin_kernel(long)", 0, 100), Event("spin_kernel", 100, 120),
          Event("cudaGraphLaunch", 130, 140, device=False),
          Event(FLASH, 200, 300), Event("void at::native::copy", 310, 400),
          Event("perfbench.on_epoch_end", 450, 460, device=False),
          Event("cudaGraphLaunch", 470, 480, device=False),
          Event("void at::native::copy", 500, 600)]


SITE = {"B": 8, "H": 4, "Lq": 257, "Lk": 257, "D": 64, "valid_keys": 8 * 257,
        "launches": {"fwd": 16, "bwd": 12}}


def reduced():
    return reduce_events(EVENTS, first_epoch("perfbench.on_epoch_end"))


def test_the_window_is_the_first_epoch():
    r = reduced()
    assert r.sentinels_kept == 2
    assert r.window == (200, 400)
    assert r.window_s == pytest.approx(200e-9)
    assert r.busy_s == pytest.approx(190e-9)
    assert r.by_name[FLASH] == (pytest.approx(100e-9), 1)
    assert r.idle_ns(400, 500) == 100


def test_the_readers():
    ctx = SimpleNamespace(trace=reduced(), trace_steps=1, window_steps=10, window_s=1e-6,
                          step_flops=1e6, peak_flops=1e12, peaks=spec.peaks("NVIDIA H100 80GB HBM3"),
                          kernels=spec.kernel_bounds(),
                          sites=[SITE])
    read = {m: spec.metric_reader(m).read(ctx) for m in (
        "train_mfu", "step_device_ms.train",
        "step_device_events.train", "flash_attn_roofline.train",
        "flash_attn_device_share.train", "epoch_gap_ms.train")}
    assert read["train_mfu"] == pytest.approx(100 * 1e6 * 10 / 1e-6 / 1e12)
    assert read["step_device_ms.train"] == pytest.approx(190e-6)
    assert read["step_device_events.train"] == 2
    assert read["flash_attn_device_share.train"] == pytest.approx(100 * 100 / 190)
    bound = spec.kernel_bounds()["flash_fwd_wg_kernel"].bound_s(ctx.sites[0], ["64", "true", "1"],
                                                                ctx.peaks)
    assert read["flash_attn_roofline.train"] == pytest.approx(100 * bound / 100e-9)
    assert read["epoch_gap_ms.train"] == pytest.approx(100 / 1e6)


def test_the_roofline_shares_launches_among_sites():
    """Two sites that launch the same kernel: its launches split as their
    forward launches a step do (here 3 to 1)."""
    long = dict(SITE, Lq=4097, Lk=4097, valid_keys=8 * 4097, launches={"fwd": 1, "bwd": 0})
    short = dict(SITE, launches={"fwd": 3, "bwd": 0})
    kernels = spec.kernel_bounds()
    peaks = spec.peaks("NVIDIA H100 80GB HBM3")
    ctx = SimpleNamespace(trace=reduced(), kernels=kernels, peaks=peaks, sites=[short, long])
    wg = kernels["flash_fwd_wg_kernel"]
    want = (0.75 * wg.bound_s(short, ["64", "true", "1"], peaks)
            + 0.25 * wg.bound_s(long, ["64", "true", "1"], peaks))
    got = spec.metric_reader("flash_attn_roofline.train").read(ctx)
    assert got == pytest.approx(100 * want / 100e-9)


def test_a_reader_with_nothing_to_read_returns_none():
    events = [e for e in EVENTS if e.name() != FLASH]
    ctx = SimpleNamespace(trace=reduce_events(events, first_epoch("perfbench.on_epoch_end")),
                          kernels=spec.kernel_bounds(), sites=[])
    assert spec.metric_reader("flash_attn_roofline.train").read(ctx) is None
    assert spec.metric_reader("flash_attn_device_share.train").read(ctx) is None


def test_the_breakdown_names_the_host_in_each_gap():
    b = reduced().breakdown()
    assert b["device_ops"][0] == [FLASH, pytest.approx(100e-9)]
    assert all(len(row) == 2 for row in b["idle_gaps"])
