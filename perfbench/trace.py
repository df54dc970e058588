"""The benchmark's reading of a device trace.

`DeviceTrace` profiles a
window with `torch.profiler` (CUDA activity, host operators and the
benchmark's spans), opening it with sentinel kernels (the profiler has been
seen to drop a window's first device records; the sentinels absorb that),
and reduces the records to what the per-layer readers need: the device
records inside the window (kernels, copies, sets), the union of their
intervals (`busy_s`), the window's length, the sums by name, the idle gaps
and what the host was doing in each.

Only the raw records are read (`kineto_results.events()`); the profiler's
own tables (`key_averages`) build an object per record, which over a window
of thousands of graph replays costs more than the window.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

SENTINELS = 64             # kernels that open a traced window
SENTINEL_CYCLES = 200_000  # each spins about 0.1 ms on an H100
SENTINEL_NAME = "spin_kernel"  # the name of torch.cuda._sleep's kernel
GAP_MIN_NS = 20_000        # an idle gap shorter than this is not listed


def _idle(records: List[Tuple[str, int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    """Idle intervals of the device within [lo, hi], given its records
    sorted by start."""
    out, end = [], lo
    for _, a, b in records:
        if b <= lo or a >= hi:
            continue
        if a > end:
            out.append((end, a))
        end = max(end, b)
    if hi > end:
        out.append((end, hi))
    return out


@dataclass
class Reduced:
    """A trace's device records and host records after its sentinels (ns on
    the trace's clock), and its window: the interval that `busy_s`,
    `window_s`, `by_name` and `device` describe."""
    window: Tuple[int, int]
    everything: List[Tuple[str, int, int]]   # (name, start, end), sorted by start
    host: List[Tuple[str, int, int]]         # host operators and spans
    sentinels_kept: int

    def __post_init__(self):
        a, b = self.window
        self.device = [r for r in self.everything if r[1] >= a and r[2] <= b]
        by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
        for n, s, e in self.device:
            by_name[n][0] += (e - s) / 1e9
            by_name[n][1] += 1
        self.by_name = {k: (v[0], v[1]) for k, v in by_name.items()}

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return self.window_s - sum(b - a for a, b in self.gaps()) / 1e9

    def gaps(self) -> List[Tuple[int, int]]:
        """Idle intervals of the device inside the window."""
        return _idle(self.device, *self.window)

    def idle_ns(self, lo: int, hi: int) -> int:
        """The device's idle time within [lo, hi], from every record."""
        return sum(b - a for a, b in _idle(self.everything, lo, hi))

    def host_at(self, a: int, b: int) -> str:
        """The host record that overlaps [a, b] most (the benchmark's spans
        and the host's operators)."""
        best, name = 0, "no host record"
        for n, s, e in self.host:
            overlap = min(b, e) - max(a, s)
            if overlap > best:
                best, name = overlap, n
        return name

    def breakdown(self, top: int = 10) -> dict:
        """The window's device operations that took most time, and the
        longest idle gaps of the whole trace after its sentinels (epoch
        boundaries too) by what the host was doing."""
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:top]
        lo = self.everything[0][1]
        hi = max(r[2] for r in self.everything)
        gaps = sorted(_idle(self.everything, lo, hi), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, s] for n, (s, _) in ops],
                "idle_gaps": [[self.host_at(a, b), (b - a) / 1e9] for a, b in gaps
                              if b - a >= GAP_MIN_NS]}


class DeviceTrace:
    """`with DeviceTrace(device, window) as trace:` profiles the block;
    `trace.reduced` holds the reduction afterwards, its window chosen by
    `window(device records, host records)` -> (start, end)."""

    def __init__(self, device, window):
        self.device = torch.device(device)
        self.window = window
        self.reduced: Optional[Reduced] = None

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        torch.cuda.synchronize(self.device)
        self.prof.start()
        for _ in range(SENTINELS):
            torch.cuda._sleep(SENTINEL_CYCLES)
        torch.cuda.synchronize(self.device)
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        self.prof.stop()
        if exc[0] is None:
            self.reduced = reduce_events(self.prof.profiler.kineto_results.events(),
                                         self.window)
        self.read_s = time.perf_counter() - t0
        return False


def reduce_events(events, window) -> Reduced:
    """The records after the last sentinel kernel; `window(device, host)`
    gives the interval of interest."""
    from torch.autograd import DeviceType

    device, host, sentinel_end, kept = [], [], None, 0
    names: Dict[str, str] = {}  # one string per distinct name
    for e in events:
        name, start = e.name(), e.start_ns()
        name = names.setdefault(name, name)
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if SENTINEL_NAME in name:
                kept += 1
                sentinel_end = end if sentinel_end is None else max(sentinel_end, end)
            else:
                device.append((name, start, end))
        else:
            host.append((name, start, end))
    if sentinel_end is None:
        raise RuntimeError("the trace kept none of the window's sentinel kernels")
    device = sorted((r for r in device if r[1] >= sentinel_end), key=lambda r: r[1])
    host = sorted((h for h in host if h[2] >= sentinel_end), key=lambda r: r[1])
    if not device:
        raise RuntimeError("the trace holds no device record after its sentinels")
    return Reduced(window(device, host), device, host, kept)


def first_epoch(span: str):
    """A `window` for `DeviceTrace`: the first traced epoch's replays, from
    the first device record launched by a CUDA graph replay
    (`cudaGraphLaunch`) to the end of the last device record that started
    before the first `span` (the epoch's end)."""
    def window(device, host):
        launch = next(s for n, s, _ in host if n.startswith("cudaGraphLaunch"))
        end_span = next(s for n, s, _ in host if n == span)
        start = next(a for _, a, _ in device if a >= launch)
        return start, max(b for _, a, b in device if a < end_span)
    return window
