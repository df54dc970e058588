"""Training observability: scalar logging and profiler hooks.

Counterpart of `gemm_gan_tpu/utils/metrics.py`: `MetricLogger` (the same
`{run_name}_metrics.jsonl` records), `trace_annotation` over
`torch.profiler.record_function`, `profile_to` and `EpochProfileWindow` over
`torch.profiler` (Chrome traces written into the log dir), and
`aggregate_device_trace` / `format_device_table`, which sum a trace's
events by category and by name: the device's kernels and copies when the
trace holds any, else the host's operators (a CPU run).
"""

from __future__ import annotations

import glob
import json
import os
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Optional

import numpy as np
import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _scalar(v) -> float:
    return float(v) if isinstance(v, torch.Tensor) else float(np.asarray(v))


class MetricLogger:
    def __init__(self, out_dir: Optional[str] = None, run_name: str = "run"):
        self.out_dir = out_dir
        self.run_name = run_name
        self.history: Dict[str, list] = defaultdict(list)
        self._file = None
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            self._file = open(os.path.join(out_dir, f"{run_name}_metrics.jsonl"), "a")
        self._t0 = time.perf_counter()
        self._steps_at_t0 = 0
        self._steps = 0

    def log(self, step: int, **scalars):
        rec = {"step": int(step), "time": time.perf_counter() - self._t0}
        for k, v in scalars.items():
            v = _scalar(v)
            self.history[k].append((int(step), v))
            rec[k] = v
        if self._file:
            self._file.write(json.dumps(rec) + "\n")
            self._file.flush()
        self._steps = step

    def steps_per_sec(self) -> float:
        dt = time.perf_counter() - self._t0
        ds = self._steps - self._steps_at_t0
        return ds / dt if dt > 0 else 0.0

    def reset_rate(self):
        self._t0 = time.perf_counter()
        self._steps_at_t0 = self._steps

    def curve(self, key: str):
        xs = self.history.get(key, [])
        return [s for s, _ in xs], [v for _, v in xs]

    def close(self):
        if self._file:
            self._file.close()
            self._file = None


@contextmanager
def trace_annotation(name: str):
    """A named range in a `torch.profiler` trace."""
    with torch.profiler.record_function(name):
        yield


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _export(prof, log_dir: str) -> str:
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


@contextmanager
def profile_to(log_dir: str):
    """Capture a profiler trace of the enclosed block into `log_dir`."""
    prof = torch.profiler.profile(activities=_activities())
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        _export(prof, log_dir)


def aggregate_device_trace(log_dir: str):
    """Sum the newest trace under `log_dir` into where-does-the-time-go
    tables: `by_category` and `by_op`, each mapping a key to [total_us,
    count], over the device's events (`DEVICE_CATEGORIES`) when the trace
    holds any, else over the host's operators; `device_us` (the device
    events' total, 0 without any) and `trace_path`."""
    paths = sorted(glob.glob(os.path.join(log_dir, "*.json")), key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no trace .json found under {log_dir}")
    with open(paths[-1]) as f:
        events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    rows = device or [e for e in events if e.get("cat") == "cpu_op"]
    out = {"by_category": defaultdict(lambda: [0.0, 0]),
           "by_op": defaultdict(lambda: [0.0, 0]),
           "device_us": sum(float(e.get("dur", 0.0)) for e in device),
           "trace_path": paths[-1]}
    for e in rows:
        dur = float(e.get("dur", 0.0))
        for agg, key in ((out["by_category"], e.get("cat", "?")),
                         (out["by_op"], e.get("name", "?"))):
            agg[key][0] += dur
            agg[key][1] += 1
    return out


def format_device_table(agg: dict, title: str, topk: int = 20, per: float = 1.0) -> str:
    """One aggregate (e.g. `by_op`) as a text table; `per` divides the
    times (e.g. the number of traced steps -> ms per step)."""
    lines = [f"-- {title} {'':<36}{'ms':>9}{'count':>8}"]
    rows = sorted(agg.items(), key=lambda kv: -kv[1][0])
    for name, (us, cnt) in rows[:topk]:
        lines.append(f"{str(name)[:44]:<48}{us / 1e3 / per:>9.3f}{cnt:>8}")
    rest = sum(v[0] for _, v in rows[topk:])
    if rest:
        lines.append(f"{'(rest)':<48}{rest / 1e3 / per:>9.3f}")
    return "\n".join(lines)


class EpochProfileWindow:
    """Steady-state `torch.profiler` capture over training epochs.

    Opens the trace after the FIRST epoch seen (that epoch's builds and
    graph capture are excluded) and closes it `n_epochs` (min 1) epochs
    later, writing the trace into `log_dir`. Call `on_epoch_end(e)` from the
    epoch callback and `close()` in a finally block. A no-op when `log_dir`
    is None. Needs >= 2 epochs to capture anything."""

    def __init__(self, log_dir: Optional[str], n_epochs: int = 1):
        self.log_dir = log_dir
        self.n_epochs = max(1, int(n_epochs))
        self._first = None
        self._prof = None

    def on_epoch_end(self, epoch: int):
        if self.log_dir is None:
            return
        if self._first is None:
            self._first = epoch
            self._prof = torch.profiler.profile(activities=_activities())
            self._prof.start()
        elif self._prof is not None and epoch >= self._first + self.n_epochs:
            self.close()

    def close(self):
        if self._prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._prof.stop()
            self.trace_path = _export(self._prof, self.log_dir)
            self._prof = None

    @property
    def captured(self) -> bool:
        """True once a window has been opened AND closed around >=1 epoch."""
        return self._first is not None and self._prof is None
