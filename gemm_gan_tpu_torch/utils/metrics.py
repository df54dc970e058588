"""Training observability: scalar logging, the port's tracer and profiler
hooks.

Counterpart of `gemm_gan_tpu/utils/metrics.py`: `MetricLogger` (the same
`{run_name}_metrics.jsonl` records), `EpochProfileWindow` over
`torch.profiler` (Chrome traces written into the log dir), and
`aggregate_device_trace` / `format_device_table`, which sum a trace's
events by category and by name: the device's kernels and copies when the
trace holds any, else the host's operators (a CPU run).

`TRACER` (a `Tracer`, off by default) measures the training loop from
inside (`train/wgan.py`):

* spans: `fit.epoch` with its children `fit.epoch_spec`, `fit.feed`,
  `fit.replays`, `fit.sync`, `tracer.read`, `fit.log`, `fit.on_epoch_end`;
  `graph.capture` with `graph.eager_step` and `graph.record`. Each is
  stamped on the clock of `torch.profiler`'s host records (Unix ns) and
  entered as a `record_function` of the same name, so a profiler trace
  shows it too;
* counters: `replays`, `captures`, `epochs`, `clip_norms` (the calls of
  `train/schedules.py`'s multi-tensor global-norm clip);
* each CUDA graph replay's device interval, from a timing event before and
  after it, put on the span clock at the next `Tracer.read` (an anchor
  event stamped on an idle stream), so the device's idle time between
  replays is known without a profiler and is given to the host span that
  was running;
* a step's stages (`STAGES`), marked by `Tracer.stage` inside the step's
  body: on the card with events that a graph capture turns into nodes, in
  a second graph of the step that replays as each run's last step, so
  each run stamps them again; on the CPU with host stamps.

Off, `span` returns one shared no-op and every other call returns at
once: no event is made, and a graph captured while it is off holds no
event node.
"""

from __future__ import annotations

import bisect
import glob
import json
import os
import statistics
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# a step's stages, in the order a step runs them (each summed over the
# step's critic updates and microbatches)
STAGES = ("gather", "embed", "critic_forward", "critic_backward", "generator", "optimizer")
SPAN_CLOCK = time.time_ns  # the clock of torch.profiler's host records


def _scalar(v) -> float:
    return float(v) if isinstance(v, torch.Tensor) else float(np.asarray(v))


class MetricLogger:
    def __init__(self, out_dir: Optional[str] = None, run_name: str = "run"):
        self.out_dir = out_dir
        self.run_name = run_name
        self._file = None
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            self._file = open(os.path.join(out_dir, f"{run_name}_metrics.jsonl"), "a")
        self._t0 = time.perf_counter()

    def log(self, step: int, **scalars):
        rec = {"step": int(step), "time": time.perf_counter() - self._t0}
        for k, v in scalars.items():
            rec[k] = _scalar(v)
        if self._file:
            self._file.write(json.dumps(rec) + "\n")
            self._file.flush()

    def close(self):
        if self._file:
            self._file.close()
            self._file = None


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("tracer", "name", "index", "annotation")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        # stamped inside the record_function, so the span lies within its record
        self.annotation = torch.profiler.record_function(self.name)
        self.annotation.__enter__()
        self.index = self.tracer._open(self.name)
        return self

    def __exit__(self, *exc):
        self.tracer._close(self.index)
        self.annotation.__exit__(*exc)
        return False


class StageMarks:
    """The stage boundaries of one step: `begin` at its start, `mark(name)`
    where stage `name` ends. On the card each boundary records a timing
    event made to be captured (`external`: a capture turns its record into
    a graph node, which every replay stamps again); on the CPU a host
    stamp."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.names: List[str] = []
        self.stamps: list = []

    def begin(self) -> None:
        self.names, self.stamps = [], []
        self.mark("")

    def mark(self, name: str) -> None:
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True, external=True)
            event.record()
        else:
            event = SPAN_CLOCK()
        self.names.append(name)
        self.stamps.append(event)

    def read(self) -> List[Tuple[str, float]]:
        """(stage, ms) of the last step marked (or replayed), in order."""
        s = self.stamps
        ms = ([a.elapsed_time(b) for a, b in zip(s, s[1:])] if self.cuda
              else [(b - a) / 1e6 for a, b in zip(s, s[1:])])
        return list(zip(self.names[1:], ms))


class GraphTiming:
    """What the tracer reads of one step's CUDA graph (or, on the CPU, of
    its body run in a loop): a timing event before and after each replay,
    from a pool grown once to the longest run, and the step's stage marks:
    on the card, in `marked`, a second graph of the same step captured with
    them (None, with `marks`, when the tracer was off at capture), whose
    metrics are `outputs`."""

    def __init__(self, device: torch.device, marks: Optional[StageMarks] = None,
                 marked=None, outputs: Optional[dict] = None):
        self.device = device
        self.marks, self.marked, self.outputs = marks, marked, outputs
        self.events: List[torch.cuda.Event] = []
        self.n = 0          # replays of the last run
        self.span = None    # the host span the last run's replays ran in


class Tracer:
    """See the module's docstring. `enable` and `disable` switch it;
    `reset` drops what it recorded; `summary` reduces it."""

    def __init__(self):
        self.on = False
        self.reset()

    def enable(self) -> None:
        self.on = True

    def disable(self) -> None:
        self.on = False

    def reset(self) -> None:
        self.spans: List[list] = []   # [name, parent index or -1, start ns, end ns or None]
        self._stack: List[int] = []
        self.counters = {"replays": 0, "captures": 0, "epochs": 0, "clip_norms": 0}
        self.runs: List[Tuple[str, np.ndarray]] = []   # (span, [n, 2] replay ns)
        self.steps: List[List[Tuple[str, float]]] = []  # stages of each read's last step
        self._unread: Dict[GraphTiming, None] = {}
        self._marks: Optional[StageMarks] = None

    # ------------------------------------------------------------ host
    def span(self, name: str):
        return _Span(self, name) if self.on else NO_SPAN

    def _open(self, name: str) -> int:
        self.spans.append([name, self._stack[-1] if self._stack else -1, SPAN_CLOCK(), None])
        self._stack.append(len(self.spans) - 1)
        return self._stack[-1]

    def _close(self, index: int) -> None:
        self.spans[index][3] = SPAN_CLOCK()
        self._stack.remove(index)

    def count(self, name: str, n: int = 1) -> None:
        if self.on:
            self.counters[name] += n

    # ---------------------------------------------------------- stages
    def stage(self, name: str) -> None:
        """Stage `name` of the step being marked ends here."""
        if self._marks is not None:
            self._marks.mark(name)

    def marking(self, marks: Optional[StageMarks]):
        """Mark the enclosed step's stages into `marks` (nothing if None)."""
        return NO_SPAN if marks is None else self._marking(marks)

    @contextmanager
    def _marking(self, marks: StageMarks):
        self._marks = marks
        marks.begin()
        try:
            yield
        finally:
            self._marks = None

    # ---------------------------------------------------------- device
    def replay(self, graphs: list, timing: GraphTiming) -> None:
        """Replay `graphs` in turn, each between two timing events."""
        n, events = len(graphs), timing.events
        while len(events) < 2 * n:
            events.append(torch.cuda.Event(enable_timing=True))
        for i, graph in enumerate(graphs):
            events[2 * i].record()
            graph.replay()
            events[2 * i + 1].record()
        self.counters["replays"] += n
        self.ran(timing, n)

    def ran(self, timing: GraphTiming, n: int) -> None:
        """`timing`'s graph (or CPU body) ran `n` steps: read at the next
        `read`."""
        timing.n = n
        timing.span = self.spans[self._stack[-1]][0] if self._stack else None
        self._unread.pop(timing, None)  # read in the order the runs ended
        self._unread[timing] = None

    def read(self) -> None:
        """After a synchronisation: put each graph's last run since the
        last read on the span clock and keep its last step's stages."""
        if not self.on or not self._unread:
            return
        with self.span("tracer.read"):
            anchors = {}
            for t in self._unread:
                if t.device.type == "cuda" and t.n:
                    if t.device not in anchors:
                        stream = torch.cuda.current_stream(t.device)
                        stream.synchronize()
                        anchor = torch.cuda.Event(enable_timing=True)
                        at = SPAN_CLOCK()
                        anchor.record(stream)
                        anchor.synchronize()
                        anchors[t.device] = anchor, at
                    anchor, at = anchors[t.device]
                    ms = [e.elapsed_time(anchor) for e in t.events[:2 * t.n]]
                    ns = at - np.round(np.asarray(ms) * 1e6).astype(np.int64)
                    self.runs.append((t.span, ns.reshape(t.n, 2)))
                if t.marks is not None and t.n and t.marks.stamps:
                    self.steps.append(t.marks.read())
            self._unread.clear()

    # --------------------------------------------------------- summary
    def _own_time_at(self, a: int, b: int, children: Dict[int, List[int]],
                     starts: List[int], now: int) -> str:
        """The span whose own time (its interval less its children's)
        overlaps [a, b] most: `perfbench/trace.py`'s `host_at` rule, on
        spans that nest."""
        def overlap(i):
            s, e = self.spans[i][2], self.spans[i][3] or now
            return max(0, min(b, e) - max(a, s))

        best, name = 0, "no span"
        for i in range(bisect.bisect_left(starts, b)):
            own = overlap(i)
            if own > 0:
                own -= sum(overlap(c) for c in children.get(i, ()))
                if own > best:
                    best, name = own, self.spans[i][0]
        return name

    def summary(self) -> dict:
        """What was recorded since the last `reset`:

        * `spans`: {name: {"n", "s"}}, the count and host seconds of each;
        * `counters`;
        * `graph_capture_s`: the seconds inside `graph.capture` spans;
        * `replays`: the replays timed on the device, `interval_s` from the
          first one's start to the last one's end, `device_ms` the median
          replay's device time;
        * `replay_idle_share` (%): the device's idle time between replays
          (runs one after another, across epoch boundaries too) over
          `interval_s`; `idle_ms_by_span`: that idle time by the host span
          that was running (a gap inside a run: the span the run was
          called in; a gap between runs: the span whose own time covers
          most of it);
        * `stage_ms`: {stage: the median over reads of the stage's ms in
          each read's last step}, and `stage_steps` the reads it took."""
        now = SPAN_CLOCK()
        by_name: Dict[str, list] = defaultdict(lambda: [0, 0.0])
        for name, _, s, e in self.spans:
            by_name[name][0] += 1
            by_name[name][1] += ((e or now) - s) / 1e9
        out = {"spans": {k: {"n": n, "s": sec} for k, (n, sec) in by_name.items()},
               "counters": dict(self.counters),
               "graph_capture_s": by_name.get("graph.capture", [0, 0.0])[1]}
        if self.runs:
            children: Dict[int, List[int]] = defaultdict(list)
            for i, sp in enumerate(self.spans):
                if sp[1] >= 0:
                    children[sp[1]].append(i)
            starts = [sp[2] for sp in self.spans]
            idle: Dict[str, float] = defaultdict(float)
            for r, (span, ns) in enumerate(self.runs):
                gaps = np.maximum(ns[1:, 0] - ns[:-1, 1], 0)
                if len(gaps):
                    idle[span or "no span"] += float(gaps.sum()) / 1e6
                if r:
                    a, b = int(self.runs[r - 1][1][-1, 1]), int(ns[0, 0])
                    if b > a:
                        idle[self._own_time_at(a, b, children, starts, now)] += (b - a) / 1e6
            allns = np.concatenate([ns for _, ns in self.runs])
            interval = int(allns[-1, 1] - allns[0, 0])
            out["replays"] = {"n": len(allns), "interval_s": interval / 1e9,
                              "device_ms": float(np.median(allns[:, 1] - allns[:, 0])) / 1e6}
            out["replay_idle_share"] = 100.0 * sum(idle.values()) * 1e6 / max(interval, 1)
            out["idle_ms_by_span"] = dict(sorted(idle.items(), key=lambda kv: -kv[1]))
        if self.steps:
            sums = []
            for step in self.steps:
                d: Dict[str, float] = defaultdict(float)
                for name, ms in step:
                    d[name] += ms
                sums.append(d)
            names = [s for s in STAGES if any(s in d for d in sums)]
            names += sorted({n for d in sums for n in d} - set(names))
            out["stage_ms"] = {n: statistics.median(d.get(n, 0.0) for d in sums)
                               for n in names}
            out["stage_steps"] = len(sums)
        return out


TRACER = Tracer()


def format_tracer_table(summary: dict) -> str:
    """`Tracer.summary` as text: the stages' ms a step, the replays' idle
    share and the idle by host span."""
    lines = []
    stages = summary.get("stage_ms", {})
    if stages:
        lines.append(f"-- step stages (ms a step, the median of {summary['stage_steps']} "
                     f"epochs' last step) {'':<4}{'ms':>9}")
        lines += [f"{name:<48}{ms:>9.3f}" for name, ms in stages.items()]
        lines.append(f"{'(sum)':<48}{sum(stages.values()):>9.3f}")
    if "replays" in summary:
        r = summary["replays"]
        lines.append(f"-- replays: {r['n']}, median {r['device_ms']:.3f} ms on the device; "
                     f"idle {summary['replay_idle_share']:.3f}% of {r['interval_s']:.3f} s")
        lines += [f"{name:<48}{ms:>9.3f}" for name, ms in summary["idle_ms_by_span"].items()]
    lines.append(f"-- graph captures {summary['graph_capture_s']:.3f} s; counters "
                 + ", ".join(f"{k} {v}" for k, v in summary["counters"].items()))
    return "\n".join(lines)


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
