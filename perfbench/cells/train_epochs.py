"""A training cell (`kind` "train_epochs"): closed-loop epochs of the port's
WGAN-GP engine over a `DeviceCache` bank (`train_cell.py`), checked against
the plain reference (`check.py`).

With `--trace 0` the result's metrics are the cell's end-to-end ones:
`train_steps_per_s` (the window's steps over its seconds on the host's
clock, ending in a synchronise) and `setup_s` (the bank, the weights, the
engine, the check's three steps and the warm-up epoch, which captures the
CUDA graph). With `--trace 1` the same window runs, then `torch.profiler`
traces epochs of a cache over the bank's first cases (`trace.py`), and the
metrics are the cell's per-layer ones (`metrics/`), with the traced
epoch's `busy_s` and `window_s` and a `breakdown` of the trace.
"""

from __future__ import annotations

import resource
import time

import torch

from perfbench import check, spec
from perfbench.host import CARD_STATE, log, smi
from perfbench.trace import DeviceTrace, first_epoch
from perfbench.train_cell import TrainCell

ON_EPOCH_END = "perfbench.on_epoch_end"


class Context:
    """What a per-layer reader gets (`metrics/__init__.py`)."""

    def __init__(self, cell, reduced, trace_steps: int, window: dict, device_kind: str):
        flops = spec.architecture_flops(cell.config["architecture"])
        self.trace, self.trace_steps = reduced, trace_steps
        self.window_steps, self.window_s = window["steps"], window["seconds"]
        self.step_flops = flops.train_step_flops(cell.config, cell.traffic)
        self.peaks = spec.peaks(device_kind)
        self.peak_flops = self.peaks[cell.config["peak"]]
        self.sites = flops.kernel_sites(cell.config, cell.traffic)
        self.kernels = spec.kernel_bounds()


def run(cell, seed: int, seconds: float, trace: bool, device, wrap=None) -> dict:
    """One run of the cell on `device`; the result's dict (its `check`
    last). `wrap(engine)` may replace the engine's methods (the tests'
    faults)."""
    t0 = time.perf_counter()
    tc = TrainCell(cell.config, cell.traffic, seed, device)
    tc.setup(wrap)
    setup_s = time.perf_counter() - t0

    def on_epoch_end(engine, state, epoch):
        # the benchmark's span at each epoch's end, for `epoch_gap_ms.train`
        with torch.profiler.record_function(ON_EPOCH_END):
            pass

    n_epochs = tc.window_epochs(seconds)
    log(f"set-up {setup_s:.3f} s ({', '.join(f'{k} {v:.3f} s' for k, v in tc.phases.items())}; "
        f"check steps {', '.join(f'{s:.3f}' for s in tc.check_step_s)} s); "
        f"window of {n_epochs} epoch(s)")
    cuda = torch.device(device).type == "cuda"
    before = smi(torch.device(device), CARD_STATE) if cuda else "cpu"
    window = tc.window(n_epochs, on_epoch_end)
    after = smi(torch.device(device), CARD_STATE) if cuda else "cpu"
    log(f"window {window['seconds']:.3f} s, {window['steps']} steps; card ({CARD_STATE}) "
        f"before: {before}; after: {after}")
    traced = None
    if trace:
        # after the window, a traced one of its own: the first of two
        # epochs of a cache over the same bank's first cases (a whole
        # epoch of the cell's traffic holds millions of device records,
        # more than the profiler reads in a run's time); the boundary
        # between the two gives the epoch gap
        tc.prepare_trace(cell.traffic["trace_steps_per_epoch"])
        with DeviceTrace(device, first_epoch(ON_EPOCH_END)) as traced:
            traced_steps = tc.traced_epochs(on_epoch_end)["steps_per_epoch"]
        log(f"trace: {len(traced.reduced.everything)} device records, "
            f"{traced.reduced.sentinels_kept} sentinels kept, read in {traced.read_s:.3f} s")
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1,
           "memory_peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else 0}
    program = tc.check
    tc.release()
    t1 = time.perf_counter()

    if trace:
        ctx = Context(cell, traced.reduced, traced_steps, window, dev["kind"])
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"], dev["window_s"] = traced.reduced.busy_s, traced.reduced.window_s
    else:
        values = {"train_steps_per_s": window["steps"] / window["seconds"], "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    if cuda:
        dev["power_limit"] = smi(torch.device(device), "power.limit")

    args = (cell.config, cell.traffic, tc.weights, tc.check_rows, tc.seeds,
            tc.steps_per_epoch, tc.dtype, device)
    reference = check.reference_readings(*args, steps=1)
    stage = check.stages(*args[:2], program["snapshots"], *args[3:])
    numbers = check.compare(program, reference, stage, cell.config["train"]["ema_decay"])
    log(f"reference {time.perf_counter() - t1:.3f} s; host peak RSS "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB")
    result = {"correct": check.verdict(numbers, cell.limits),
              "attempted": window["steps"], "failed": window["failed"],
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = traced.reduced.breakdown()
    for k in check.NUMBERS:
        if k not in check.compared(cell.limits):
            log(f"{k} {numbers[k]!r} (reported, not compared)")
    result["check"] = {k: {"value": numbers[k], "limit": cell.limits[k]["limit"]}
                       for k in check.compared(cell.limits)}
    return result
