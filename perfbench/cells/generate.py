"""A generate cell (`kind` "generate"): offline sampling of a synthetic
cohort by the port's sampling entry, one call a pass over the bank
(`generate_cell.py`), checked against the plain reference
(`generate_check.py`).

With `--trace 0` the result's metrics are the cell's end-to-end ones:
`infer_samples_per_s` (the samples that have landed where the caller
receives them at the window's end, over its seconds on the host's clock:
a sample is one input of the offline job, here one generated profile;
each call's graph capture is inside the window) and `setup_s` (the bank,
the weights, the engine and two warm-up calls). With `--trace 1` the same
window runs, then `torch.profiler` traces one more call (a pass), each
batch inside the benchmark's span `perfbench.generate.batch`, and the
metrics are the cell's per-layer ones (`metrics/`), with the traced
pass's `busy_s` and `window_s` and a `breakdown` of the trace.

The FLOPs of a batch and the attentions of the flash kernels come from
`flops/<architecture>_generate.py` (`generate_batch_flops`,
`generate_kernel_sites`).
"""

from __future__ import annotations

import resource
import time

import torch

from perfbench import generate_check, spec
from perfbench.generate_cell import GenerateCell
from perfbench.host import CARD_STATE, log, smi
from perfbench.trace import DeviceTrace, Reduced

SPAN = "perfbench.generate.batch"


def spanned(span: str):
    """A `window` for `DeviceTrace`: the traced pass, from the first device
    record that starts after the first `span` opens to the end of the last
    device record (the pass ends in a synchronise). The profiler mirrors
    each `span` on the device's timeline; those copies are no device work
    and are passed over (`without`)."""
    def window(device, host):
        first = next(s for n, s, _ in host if n == span)
        work = [r for r in device if r[0] != span]
        return next(a for _, a, _ in work if a >= first), max(b for _, _, b in work)
    return window


def without(reduced: Reduced, span: str) -> Reduced:
    """`reduced` without the device timeline's copies of the host span
    `span`, so that busy time, sums by name and the breakdown count only
    device work."""
    return Reduced(reduced.window, [r for r in reduced.everything if r[0] != span],
                   reduced.host, reduced.sentinels_kept)


class Context:
    """What a per-layer reader of a generate cell gets (`metrics/`):

    * `trace`: the traced pass's reduction (`trace.Reduced`);
    * `trace_batches`: the batches of the traced pass;
    * `window_batches`, `window_s`: the run's untraced window, its
      batches and its seconds on the host's clock;
    * `batch_flops`: one batch's FLOPs (`generate_batch_flops`);
    * `peak_flops`, `peaks`: the configuration's peak, the card's row of
      `peaks.json`;
    * `sites`: the attentions routed to the flash kernels
      (`generate_kernel_sites`), each with its `launches` a batch;
    * `kernels`: {kernel name: bound module} of `kernels/`."""

    def __init__(self, cell, reduced, trace_batches: int, window: dict, device_kind: str):
        flops = spec.architecture_flops(cell.config["architecture"] + "_generate")
        self.trace, self.trace_batches = reduced, trace_batches
        self.window_batches, self.window_s = window["batches"], window["seconds"]
        self.batch_flops = flops.generate_batch_flops(cell.config, cell.traffic)
        self.peaks = spec.peaks(device_kind)
        self.peak_flops = self.peaks[cell.config["peak"]]
        self.sites = flops.generate_kernel_sites(cell.config, cell.traffic)
        self.kernels = spec.kernel_bounds()


def run(cell, seed: int, seconds: float, trace: bool, device, wrap=None) -> dict:
    """One run of the cell on `device`; the result's dict (its `check`
    last). `wrap(server)` may replace the methods of each server the
    engine makes (the tests' faults)."""
    t0 = time.perf_counter()
    gcell = GenerateCell(cell.config, cell.traffic, seed, device)
    gcell.setup(wrap)
    setup_s = time.perf_counter() - t0
    n_calls = gcell.window_calls(seconds)
    phases = ", ".join(f"{k} {v:.3f} s" for k, v in gcell.phases.items())
    log(f"set-up {setup_s:.3f} s ({phases}); window of {n_calls} call(s)")
    cuda = torch.device(device).type == "cuda"
    before = smi(torch.device(device), CARD_STATE) if cuda else "cpu"
    window = gcell.window(n_calls)
    after = smi(torch.device(device), CARD_STATE) if cuda else "cpu"
    log(f"window {window['seconds']:.3f} s, {window['samples']} samples in "
        f"{window['batches']} batches; card ({CARD_STATE}) before: {before}; after: {after}")
    traced = None
    if trace:
        with DeviceTrace(device, spanned(SPAN)) as traced:
            traced_batches = gcell.traced_call(SPAN)
        reduced = without(traced.reduced, SPAN)
        log(f"trace: {len(reduced.everything)} device records, "
            f"{reduced.sentinels_kept} sentinels kept, read in {traced.read_s:.3f} s")
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1,
           "memory_peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else 0}
    picks = sorted(window["kept"])
    inputs = gcell.check_inputs(picks)
    gcell.release()
    t1 = time.perf_counter()

    if trace:
        ctx = Context(cell, reduced, traced_batches, window, dev["kind"])
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"], dev["window_s"] = reduced.busy_s, reduced.window_s
    else:
        values = {"infer_samples_per_s": window["samples"] / window["seconds"],
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    if cuda:
        dev["power_limit"] = smi(torch.device(device), "power.limit")

    reference = generate_check.reference_profiles(cell.config, inputs, picks,
                                                  cell.traffic["cases"], device)
    numbers = generate_check.numbers(window["kept"], reference)
    log(f"reference {time.perf_counter() - t1:.3f} s over batches {picks} (call, batch); "
        f"host peak RSS {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB")
    result = {"correct": generate_check.verdict(numbers, cell.limits),
              "attempted": window["samples"] + window["failed"], "failed": window["failed"],
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = reduced.breakdown()
    compared = generate_check.compared(cell.limits)
    for k in generate_check.NUMBERS:
        if k not in compared:
            log(f"{k} {numbers[k]!r} (reported, not compared)")
    result["check"] = {k: {"value": numbers[k], "limit": cell.limits[k]["limit"]}
                       for k in compared}
    return result
