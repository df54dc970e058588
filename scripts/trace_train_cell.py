"""One benchmark training cell with the port's tracer on: what it reads, and
what it costs.

    python3 scripts/trace_train_cell.py --workload film_xattn_bf16.train_cohort \
        --seed 4100000001 [--seconds 40] [--pairs 6] [--profile 1]

Runs on one CUDA card, in one process, `perfbench/train_cell.py`'s cell
(its bank, weights, check steps and warm-up epoch) with
`gemm_gan_tpu_torch.utils.metrics.TRACER` on from the start:

1. set-up: the seconds inside `graph.capture` spans (the check's graph and
   the window's) against the set-up's;
2. the window, as many epochs as fit in `--seconds` (as the benchmark's):
   the tracer's summary (each stage's ms in each epoch's last replay, the
   replays' idle share and idle by host span) and the rate on the host's
   clock;
3. `--pairs N`: the tracer's cost: a second cache over the same bank whose
   graph is captured with the tracer off, then N pairs of epochs, one on
   each cache (the tracer off for the second cache's, on for the first's),
   which goes first alternating; each epoch's steps a second on the host's
   clock, ending in a synchronise;
4. `--profile 1`: the benchmark's traced epochs (`perfbench/trace.py`: two
   epochs of a 32-step cache under `torch.profiler`) with the tracer on:
   the trace's device ms a step (as `step_device_ms.train` reads it) beside
   the stages' sum, the profiler's idle share beside the tracer's, and each
   span's start and end against its `record_function` record.

Prints the window's table on standard error and one JSON line on
standard output. Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
os.environ.setdefault("OMP_NUM_THREADS", "1")

ON_EPOCH_END = "perfbench.on_epoch_end"


def _epoch(tc, cache, epoch: int) -> float:
    """Steps a second of one epoch of `cache` on the host's clock."""
    tc._sync()
    t0 = time.perf_counter()
    tc.state = tc.engine.fit(tc.state, epochs=epoch + 1, scan_cache=cache, start_epoch=epoch)
    tc._sync()
    return len(cache) / (time.perf_counter() - t0)


def _cost(tc, pairs: int, tracer) -> dict:
    """Epochs with the tracer on (the window's cache, its graph captured
    with the tracer on) and off (a second cache, captured off), in turns."""
    from perfbench.train_cell import SEED_CACHE

    off_cache = tc._cache(tc.bank, tc.seeds[SEED_CACHE] + 1)
    tracer.disable()
    _epoch(tc, off_cache, 0)  # captures its graph
    rates = {"on": [], "off": []}
    for i in range(pairs):
        for side in (("off", "on") if i % 2 == 0 else ("on", "off")):
            if side == "on":
                tracer.enable()
                rates["on"].append(_epoch(tc, tc.cache, 1))
                tracer.disable()
            else:
                rates["off"].append(_epoch(tc, off_cache, 1))
    med = {k: statistics.median(v) for k, v in rates.items()}
    return {"steps_per_s": rates, "median": med,
            "cost_pct": 100.0 * (med["off"] - med["on"]) / med["off"],
            "on_slower_in_pairs": sum(a < b for a, b in zip(rates["on"], rates["off"]))}


def _profile(tc, cell, tracer) -> dict:
    import torch

    from perfbench.trace import DeviceTrace, first_epoch

    def on_epoch_end(engine, state, epoch):
        with torch.profiler.record_function(ON_EPOCH_END):
            pass

    tracer.enable()
    tc.prepare_trace(cell.traffic["trace_steps_per_epoch"])
    tracer.reset()
    with DeviceTrace(tc.device, first_epoch(ON_EPOCH_END)) as traced:
        steps = tc.traced_epochs(on_epoch_end)["steps_per_epoch"]
    s = tracer.summary()
    red = traced.reduced
    by_name = {}
    for name, start, end in red.host:
        by_name.setdefault(name, []).append((start, end))
    seen, dist = {}, []
    for name, _, start, end in tracer.spans:
        k = seen.get(name, 0)
        seen[name] = k + 1
        rec = by_name.get(name, [])
        if k < len(rec):
            dist.append((abs(start - rec[k][0]) / 1e3, abs(end - rec[k][1]) / 1e3))
    step_ms = 1e3 * sum(v for v, _ in red.by_name.values()) / steps
    top = sorted(red.by_name.items(), key=lambda kv: -kv[1][0])[:3]
    return {"step_device_ms": step_ms, "records": len(red.device), "window_s": red.window_s,
            "replay_device_ms": s.get("replays", {}).get("device_ms"),
            "top": [[n[:60], sec, count] for n, (sec, count) in top],
            "stage_ms": s.get("stage_ms"),
            "stage_sum_ms": sum(s.get("stage_ms", {}).values()),
            "tracer_idle_share": s.get("replay_idle_share"),
            "profiler_idle_share": 100.0 * (1 - red.busy_s / red.window_s),
            "spans_matched": len(dist), "spans": len(tracer.spans),
            "start_us": {"median": statistics.median(d[0] for d in dist),
                         "max": max(d[0] for d in dist)} if dist else None,
            "end_us": {"median": statistics.median(d[1] for d in dist),
                       "max": max(d[1] for d in dist)} if dist else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--pairs", type=int, default=0)
    ap.add_argument("--profile", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from gemm_gan_tpu_torch.utils.metrics import TRACER, format_tracer_table
    from perfbench import spec
    from perfbench.host import smi
    from perfbench.train_cell import TrainCell

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    cell = spec.load_cell(args.workload)
    out = {"workload": args.workload, "seed": args.seed,
           "card": f"{torch.cuda.get_device_name(device)}, {smi(device, 'power.limit')}"}
    TRACER.reset()
    TRACER.enable()
    t0 = time.perf_counter()
    tc = TrainCell(cell.config, cell.traffic, args.seed, device)
    tc.setup()
    out["setup_s"] = time.perf_counter() - t0
    out["setup_phases"] = tc.phases
    out["setup"] = TRACER.summary()
    TRACER.reset()
    n = tc.window_epochs(args.seconds)
    window = tc.window(n)
    out["window"] = {"epochs": n, "steps_per_s": window["steps"] / window["seconds"],
                     "tracer": TRACER.summary()}
    print(format_tracer_table(out["window"]["tracer"]), file=sys.stderr)
    if args.pairs:
        out["cost"] = _cost(tc, args.pairs, TRACER)
    if args.profile:
        out["profile"] = _profile(tc, cell, TRACER)
    TRACER.disable()
    tc.release()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
