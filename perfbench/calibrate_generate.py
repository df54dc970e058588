"""Readings for the correctness limits of a generate cell, on the card.

    python3 perfbench/calibrate_generate.py --workload <name> --seeds 1 2 3 ... [--out FILE]
        [--benchmark perfbench/held.json]

For each seed, in one process (the kernels build once): the cell's set-up,
a window of `--calls` calls (one by default: the window's first and last
batch and others drawn from the seed, as many as a run compares), then the
numbers of `generate_check.py` for each side put in the program's place:
the program; the control, the reference computed in the precision below
the configuration's (`check.CONTROL`: TF32 products for an f32
configuration, fp8 for a bf16 one); and the reference with a fault planted
(`generate_check.FAULTS`). Prints one JSON line per seed with each side's
numbers, then one line with the program's largest and each other side's
least reading over the seeds. The limits in `limits/<workload>.json` are
set from these readings: above the largest program reading and below the
smallest that the control or a fault gives (`PERF.md` gives them). The
benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
os.environ.setdefault("USE_FLAX", "0")

from perfbench.generate_check import FAULTS  # noqa: E402  (after the path is set)


def readings(cell, seed: int, device, faults=FAULTS, calls: int = 1) -> dict:
    """{side: numbers} of the program, the control and each fault."""
    from perfbench import check, generate_check
    from perfbench.generate_cell import GenerateCell

    gcell = GenerateCell(cell.config, cell.traffic, seed, device)
    gcell.setup()
    window = gcell.window(calls)
    picks = sorted(window["kept"])
    inputs = gcell.check_inputs(picks)
    gcell.release()
    args = (cell.config, inputs, picks, cell.traffic["cases"], device)
    reference = generate_check.reference_profiles(*args)
    control = check.CONTROL[cell.config["model"]["compute_dtype"]]
    sides = {"program": lambda: window["kept"],
             "control": lambda: generate_check.reference_profiles(*args, precision=control)}
    for fault in faults:
        sides[fault] = lambda fault=fault: generate_check.reference_profiles(*args, fault=fault)
    out = {"seed": seed, "picks": picks}
    for name, side in sides.items():
        out[name] = generate_check.numbers(side(), reference)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--calls", type=int, default=1)
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    ap.add_argument("--benchmark", default=None,
                    help="the file that describes the cell (default: BENCHMARK.json; "
                         "perfbench/held.json for a cell held out of it)")
    ap.add_argument("--faults", nargs="*", default=FAULTS, choices=FAULTS,
                    help="the reference's planted faults to read (default: all)")
    args = ap.parse_args(argv)

    import torch

    from perfbench import spec

    if not torch.cuda.is_available():
        print("calibrate_generate.py needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload, args.benchmark)
    lines = []
    for seed in args.seeds:
        lines.append(readings(cell, seed, torch.device("cuda", 0), args.faults, args.calls))
        line = json.dumps(lines[-1])
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    sides = [k for k in lines[0] if isinstance(lines[0][k], dict)]
    summary = {side: {k: (max if side == "program" else min)(r[side][k] for r in lines)
                      for k in lines[0]["program"]} for side in sides}
    print(json.dumps({"seeds": args.seeds, "program_max": summary.pop("program"),
                      **{f"{side}_min": v for side, v in summary.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
