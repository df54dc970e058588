"""Readings for the correctness limits of a training cell, on the card.

    python3 perfbench/calibrate.py --workload <name> --seeds 1 2 3 ... [--out FILE]

For each seed, in one process (the kernels build once): the cell's set-up
up to its check (no warm-up epoch, no window), the program's readings of
its first three steps, then the numbers of `check.py` for each side put in
the program's place: the program; the control, the reference computed in
the precision below the configuration's (`check.CONTROL`: TF32 products
for an f32 configuration, fp8 for a bf16 one); and the reference with a
fault planted (`wgan_step.FAULTS`: each update's means over half of the
batch; the critic's updates alone over half of it; the critic's loss
without the penalty; without the drift term). A state, a net or an EMA left unchanged
reads 1 on the move and EMA gaps by their construction and needs no run.
Prints one JSON line per seed: each side's numbers, each number's worst
per step, and the parameters of the worst. The limits in
`limits/<workload>.json` are set from these readings: above the largest
program reading and below the smallest that a control or fault gives
(`PERF.md` gives them). The benchmark's own runs do not run this.
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

from perfbench.reference.wgan_step import FAULTS  # noqa: E402  (after the path is set)


def readings(cell, seed: int, device, faults=FAULTS) -> dict:
    """{side: numbers, side + "_steps": {number: worst per step}, side +
    "_top": {number: the three worst parameters of its worst step}}."""
    from perfbench import check
    from perfbench.train_cell import TrainCell

    tc = TrainCell(cell.config, cell.traffic, seed, device)
    tc.setup(warm=False)
    program = tc.check
    tc.release()
    del tc.check
    args = (cell.config, cell.traffic, tc.weights, tc.check_rows, tc.seeds,
            tc.steps_per_epoch, tc.dtype, device)
    reference = check.reference_readings(*args, steps=1)
    control = check.CONTROL[cell.config["model"]["compute_dtype"]]
    sides = {"program": lambda: program,
             "control": lambda: check.reference_readings(*args, precision=control)}
    for fault in faults:
        sides[fault] = lambda fault=fault: check.reference_readings(*args, fault=fault)
    out = {"seed": seed, "check_step_s": tc.check_step_s}
    for name, side in sides.items():
        side = side()  # one side's state at a time on the host
        stage = check.stages(*args[:2], side["snapshots"], *args[3:])
        g = check.gaps(side, reference, stage, cell.config["train"]["ema_decay"])
        out[name] = check.numbers(g)
        out[name + "_steps"] = {k: check.worst(v) for k, v in g.items()}
        out[name + "_top"] = {
            k: sorted(max(v, key=lambda d: max(d.values())).items(), key=lambda kv: -kv[1])[:3]
            for k, v in g.items()}
        del side, stage
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    ap.add_argument("--faults", nargs="*", default=FAULTS, choices=FAULTS,
                    help="the reference's planted faults to read (default: all)")
    args = ap.parse_args(argv)

    import torch

    from perfbench import spec

    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    lines = []
    for seed in args.seeds:
        lines.append(readings(cell, seed, torch.device("cuda", 0), args.faults))
        line = json.dumps(lines[-1])
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    sides = [k for k in lines[0] if isinstance(lines[0][k], dict)
             and not k.endswith(("_steps", "_top"))]
    summary = {side: {k: (max if side == "program" else min)(r[side][k] for r in lines)
                      for k in lines[0]["program"]} for side in sides}
    print(json.dumps({"seeds": args.seeds, "program_max": summary.pop("program"),
                      **{f"{side}_min": v for side, v in summary.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
