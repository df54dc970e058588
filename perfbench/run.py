"""Run one cell of the port's benchmark once.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, traffic mix, metrics and correctness limits
are found by name from `BENCHMARK.json` at the root of the checkout
(`spec.py`), and so is the code that runs it: the module of its traffic's
`kind`, `cells/<kind>.py`. The program measured is `gemm_gan_tpu_torch` on
CUDA cards; without as many as the cell asks for the run exits 2 and
prints no result.

Every run checks what its timed path produced against the plain
reference, prints each compared number beside its limit as the last lines
of standard error, and prints the result as the last line of standard
output, its `check` key last. A run in whose process JAX, jaxlib, Flax or
the JAX package has been imported exits 3 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# a library that the port imports must not pull in JAX on its own
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, ".perfbench_cache", "triton"))
# one process with few threads: the host's part of a step is launching
# graphs, and idle pool threads on a shared host only add noise
os.environ.setdefault("OMP_NUM_THREADS", "1")

FORBIDDEN = ("jax", "jaxlib", "flax", "gemm_gan_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, jaxlib's, Flax's or
    the JAX package's (compared whole: the port's name begins with the JAX
    package's)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def run_cell(cell, seed: int, seconds: float, trace: bool, device, wrap=None) -> dict:
    """One run of `cell` by the module of its kind (`cells/<kind>.py`)."""
    from perfbench import spec

    return spec.cell_kind(cell.traffic["kind"]).run(cell, seed, seconds, trace, device, wrap)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench import spec

    torch.set_num_threads(1)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    leaked = forbidden_modules()
    if leaked:
        print(f"modules of {leaked} were imported in the run's process", file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
