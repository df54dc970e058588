"""The benchmark's description, read from `BENCHMARK.json` at the root of
the checkout, and the files it names.

Every cell, configuration, traffic mix, per-layer metric and kernel is
found by its name: a configuration's file is the one `BENCHMARK.json`
gives; a traffic mix is `traffic/<name>.json`, and the code that runs a
cell is `cells/<kind>.py` by the mix's `kind`; a configuration's
`architecture` names its FLOP count, `flops/<architecture>.py`, and its
plain reference, `reference/<architecture>.py`; a cell's correctness
limits are `limits/<workload>.json`; a per-layer metric's reader is
`metrics/<metric name>.py`; a kernel's bound is `kernels/<kernel name>.py`.
A later cell kind, architecture, cell, metric or kernel is added as files
and entries, without editing any file here.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass
from types import ModuleType
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str) -> ModuleType:
    """The Python file `path` as a module named `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    """One entry of `workloads` with everything it names."""
    name: str
    chips: int
    config: dict          # the configuration file's contents
    traffic: dict         # the traffic mix's parameters
    limits: dict          # the correctness limits of this cell
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(workload: str, benchmark_path: Optional[str] = None) -> Cell:
    bench = _load_json(benchmark_path or os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; known: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(os.path.join(ROOT, configs[w["config"]]["file"]))
    return Cell(
        name=workload, chips=int(w["chips"]), config=config,
        traffic=_load_json(os.path.join(HERE, "traffic", f"{w['traffic']}.json")),
        limits=_load_json(os.path.join(HERE, "limits", f"{workload}.json")),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)])


def cell_kind(kind: str) -> ModuleType:
    """The module that runs cells whose traffic is of `kind`:
    `cells/<kind>.py`, with `run(cell, seed, seconds, trace, device,
    wrap=None)`."""
    return importlib.import_module(f"perfbench.cells.{kind}")


def architecture_flops(architecture: str) -> ModuleType:
    """The FLOP count of `architecture`: `flops/<architecture>.py`."""
    return importlib.import_module(f"perfbench.flops.{architecture}")


def metric_reader(name: str) -> ModuleType:
    """The reader of per-layer metric `name`: `metrics/<name>.py`, whose
    `read(ctx)` returns the metric's value or None."""
    return load_module(os.path.join(HERE, "metrics", f"{name}.py"),
                       f"perfbench_metric_{name.replace('.', '_')}")


def kernel_bounds() -> Dict[str, ModuleType]:
    """{kernel name: module} of every file under `kernels/`: the port's own
    kernels, each with `bound_s(site, template_args, peaks)`."""
    out = {}
    for fname in sorted(os.listdir(os.path.join(HERE, "kernels"))):
        if fname.endswith(".py") and not fname.startswith("_"):
            name = fname[:-3]
            out[name] = load_module(os.path.join(HERE, "kernels", fname),
                                    f"perfbench_kernel_{name}")
    return out


def peaks(device_name: str) -> dict:
    """The published peaks of the card named `device_name` (`peaks.json`)."""
    table = _load_json(os.path.join(HERE, "peaks.json"))
    if device_name not in table:
        raise KeyError(f"no peaks for {device_name!r} in peaks.json; known: {sorted(table)}")
    return table[device_name]
