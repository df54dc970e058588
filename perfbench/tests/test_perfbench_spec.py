"""`BENCHMARK.json` against the form the benchmark's contract gives it, and
every file it names."""

import json
import os
import re

import pytest

from perfbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))


def test_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"] and 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) <= 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files_and_reports_enough(cell):
    c = spec.load_cell(cell)
    assert c.chips == 1
    assert {"setup_s"} < {m["name"] for m in c.end_to_end}
    assert c.per_layer
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in c.per_layer:
        assert m["moves"] in e2e
        assert hasattr(spec.metric_reader(m["name"]), "read")
    assert any(v.get("limit") is not None for v in c.limits.values())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_code_by_name(cell):
    """The cell's kind, its architecture's FLOP count and its plain
    reference are files found by the names its traffic and configuration
    give."""
    from perfbench.reference import model

    c = spec.load_cell(cell)
    assert callable(spec.cell_kind(c.traffic["kind"]).run)
    flops = spec.architecture_flops(c.config["architecture"])
    assert flops.train_step_flops(c.config, c.traffic) > 0
    assert all(site["launches"] for site in flops.kernel_sites(c.config, c.traffic))
    ref = model(c.config["architecture"])
    assert all(hasattr(ref, k) for k in ("Net", "param_shapes", "init_params"))


def test_configs_hold_their_files():
    for c in BENCH["configs"]:
        cfg = json.load(open(os.path.join(spec.ROOT, c["file"])))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["peak"] in spec.peaks("NVIDIA H100 80GB HBM3")
