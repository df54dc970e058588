"""One short run of each cell on the card (`python -m pytest perfbench/tests
-m card` on a machine with one): the result's last line, correct."""

import json
import os
import subprocess
import sys

import pytest

from perfbench import spec

BENCH = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_short_run_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark runs only on one")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
                          "3000000123", "--seconds", "1", "--trace", "0"], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True


def test_no_card_no_result():
    """Without a card the run exits 2 and prints nothing on standard output."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1"],
                         cwd=spec.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""
