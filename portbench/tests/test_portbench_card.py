"""On the card: a short run of each cell through the command, and every
device-trace metric the cell lists read from it.  Marked ``cuda``; skips
without a card."""

import json
import subprocess
import sys

import pytest

from portbench import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
DEVICE_TRACE = {m["name"] for m in BENCH["per_layer"] if m["source"] == "device_trace"}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_short_traced_run_on_the_card(card, cell):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                        str(2**31 + 77), "--seconds", "1", "--trace", "1"],
                       cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu" and line["device"]["busy_s"] > 0
    traced = {m["name"] for m in harness.cell_spec(BENCH, cell)[4]
              if m["source"] == "device_trace"}
    assert traced == {n for n in line["metrics"] if n in DEVICE_TRACE}
    for name in traced:
        assert 0 < line["metrics"][name]["value"] <= 100, name
    assert len(line["breakdown"]["device_ops"]) <= 10
