"""On the card: a short run of each cell through the command, and the
trace it reads.  Marked ``cuda``; skips without a card."""

import json
import subprocess
import sys

import pytest

from portbench import harness

CELLS = [w["name"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]


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
    assert 0 < line["metrics"]["kernel.argkmin_roofline"]["value"] <= 100
    assert 0 < line["metrics"]["kernel.sweep_roofline"]["value"] <= 100
    assert len(line["breakdown"]["device_ops"]) <= 10
