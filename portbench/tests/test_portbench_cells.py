"""Each cell, run tiny on the CPU, prints one result line of the contract;
the command itself refuses to run without a card."""

import json
import pathlib
import subprocess
import sys
import time

import pytest

from portbench import harness

ROOT = harness.ROOT
BENCH = harness.load_json(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
TINY = {"vertices": 1500}


def tiny_run(cell, trace=False, seed=2**31 + 11):
    return harness.run(cell, seed, 0.01, trace, t_start=time.perf_counter(), device="cpu",
                       overrides=TINY)


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cpu_run_prints_a_result(cell, capsys):
    out = tiny_run(cell)
    line = json.loads(json.dumps(out))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "check"
    assert line["correct"] is True and line["attempted"] >= 1 and line["failed"] == 0
    e2e = {m["name"]: m["unit"] for m in BENCH["end_to_end"]
           if cell in m.get("workloads", [cell])}
    assert {k: v["unit"] for k, v in line["metrics"].items()} == e2e
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for name, v in line["check"].items():
        assert v["value"] <= v["limit"]
    err = capsys.readouterr().err.strip().splitlines()
    assert [ln.split()[0] for ln in err[-len(line["check"]):]] == list(line["check"])


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_traced_run_reads_the_span_metrics(cell):
    line = tiny_run(cell, trace=True)
    assert line["correct"] is True
    # the device-trace metrics need the card; the spans and counters do not
    want = {"ingest.select_s", "graph.list_build_s", "stage.snapshot_s", "solve.solve_s",
            "solve.sweeps"}
    assert want <= set(line["metrics"])
    assert line["metrics"]["solve.sweeps"]["value"] >= 1


def test_every_metric_has_a_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(harness.metric_module(m["name"]).read)


def test_no_card_no_result():
    """Without a CUDA device the command exits non-zero and prints nothing on
    stdout."""
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed",
                        "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert p.returncode != 0 and p.stdout == ""
    assert "torch.cuda.is_available() is False" in p.stderr


def test_benchmark_files_are_under_paths():
    paths = [ROOT / p for p in BENCH["paths"]]
    for c in BENCH["configs"]:
        f = (ROOT / c["file"]).resolve()
        assert any(f.is_relative_to(p.resolve()) for p in paths)
        cfg = harness.load_json(f)
        assert cfg["name"] == c["name"]
        assert set(cfg["reduced"]) == set(c["reduced"])
        assert "assumed" in cfg and "source" in cfg
    assert pathlib.Path(ROOT / BENCH["command"][1]).is_relative_to(paths[0])
