"""Each cell, run tiny on the CPU, prints one result line of the contract;
the command itself refuses to run without a card."""

import copy
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
SPANS = ("program_span", "program_counter")  # the sources a CPU run reads


def tiny_run(cell, trace=False, seed=2**31 + 11, overrides=TINY):
    return harness.run(cell, seed, 0.01, trace, t_start=time.perf_counter(), device="cpu",
                       overrides=overrides)


def listed(bench, cell, sources):
    """The per-layer metrics whose entries list ``cell``, from ``sources``."""
    return {m["name"] for m in harness.cell_spec(bench, cell)[4] if m["source"] in sources}


def check_result_line(bench, cell, out, err):
    line = json.loads(json.dumps(out))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "check"
    assert line["correct"] is True and line["attempted"] >= 1 and line["failed"] == 0
    e2e = {m["name"]: m["unit"] for m in harness.cell_spec(bench, cell)[3]}
    assert {k: v["unit"] for k, v in line["metrics"].items()} == e2e
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for name, v in line["check"].items():
        assert v["value"] <= v["limit"]
    err = err.strip().splitlines()
    assert [ln.split()[0] for ln in err[-len(line["check"]):]] == list(line["check"])


def check_traced_span_metrics(bench, cell, line):
    """The device-trace metrics need the card; every metric the cell lists
    from the spans and counters is read here, and no other."""
    assert line["correct"] is True
    assert set(line["metrics"]) == listed(bench, cell, SPANS)
    if "solve.sweeps" in line["metrics"]:
        assert line["metrics"]["solve.sweeps"]["value"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cpu_run_prints_a_result(cell, capsys):
    out = tiny_run(cell)
    check_result_line(BENCH, cell, out, capsys.readouterr().err)


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_traced_run_reads_the_span_metrics(cell):
    check_traced_span_metrics(BENCH, cell, tiny_run(cell, trace=True))


def test_a_cell_added_as_data_alone_meets_the_per_cell_expectations(monkeypatch, capsys):
    """A later cell that brings only entries and a configuration file (here
    the fit traffic on a tiny configuration, listed by no per-layer metric)
    passes the same per-cell checks, with no edit to a file the benchmark has."""
    bench = copy.deepcopy(BENCH)
    bench["configs"].append({"name": "tiny", "source": "https://example.org/tiny",
                             "file": "portbench/configs/tiny.json", "reduced": [],
                             "why": "a test's configuration"})
    bench["workloads"].append({"name": "tiny.fit", "config": "tiny", "traffic": "fit",
                               "chips": 1, "why": "a test's cell"})
    base = harness.load_json(ROOT / BENCH["configs"][0]["file"])
    files = {ROOT / "BENCHMARK.json": bench,
             ROOT / "portbench/configs/tiny.json": dict(base, name="tiny", vertices=1200)}
    real = harness.load_json
    monkeypatch.setattr(harness, "load_json",
                        lambda path: files[path] if path in files else real(path))
    assert listed(bench, "tiny.fit", SPANS + ("device_trace",)) == set()
    check_result_line(bench, "tiny.fit", tiny_run("tiny.fit", overrides=None),
                      capsys.readouterr().err)
    check_traced_span_metrics(bench, "tiny.fit", tiny_run("tiny.fit", trace=True,
                                                          overrides=None))


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
