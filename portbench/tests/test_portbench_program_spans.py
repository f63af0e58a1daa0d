"""The per-layer metrics that read the program's own spans and counters
(``portbench/program_spans.py``), in tiny CPU runs: a traced run of each
cell reads every one that cell lists and sums the take up on standard error; an untraced run
leaves the recorder off; against a program without the recorder they read
nothing and the run goes on."""

import json
import time

import pytest

from portbench import harness, program_spans
from repro_torch import telemetry

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
PROGRAM = [m["name"] for m in BENCH["per_layer"]
           if m["name"] in ("graph.rerank_s", "graph.edges_s", "stage.build_s", "stage.commit_s",
                            "stage.init_s", "solve.host_wait_s")]


@pytest.fixture(autouse=True)
def recorder_off():
    yield
    telemetry.disable()
    telemetry.take()


def tiny_run(cell, trace, seed=2**31 + 23):
    return harness.run(cell, seed, 0.01, trace, t_start=time.perf_counter(), device="cpu",
                       overrides={"vertices": 1500})


def test_the_six_metrics_are_in_the_benchmark():
    assert len(PROGRAM) == 6
    for m in BENCH["per_layer"]:
        if m["name"] in PROGRAM:
            assert m["moves"] == "fit_vertices_per_s"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", CELLS)) <= set(CELLS), m["name"]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_program_spans(cell, capsys):
    line = tiny_run(cell, trace=True)
    assert line["correct"] is True
    want = {m["name"] for m in harness.cell_spec(BENCH, cell)[4]
            if m["source"] in ("program_span", "program_counter")}
    assert set(line["metrics"]) == want  # the device-trace metrics need the card
    for name in want:
        assert line["metrics"][name]["value"] >= 0, name
    if "solve.host_wait_s" in want:
        assert line["metrics"]["solve.host_wait_s"]["value"] > 0
    assert not telemetry.enabled()  # the first reading turned it off
    err = capsys.readouterr().err.splitlines()
    tag = "program spans: "
    summary = json.loads(next(ln for ln in err if ln.startswith(tag))[len(tag):])
    assert summary["fits"] == line["attempted"]
    assert {"graph.rerank", "stage.init", "solve.run"} <= set(summary["self_s"])
    assert 0 < summary["cover"]["graph.apply_batch"] <= 1
    assert 0 < summary["cover"]["engine.submit"] <= 1


def test_untraced_run_leaves_the_recorder_off():
    line = tiny_run(CELLS[0], trace=False)
    assert line["correct"] is True
    assert not telemetry.enabled()
    assert telemetry.take().spans == []


def test_without_the_recorder_nothing_is_read(monkeypatch):
    """A program that has no recorder (the parent of the change that added
    it) runs traced as before, without these metrics."""
    monkeypatch.setattr(program_spans, "_recorder", lambda: None)
    line = tiny_run(CELLS[0], trace=True)
    assert line["correct"] is True
    assert not set(PROGRAM) & set(line["metrics"])
    assert "graph.list_build_s" in line["metrics"]
    assert not telemetry.enabled()


def test_idle_splits_at_span_edges():
    """A device gap that outlasts a step is split among the steps it covers;
    the harness's midpoint rule alone would give it all to one."""
    from types import SimpleNamespace

    from portbench.trace import DeviceEvent

    spans = [telemetry.Span("graph.apply_batch", 0, 30, 0, None, 0, 1),
             telemetry.Span("graph.rerank", 0, 6, 1, 0, 0, 1),
             telemetry.Span("graph.edges", 6, 20, 2, 0, 0, 1)]
    run = SimpleNamespace(
        window=SimpleNamespace(items=1), lo=0, hi=40,
        trace=SimpleNamespace(events=[DeviceEvent("k", 0, 2), DeviceEvent("k", 10, 12)],
                              to_trace=lambda t: t))
    got = program_spans.summary(run, spans, {})
    assert dict(got["idle_s"]) == {"graph.rerank": 4e-9, "graph.edges": 12e-9,
                                   "graph.apply_batch": 10e-9, "outside any span": 10e-9}
    assert got["idle_total_s"] == 36e-9
    assert got["self_s"]["graph.apply_batch"] == 10e-9
    assert got["idle_unsplit_share"] == 20 / 36
