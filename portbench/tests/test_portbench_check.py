"""The check fails what it has to: the control (the reference in TF32 and
bfloat16) and a run whose timed path is broken underneath.  Each fault
drives a whole tiny run on the CPU past the look for a card."""

import time

import numpy as np
import pytest

from portbench import control, harness

CELLS = [w["name"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]
TINY = 1500


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    r = control.readings(cell, 2**31 + 5, "cpu", vertices=TINY)
    assert not r["control_passes"]
    assert r["control"]["knn_gap"] > r["limits"]["knn_gap"]


def _run(cell="amazon-polarity-nomic128.fit"):
    return harness.run(cell, 2**31 + 9, 0.01, False, t_start=time.perf_counter(),
                       device="cpu", overrides={"vertices": TINY})


def test_sound_run_is_correct():
    assert _run()["correct"] is True


def test_solve_that_returns_its_state_unchanged(monkeypatch):
    from repro_torch.core.propagate import PropagateResult
    from repro_torch.kernels import ops

    def unchanged(problem, f0, frontier0, **kw):
        return PropagateResult(f=f0, iterations=0, converged=True, max_residual=0.0)

    monkeypatch.setattr(ops, "run_propagation", unchanged)
    out = _run()
    assert out["correct"] is False
    assert out["check"]["label_gap"]["value"] > out["check"]["label_gap"]["limit"]


def test_half_the_batch_left_out(monkeypatch):
    from repro_torch.serving.lp_service import LPService

    orig = LPService.add_points

    def half(self, embeddings, labels=None):
        h = len(embeddings) // 2
        return orig(self, embeddings[:h], None if labels is None else labels[:h])

    monkeypatch.setattr(LPService, "add_points", half)
    out = _run()
    assert out["correct"] is False
    assert out["check"]["knn_gap"]["value"] == 1.0


def test_a_committed_label_altered(monkeypatch):
    from repro_torch.serving.estimator import DynLabelPropagation

    orig = DynLabelPropagation._refresh_transduction

    def flip(self):
        orig(self)
        unl = np.flatnonzero(self.graph_.labels == -1)
        self.transduction_[unl[len(unl) // 2]] ^= 1

    monkeypatch.setattr(DynLabelPropagation, "_refresh_transduction", flip)
    out = _run()
    assert out["correct"] is False
    assert out["check"]["label_gap"]["value"] > out["check"]["label_gap"]["limit"]


def test_a_neighbour_list_altered(monkeypatch):
    from repro_torch.ingest.incremental_knn import DeviceIngestor

    orig = DeviceIngestor.select

    def worse(self, g, new_ids, embn_new):
        sel = orig(self, g, new_ids, embn_new)
        sel.cand_idx[:, 0] = -1  # every row loses its best candidate
        return sel

    monkeypatch.setattr(DeviceIngestor, "select", worse)
    out = _run()
    assert out["correct"] is False
    assert out["check"]["knn_gap"]["value"] > out["check"]["knn_gap"]["limit"]


def test_judge_keeps_each_numbers_worst_reading():
    from portbench import check

    limits = {"a": 0.5, "b": 1.0}
    ok, numbers = check.judge([{"a": 0.1, "b": 0.9}, {"a": 0.4, "b": 0.2}], limits)
    assert ok and numbers == {"a": {"value": 0.4, "limit": 0.5}, "b": {"value": 0.9, "limit": 1.0}}
    assert not check.judge([{"a": 0.1, "b": 0.9}, {"a": 0.6, "b": 0.2}], limits)[0]
    assert not check.judge([], limits)[0]  # nothing read is not correct
