"""The port's recorder (``repro_torch.telemetry``) on the CPU.

Off by default, a fit records nothing.  On, a small
``DynLabelPropagation.fit`` and ``partial_fit`` record every step of the fit's
path once a batch, each span inside its parent on its thread, the worker's
solve under its batch's id; the labels and lists are the bits of a fit with
the recorder off; the frontier loop's host wait and the ingest selects are
counted.
"""

import numpy as np
import pytest
import torch

from repro_torch import telemetry
from repro_torch.serving.estimator import UNLABELED, DynLabelPropagation

torch.set_num_threads(1)

# each batch's spans and the span each runs inside (None: outermost)
PER_BATCH = {
    "engine.submit": None,
    "graph.apply_batch": "engine.submit",
    "graph.delete": "graph.apply_batch",
    "graph.append": "graph.apply_batch",
    "ingest.select": "graph.apply_batch",
    "ingest.store_append": "ingest.select",
    "ingest.search": "ingest.select",
    "ingest.readback": "ingest.select",
    "graph.rerank": "graph.apply_batch",
    "graph.merge": "graph.apply_batch",
    "graph.edges": "graph.apply_batch",
    "graph.gprime": "graph.apply_batch",
    "graph.relabel": "graph.apply_batch",
    "graph.finalize": "graph.apply_batch",
    "stage.build": "engine.submit",
    "stage.resolve": "engine.submit",
    "stage.commit": "engine.submit",
    "stage.init": "engine.submit",
    "stage.queue": "engine.submit",
    "engine.drain": None,  # the service's sync drains each batch
    "engine.drain_wait": "engine.drain",
    "engine.fold": "engine.drain",
    "solve.run": None,  # the worker thread's
}
FRONT_DOOR = ("service.admit", "fit.readback")  # once a call, outside any batch


@pytest.fixture(autouse=True)
def recorder_off():
    yield
    telemetry.disable()
    telemetry.take()


def _data(n=240, d=8, seed=0):
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.normal(-2.5, 0.7, (n // 2, d)),
                        rng.normal(2.5, 0.7, (n - n // 2, d))]).astype(np.float32)
    y = np.full(n, UNLABELED, np.int8)
    y[rng.choice(n // 2, 4, replace=False)] = 0
    y[n // 2 + rng.choice(n - n // 2, 4, replace=False)] = 1
    return X, y


def _fit_twice(X, y):
    """fit on the first 160 rows, partial_fit the rest: two batches."""
    clf = DynLabelPropagation(k=5, engine_opts={"device": "cpu"})
    clf.fit(X[:160], y[:160])
    clf.partial_fit(X[160:], y[160:])
    clf.engine_.close()
    return clf


def test_off_by_default_records_nothing():
    assert not telemetry.enabled()
    assert telemetry.span("a") is telemetry.span("b")  # the shared no-op
    X, y = _data()
    _fit_twice(X, y)
    rec = telemetry.take()
    assert rec.spans == [] and rec.counters == {}


def test_every_step_once_a_batch_inside_its_parent():
    X, y = _data()
    telemetry.enable()
    _fit_twice(X, y)
    rec = telemetry.take()
    telemetry.disable()
    by_id = {s.id: s for s in rec.spans}
    names = [s.name for s in rec.spans]
    assert names.count("fit.init_stack") == 1
    for name in FRONT_DOOR:
        assert names.count(name) == 2
        assert all(s.batch is None for s in rec.spans if s.name == name)
    for name, parent in PER_BATCH.items():
        got = [s for s in rec.spans if s.name == name]
        assert sorted(s.batch for s in got) == [0, 1], name
        for s in got:
            up = by_id.get(s.parent)
            assert (up.name if up else None) == parent, name
            if up is not None:
                assert up.thread == s.thread and up.batch == s.batch
                assert up.t0 <= s.t0 <= s.t1 <= up.t1, name
    main = {s.thread for s in rec.spans if s.name == "engine.submit"}
    solves = [s for s in rec.spans if s.name == "solve.run"]
    assert {s.thread for s in solves}.isdisjoint(main)
    submits = {s.batch: s for s in rec.spans if s.name == "engine.submit"}
    for s in solves:  # queued at the end of its own batch's submit
        assert s.t0 >= submits[s.batch].t0
    assert set(names) == set(PER_BATCH) | set(FRONT_DOOR) | {"fit.init_stack"}


def test_bits_equal_with_the_recorder_on_and_off():
    X, y = _data(seed=3)
    off = _fit_twice(X, y)
    telemetry.enable()
    on = _fit_twice(X, y)
    telemetry.disable()
    assert telemetry.take().spans
    for name in ("knn_idx", "knn_wgt", "src", "dst", "wgt", "f", "labels"):
        a, b = getattr(off.graph_, name), getattr(on.graph_, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert off.transduction_.tobytes() == on.transduction_.tobytes()


def test_counters_host_wait_and_selects():
    X, y = _data(seed=5)
    telemetry.enable()
    clf = DynLabelPropagation(k=5, engine_opts={"device": "cpu"})
    clf.fit(X[:160], y[:160])
    clf.partial_fit(X[160:], y[160:])
    clf.forget(np.arange(0, 240, 7))  # a batch without insertions
    clf.engine_.close()
    rec = telemetry.take()
    telemetry.disable()
    assert rec.counters["solve.host_wait_ns"] > 0
    assert rec.counters["graph.flagged_rows"] > 0  # partial_fit displaces old rows
    submits = [s for s in rec.spans if s.name == "engine.submit"]
    assert len(submits) == 3
    assert sum(s.name == "ingest.select" for s in rec.spans) == 2


def test_a_full_buffer_counts_its_drops(monkeypatch):
    monkeypatch.setattr(telemetry, "MAX_SPANS", 3)
    telemetry.enable()
    for i in range(5):
        with telemetry.span(f"s{i}"):
            telemetry.count("n", 2)
    rec = telemetry.take()
    assert [s.name for s in rec.spans] == ["s0", "s1", "s2"]
    assert rec.counters == {"n": 10, "telemetry.dropped": 2}
    assert telemetry.take().spans == []
