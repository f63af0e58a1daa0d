"""The port's ``StreamEngine``: bit for bit against the port's ``DynLP`` per
batch, the engine's edge cases, and parity with the JAX package's engine.

Mirrors ``tests/test_stream.py``, ``test_stream_edges.py`` and the
single-device cases of ``test_stream_property.py``.  Inside the port the
engine and ``DynLP.step`` compute the same thing from the same inputs, so
labels must be equal bit for bit, for both backends (``ell_cuda`` runs its
kernel's plain version on the CPU).  Against the reference, the host state
(graph, kNN lists) must be byte-identical and the labels within 20·δ.
"""

import logging
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.core.stream import StreamEngine as JaxStreamEngine
from repro.data import synth as jsynth
from repro.graph import dynamic as jdyn
from repro_torch.core.dynlp import DynLP
from repro_torch.core.propagate import propagate
from repro_torch.core.snapshot import ladder_size
from repro_torch.core.stream import StreamEngine
from repro_torch.data import synth as tsynth
from repro_torch.graph.dynamic import UNLABELED, BatchUpdate, DynamicGraph
from repro_torch.ingest import DeviceIngestor
from repro_torch.kernels import ops
from repro_torch.state import graph_from_reference, store_from_reference

torch.set_num_threads(1)

DELTA = 1e-4
EMB_DIM = 8
GRAPH = ("src", "dst", "wgt", "knn_idx", "knn_wgt")
NONE = np.zeros(0, np.int64)


def _engine(g, **kw):
    return StreamEngine(g, delta=kw.pop("delta", DELTA), device="cpu", **kw)


def _random_batches(seed, n_batches, batch_size, frac_del, hostile_dels, include_empty,
                    batch_cls=BatchUpdate):
    """Random two-Gaussian insert/delete stream (the reference property
    test's generator).  ``hostile_dels`` adds duplicate and never-seen ids
    to the deletions; ``include_empty`` splices in an empty Δ_t."""
    rng = np.random.default_rng(seed)
    batches = []
    next_id = 0
    for b in range(n_batches):
        n = batch_size
        cls = rng.integers(0, 2, n).astype(np.int8)
        emb = np.zeros((n, EMB_DIM), np.float32)
        emb[:, 0] = np.where(cls == 1, 3.0, -3.0)
        emb += rng.normal(0, 0.9, (n, EMB_DIM)).astype(np.float32)
        labels = np.full(n, UNLABELED, np.int8)
        if b == 0:  # seed both classes so propagation has sources
            labels[0] = cls[0]
            labels[1] = 1 - cls[0]
            emb[1, 0] = -emb[0, 0]
        n_del = int(round(frac_del * n)) if next_id else 0
        del_ids = rng.integers(0, next_id, n_del).astype(np.int64) if n_del else NONE
        if hostile_dels and next_id:
            del_ids = np.concatenate([del_ids, del_ids[:2],
                                      np.array([next_id + 17, -1], np.int64)])
        batches.append(batch_cls(ins_emb=emb, ins_labels=labels, del_ids=del_ids))
        next_id += n
    if include_empty:
        batches.insert(n_batches // 2 + 1, batch_cls(
            ins_emb=np.zeros((0, EMB_DIM), np.float32), ins_labels=np.zeros(0, np.int8),
            del_ids=NONE))
    return batches


def _empty_batch(dim=4):
    return BatchUpdate(ins_emb=np.zeros((0, dim), np.float32),
                       ins_labels=np.zeros(0, np.int8), del_ids=NONE)


def _seed_batch(rng, dim=4, n=20):
    emb = rng.normal(0, 1, (n, dim)).astype(np.float32)
    emb[0, 0], emb[1, 0] = 3.0, -3.0
    labels = np.full(n, UNLABELED, np.int8)
    labels[0], labels[1] = 1, 0
    return BatchUpdate(ins_emb=emb, ins_labels=labels, del_ids=NONE)


# --------------------------------------------------------------------- #
# the engine against the port's DynLP, bit for bit
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("backend,ingest", [("ref", "host"), ("ell_cuda", "host"),
                                            ("ell_cuda", "device")])
def test_step_bit_identical_to_dynlp(backend, ingest):
    gs, gd = DynamicGraph(EMB_DIM, k=4), DynamicGraph(EMB_DIM, k=4)
    eng = _engine(gs, backend=backend, ingest=ingest)
    dyn = DynLP(gd, delta=DELTA, backend=backend, device="cpu")
    for i, batch in enumerate(_random_batches(1, 4, 30, 0.2, False, False)):
        ss, sd = eng.step(batch), dyn.step(batch)
        assert (ss.iterations, ss.converged, ss.num_unlabeled, ss.num_components,
                ss.frontier_size) == (sd.iterations, sd.converged, sd.num_unlabeled,
                                      sd.num_components, sd.frontier_size), i
        assert gs.f.tobytes() == gd.f.tobytes(), i
        assert (ss.backend, ss.transport) == (backend, "single")
        for name in GRAPH:
            assert getattr(gs, name).tobytes() == getattr(gd, name).tobytes(), (i, name)
    np.testing.assert_array_equal(eng.predictions()[1], dyn.predictions()[1])


@pytest.mark.parametrize("seed,n_batches,batch_size,frac_del,hostile,empty", [
    (0, 3, 20, 0.0, False, True), (1, 4, 12, 0.3, True, False),
    (2, 3, 25, 0.2, True, True), (3, 2, 30, 0.1, False, False),
])
def test_random_streams_bit_identical_to_dynlp(seed, n_batches, batch_size, frac_del,
                                               hostile, empty):
    """Random mixed streams (duplicate and never-seen deletions, an empty
    Δ_t): after every batch the streamed labels equal DynLP's bit for bit."""
    batches = _random_batches(seed, n_batches, batch_size, frac_del, hostile, empty)
    gs, gd = DynamicGraph(EMB_DIM, k=4), DynamicGraph(EMB_DIM, k=4)
    eng, dyn = _engine(gs), DynLP(gd, delta=DELTA, device="cpu")
    for i, batch in enumerate(batches):
        ss, sd = eng.step(batch), dyn.step(batch)
        assert (ss.iterations, ss.converged, ss.num_unlabeled) == \
            (sd.iterations, sd.converged, sd.num_unlabeled), i
        assert gs.f.tobytes() == gd.f.tobytes(), i
        np.testing.assert_array_equal(gs.alive, gd.alive)


@pytest.mark.parametrize("ingest", ["host", "device"])
def test_pipelined_submit_drain_bit_identical_to_dynlp(ingest):
    """Staging batch t+1 while batch t is in flight reaches DynLP's labels."""
    batches = _random_batches(4, 4, 20, 0.2, True, False)
    gp, gd = DynamicGraph(EMB_DIM, k=4), DynamicGraph(EMB_DIM, k=4)
    eng, dyn = _engine(gp, ingest=ingest), DynLP(gd, delta=DELTA, device="cpu")
    stats = []
    for batch in batches:
        prev = eng.submit(batch)
        if prev is not None:
            stats.append(prev)
        dyn.step(batch)
    stats.append(eng.drain())
    assert len(stats) == len(batches) == eng.commits == eng.batches
    assert all(s.converged for s in stats)
    assert gp.f.tobytes() == gd.f.tobytes()


def test_pipelined_stream_under_a_short_switch_interval():
    """The solve thread and the caller share the interpreter: with thread
    switches forced every microsecond, a pipelined device-ingest stream
    still gives DynLP's bits, and ``close`` leaves no solve running."""
    batches = _random_batches(7, 3, 16, 0.2, True, False)
    gp, gd = DynamicGraph(EMB_DIM, k=4), DynamicGraph(EMB_DIM, k=4)
    eng, dyn = _engine(gp, ingest="device"), DynLP(gd, delta=DELTA, device="cpu")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for batch in batches:
            eng.submit(batch)
            dyn.step(batch)
        eng.close()
        assert eng.drain().converged
    finally:
        sys.setswitchinterval(old)
    assert gp.f.tobytes() == gd.f.tobytes()
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(batches[0])  # a closed engine takes no more batches
    assert eng.batches == len(batches)


def test_deletes_and_inserts_roundtrip():
    """Deletions and insertions in one Δ_t: a hostile cluster is swapped for
    a friendly one and the labels recover."""
    rng = np.random.default_rng(0)
    g = DynamicGraph(emb_dim=4, k=3)
    eng = _engine(g, delta=1e-5)
    anchors = np.array([[1, 0, 0, 0], [-1, 0, 0, 0]], np.float32)
    cloud = rng.normal([1, 0, 0, 0], 0.1, (30, 4)).astype(np.float32)
    eng.step(BatchUpdate(ins_emb=np.concatenate([anchors, cloud]),
                         ins_labels=np.array([1, 0] + [UNLABELED] * 30, np.int8),
                         del_ids=NONE))
    hostile = rng.normal([-0.6, 0, 0, 0], 0.1, (40, 4)).astype(np.float32)
    eng.step(BatchUpdate(ins_emb=hostile, ins_labels=np.full(40, UNLABELED, np.int8),
                         del_ids=NONE))
    hostile_ids = np.arange(32, 72)
    assert g.f[hostile_ids].mean() < 0.5
    friendly = rng.normal([0.9, 0, 0, 0], 0.1, (10, 4)).astype(np.float32)
    st = eng.step(BatchUpdate(ins_emb=friendly, ins_labels=np.full(10, UNLABELED, np.int8),
                              del_ids=hostile_ids))
    assert st.converged and not g.alive[hostile_ids].any()
    ids = np.flatnonzero(g.alive & (g.labels == UNLABELED))
    assert (g.f[ids] > 0.5).all()


def test_deletion_only_batch():
    g = DynamicGraph(EMB_DIM, k=4)
    eng = _engine(g)
    for batch in _random_batches(5, 2, 40, 0.0, False, False):
        eng.step(batch)
    victims = np.flatnonzero(g.alive & (g.labels == UNLABELED))[:20].astype(np.int64)
    st = eng.step(BatchUpdate(ins_emb=np.zeros((0, EMB_DIM), np.float32),
                              ins_labels=np.zeros(0, np.int8), del_ids=victims))
    assert st.converged and st.frontier_size > 0 and st.backend == "ref"
    assert not g.alive[victims].any()


# --------------------------------------------------------------------- #
# edge cases: idle drains, empty batches, no-op deletes, poll, views
# --------------------------------------------------------------------- #
def test_drain_and_poll_with_nothing_pending():
    eng = _engine(DynamicGraph(emb_dim=4, k=3))
    assert eng.drain() is None and eng.poll() is None and not eng.in_flight
    eng.submit(_seed_batch(np.random.default_rng(0)))
    assert eng.in_flight
    assert eng.drain() is not None
    assert eng.drain() is None and eng.commits == 1


def test_empty_batch_on_empty_graph_stages_nothing():
    eng = _engine(DynamicGraph(emb_dim=4, k=3))
    st = eng.step(_empty_batch())
    assert st.converged and st.iterations == 0 and st.frontier_size == 0
    assert (st.bucket, st.transport, st.backend) == ((0, 0), "none", "none")
    assert not st.recompiled and eng.recompile_count == 0 and not eng.bucket_keys
    assert eng.batches == eng.commits == 1


def test_empty_batch_and_unknown_deletes_commit_unchanged_labels():
    g = DynamicGraph(emb_dim=4, k=3)
    eng = _engine(g)
    eng.step(_seed_batch(np.random.default_rng(1)))
    f_before, alive_before = g.f.copy(), g.alive.copy()
    rungs = eng.recompile_count
    for batch in (_empty_batch(), BatchUpdate(ins_emb=np.zeros((0, 4), np.float32),
                                              ins_labels=np.zeros(0, np.int8),
                                              del_ids=np.array([999, -5], np.int64))):
        st = eng.step(batch)
        assert st.converged and st.iterations == 0 and not st.recompiled
    assert eng.recompile_count == rungs
    np.testing.assert_array_equal(g.f, f_before)
    np.testing.assert_array_equal(g.alive, alive_before)
    np.testing.assert_array_equal(eng.committed_view().f, f_before)
    assert eng.committed_view().commit_id == 3


def test_predictions_and_view_before_any_commit():
    eng = _engine(DynamicGraph(emb_dim=4, k=3))
    ids, pred = eng.predictions()
    assert len(ids) == 0 and len(pred) == 0
    view = eng.committed_view()
    assert view.commit_id == 0 and view.num_nodes == 0
    p, c = view.query([0, 7, -1])
    assert (p == UNLABELED).all() and (c == 0).all()


def test_poll_commits_only_when_ready():
    eng = _engine(DynamicGraph(emb_dim=4, k=3))
    assert eng.poll() is None
    eng.submit(_seed_batch(np.random.default_rng(3)))
    deadline = time.monotonic() + 60
    st = None
    while st is None and time.monotonic() < deadline:
        st = eng.poll()
    assert st is not None and st.converged
    assert not eng.in_flight and eng.commits == 1 and eng.poll() is None


def test_submit_after_empty_batch_resumes_normal_path():
    rng = np.random.default_rng(4)
    eng = _engine(DynamicGraph(emb_dim=4, k=3))
    eng.submit(_seed_batch(rng))
    eng.submit(_empty_batch())  # drains batch 0, queues the no-op
    more = rng.normal([3, 0, 0, 0], 0.1, (10, 4)).astype(np.float32)
    prev = eng.submit(BatchUpdate(ins_emb=more, ins_labels=np.full(10, UNLABELED, np.int8),
                                  del_ids=NONE))
    assert prev is not None and prev.iterations == 0  # the no-op's stats
    st = eng.drain()
    assert st is not None and st.converged and st.frontier_size > 0
    assert eng.batches == eng.commits == 3 and eng.bucket_keys
    assert eng.committed_view().commit_id == 3


@pytest.mark.parametrize("seed,batch_size", [(0, 8), (1, 24)])
def test_committed_view_is_frozen_copy(seed, batch_size):
    """A later, undrained submit never leaks into the committed view."""
    batches = _random_batches(seed, 2, batch_size, 0.1, False, False)
    g = DynamicGraph(EMB_DIM, k=4)
    eng = _engine(g)
    eng.step(batches[0])
    view = eng.committed_view()
    f_then = view.f.copy()
    eng.submit(batches[1])  # mutates g.f (supernode inits) before the commit
    np.testing.assert_array_equal(view.f, f_then)
    assert not view.f.flags.writeable
    assert eng.committed_view() is view
    eng.drain()
    assert eng.committed_view() is not view


def test_submit_returns_while_its_solve_is_held(monkeypatch):
    """``submit`` queues the solve and returns: a backend that holds the
    solve on an event shows the caller back before the solve ran."""
    gate, started = threading.Event(), threading.Event()

    def held(problem, f0, frontier0, **kw):
        started.set()
        assert gate.wait(60)
        return propagate(problem, f0, frontier0, **kw)

    monkeypatch.setitem(ops._REGISTRY, "held", ops.BackendSpec(
        name="held", auto_priority=0, auto_eligible=lambda info: False, run=held))
    g = DynamicGraph(emb_dim=4, k=3)
    eng = _engine(g, backend="held")
    assert eng.submit(_seed_batch(np.random.default_rng(5))) is None
    assert started.wait(60)
    assert eng.in_flight and eng.poll() is None  # submit came back; the solve waits
    assert eng.committed_view().commit_id == 0
    gate.set()
    st = eng.drain()
    assert st.converged and st.backend == "held" and eng.commits == 1


# --------------------------------------------------------------------- #
# knobs: max_k, the rung ladder, validation
# --------------------------------------------------------------------- #
def _hub_stream(eng, rng, batches=4, per_batch=25):
    """Points on a cone around one hub vertex: the hub's in-degree, and the
    natural ELL K, grow with every batch (the reference test's stream)."""
    dim = eng.graph.emb_dim
    hub = np.zeros((1, dim), np.float32)
    hub[0, 0] = 1.0
    anchors = np.zeros((2, dim), np.float32)
    anchors[0, 0], anchors[1, 0] = 1.0, -1.0
    eng.step(BatchUpdate(ins_emb=np.concatenate([anchors, hub]),
                         ins_labels=np.array([1, 0, UNLABELED], np.int8), del_ids=NONE))
    for _ in range(batches):
        u = rng.normal(0, 1, (per_batch, dim)).astype(np.float32)
        u[:, 0] = 0.0
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        pts = (0.9 * hub + np.float32(np.sqrt(1.0 - 0.81)) * u).astype(np.float32)
        eng.step(BatchUpdate(ins_emb=pts, ins_labels=np.full(per_batch, UNLABELED, np.int8),
                             del_ids=NONE))


def test_max_k_default_and_hub_cap():
    g = DynamicGraph(emb_dim=8, k=3)
    assert _engine(g).max_k == 12
    assert _engine(g, max_k=None).max_k is None
    assert _engine(g, max_k=7).max_k == 7
    with pytest.raises(ValueError, match="max_k"):
        _engine(g, max_k="huge")
    free = _engine(DynamicGraph(emb_dim=64, k=3), max_k=None)
    _hub_stream(free, np.random.default_rng(0))
    assert max(k for _, k in free.bucket_keys) >= 32  # the uncapped creep
    capped = _engine(DynamicGraph(emb_dim=64, k=3))  # default cap 4k = 12
    _hub_stream(capped, np.random.default_rng(0))
    assert max(k for _, k in capped.bucket_keys) <= 16  # bucket_k(12)
    ids = np.flatnonzero(capped.graph.alive & (capped.graph.labels == UNLABELED))
    assert (capped.graph.f[ids] > 0.5).all()


def test_max_k_warning_scoped_per_engine(caplog):
    """Each engine warns once per (cap, natural-K rung): a fresh engine warns
    again instead of inheriting another engine's dedup state."""
    def run_engine():
        _hub_stream(_engine(DynamicGraph(emb_dim=64, k=3), max_k=8),
                    np.random.default_rng(0), batches=3)

    with caplog.at_level(logging.WARNING, logger="repro_torch.core.snapshot"):
        run_engine()
        first = [r for r in caplog.records if "truncating" in r.getMessage()]
        caplog.clear()
        run_engine()
        second = [r for r in caplog.records if "truncating" in r.getMessage()]
    assert first and len(second) == len(first) <= 4


def test_rung_allocations_bounded_by_ladder():
    """A 15-batch stream allocates buffers per rung, not per batch: the
    'recompiled' batches are the rung entries, within ``ladder_size``."""
    spec = tsynth.StreamSpec(total_vertices=600, batch_size=40, emb_dim=EMB_DIM, seed=5,
                             class_sep=6.0, noise=0.9)
    g = DynamicGraph(EMB_DIM, k=4)
    eng = _engine(g)
    recompiled = 0
    for batch, _ in tsynth.gaussian_mixture_stream(spec):
        recompiled += eng.step(batch).recompiled
    max_k = max(k for _, k in eng.bucket_keys)
    assert eng.batches == 15 and recompiled == eng.recompile_count
    assert eng.recompile_count == len(eng.bucket_keys) <= ladder_size(600 + 256, max_k)
    assert len(eng.bucket_keys) <= eng.batches // 2
    slots = sum(b is not None for pair in eng._buffers.values() for b in pair)
    assert slots <= 2 * len(eng.bucket_keys)


def test_constructor_validation_and_deferred_surface():
    g = DynamicGraph(emb_dim=4, k=3)
    with pytest.raises(ValueError, match="ingest mode"):
        _engine(g, ingest="sideways")
    with pytest.raises(ValueError, match="ingest_order"):
        _engine(g, ingest_order="random")
    with pytest.raises(ValueError, match="unknown backend"):
        _engine(g, backend="landmark")
    with pytest.raises(TypeError):
        _engine(g, mesh=object())
    eng = _engine(g)
    # the read and persistence surface is ported; the mesh (above) is not
    for name in ("device_view", "checkpoint", "checkpoint_state", "restore"):
        assert callable(getattr(eng, name)), name
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            StreamEngine(g)


def test_locality_order_agrees_across_ingest_paths():
    batches = _random_batches(6, 3, 20, 0.1, False, False)
    gh, gd = DynamicGraph(EMB_DIM, k=4), DynamicGraph(EMB_DIM, k=4)
    eh = _engine(gh, ingest_order="locality")
    ed = _engine(gd, ingest_order="locality", ingest="device")
    for batch in batches:
        eh.step(batch)
        ed.step(batch)
    for name in GRAPH + ("f", "emb"):
        assert getattr(gh, name).tobytes() == getattr(gd, name).tobytes(), name


# --------------------------------------------------------------------- #
# the port's engine against the JAX package's
# --------------------------------------------------------------------- #
def _check_against_reference(jg, tg):
    for name in GRAPH + ("alive", "labels"):
        assert getattr(jg, name).tobytes() == getattr(tg, name).tobytes(), name
    ids = np.flatnonzero(tg.alive & (tg.labels == UNLABELED))
    assert np.abs(jg.f[ids] - tg.f[ids]).max(initial=0) <= 20 * DELTA


@pytest.mark.parametrize("ingest", ["host", "device"])
def test_engine_matches_reference_engine(ingest):
    spec = dict(total_vertices=240, batch_size=60, emb_dim=EMB_DIM, seed=8,
                class_sep=6.0, noise=0.9)
    jg, tg = jdyn.DynamicGraph(EMB_DIM, k=4), DynamicGraph(EMB_DIM, k=4)
    je = JaxStreamEngine(jg, delta=DELTA, backend="ref", ingest=ingest)
    te = _engine(tg, ingest=ingest)
    for (jb, _), (tb, _) in zip(jsynth.gaussian_mixture_stream(jsynth.StreamSpec(**spec)),
                                tsynth.gaussian_mixture_stream(tsynth.StreamSpec(**spec))):
        js, ts = je.step(jb), te.step(tb)
        assert (js.num_unlabeled, js.frontier_size, js.num_components) == \
            (ts.num_unlabeled, ts.frontier_size, ts.num_components)
        assert ts.converged and js.converged
        _check_against_reference(jg, tg)


def test_hand_over_from_reference_engine_mid_stream():
    """Two batches through the reference's device-ingest engine, its graph
    and embedding store carried into the port (``state.py``), then both go
    on with the same batches: graphs and stores byte-identical."""
    spec = dict(total_vertices=240, batch_size=60, emb_dim=EMB_DIM, seed=9,
                class_sep=6.0, noise=0.9)
    jbatches = list(jsynth.gaussian_mixture_stream(jsynth.StreamSpec(**spec)))
    tbatches = list(tsynth.gaussian_mixture_stream(tsynth.StreamSpec(**spec)))
    jg = jdyn.DynamicGraph(EMB_DIM, k=4)
    je = JaxStreamEngine(jg, delta=DELTA, backend="ref", ingest="device")
    for jb, _ in jbatches[:2]:
        je.step(jb)
    js = je.ingestor.store
    tg = graph_from_reference(jg.state_arrays(), emb_dim=EMB_DIM, k=4)
    store = store_from_reference({k: np.asarray(v) for k, v in js.state_arrays().items()},
                                 js.count, EMB_DIM, device="cpu")
    te = _engine(tg, ingest=DeviceIngestor(EMB_DIM, store=store))
    for (jb, _), (tb, _) in zip(jbatches[2:], tbatches[2:]):
        je.step(jb)
        assert te.step(tb).converged
        _check_against_reference(jg, tg)
        for name in ("emb", "valid", "kth"):
            assert np.asarray(getattr(js, name)).tobytes() == \
                getattr(store, name).numpy().tobytes(), name
