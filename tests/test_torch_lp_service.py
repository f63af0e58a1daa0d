"""The port's ``LPService`` and its background driver.

Mirrors the single-device tests of ``tests/test_lp_service.py`` (committed
queries bit-identical to a full ``DynLP`` recompute, no torn reads while a
batch is in flight, admission window, backpressure) and of
``tests/test_service_driver.py`` (deadlines fire with zero caller traffic,
fused reads never torn across a mid-burst commit, shutdown drains every
ticket), on the CPU.  Then the port's service against the JAX package's on
the same caller-clocked stream: the same window boundaries and commits,
labels within 20·δ, hard predictions equal away from the cutoff.  Every
wait is bounded.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.core.stream import StreamEngine as JaxStreamEngine
from repro.data import synth as jsynth
from repro.graph import dynamic as jdyn
from repro.serving.lp_service import LPService as JaxLPService
from repro_torch.core.dynlp import DynLP
from repro_torch.core.stream import StreamEngine
from repro_torch.data.synth import StreamSpec, gaussian_mixture_stream
from repro_torch.graph.dynamic import UNLABELED, DynamicGraph
from repro_torch.serving.lp_service import Backpressure, LPService

torch.set_num_threads(1)

SPEC = StreamSpec(total_vertices=300, batch_size=60, seed=7, class_sep=6.0, noise=0.9)
RNG = np.random.default_rng(0)
WAIT_S = 60.0  # bound on every wait below


def _service(graph, **kw):
    eng = StreamEngine(graph, delta=1e-4, device="cpu")
    kw.setdefault("window_ops", 10_000)
    kw.setdefault("window_ms", 1e9)  # admission only via flush()/window
    kw.setdefault("max_pending_ops", 100_000)
    return LPService(eng, **kw)


def _split_mutations(svc, batch, parts=3):
    """Feed one stream batch as ``parts`` mutations (deletes ride on the
    first): the coalesced window must equal the original batch."""
    n = len(batch.ins_emb)
    cuts = [(i * n) // parts for i in range(parts + 1)]
    tickets = [svc.mutate(ins_emb=batch.ins_emb[cuts[0]:cuts[1]],
                          ins_labels=batch.ins_labels[cuts[0]:cuts[1]],
                          del_ids=batch.del_ids)]
    for a, b in zip(cuts[1:], cuts[2:]):
        tickets.append(svc.mutate(ins_emb=batch.ins_emb[a:b], ins_labels=batch.ins_labels[a:b]))
    return tickets


# ---------------------------------------------------------------------- #
# tests/test_lp_service.py, single device
# ---------------------------------------------------------------------- #
def test_committed_queries_match_full_dynlp_recompute():
    """After every commit the served labels are bit-identical to a full
    ``DynLP`` recompute over the same coalesced batches."""
    g = DynamicGraph(emb_dim=SPEC.emb_dim, k=5)
    svc = _service(g)
    g_ref = DynamicGraph(emb_dim=SPEC.emb_dim, k=5)
    dyn = DynLP(g_ref, delta=1e-4, device="cpu")
    for batch, _ in gaussian_mixture_stream(SPEC):
        tickets = _split_mutations(svc, batch)
        admitted = svc.flush()
        assert len(admitted.ins_emb) == len(batch.ins_emb)
        np.testing.assert_array_equal(admitted.del_ids, batch.del_ids)
        st = svc.sync()
        assert st is not None and st.converged
        assert all(t.committed and t.latency_ms >= 0 for t in tickets)
        dyn.step(batch)

        view = svc.committed_view()
        np.testing.assert_array_equal(view.f, g_ref.f)
        np.testing.assert_array_equal(view.alive, g_ref.alive)
        ids = np.flatnonzero(g_ref.alive)
        res = svc.query(ids)
        seeded = g_ref.labels[ids] != UNLABELED
        want_pred = np.where(seeded, g_ref.labels[ids], (g_ref.f[ids] >= 0.5).astype(np.int8))
        want_conf = np.where(seeded, 1.0, np.maximum(g_ref.f[ids], 1 - g_ref.f[ids]))
        np.testing.assert_array_equal(res.pred, want_pred)
        np.testing.assert_array_equal(res.confidence, want_conf.astype(np.float32))
        assert res.commit_id == svc.engine.commits


def test_inflight_queries_serve_previous_commit_no_torn_reads():
    """Between admission and commit the host graph is already mutated;
    queries keep answering from the previous committed snapshot."""
    g = DynamicGraph(emb_dim=SPEC.emb_dim, k=5)
    svc = _service(g)
    prev_f, prev_alive = g.f.copy(), g.alive.copy()
    for batch, _ in gaussian_mixture_stream(SPEC):
        base = g.num_nodes
        _split_mutations(svc, batch)
        svc.flush()  # admits: solve in flight, NOT committed
        assert svc.engine.in_flight
        view = svc.committed_view()
        np.testing.assert_array_equal(view.f, prev_f)
        np.testing.assert_array_equal(view.alive, prev_alive)
        assert g.num_nodes > base  # the live graph HAS changed...
        res = svc.query(np.arange(base, g.num_nodes))  # ...but not for readers
        assert (res.pred == UNLABELED).all() and (res.confidence == 0).all()
        svc.sync()
        prev_f, prev_alive = g.f.copy(), g.alive.copy()
    assert svc.stats().queries_while_inflight > 0


def test_pipelined_windows_match_sync_per_batch():
    """Back-to-back window admissions (submit overlapping the previous
    solve, commits harvested by poll) land on the same labels as the
    one-batch-at-a-time service."""
    g_p = DynamicGraph(emb_dim=SPEC.emb_dim, k=5)
    piped = _service(g_p, window_ops=SPEC.batch_size)
    g_s = DynamicGraph(emb_dim=SPEC.emb_dim, k=5)
    synced = _service(g_s)
    for batch, _ in gaussian_mixture_stream(SPEC):
        piped.mutate(ins_emb=batch.ins_emb, ins_labels=batch.ins_labels, del_ids=batch.del_ids)
        synced.mutate(ins_emb=batch.ins_emb, ins_labels=batch.ins_labels,
                      del_ids=batch.del_ids)
        synced.flush()
        synced.sync()
    piped.sync()
    np.testing.assert_array_equal(piped.committed_view().f, synced.committed_view().f)
    st = piped.stats()
    assert st.batches_admitted == st.batches_committed == 5
    assert st.commit_latency_ms["count"] == st.mutations


def test_admission_window_deadline_and_size():
    rng = np.random.default_rng(0)
    g = DynamicGraph(emb_dim=4, k=3)
    svc = LPService(StreamEngine(g, delta=1e-4, device="cpu"), window_ops=8, window_ms=1e9)
    svc.mutate(ins_emb=rng.normal(0, 1, (3, 4)).astype(np.float32),
               ins_labels=np.array([0, 1, UNLABELED], np.int8))
    assert svc.stats().batches_admitted == 0  # below the size bound
    assert svc.stats().pending_ops == 3
    svc.mutate(ins_emb=rng.normal(0, 1, (5, 4)).astype(np.float32))
    assert svc.stats().batches_admitted == 1  # crossing it admits at once
    svc.sync()
    svc.window_ms = 0.0  # a zero deadline admits at the next pump
    svc.mutate(del_ids=np.array([0], np.int64))
    svc.pump()
    assert svc.stats().batches_admitted == 2
    svc.sync()
    assert svc.stats().pending_ops == 0


def test_backpressure_reject_and_block(monkeypatch):
    rng = np.random.default_rng(1)
    g = DynamicGraph(emb_dim=4, k=3)
    eng = StreamEngine(g, delta=1e-4, device="cpu")
    svc = LPService(eng, window_ops=4, window_ms=1e9, max_pending_ops=8,
                    reject_on_overload=True)
    # a busy device: poll never commits, so admitted ops pin the queue
    monkeypatch.setattr(eng, "poll", lambda: None)
    svc.mutate(ins_emb=rng.normal(0, 1, (4, 4)).astype(np.float32),
               ins_labels=np.array([0, 1, UNLABELED, UNLABELED], np.int8))
    assert svc.stats().batches_admitted == 1
    svc.mutate(ins_emb=rng.normal(0, 1, (3, 4)).astype(np.float32))
    with pytest.raises(Backpressure):
        svc.mutate(ins_emb=rng.normal(0, 1, (2, 4)).astype(np.float32))
    assert svc.stats().rejected == 1
    svc.reject_on_overload = False  # blocking mode drains instead
    t = svc.mutate(ins_emb=rng.normal(0, 1, (2, 4)).astype(np.float32))
    assert svc.stats().pending_ops <= 8
    svc.sync()
    assert t.committed
    with pytest.raises(Backpressure):  # can never fit: rejected in either mode
        svc.mutate(ins_emb=rng.normal(0, 1, (9, 4)).astype(np.float32))
    assert svc.stats().rejected == 2


def test_query_before_any_commit_and_validation():
    g = DynamicGraph(emb_dim=4, k=3)
    svc = _service(g)
    res = svc.query([0, 5, -3])
    assert (res.pred == UNLABELED).all() and (res.confidence == 0).all()
    assert res.commit_id == 0
    assert svc.committed_view().num_nodes == 0
    with pytest.raises(ValueError, match="empty mutation"):
        svc.mutate()
    with pytest.raises(ValueError, match="ins_labels"):
        svc.mutate(ins_emb=np.zeros((2, 4), np.float32), ins_labels=np.zeros(3, np.int8))


def test_service_stats_counts():
    g = DynamicGraph(emb_dim=SPEC.emb_dim, k=5)
    svc = _service(g)
    for batch, _ in gaussian_mixture_stream(SPEC):
        svc.mutate(ins_emb=batch.ins_emb, ins_labels=batch.ins_labels, del_ids=batch.del_ids)
        svc.flush()
        svc.query(np.arange(4))
        svc.sync()
    st = svc.stats()
    assert st.mutations == 5 and st.batches_committed == 5
    assert st.queries == 5 and st.query_nodes == 20
    assert st.queries_while_inflight == 5
    assert st.pending_ops == 0 and st.rejected == 0
    assert st.commit_latency_ms["count"] == 5
    assert st.commit_latency_ms["p50"] <= st.commit_latency_ms["max"]
    assert st.recompiles <= st.bucket_rungs


# ---------------------------------------------------------------------- #
# tests/test_service_driver.py, single device
# ---------------------------------------------------------------------- #
def _driven(**kw):
    g = DynamicGraph(emb_dim=8, k=4)
    kw.setdefault("window_ops", 64)
    kw.setdefault("window_ms", 15.0)
    return LPService(StreamEngine(g, delta=1e-3, device="cpu"), **kw)


def _labeled(n, base=0):
    """n vertices with the deterministic label pattern (i + base) % 2."""
    emb = RNG.normal(size=(n, 8)).astype(np.float32)
    lab = ((np.arange(n) + base) % 2).astype(np.int8)
    return emb, lab


def _wait_until(cond, timeout=WAIT_S, msg="condition"):
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {msg}")
        time.sleep(0.005)


def test_deadline_fires_with_zero_caller_traffic():
    """One small mutation, then NO further calls: the driver's clock closes
    the window at its deadline and commits the batch on its own."""
    svc = _driven(window_ops=1000, window_ms=25.0)
    with svc:
        t = svc.mutate(*_labeled(4))
        assert not t.committed
        _wait_until(lambda: t.committed, msg="deadline admission + commit")
        st = svc.stats()
        assert st.deadline_admissions >= 1
        assert st.batches_admitted == st.batches_committed == 1
    r = svc.query(np.arange(4))
    assert (r.pred >= 0).all() and (r.confidence == 1.0).all()


def test_concurrent_readers_never_torn_across_commits():
    """Reader threads hammer the service while commits land mid-burst.
    Seeds arrive in id order with a fixed label pattern, and one window
    inserts a contiguous block, so every coherent view knows a PREFIX of
    the ids; a torn read would show a hole or a wrong label."""
    svc = _driven(window_ops=8, window_ms=2.0)
    total = 160
    stop = threading.Event()
    failures: list[str] = []

    def reader():
        ids = np.arange(total)
        while not stop.is_set():
            r = svc.query(ids)
            known = r.pred != UNLABELED
            if known.any():
                k = int(np.flatnonzero(known).max()) + 1
                if not known[:k].all():
                    failures.append(f"non-prefix visibility at commit {r.commit_id}")
                    return
                if not np.array_equal(r.pred[:k], (np.arange(k) % 2).astype(np.int8)):
                    failures.append(f"wrong labels at commit {r.commit_id}")
                    return
                if not (r.confidence[:k] == 1.0).all():
                    failures.append("seed confidence != 1.0")
                    return
            if not (r.confidence[~known] == 0.0).all():
                failures.append("unknown ids with nonzero confidence")
                return

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # interleave the threads as finely as it goes
    try:
        with svc:
            threads = [threading.Thread(target=reader) for _ in range(4)]
            for th in threads:
                th.start()
            done = 0
            while done < total:
                n = min(8, total - done)
                svc.mutate(*_labeled(n, base=done))
                done += n
                time.sleep(0.002)
            svc.sync()
            stop.set()
            for th in threads:
                th.join(WAIT_S)
            assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(switch)
    assert not failures, failures
    assert (svc.query(np.arange(total)).pred != UNLABELED).all()


def test_stop_drains_inflight_tickets():
    """Every ticket queued before stop() is fulfilled, not abandoned."""
    svc = _driven()
    with svc:
        svc.mutate(*_labeled(16))
        svc.sync()
        tickets = [svc.query_async(RNG.integers(0, 16, 32)) for _ in range(64)]
    assert all(t.done for t in tickets)
    assert all(t.wait(0.1).pred.shape == (32,) for t in tickets)
    assert not svc.driver_running


def test_reads_batch_across_concurrent_callers():
    """Concurrent async reads fuse: fewer gathers than tickets."""
    svc = _driven()
    with svc:
        svc.mutate(*_labeled(32))
        svc.sync()
        tickets = [svc.query_async(RNG.integers(0, 32, 16)) for _ in range(100)]
        for t in tickets:
            t.wait(WAIT_S)
        st = svc.stats()
        assert st.read_tickets == 100
        assert st.read_batches < st.read_tickets
        assert st.queries == 100


def test_async_results_match_host_view_semantics():
    """Fused gathers answer exactly like ``LabelView.query``, dead,
    unknown and out-of-range ids included."""
    svc = _driven()
    with svc:
        svc.mutate(*_labeled(24))
        svc.mutate(ins_emb=RNG.normal(size=(8, 8)).astype(np.float32))
        svc.sync()
        svc.mutate(del_ids=np.arange(3))
        svc.sync()
        ids = np.array([-5, 0, 1, 2, 5, 23, 24, 30, 31, 32, 10 ** 6, 2 ** 33])
        got = svc.query_async(ids, cutoff=0.4).wait(WAIT_S)
    want_pred, want_conf = svc.committed_view().query(ids, cutoff=0.4)
    assert got.pred.tobytes() == want_pred.tobytes()
    assert got.confidence.tobytes() == want_conf.tobytes()


def test_driver_lifecycle_idempotent_and_restartable():
    svc = _driven()
    svc.start()
    svc.start()  # idempotent
    assert svc.driver_running
    svc.stop()
    assert not svc.driver_running
    svc.start()  # restart after stop
    svc.mutate(*_labeled(4))
    svc.sync()
    assert svc.query(np.arange(4)).pred.shape == (4,)
    svc.close()
    assert not svc.driver_running


# ---------------------------------------------------------------------- #
# against the JAX package's service
# ---------------------------------------------------------------------- #
DELTA = 1e-4


@pytest.mark.parametrize("ingest", ["host", "device"])
def test_service_matches_reference_service(ingest):
    """The same caller-clocked mutations (each batch split in three, one
    window a batch, pipelined) through both services: the same admitted
    windows and commits, byte-identical graphs, labels within 20·δ and the
    same hard predictions where |F − 0.5| > 20·δ."""
    spec = dict(total_vertices=240, batch_size=60, emb_dim=8, seed=8, class_sep=6.0,
                noise=0.9)
    jg, tg = jdyn.DynamicGraph(8, k=4), DynamicGraph(8, k=4)
    opts = dict(window_ops=60, window_ms=1e9, max_pending_ops=100_000)
    jsvc = JaxLPService(JaxStreamEngine(jg, delta=DELTA, backend="ref", ingest=ingest), **opts)
    tsvc = LPService(StreamEngine(tg, delta=DELTA, ingest=ingest, device="cpu"), **opts)
    for (jb, _), (tb, _) in zip(jsynth.gaussian_mixture_stream(jsynth.StreamSpec(**spec)),
                                gaussian_mixture_stream(StreamSpec(**spec))):
        for svc, b in ((jsvc, jb), (tsvc, tb)):
            _split_mutations(svc, b)
        js, ts = jsvc.stats(), tsvc.stats()
        assert (js.batches_admitted, js.batches_committed, js.pending_ops) == \
            (ts.batches_admitted, ts.batches_committed, ts.pending_ops)
    jsvc.sync(), tsvc.sync()
    js, ts = jsvc.stats(), tsvc.stats()
    assert js.batches_committed == ts.batches_committed == 4
    assert jsvc.engine.commits == tsvc.engine.commits
    for name in ("src", "dst", "wgt", "knn_idx", "knn_wgt", "alive", "labels"):
        assert getattr(jg, name).tobytes() == getattr(tg, name).tobytes(), name
    ids = np.arange(-2, tg.num_nodes + 2)
    jres, tres = jsvc.query(ids), tsvc.query(ids)
    assert jres.commit_id == tres.commit_id
    unl = np.flatnonzero(tg.alive & (tg.labels == UNLABELED))
    assert np.abs(jg.f[unl] - tg.f[unl]).max(initial=0) <= 20 * DELTA
    away = np.abs(tg.f[np.clip(ids, 0, tg.num_nodes - 1)] - 0.5) > 20 * DELTA
    np.testing.assert_array_equal(np.asarray(jres.pred)[away], tres.pred[away])
    np.testing.assert_allclose(np.asarray(jres.confidence), tres.confidence, atol=20 * DELTA)
