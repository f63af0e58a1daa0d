"""Port vs reference, device ingest: the embedding store and the
``DeviceIngestor`` selector.

The store's tensors must equal the reference store's arrays byte for byte
after the same updates.  Graphs built through the port's ``DeviceIngestor``
must equal the port's host selector's and the reference's device
ingestor's byte for byte (kNN lists and the undirected edge arrays): the
selector only nominates candidate supersets, and the canonical
re-selection is shared numpy code (``graph.knn`` docstring).
"""

import numpy as np
import pytest
import torch

from repro.graph import dynamic as jdyn
from repro.ingest import DeviceIngestor as JaxDeviceIngestor
from repro.ingest.embedding_store import EmbeddingStore as JaxEmbeddingStore
from repro_torch import telemetry
from repro_torch.graph.dynamic import UNLABELED, BatchUpdate, DynamicGraph
from repro_torch.graph.knn import build_knn_graph
from repro_torch.ingest import DeviceIngestor, ingest_cache_size, ingest_ladder_bound
from repro_torch.ingest import embedding_store
from repro_torch.ingest.embedding_store import EmbeddingStore, cap_bucket, dim_pad

torch.set_num_threads(1)

GRAPH = ("knn_idx", "knn_wgt", "src", "dst", "wgt")
NONE = np.zeros(0, np.int64)


def _insert_stream(rng, emb_dim, n_batches, max_batch):
    sizes = [int(rng.integers(0, max_batch + 1)) for _ in range(n_batches)]
    sizes[0] = max(sizes[0], 3)
    sizes[min(1, n_batches - 1)] = 1  # a singleton batch
    if n_batches > 2:
        sizes[2] = 0  # an empty batch
    return [rng.normal(size=(s, emb_dim)).astype(np.float32) for s in sizes]


def _apply(g, emb, dels, selector, batch_cls=BatchUpdate):
    g.apply_batch(batch_cls(ins_emb=emb, ins_labels=np.full(len(emb), UNLABELED, np.int8),
                            del_ids=dels), selector=selector)


def _same_graph(a, b, what=""):
    for name in GRAPH:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), (what, name)


def _same_store(jstore, tstore):
    for name in ("emb", "valid", "kth"):
        j = np.asarray(getattr(jstore, name))
        t = getattr(tstore, name).numpy()
        assert j.dtype == t.dtype and j.shape == t.shape and j.tobytes() == t.tobytes(), name
    assert (jstore.count, jstore.capacity, jstore.dp) == (tstore.count, tstore.capacity,
                                                          tstore.dp)


# --------------------------------------------------------------------- #
# the embedding store against the reference's
# --------------------------------------------------------------------- #
def test_store_ladder_growth_and_padding():
    js, ts = JaxEmbeddingStore(emb_dim=10), EmbeddingStore(emb_dim=10, device="cpu")
    assert ts.dp == dim_pad(10) == 16
    assert ts.capacity == cap_bucket(1) == 1024
    rng = np.random.default_rng(0)
    for n, cap, grows in ((700, 1024, 0), (700, 2048, 1)):
        x = rng.normal(size=(n, 10)).astype(np.float32)
        jb, jv, jbase = js.append(x)
        tb, tv, tbase = ts.append(x)
        assert ts.capacity == cap and ts.grows == grows and tbase == jbase
        assert np.asarray(jb).tobytes() == tb.numpy().tobytes()
        assert np.asarray(jv).tobytes() == tv.numpy().tobytes()
        _same_store(js, ts)
    assert ts.count == 1400 and ts.appends == 2
    assert ts.valid[:1400].all() and not ts.valid[1400:].any()
    assert (ts.emb[:, 10:] == 0).all()  # padded feature columns stay zero
    assert ts.device_bytes() == 2048 * 16 * 4 + 2048 + 2048 * 4


def test_store_kill_and_kth_roundtrip():
    js, ts = JaxEmbeddingStore(emb_dim=4), EmbeddingStore(emb_dim=4, device="cpu")
    x = np.random.default_rng(1).normal(size=(50, 4)).astype(np.float32)
    js.append(x)
    ts.append(x)
    dead = np.array([3, 7, 11, 5000], np.int64)  # 5000 is out of range: dropped
    js.kill(dead)
    ts.kill(dead)
    assert not ts.valid[[3, 7, 11]].any() and int(ts.valid[:50].sum()) == 47
    rows, vals = np.array([5, 9, 4096], np.int64), np.array([0.25, 0.75, 0.5], np.float32)
    js.set_kth(rows, vals)
    ts.set_kth(rows, vals)
    assert float(ts.kth[5]) == 0.25 and float(ts.kth[9]) == 0.75
    _same_store(js, ts)


def test_store_state_arrays_roundtrip():
    ts = EmbeddingStore(emb_dim=6, device="cpu")
    ts.append(np.random.default_rng(2).normal(size=(30, 6)).astype(np.float32))
    snap = ts.state_arrays()
    ts.kill(np.array([0, 1], np.int64))  # in place: the snapshot is a copy
    assert snap["valid"][:2].all()
    back = EmbeddingStore(emb_dim=6, device="cpu")
    back.load_state_arrays(snap, count=30)
    for name in ("emb", "valid", "kth"):
        assert torch.equal(getattr(back, name), snap[name])
    with pytest.raises(ValueError, match="padded dim"):
        EmbeddingStore(emb_dim=20, device="cpu").load_state_arrays(snap, count=30)


# --------------------------------------------------------------------- #
# DeviceIngestor streams
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seed,n_batches,k,emb_dim", [(0, 5, 3, 12), (1, 8, 5, 4),
                                                      (2, 4, 2, 32)])
def test_device_insert_stream_bit_identical_to_rebuild(seed, n_batches, k, emb_dim):
    """Insert streams (empty and singleton batches included): the CSR
    snapshot equals a from-scratch ``build_knn_graph`` bit for bit."""
    rng = np.random.default_rng(seed)
    batches = _insert_stream(rng, emb_dim, n_batches, 24)
    g = DynamicGraph(emb_dim, k=k)
    ing = DeviceIngestor(emb_dim, device="cpu")
    telemetry.enable()
    try:
        for b in batches:
            _apply(g, b, NONE, ing)
    finally:
        telemetry.disable()
    selects = sum(s.name == "ingest.select" for s in telemetry.take().spans)
    ref = build_knn_graph(np.concatenate(batches), k=k)
    csr, ids = g.snapshot_csr()
    np.testing.assert_array_equal(ids, np.arange(g.num_nodes))
    for name in ("rowptr", "col", "wgt"):
        assert np.asarray(getattr(csr, name)).tobytes() == \
            np.asarray(getattr(ref, name)).tobytes(), name
    assert selects == sum(len(b) > 0 for b in batches)


@pytest.mark.parametrize("seed,n_batches,k,frac_del", [(3, 6, 3, 0.2), (4, 5, 5, 0.3),
                                                       (5, 7, 2, 0.1)])
def test_device_matches_host_selector_mixed_stream(seed, n_batches, k, frac_del):
    """Mixed insert/delete streams: the port's device selector equals its
    host selector batch for batch, lists and undirected edges."""
    rng = np.random.default_rng(seed)
    batches = _insert_stream(rng, 12, n_batches, 20)
    gh, gd = DynamicGraph(12, k=k), DynamicGraph(12, k=k)
    ing = DeviceIngestor(12, device="cpu")
    total = 0
    for t, b in enumerate(batches):
        n_del = int(round(frac_del * len(b))) if total else 0
        dels = (rng.choice(total, size=min(n_del, total), replace=False).astype(np.int64)
                if n_del else NONE)
        _apply(gh, b, dels, None)
        _apply(gd, b, dels, ing)
        total += len(b)
        _same_graph(gh, gd, t)


def test_device_ingest_matches_reference_stream():
    """The port's DeviceIngestor and the reference's, fed the same mixed
    stream: graphs and stores byte-identical after every batch."""
    rng = np.random.default_rng(6)
    jg, tg = jdyn.DynamicGraph(10, k=4), DynamicGraph(10, k=4)
    jing, ting = JaxDeviceIngestor(10), DeviceIngestor(10, device="cpu")
    total = 0
    for t, b in enumerate(_insert_stream(rng, 10, 7, 30)):
        dels = (rng.choice(total, size=3, replace=False).astype(np.int64)
                if total > 6 else NONE)
        _apply(jg, b, dels, jing, jdyn.BatchUpdate)
        _apply(tg, b, dels, ting)
        total += len(b)
        _same_graph(jg, tg, t)
        _same_store(jing.store, ting.store)


def test_mass_duplicates_tie_break():
    """All-identical points: deep ties resolve to the same lowest-id
    neighbors on both selectors."""
    dup = np.ones((20, 6), np.float32)
    gh, gd = DynamicGraph(6, k=3), DynamicGraph(6, k=3)
    ing = DeviceIngestor(6, device="cpu")
    for lo, hi in [(0, 9), (9, 20)]:
        _apply(gh, dup[lo:hi], NONE, None)
        _apply(gd, dup[lo:hi], NONE, ing)
    _same_graph(gh, gd)
    np.testing.assert_array_equal(gd.knn_idx[0], [1, 2, 3])


def test_attach_and_lazy_attach_adopt_existing_rows():
    """An ingestor that joins a graph built on the host (explicitly, or
    lazily at its first batch) goes on byte-identical to the host path."""
    rng = np.random.default_rng(7)
    batches = [rng.normal(size=(n, 8)).astype(np.float32) for n in (15, 9, 12)]
    gh, ga, gl = (DynamicGraph(8, k=3) for _ in range(3))
    for g in (gh, ga, gl):
        _apply(g, batches[0], NONE, None)
    attached = DeviceIngestor(8, device="cpu")
    attached.attach(ga)
    assert attached.store.count == ga.num_nodes
    lazy = DeviceIngestor(8, device="cpu")
    for b in batches[1:]:
        dels = np.array([2, 5], np.int64)
        _apply(gh, b, dels, None)
        _apply(ga, b, dels, attached)
        _apply(gl, b, dels, lazy)
        _same_graph(gh, ga, "attach")
        _same_graph(gh, gl, "lazy")


def test_ingest_cache_within_ladder_bound():
    """tests/test_ingest.py's stream on the port: the shapes the store and
    the kernel run at stay under the a-priori ladder bound, and each one
    seen first ticks the recorder's ``ingest.new_shapes`` counter."""
    rng = np.random.default_rng(2)
    emb_dim, k = 16, 4
    g = DynamicGraph(emb_dim, k=k)
    ing = DeviceIngestor(emb_dim, device="cpu")
    c0 = ingest_cache_size()
    total = 0
    telemetry.enable()
    try:
        for t in range(30):
            m = int(rng.integers(1, 33))
            dels = (rng.choice(total, size=4, replace=False).astype(np.int64)
                    if t % 6 == 5 and total > 8 else NONE)
            _apply(g, rng.normal(size=(m, emb_dim)).astype(np.float32), dels, ing)
            total += m
    finally:
        telemetry.disable()
    new = telemetry.take().counters.get("ingest.new_shapes", 0)
    assert ingest_cache_size() - c0 == new <= ingest_ladder_bound(total, 32)


def test_ingestor_out_of_sync_raises():
    g1, g2 = DynamicGraph(6, k=3), DynamicGraph(6, k=3)
    ing = DeviceIngestor(6, device="cpu")
    rng = np.random.default_rng(4)
    _apply(g1, rng.normal(size=(5, 6)).astype(np.float32), NONE, ing)
    _apply(g2, rng.normal(size=(3, 6)).astype(np.float32), NONE, None)
    with pytest.raises(RuntimeError, match="out of sync"):
        _apply(g2, rng.normal(size=(4, 6)).astype(np.float32), NONE, ing)


def test_ingest_shapes_within_ladder_bound(monkeypatch):
    """One stream: the distinct update/kernel shapes stay under the a-priori
    ladder bound, which does not grow with the stream's length."""
    # the registry is per process: start it empty, so shapes that an
    # earlier test in this process ran at count for this stream too
    monkeypatch.setattr(embedding_store, "_SHAPES", set())
    rng = np.random.default_rng(2)
    g = DynamicGraph(16, k=4)
    ing = DeviceIngestor(16, device="cpu", capacity_floor=8)
    c0 = ingest_cache_size()
    total = 0
    for t in range(30):
        m = int(rng.integers(1, 33))
        dels = (rng.choice(total, size=4, replace=False).astype(np.int64)
                if t % 6 == 5 and total > 8 else NONE)
        _apply(g, rng.normal(size=(m, 16)).astype(np.float32), dels, ing)
        total += m
    assert 0 < ingest_cache_size() - c0 <= ingest_ladder_bound(total, 32)
    # one capacity rung, one batch rung, eight scatter rungs (8 ... 1024)
    assert ingest_ladder_bound(1024, 8) == 1 + 1 + 0 + 8 + 8
