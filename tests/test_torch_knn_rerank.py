"""The canonical re-selection on the card's plain version, and where the
stream takes it.

``rerank_ref`` (``kernels/knn_rerank.py``) must give the bits of the host's
``topk_pairs(pair_weights(...), cand, k)`` (``graph.knn``) at every width:
the weights numpy's pairwise sum, the order (weight desc, id asc), empty
slots (-1, -inf).  ``DeviceIngestor`` on a single-device store leaves its
candidates on the device and re-selects them through it, counting
``graph.rerank_store_rows``; the host selector and a mesh store keep the
host's code, and every path gives the same graph.  The kernel is held to
``rerank_ref`` on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from repro_torch import telemetry
from repro_torch.core.distributed import DeviceMesh
from repro_torch.graph.dynamic import UNLABELED, BatchUpdate, DynamicGraph, HostKNNSelector
from repro_torch.graph.knn import normalize_rows, pair_weights, topk_pairs
from repro_torch.ingest import DeviceIngestor
from repro_torch.ingest.embedding_store import dim_pad
from repro_torch.kernels.knn_rerank import pairwise_sum, rerank_candidates, rerank_ref

torch.set_num_threads(1)

GRAPH = ("knn_idx", "knn_wgt", "src", "dst", "wgt")


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _host_lists(emb, base, cand, k):
    """The host's re-selection (``DynamicGraph.apply_batch``'s numpy path)."""
    cand = np.asarray(cand, np.int64)
    cw = np.full(cand.shape, -np.inf, np.float32)
    qr, qc = np.nonzero(cand >= 0)
    if len(qr):
        cw[qr, qc] = pair_weights(emb[base:][qr], emb[cand[qr, qc]])
    return topk_pairs(cw, cand, k)


def _inputs(rng, d, tk, m=64, c=400, dp=None):
    """A store of ``c`` rows (the batch's ``m`` last) padded to ``dp``
    columns, and (m, tk) candidates: -1 slots, rows with fewer than k
    valid, a third of the rows copies of one row (ties on weight, so the
    id decides), some rows all empty."""
    emb = normalize_rows(rng.normal(size=(c, d)).astype(np.float32))
    emb[::3] = emb[1]
    dp = dim_pad(d) if dp is None else dp
    store = np.zeros((c, dp), np.float32)
    store[:, :d] = emb
    base = c - m
    cand = np.stack([rng.choice(base, size=tk, replace=False) for _ in range(m)])
    cand[rng.random((m, tk)) < 0.2] = -1
    cand[::5, tk // 3:] = -1  # fewer than k valid
    cand[7] = -1
    return emb, store, base, cand.astype(np.int32)


@pytest.mark.parametrize("n", [1, 3, 7, 8, 9, 12, 13, 16, 100, 127, 128, 129, 200, 256, 384])
def test_pairwise_sum_is_numpys_sum(n):
    rng = np.random.default_rng(n)
    p = rng.normal(size=(300, 3, n)).astype(np.float32) * np.float32(1e3) ** rng.integers(
        -1, 2, size=(300, 3, n))
    p = p.astype(np.float32)
    want = p.sum(axis=-1, dtype=np.float32)
    got = pairwise_sum(torch.from_numpy(p)).numpy()
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("d", [3, 5, 8, 12, 13, 16, 100, 128])
@pytest.mark.parametrize("tk,k", [(1, 1), (1, 5), (11, 3), (11, 20), (13, 5), (13, 13),
                                  (32, 5), (32, 40)])
def test_rerank_ref_gives_the_hosts_bits(d, tk, k):
    rng = np.random.default_rng(1000 * d + tk + k)
    emb, store, base, cand = _inputs(rng, d, tk)
    want_i, want_w = _host_lists(emb, base, cand, k)
    got_i, got_w = rerank_ref(torch.from_numpy(store), base, torch.from_numpy(cand), d=d, k=k)
    assert got_i.dtype == torch.int64 and got_w.dtype == torch.float32
    assert np.array_equal(got_i.numpy(), want_i)
    assert np.array_equal(_bits(got_w.numpy()), _bits(want_w))


@pytest.mark.parametrize("d,dp", [(12, 64), (16, 128), (100, 128), (3, 8)])
def test_rerank_sums_the_true_width_of_a_wider_store(d, dp):
    """Zero columns past ``d`` would move the eight running sums (at d = 12
    numpy adds terms 8..11 after the tree): the sum runs over ``d``."""
    rng = np.random.default_rng(d + dp)
    emb, store, base, cand = _inputs(rng, d, 13, dp=dp)
    want_i, want_w = _host_lists(emb, base, cand, 5)
    got_i, got_w = rerank_candidates(torch.from_numpy(store), base, torch.from_numpy(cand),
                                     d=d, k=5)
    assert np.array_equal(got_i.numpy(), want_i)
    assert np.array_equal(_bits(got_w.numpy()), _bits(want_w))


def test_rerank_takes_int64_ids_and_an_empty_batch():
    rng = np.random.default_rng(3)
    emb, store, base, cand = _inputs(rng, 16, 13)
    st = torch.from_numpy(store)
    a = rerank_candidates(st, base, torch.from_numpy(cand), d=16, k=5)
    b = rerank_candidates(st, base, torch.from_numpy(cand.astype(np.int64)), d=16, k=5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    i, w = rerank_candidates(st, base, torch.zeros((0, 13), dtype=torch.int32), d=16, k=5)
    assert i.shape == w.shape == (0, 5)


def test_rerank_refuses_what_it_cannot_read():
    st = torch.zeros((64, 16))
    cand = torch.zeros((4, 13), dtype=torch.int32)
    with pytest.raises(ValueError):
        rerank_candidates(st, 62, cand, d=16, k=5)  # rows past the store
    with pytest.raises(ValueError):
        rerank_candidates(st, 0, cand, d=17, k=5)  # wider than the store
    with pytest.raises(ValueError):
        rerank_candidates(st, 0, cand, d=16, k=0)
    with pytest.raises(TypeError):
        rerank_candidates(st, 0, cand.float(), d=16, k=5)
    with pytest.raises(TypeError):
        rerank_candidates(st.double(), 0, cand, d=16, k=5)


def _stream(selector, emb_dim=12, k=4, seed=0, sizes=(40, 1, 0, 25, 33)):
    """Mixed batches (insertions, a singleton, an empty one, deletions)
    through ``selector``; returns the graph and each inserting batch's
    size."""
    rng = np.random.default_rng(seed)
    g = DynamicGraph(emb_dim, k=k)
    total = 0
    for s in sizes:
        dels = (rng.choice(total, size=total // 6, replace=False).astype(np.int64)
                if total else np.zeros(0, np.int64))
        emb = rng.normal(size=(s, emb_dim)).astype(np.float32)
        emb[: s // 4] = emb[:1]  # duplicates: ties the id order decides
        g.apply_batch(BatchUpdate(ins_emb=emb, ins_labels=np.full(s, UNLABELED, np.int8),
                                  del_ids=dels), selector=selector)
        total += s
    return g, [s for s in sizes if s]


@pytest.mark.parametrize("path", ["store", "host", "mesh"])
def test_rerank_store_rows_counts_the_rows_reranked_on_the_device(path):
    selector = {"store": lambda: DeviceIngestor(12, device="cpu"),
                "host": lambda: None,
                "mesh": lambda: DeviceIngestor(12, mesh=DeviceMesh.local(4, device="cpu"))}[path]()
    telemetry.enable()
    try:
        g, inserted = _stream(selector)
        rec = telemetry.take()
    finally:
        telemetry.disable()
    want = sum(inserted) if path == "store" else 0
    assert rec.counters.get("graph.rerank_store_rows", 0) == want
    assert sum(s.name == "graph.rerank" for s in rec.spans) == len(inserted)
    host, _ = _stream(HostKNNSelector() if path != "host" else None)
    for name in GRAPH:
        assert getattr(g, name).tobytes() == getattr(host, name).tobytes(), name


def test_select_leaves_the_candidates_on_the_device_and_rerank_reads_them():
    """The store path hands ``apply_batch`` a device tensor of (M, TK) ids;
    a fault planted in it after ``select`` reaches the lists."""

    class Faulty(DeviceIngestor):
        def select(self, g, new_ids, embn_new):
            sel = super().select(g, new_ids, embn_new)
            assert isinstance(sel.cand_idx, torch.Tensor)
            assert sel.cand_idx.shape == (len(new_ids), min(g.k + 8, self.store.capacity))
            sel.cand_idx[:, 0] = -1  # every row loses its best candidate
            return sel

    good, _ = _stream(DeviceIngestor(12, device="cpu"))
    bad, _ = _stream(Faulty(12, device="cpu"))
    assert (good.knn_idx != bad.knn_idx).any(axis=1).mean() > 0.5
