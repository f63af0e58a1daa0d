"""Port vs reference, graph layer: the host state must match byte for byte.

The port's graph modules are numpy copies of the reference's, so the same
batches must give the same edge lists, kNN lists, ``BatchEffect`` arrays and
snapshot arrays, bit for bit (no tolerance: the arithmetic is the same
numpy code on the same inputs).
"""

import numpy as np
import pytest
import torch

from repro.core import snapshot as jsnap
from repro.data import synth as jsynth
from repro.graph import dynamic as jdyn
from repro.graph import knn as jknn
from repro.graph import structures as jstruct
from repro_torch.core import snapshot as tsnap
from repro_torch.data import synth as tsynth
from repro_torch.graph import dynamic as tdyn
from repro_torch.graph import knn as tknn
from repro_torch.graph import structures as tstruct
from repro_torch.state import graph_from_reference

torch.set_num_threads(1)

GRAPH_ARRAYS = ("emb", "embn", "labels", "alive", "f", "knn_idx", "knn_wgt",
                "src", "dst", "wgt")
EFFECT_ARRAYS = ("new_ids", "affected", "gprime_src", "gprime_dst", "gprime_wgt")
HOST_ARRAYS = ("nbr", "wgt", "wl0", "wl1", "valid", "unl_ids", "remap")
# snapshot knobs: defaults, the DynLP wiring (auto_bucket + max_k=4k), a
# tight max_k that truncates, explicit padding, and a hot working set
SNAPSHOT_KNOBS = [
    {}, {"auto_bucket": True, "max_k": 20}, {"max_k": 3},
    {"pad_to": 4096, "k_pad": 16, "row_multiple": 8}, {"hot": "every-other"},
]


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), what


def _batch_pair(batch):
    """The same BatchUpdate for both packages (fresh copies for each)."""
    kw = {f: (None if getattr(batch, f) is None else np.array(getattr(batch, f)))
          for f in ("ins_emb", "ins_labels", "del_ids", "rel_ids", "rel_labels")}
    return jdyn.BatchUpdate(**kw), tdyn.BatchUpdate(**kw)


def _mixed_stream(seed=5):
    """Inserts, deletions and relabels (ground-truth flips and un-labels)."""
    spec = jsynth.StreamSpec(total_vertices=900, batch_size=300, emb_dim=8,
                             seed=seed, class_sep=4.0, noise=1.0)
    rng = np.random.default_rng(seed)
    n = 0
    for batch, _ in jsynth.gaussian_mixture_stream(spec):
        if n:
            rel = rng.choice(n, size=12, replace=False).astype(np.int64)
            batch.rel_ids = rel
            batch.rel_labels = rng.integers(-1, 2, size=12).astype(np.int8)
        n += len(batch.ins_emb)
        yield batch
    # a delete-only and a relabel-only batch close the stream
    yield jdyn.BatchUpdate(ins_emb=np.zeros((0, 8), np.float32),
                           ins_labels=np.zeros(0, np.int8),
                           del_ids=rng.choice(n, size=40, replace=False))
    yield jdyn.BatchUpdate(ins_emb=np.zeros((0, 8), np.float32),
                           ins_labels=np.zeros(0, np.int8),
                           del_ids=np.zeros(0, np.int64),
                           rel_ids=np.arange(0, 60, dtype=np.int64),
                           rel_labels=np.full(60, -1, np.int8))


def _snapshot_kwargs(knobs, g):
    kw = dict(knobs)
    if kw.get("hot") == "every-other":
        kw["hot"] = np.arange(g.num_nodes) % 2 == 0
    return kw


def _check_graphs(jg, tg):
    for name in GRAPH_ARRAYS:
        _same(getattr(jg, name), getattr(tg, name), name)


def test_mixed_stream_state_is_byte_identical():
    jg, tg = jdyn.DynamicGraph(emb_dim=8, k=4), tdyn.DynamicGraph(emb_dim=8, k=4)
    for batch in _mixed_stream():
        jb, tb = _batch_pair(batch)
        je, te = jg.apply_batch(jb), tg.apply_batch(tb)
        for name in EFFECT_ARRAYS:
            _same(getattr(je, name), getattr(te, name), name)
        _check_graphs(jg, tg)
        for knobs in SNAPSHOT_KNOBS:
            jh = jsnap.build_host_problem(jg, **_snapshot_kwargs(knobs, jg),
                                          warned=set())
            th = tsnap.build_host_problem(tg, **_snapshot_kwargs(knobs, tg),
                                          warned=set())
            for name in HOST_ARRAYS:
                _same(getattr(jh, name), getattr(th, name), f"{knobs} {name}")


def test_hub_stream_max_k_truncation_is_byte_identical(caplog):
    """Hubs push the natural K past max_k: the heaviest-edge truncation and
    the K bucket must match the reference's, and the warning fires once per
    engine set for a rung."""
    jg, tg = jdyn.DynamicGraph(emb_dim=8, k=5), tdyn.DynamicGraph(emb_dim=8, k=5)
    warned = set()
    truncated = False
    for (jb, _), (tb, _) in zip(jsynth.hub_stream(n_batches=4, per_hub=30),
                                tsynth.hub_stream(n_batches=4, per_hub=30)):
        jg.apply_batch(jb)
        tg.apply_batch(tb)
        for knobs in ({"max_k": 8, "auto_bucket": True}, {"max_k": 8}):
            jh = jsnap.build_host_problem(jg, warned=set(), **knobs)
            th = tsnap.build_host_problem(tg, warned=warned, **knobs)
            for name in HOST_ARRAYS:
                _same(getattr(jh, name), getattr(th, name), f"{knobs} {name}")
        nat = np.diff(tstruct.coo_to_csr(
            tg.num_nodes, tg.src, tg.dst, tg.wgt).rowptr).max()
        truncated |= nat > 8
    assert truncated, "the hub stream should exceed max_k"
    warnings = [r for r in caplog.records if r.levelname == "WARNING"
                and r.name == "repro_torch.core.snapshot"]
    assert len(warnings) == len(warned) >= 1


@pytest.mark.parametrize("make", ["gaussian_mixture_stream", "locality_stream"])
def test_synth_streams_match(make):
    spec = dict(total_vertices=700, batch_size=250, emb_dim=4, seed=9)
    for (jb, jc), (tb, tc) in zip(getattr(jsynth, make)(jsynth.StreamSpec(**spec)),
                                  getattr(tsynth, make)(tsynth.StreamSpec(**spec))):
        for name in ("ins_emb", "ins_labels", "del_ids"):
            _same(getattr(jb, name), getattr(tb, name), name)
        _same(jc, tc, "classes")


def test_knn_builders_match():
    rng = np.random.default_rng(1)
    emb = rng.normal(0, 1, (300, 6)).astype(np.float32)
    emb[50:60] = emb[40]  # mass duplicates exercise the tie rule
    for a, b in zip(jknn.knn_edges(emb, k=5, block=64),
                    tknn.knn_edges(emb, k=5, block=64)):
        _same(a, b, "knn_edges")
    s, d, w = jknn.knn_edges(emb, k=5)
    for a, b in zip(jknn.symmetrize(300, s, d, w), tknn.symmetrize(300, s, d, w)):
        _same(a, b, "symmetrize")
    jc, tc = jknn.build_knn_graph(emb, k=4), tknn.build_knn_graph(emb, k=4)
    for name in ("rowptr", "col", "wgt"):
        _same(getattr(jc, name), getattr(tc, name), name)
    sim = rng.normal(0, 1, (20, 40)).astype(np.float32)
    _same(jknn.select_candidates(sim, 5), tknn.select_candidates(sim, 5), "cands")
    assert jknn.SELECT_MARGIN == tknn.SELECT_MARGIN
    assert jknn.selection_slack(16) == tknn.selection_slack(16)


@pytest.mark.parametrize("max_degree", [None, 2, 7])
def test_ell_layouts_match(max_degree):
    rng = np.random.default_rng(max_degree or 0)
    n = 80
    src = rng.integers(0, n, 400)
    dst = rng.integers(0, n, 400)
    w = rng.uniform(0.1, 1, 400).astype(np.float32)
    jc, tc = jstruct.coo_to_csr(n, src, dst, w), tstruct.coo_to_csr(n, src, dst, w)
    for name in ("rowptr", "col", "wgt"):
        _same(getattr(jc, name), getattr(tc, name), name)
    for fn in ("csr_to_ell", "csr_to_ell_fast"):
        je = getattr(jstruct, fn)(jc, max_degree=max_degree)
        te = getattr(tstruct, fn)(tc, max_degree=max_degree)
        assert isinstance(te.nbr, torch.Tensor) and te.nbr.dtype == torch.int32
        _same(np.asarray(je.nbr), te.nbr.numpy(), f"{fn} nbr")
        _same(np.asarray(je.wgt), te.wgt.numpy(), f"{fn} wgt")
        _same(np.asarray(je.degrees()), te.degrees().numpy().astype(np.int32), "deg")


def test_graph_from_reference_continues_identically():
    """The reference's state_arrays() → port graph: the next batches give
    the same bytes in both packages."""
    jg = jdyn.DynamicGraph(emb_dim=8, k=4)
    stream = list(_mixed_stream(seed=11))
    for batch in stream[:2]:
        jg.apply_batch(_batch_pair(batch)[0])
    tg = graph_from_reference(jg.state_arrays(), emb_dim=8, k=4)
    _check_graphs(jg, tg)
    for batch in stream[2:]:
        jb, tb = _batch_pair(batch)
        jg.apply_batch(jb)
        tg.apply_batch(tb)
        _check_graphs(jg, tg)


def test_bucket_ladders_match():
    for n in (1, 255, 256, 257, 1000, 28_870, 100_000):
        assert jsnap.bucket(n) == tsnap.bucket(n)
    for k in (1, 8, 9, 20, 24, 64, 65, 200):
        assert jsnap.bucket_k(k) == tsnap.bucket_k(k)
    assert jsnap.ladder_size(100_000, 40) == tsnap.ladder_size(100_000, 40)


def test_label_view_matches():
    jg, tg = jdyn.DynamicGraph(emb_dim=8, k=4), tdyn.DynamicGraph(emb_dim=8, k=4)
    for batch in list(_mixed_stream(seed=2))[:2]:
        jb, tb = _batch_pair(batch)
        jg.apply_batch(jb)
        tg.apply_batch(tb)
    jv, tv = jsnap.LabelView.from_graph(jg, 3), tsnap.LabelView.from_graph(tg, 3)
    ids = np.array([-1, 0, 5, 17, 599, 600, 10**6])
    for a, b in zip(jv.query(ids, 0.4), tv.query(ids, 0.4)):
        _same(a, b, "query")
    for a, b in zip(jv.predictions(), tv.predictions()):
        _same(a, b, "predictions")
