"""The port's read path: ``query_bucket``, ``DeviceLabelView`` and its
publication at drain, against the host ``LabelView`` and the JAX package's
``DeviceLabelView`` on the same arrays.

A read is a gather and adds nothing, so the device view must answer exactly
as the host view does (and as the reference's), for every kind of id:
negative, out of range, beyond int32, dead, seeded and propagated, with a
scalar or a per-id cutoff, and for the empty query.
"""

import numpy as np
import pytest
import torch

from repro.core import snapshot as jsnap
from repro_torch.core import snapshot as tsnap
from repro_torch.core.distributed import DeviceMesh, view_sharding
from repro_torch.core.snapshot import LabelView, ViewSharding, publish_device_view, query_bucket
from repro_torch.core.stream import StreamEngine
from repro_torch.data.synth import StreamSpec, gaussian_mixture_stream
from repro_torch.graph.dynamic import UNLABELED, BatchUpdate, DynamicGraph

torch.set_num_threads(1)

SPEC = StreamSpec(total_vertices=240, batch_size=60, seed=7, class_sep=6.0, noise=0.9)
I32 = np.iinfo(np.int32)


def _arrays(n, seed):
    rng = np.random.default_rng(seed)
    f = rng.random(n).astype(np.float32)
    f[rng.random(n) < 0.1] = 0.5  # exactly at the default cutoff
    labels = np.full(n, UNLABELED, np.int8)
    seeds = rng.random(n) < 0.2
    labels[seeds] = rng.integers(0, 2, int(seeds.sum()))
    alive = rng.random(n) > 0.15
    return f, labels, alive


def _ids(n, seed):
    rng = np.random.default_rng(seed + 1)
    return np.concatenate([
        rng.integers(-3, n + 3, 300), np.arange(n),
        [-1, -7, n, n + 1, I32.max, I32.max + 1, I32.min, I32.min - 1, 2 ** 40, -2 ** 40],
    ]).astype(np.int64)


@pytest.mark.parametrize("q", [0, 1, 255, 256, 257, 1000, 4096, 5000])
def test_query_bucket_matches_reference(q):
    assert query_bucket(q) == jsnap.query_bucket(q)
    assert query_bucket(q) >= max(q, tsnap.QUERY_FLOOR)


@pytest.mark.parametrize("n,seed", [(1, 0), (100, 1), (300, 2), (1000, 3)])
@pytest.mark.parametrize("per_id_cutoff", [False, True])
def test_device_view_matches_host_and_reference(n, seed, per_id_cutoff):
    f, labels, alive = _arrays(n, seed)
    ids = _ids(n, seed)
    cutoff = (np.random.default_rng(seed + 2).random(len(ids)).astype(np.float32)
              if per_id_cutoff else 0.5)
    view = LabelView(f=f.copy(), labels=labels.copy(), alive=alive.copy(), commit_id=3)
    dv = publish_device_view(view, "cpu")
    assert (dv.commit_id, dv.num_nodes, dv.host) == (3, n, view)
    pred, conf = dv.query(ids, cutoff)
    if per_id_cutoff:  # the host view takes one cutoff: ask it id by id
        want = [view.query(ids[i:i + 1], cutoff[i]) for i in range(len(ids))]
        want_pred = np.concatenate([p for p, _ in want])
        want_conf = np.concatenate([c for _, c in want])
    else:
        want_pred, want_conf = view.query(ids, cutoff)
    assert pred.dtype == np.int8 and conf.dtype == np.float32
    assert pred.tobytes() == want_pred.tobytes()
    assert conf.tobytes() == want_conf.tobytes()
    jv = jsnap.LabelView(f=f.copy(), labels=labels.copy(), alive=alive.copy(), commit_id=3)
    jpred, jconf = jsnap.publish_device_view(jv).query(ids, cutoff)
    assert pred.tobytes() == np.asarray(jpred).tobytes()
    assert conf.tobytes() == np.asarray(jconf).tobytes()


def test_empty_query_and_empty_view():
    f, labels, alive = _arrays(50, 4)
    dv = publish_device_view(LabelView(f=f, labels=labels, alive=alive, commit_id=0), "cpu")
    pred, conf = dv.query(np.zeros(0, np.int64))
    assert pred.shape == conf.shape == (0,)
    empty = LabelView(f=np.zeros(0, np.float32), labels=np.zeros(0, np.int8),
                      alive=np.zeros(0, bool), commit_id=0)
    pred, conf = publish_device_view(empty, "cpu").query([0, -1, 5])
    assert (pred == UNLABELED).all() and (conf == 0).all()


def test_padding_rows_publish_dead():
    n = 300
    f, labels, alive = _arrays(n, 5)
    alive[:] = True
    dv = publish_device_view(LabelView(f=f, labels=labels, alive=alive, commit_id=1), "cpu")
    n_pad = tsnap.bucket(n)
    assert dv.f.shape == dv.labels.shape == dv.alive.shape == (n_pad,)
    assert not dv.alive[n:].any()
    assert (dv.labels[n:] == UNLABELED).all() and (dv.f[n:] == 0).all()
    assert dv.f[:n].numpy().tobytes() == f.tobytes()
    pred, conf = dv.query(np.arange(n, n_pad))  # padding rows answer as unknown
    assert (pred == UNLABELED).all() and (conf == 0).all()


def test_engine_publishes_at_drain_with_commit_id():
    """``device_view`` is published on its first call and then at every
    drain; an in-flight batch leaves it on the previous commit, and a view
    a reader still holds keeps answering its own commit."""
    g = DynamicGraph(emb_dim=SPEC.emb_dim, k=5)
    eng = StreamEngine(g, delta=1e-4, device="cpu")
    assert eng._device_view is None  # nothing published until a reader asks
    first = eng.device_view()
    assert first.commit_id == 0 and first.num_nodes == 0
    assert eng.device_view() is first
    held = []
    for t, (batch, _) in enumerate(gaussian_mixture_stream(SPEC)):
        eng.submit(batch)
        assert eng.in_flight
        dv = eng.device_view()
        assert dv.commit_id == t  # the previous commit while in flight
        eng.drain()
        dv = eng.device_view()
        assert dv.commit_id == eng.commits == t + 1
        assert dv.host is eng.committed_view()
        ids = np.arange(-2, g.num_nodes + 2)
        for got, want in zip(dv.query(ids), eng.committed_view().query(ids)):
            assert got.tobytes() == want.tobytes()
        held.append((dv, ids, dv.query(ids)))
    for dv, ids, answers in held:  # later commits did not touch earlier views
        for got, want in zip(dv.query(ids), answers):
            assert got.tobytes() == want.tobytes()


def test_read_placement():
    """"auto" and None place the view on the engine's device, and on a mesh
    with no spare card on its ``view_sharding`` (one device here: that
    device's one view); a device or a ``ViewSharding`` is taken as given,
    a ViewSharding of several blocks answering as the host view does; a
    placement that is none of these raises."""
    g = DynamicGraph(emb_dim=4, k=3)
    g.apply_batch(BatchUpdate(
        ins_emb=np.random.default_rng(0).normal(size=(40, 4)).astype(np.float32),
        ins_labels=np.array([0, 1] + [UNLABELED] * 38, np.int8),
        del_ids=np.array([5, 7], np.int64)))
    mesh = DeviceMesh.local(4, device="cpu")
    for placement, kw in (("auto", {}), (None, {}), ("cpu", {}), (torch.device("cpu"), {}),
                          ("auto", dict(mesh=mesh)), (view_sharding(mesh), {})):
        eng = StreamEngine(g, device="cpu", read_placement=placement, **kw)
        dv = eng.device_view()
        assert dv.f.device.type == "cpu" and dv.stream is None
        ids = np.arange(-2, g.num_nodes + 2)
        for got, want in zip(dv.query(ids), eng.committed_view().query(ids)):
            assert got.tobytes() == want.tobytes()
    eng = StreamEngine(g, device="cpu", read_placement=ViewSharding(("cpu",) * 3))
    dv = eng.device_view()
    assert len(dv.blocks) == 3 and dv.commit_id == 0 and dv.host is eng.committed_view()
    ids = np.concatenate([np.arange(-2, g.num_nodes + 2), [10**12, 13, 13]])
    whole = publish_device_view(eng.committed_view(), "cpu")
    for cut in (0.5, np.linspace(0, 1, len(ids)).astype(np.float32)):
        for got, want in zip(dv.query(ids, cut), whole.query(ids, cut)):
            assert got.tobytes() == want.tobytes()
    for got, want in zip(dv.query(ids), eng.committed_view().query(ids)):
        assert got.tobytes() == want.tobytes()
    for placement in ("replica", "bogus", 3, object()):
        with pytest.raises(ValueError, match="read_placement"):
            StreamEngine(g, device="cpu", read_placement=placement)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            StreamEngine(g, device="cpu", read_placement="cuda")


def test_new_entry_points_need_a_card_by_default(tmp_path):
    """Without a CUDA device, leaving ``device`` out raises on every new
    entry point rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    from repro_torch.core.persistence import restore_engine
    from repro_torch.serving.estimator import DynLabelPropagation
    from repro_torch.serving.lp_service import LPService

    g = DynamicGraph(emb_dim=4, k=3)
    eng = StreamEngine(g, device="cpu")
    eng.checkpoint(str(tmp_path))
    view = eng.committed_view()
    X = np.zeros((4, 4), np.float32)
    for call in (lambda: publish_device_view(view),
                 lambda: LPService(StreamEngine(g)),
                 lambda: DynLabelPropagation().fit(X),
                 lambda: StreamEngine.restore(str(tmp_path)),
                 lambda: restore_engine(str(tmp_path))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
