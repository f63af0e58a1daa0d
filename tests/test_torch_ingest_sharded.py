"""The port's row-sharded embedding store and its sweep at a global row
offset, against the single-device store and the reference.

Mirrors ``tests/test_ingest_sharded.py`` and the elastic restores of
``test_checkpoint_restore.py``; the reference's forced 8-device
subprocesses become in-process ``DeviceMesh.local(8, device="cpu")``
meshes.  Held: graphs and displaced-row sets equal to the single-device
store's after every batch; argkmin with ``row0`` against the reference's
XLA pass at the same ``row0`` (candidate sets and masks exact, values
within 1e-6); the sharded sweep equal to one pass over the whole store,
and its sets and mask to the reference's ``argkmin_candidates``;
checkpoints restored across mesh shapes (8 → 1, 1 → 8) and across packages
(a port mesh checkpoint in the reference, a reference checkpoint onto a
port mesh), each going on to the uninterrupted stream's state.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core.stream import StreamEngine as JaxStreamEngine
from repro.data import synth as jsynth
from repro.graph import dynamic as jdyn
from repro.kernels.argkmin import _argkmin_xla_impl
from repro.kernels.argkmin import argkmin_candidates as jax_argkmin
from repro_torch.core.distributed import DeviceMesh, build_store_shard_plan, store_plan_count
from repro_torch.core.stream import StreamEngine
from repro_torch.data.synth import StreamSpec, gaussian_mixture_stream
from repro_torch.graph.dynamic import UNLABELED, BatchUpdate, DynamicGraph
from repro_torch.graph.knn import SELECT_MARGIN, normalize_rows, selection_slack
from repro_torch.ingest import DeviceIngestor, ShardedEmbeddingStore, ingest_cache_size
from repro_torch.ingest import ingest_ladder_bound
from repro_torch.kernels.argkmin import argkmin_ref, shard_sweep

torch.set_num_threads(1)

DELTA = 1e-3
GRAPH_KEYS = ("src", "dst", "wgt", "knn_idx", "knn_wgt", "labels", "alive", "f")


def _mesh(n=8):
    return DeviceMesh.local(n, device="cpu")


class RecordingIngestor(DeviceIngestor):
    """DeviceIngestor that records each batch's displaced-row set."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.flagged_log = []

    def select(self, g, new_ids, embn_new):
        sel = super().select(g, new_ids, embn_new)
        self.flagged_log.append(np.sort(sel.flagged))
        return sel


def _apply(g, emb, dels, selector):
    g.apply_batch(BatchUpdate(ins_emb=emb, ins_labels=np.full(len(emb), UNLABELED, np.int8),
                              del_ids=dels), selector=selector)


def run_sharded_vs_single(mesh, n_batches, seed, emb_dim=12, k=4, frac_del=0.15,
                          max_batch=20):
    """A sharded and a single-device ingest stream over the same mixed
    batches: graphs and flagged sets bit-identical after every batch."""
    rng = np.random.default_rng(seed)
    sizes = [int(rng.integers(1, max_batch + 1)) for _ in range(n_batches)]
    batches = [rng.normal(size=(s, emb_dim)).astype(np.float32) for s in sizes]
    gs, g1 = DynamicGraph(emb_dim, k=k), DynamicGraph(emb_dim, k=k)
    ing_s = RecordingIngestor(emb_dim, mesh=mesh)
    ing_1 = RecordingIngestor(emb_dim, device="cpu")
    assert ing_s.store.n_shards == mesh.n_devices and ing_1.store.n_shards == 1
    total = 0
    for t, b in enumerate(batches):
        n_del = int(round(frac_del * len(b))) if total else 0
        dels = (rng.choice(total, size=min(n_del, total), replace=False).astype(np.int64)
                if n_del else np.zeros(0, np.int64))
        _apply(gs, b, dels, ing_s)
        _apply(g1, b, dels, ing_1)
        total += len(b)
        for name in ("knn_idx", "knn_wgt", "src", "dst", "wgt"):
            assert getattr(gs, name).tobytes() == getattr(g1, name).tobytes(), (t, name)
        np.testing.assert_array_equal(ing_s.flagged_log[-1], ing_1.flagged_log[-1],
                                      err_msg=f"flagged sets diverge at batch {t}")
    for name in ("emb", "valid", "kth"):
        assert torch.equal(getattr(ing_s.store, name), getattr(ing_1.store, name)), name
    return ing_s, ing_1, total, max_batch


@given(st.integers(0, 10_000), st.integers(3, 8), st.floats(0.0, 0.3))
@settings(max_examples=4, deadline=None)
def test_sharded_store_bit_identical_1dev_mesh(seed, n_batches, frac_del):
    """On a one-shard mesh the sharded path (store plan, shard sweep,
    merge) is still bit-identical to the single-device store."""
    run_sharded_vs_single(_mesh(1), n_batches, seed, frac_del=frac_del)


def test_sharded_store_bit_identical_8_shards():
    """60 mixed insert/delete batches on an 8-shard mesh, the store growing
    across a rung (every shard re-cut): graphs and displaced-row sets
    bit-identical to the single-device store; each shard holds 1/8 of the
    store's bytes; the shapes seen stay within the sharded ladder bound."""
    c0 = ingest_cache_size()
    ing_s, ing_1, total, max_batch = run_sharded_vs_single(_mesh(), n_batches=60, seed=123,
                                                           max_batch=40)
    assert ing_s.store.grows >= 1 and ing_s.store.capacity == ing_1.store.capacity
    assert ing_s.store.device_bytes() * 8 == ing_1.store.device_bytes()
    bound = ingest_ladder_bound(total, max_batch, sharded=True) + \
        ingest_ladder_bound(total, max_batch)
    assert ingest_cache_size() - c0 <= bound


def test_sharded_store_duplicate_ties_cross_shard():
    """300 identical points over an 8-shard store of 128 rows a shard: the
    merge must resolve the ties, which span three shards, to the lowest
    global ids, as the single-device pass does."""
    mesh = _mesh()
    dup = np.ones((300, 6), np.float32)
    gs, g1 = DynamicGraph(6, k=3), DynamicGraph(6, k=3)
    ing_s, ing_1 = DeviceIngestor(6, mesh=mesh), DeviceIngestor(6, device="cpu")
    assert ing_s.store.rows_per_shard == 128
    for lo, hi in [(0, 150), (150, 300)]:
        _apply(gs, dup[lo:hi], np.zeros(0, np.int64), ing_s)
        _apply(g1, dup[lo:hi], np.zeros(0, np.int64), ing_1)
    np.testing.assert_array_equal(gs.knn_idx, g1.knn_idx)
    np.testing.assert_array_equal(gs.knn_wgt, g1.knn_wgt)
    assert (gs.knn_idx[150:] < 3).all()  # the lowest ids win every tie


def test_indivisible_mesh():
    """A shard count that does not divide the capacity ladder: the sharded
    store refuses, and the ingestor warns and keeps the single-device store
    on the mesh's first device, as the reference's does."""
    mesh = _mesh(7)
    with pytest.raises(ValueError, match="not divisible"):
        ShardedEmbeddingStore(8, mesh)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        ing = DeviceIngestor(8, mesh=mesh)
    assert ing.mesh is None and ing.store.n_shards == 1
    assert ing.store.emb.device == mesh.device
    assert any("does not" in str(x.message) for x in w)
    with pytest.raises(ValueError, match="not divisible"):
        build_store_shard_plan(mesh, (1024, 8))


def test_store_updates_land_in_their_owner_shards():
    """Appends across a shard boundary, kills, k-th refreshes and a grow:
    the shards' concatenation equals the single-device store throughout."""
    s8, s1 = ShardedEmbeddingStore(5, _mesh()), DeviceIngestor(5, device="cpu").store
    rng = np.random.default_rng(0)
    for m in (100, 60, 90, 400, 700):  # crosses 128-row boundaries, then grows twice
        emb = normalize_rows(rng.normal(size=(m, 5)).astype(np.float32))
        b8, v8, base8 = s8.append(emb)
        b1, v1, base1 = s1.append(emb)
        assert base8 == base1 and len(b8) == 8 and all(torch.equal(b, b1) for b in b8)
        ids = rng.choice(s1.count, 17, replace=False)
        s8.kill(np.concatenate([ids, [s1.capacity + 5, -1]]))
        s1.kill(np.concatenate([ids, [s1.capacity + 5, -1]]))
        rows = rng.choice(s1.count, 23, replace=False)
        vals = rng.uniform(0, 1, 23).astype(np.float32)
        s8.set_kth(rows, vals)
        s1.set_kth(rows, vals)
        for name in ("emb", "valid", "kth"):
            assert torch.equal(getattr(s8, name), getattr(s1, name)), (m, name)
        assert s8.capacity == s1.capacity and s8.count == s1.count
    assert s8.grows == s1.grows == 1
    lo, hi = 120, 520
    assert torch.equal(s8.landmark_rows(lo, hi), s1.landmark_rows(lo, hi))
    ids = np.array([1000, 3, 127, 128, 129, 1300, 3])
    assert torch.equal(s8.landmark_gather(ids), s1.landmark_gather(ids))
    for k, v in s8.host_state().items():
        assert v.tobytes() == s1.host_state()[k].tobytes(), k


# ---------------------------------------------------------------------- #
# argkmin at a global row offset
# ---------------------------------------------------------------------- #
def _store(rng, c, d, m, count, base_id):
    emb = np.zeros((c, d), np.float32)
    emb[:count] = normalize_rows(rng.normal(size=(count, d)).astype(np.float32))
    valid = np.zeros(c, bool)
    valid[:count] = rng.random(count) >= 0.1
    kth = rng.uniform(0.4, 0.9, c).astype(np.float32)
    kth[rng.random(c) < 0.1] = -np.inf
    batch = normalize_rows(rng.normal(size=(m, d)).astype(np.float32))
    return emb, valid, kth, batch, np.arange(m) < m - 1, base_id


def _same_sets(got, want, tol=1e-6):
    """Candidate sets per row and masks exact, values within ``tol``."""
    (tv, ti, td), (jv, ji, jd) = got, want
    np.testing.assert_array_equal(td, jd)
    for q in range(len(tv)):
        tmap = dict(zip(ti[q][np.isfinite(tv[q])], tv[q][np.isfinite(tv[q])]))
        jmap = dict(zip(ji[q][np.isfinite(jv[q])], jv[q][np.isfinite(jv[q])]))
        assert set(tmap) == set(jmap), q
        for i in tmap:
            assert abs(tmap[i] - jmap[i]) <= tol


@pytest.mark.parametrize("row0,base_id", [(384, 500), (384, 200), (384, 900), (0, 100),
                                          (1024, 1030)])
def test_argkmin_ref_row0_matches_reference(row0, base_id):
    """One store block at global offset ``row0``, with the batch's own rows
    (``base_id``) inside the block, before it or after it: the plain
    version's candidate sets and displacement mask equal the reference's
    XLA pass at the same ``row0``, values within 1e-6."""
    rng = np.random.default_rng(row0 + base_id)
    c, d, m, topk = 128, 16, 24, 9
    emb, valid, kth, batch, bvalid, _ = _store(rng, c, d, m, c, base_id)
    if row0 <= base_id < row0 + c:  # the batch sits in this block
        emb[base_id - row0:base_id - row0 + m] = batch[: c - (base_id - row0)]
    slack = selection_slack(d)
    got = argkmin_ref(*(torch.from_numpy(a) for a in (emb, valid, kth, batch, bvalid)),
                      base_id, slack, topk=topk, row0=row0)
    want = _argkmin_xla_impl(*(jnp.asarray(a) for a in (emb, valid, kth, batch, bvalid)),
                             jnp.int32(base_id), jnp.float32(slack), jnp.int32(row0), topk)
    got = tuple(t.numpy() for t in got)
    _same_sets(got, tuple(np.asarray(a) for a in want))
    fin = np.isfinite(got[0])
    assert ((got[1][fin] >= row0) & (got[1][fin] < row0 + c)).all()
    assert not (got[1][fin] == (base_id + np.nonzero(fin)[0])).any()  # no self match
    disp_rows = row0 + np.flatnonzero(got[2])
    assert (disp_rows < base_id).all()
    # row0 = 0 is the whole-store pass of before
    if row0 == 0:
        whole = argkmin_ref(*(torch.from_numpy(a) for a in (emb, valid, kth, batch, bvalid)),
                            base_id, slack, topk=topk)
        assert all(torch.equal(a, torch.from_numpy(b)) for a, b in zip(whole, got))


@pytest.mark.parametrize("dup", [False, True])
def test_shard_sweep_matches_whole_store_and_reference(dup):
    """The sharded sweep (8 shards of 128 rows, one pass each at its row0,
    lists merged) gives one pass over the whole store's bits; its sets and
    mask equal the reference's ``argkmin_candidates`` on the whole store.
    With mass duplicates the ties span shards."""
    rng = np.random.default_rng(7 + dup)
    c, d, m, k = 1024, 16, 40, 5
    emb, valid, kth, batch, bvalid, _ = _store(rng, c, d, m, 900, 860)
    emb[860:900] = batch
    valid[860:899] = True
    if dup:
        emb[100:700] = emb[100]
        batch[:20] = emb[100]
        emb[860:880] = emb[100]
    slack, topk = selection_slack(d), k + SELECT_MARGIN
    tens = [torch.from_numpy(a) for a in (emb, valid, kth, batch, bvalid)]
    whole = argkmin_ref(*tens, 860, slack, topk=topk)
    cut = [t.view(8, -1, *t.shape[1:]).unbind(0) for t in tens[:3]]
    got = shard_sweep(*cut, (tens[3],) * 8, (tens[4],) * 8, 860, slack, topk=topk)
    for a, b in zip(got, whole):
        assert a.numpy().tobytes() == b.numpy().tobytes()
    want = jax_argkmin(*(jnp.asarray(a) for a in (emb, valid, kth, batch, bvalid)), 860,
                       slack, k=k, backend="xla")
    _same_sets(tuple(t.numpy() for t in got), tuple(np.asarray(a) for a in want))
    mesh = _mesh()
    before = store_plan_count()
    plan = build_store_shard_plan(mesh, (c, d))
    assert build_store_shard_plan(_mesh(), (c, d)) is plan
    assert store_plan_count() - before <= 1
    again = plan.sweep(*cut, (tens[3],) * 8, (tens[4],) * 8, 860, slack, topk=topk)
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    with pytest.raises(ValueError, match="do not match plan rung"):
        plan.sweep(*(x[:4] for x in cut), (tens[3],) * 4, (tens[4],) * 4, 860, slack,
                   topk=topk)


# ---------------------------------------------------------------------- #
# elastic checkpoints
# ---------------------------------------------------------------------- #
SPEC = dict(total_vertices=320, batch_size=40, seed=9, emb_dim=4, class_sep=6.0, noise=0.9,
            frac_deleted=0.12, frac_unlabeled=0.85, frac_labeled=0.03)


def _batches():
    return [b for b, _ in gaussian_mixture_stream(StreamSpec(**SPEC))]


def _engine(**kw):
    return StreamEngine(DynamicGraph(emb_dim=SPEC["emb_dim"], k=5), delta=DELTA,
                        ingest="device", **kw)


@pytest.fixture(scope="module")
def oracle():
    eng = _engine(device="cpu")
    for b in _batches():
        eng.step(b)
    return eng


def _assert_state(eng, ref):
    for name in GRAPH_KEYS:
        assert getattr(eng.graph, name).tobytes() == getattr(ref.graph, name).tobytes(), name
    for name in ("emb", "valid", "kth"):
        assert torch.equal(getattr(eng.ingestor.store, name),
                           getattr(ref.ingestor.store, name)), name


@pytest.mark.parametrize("src_shards,dst_shards", [(8, 0), (0, 8), (8, 4)])
def test_elastic_checkpoint_across_mesh_shapes(tmp_path, oracle, src_shards, dst_shards):
    """Four batches, checkpoint, restore onto another mesh shape (or none),
    the rest of the stream: the uninterrupted engine's graph, labels and
    store, bit for bit."""
    batches = _batches()
    src_kw = dict(mesh=_mesh(src_shards)) if src_shards else dict(device="cpu")
    dst_kw = dict(mesh=_mesh(dst_shards)) if dst_shards else dict(device="cpu")
    src = _engine(**src_kw)
    assert src.ingestor.store.n_shards == max(src_shards, 1)
    for b in batches[:4]:
        src.step(b)
    src.checkpoint(str(tmp_path))
    r = StreamEngine.restore(str(tmp_path), **dst_kw)
    assert r.ingestor.store.n_shards == max(dst_shards, 1)
    assert (r.ingestor.store.count, r.ingestor.store.capacity) == \
        (src.ingestor.store.count, src.ingestor.store.capacity)
    _assert_state(r, src)
    assert (r.mesh.n_devices if r.mesh else 0) == dst_shards
    for b in batches[4:]:
        r.step(b)
    _assert_state(r, oracle)


def test_mesh_checkpoint_keeps_rung_state_on_the_same_mesh(tmp_path):
    """Restored onto a mesh of the same shard count with the same knobs,
    transport modes, export budgets, counters and the auto:measured probe
    cache reinstall (the probe cache is then hit, not re-measured); onto
    another shard count they are dropped; a saved "halo" degrades to auto
    on a mesh-less restore."""
    batches = _batches()
    eng = _engine(mesh=_mesh(2), transport="auto:measured")
    for b in batches[:4]:
        eng.step(b)
    assert eng._measured, "no rung was probed"
    eng.checkpoint(str(tmp_path / "m"))
    r = StreamEngine.restore(str(tmp_path / "m"), mesh=_mesh(2))
    assert r.transport == "auto:measured" and r._measured == eng._measured
    assert r._backend_modes == eng._backend_modes and r._transport_modes == {}
    for b in batches[4:]:
        r.step(b)
    assert r.probe_cache_hits >= 1  # a cached rung re-entered: decided, not re-probed
    other = StreamEngine.restore(str(tmp_path / "m"), mesh=_mesh(4))
    assert other._measured == {} and other._backend_modes == {}
    h = _engine(mesh=_mesh(8), transport="halo")
    for b in batches[:3]:
        h.step(b)
    h.checkpoint(str(tmp_path / "h"))
    same = StreamEngine.restore(str(tmp_path / "h"), mesh=_mesh(8))
    assert same.transport == "halo" and same._export_budgets == h._export_budgets
    assert (same.halo_batches, same._transport_modes) == (h.halo_batches, h._transport_modes)
    flat = StreamEngine.restore(str(tmp_path / "h"), device="cpu")
    assert flat.transport == "auto" and flat.mesh is None and flat._export_budgets == {}


@pytest.mark.parametrize("direction", ["port_mesh_to_jax", "jax_to_port_mesh"])
def test_mesh_checkpoint_across_packages(tmp_path, direction):
    """A port mesh checkpoint restores in the reference with no mesh, and a
    reference checkpoint onto an 8-shard port mesh: graph and store bytes
    equal at the restore, the same graph after the rest of the stream,
    labels within 20·δ."""
    tb = _batches()
    jb = [b for b, _ in jsynth.gaussian_mixture_stream(jsynth.StreamSpec(**SPEC))]
    d = str(tmp_path)
    if direction == "port_mesh_to_jax":
        src = _engine(mesh=_mesh(), transport="halo")
        for b in tb[:3]:
            src.step(b)
        src.checkpoint(d)
        dst = JaxStreamEngine.restore(d, backend="ref", block_rows=512, interpret=None)
        assert dst.mesh is None and dst.transport == "auto"
        teng, jeng, rest = src, dst, list(zip(tb[3:], jb[3:]))
    else:
        src = JaxStreamEngine(jdyn.DynamicGraph(emb_dim=SPEC["emb_dim"], k=5), delta=DELTA,
                              backend="ref", ingest="device")
        for b in jb[:3]:
            src.step(b)
        src.checkpoint(d)
        dst = StreamEngine.restore(d, mesh=_mesh())
        assert dst.ingestor.store.n_shards == 8 and dst.mesh.n_devices == 8
        teng, jeng, rest = dst, src, list(zip(tb[3:], jb[3:]))
    assert (dst.commits, dst.batches) == (src.commits, src.batches)

    def check():
        for name in GRAPH_KEYS[:-1]:
            assert getattr(teng.graph, name).tobytes() == getattr(jeng.graph, name).tobytes()
        g = teng.graph
        unl = np.flatnonzero(g.alive & (g.labels == UNLABELED))
        assert np.abs(g.f[unl] - jeng.graph.f[unl]).max(initial=0) <= 20 * DELTA
        for name in ("emb", "valid", "kth"):
            assert getattr(teng.ingestor.store, name).numpy().tobytes() == \
                np.asarray(getattr(jeng.ingestor.store, name)).tobytes(), name

    check()
    for t, j in rest:
        teng.step(t)
        jeng.step(j)
        check()
