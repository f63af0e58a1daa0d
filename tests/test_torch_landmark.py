"""The port's ``landmark`` backend: the single-device tests of
``tests/test_stream_landmark.py``, then the port against the JAX package.

The landmark backend answers for a hot-set agreement floor against the
exact engine (≥ 0.98, the reference's), not for equal bits.  What is exact
inside the port is checkpoint/restore: a restored hot/cold stream replays
bit for bit.  Against the reference (same graph, same stream):

- ``LandmarkState``: equal landmark ids; equal assignment index sets per
  row (argkmin values may differ by one f32 ULP between XLA and the port,
  so the top-R *sets* are held, not their order); weights within 1e-6 and
  cold estimates within 1e-6 (a few ULPs of values in [0, 1]).
- The engine: equal graph bytes, equal hot masks (the working-set clock)
  and cold row ids, labels within 20·δ (the solves sum in different
  orders; cold labels are convex combinations of landmark labels).
- Checkpoints with landmark state restore across packages, both ways.

The reference's env-hint test waits for ``REPRO_BACKEND`` in the port, and
its forced 8-device test for the port's mesh.
"""

import json

import numpy as np
import pytest
import torch

from repro.core.stream import StreamEngine as JaxStreamEngine
from repro.data import synth as jsynth
from repro.graph import dynamic as jdyn
from repro.ingest import EmbeddingStore as JaxEmbeddingStore
from repro.kernels import landmark_propagate as jlm
from repro_torch.core import persistence
from repro_torch.core.propagate import PropagationProblem, propagate
from repro_torch.core.stream import StreamEngine
from repro_torch.data.synth import StreamSpec, gaussian_mixture_stream
from repro_torch.graph.dynamic import UNLABELED, DynamicGraph
from repro_torch.ingest import EmbeddingStore
from repro_torch.kernels import ops
from repro_torch.kernels.landmark_propagate import LandmarkConfig, LandmarkState
from repro_torch.state import graph_from_reference

torch.set_num_threads(1)

DELTA = 1e-4
GRAPH = ("src", "dst", "wgt", "knn_idx", "knn_wgt", "alive", "labels")

# 50 mixed insert/delete batches (the reference's acceptance workload)
SPEC_50 = dict(total_vertices=1500, batch_size=30, seed=11, class_sep=6.0, noise=0.9,
               frac_deleted=0.2, frac_labeled=0.05)

LM_CFG = dict(num_landmarks=32, assign_k=4, hot_ttl=3)


def _mixed_batches(spec=SPEC_50):
    batches = [b for b, _ in gaussian_mixture_stream(StreamSpec(**spec))]
    assert len(batches) == 50
    assert any(len(b.del_ids) for b in batches)
    return batches


def _engine(g, **kw):
    return StreamEngine(g, delta=DELTA, device="cpu", **kw)


# ------------------------------------------------------------------ #
# registry contract
# ------------------------------------------------------------------ #
def test_landmark_registry_capabilities():
    spec = ops.backend_spec("landmark")
    assert ops.backend_names() == ("ref", "ell_cuda", "bsr", "landmark")
    # outranks every exact backend when eligible: scale wins
    assert spec.auto_priority > max(ops.backend_spec(n).auto_priority
                                    for n in ("ref", "ell_cuda", "bsr"))
    big, small = ops.LANDMARK_AUTO_MIN_ROWS, ops.LANDMARK_AUTO_MIN_ROWS - 1
    assert big == 4096
    for hw in ("cpu", "cuda"):  # not gated on the device
        assert spec.auto_eligible(ops.ProblemInfo(hw, num_rows=big, landmark_ready=True))
        assert not spec.auto_eligible(ops.ProblemInfo(hw, num_rows=big))
        assert not spec.auto_eligible(ops.ProblemInfo(hw, num_rows=small,
                                                      landmark_ready=True))
        # plain callers (no landmark_ready) never see it in an auto scan
        assert ops.select_backend("auto", device=hw, num_rows=big) != "landmark"
        assert ops.select_backend("auto", device=hw, num_rows=big,
                                  landmark_ready=True) == "landmark"
        assert ops.backend_candidates(None, device=hw)[0] == "landmark"
        assert ops.backend_candidates("landmark", device=hw) == ("landmark",)
    assert ops.backend_candidates(None, device="cpu") == ("landmark", "ref")


def test_landmark_standalone_solve_is_the_exact_one():
    """Outside the engine the hot/cold split does not exist: a
    ``run_propagation(backend="landmark")`` is the exact solve."""
    nbr = torch.full((4, 2), -1, dtype=torch.int32)
    p = PropagationProblem(nbr=nbr, wgt=torch.zeros(4, 2), wl0=torch.ones(4),
                           wl1=torch.zeros(4), valid=torch.ones(4, dtype=torch.bool))
    f0, fr = torch.full((4,), 0.5), torch.ones(4, dtype=torch.bool)
    res = ops.run_propagation(p, f0, fr, backend="landmark", device="cpu")
    want = propagate(p, f0, fr)
    assert res.f.equal(want.f) and res.iterations == want.iterations


# ------------------------------------------------------------------ #
# hot/cold streaming (single device)
# ------------------------------------------------------------------ #
def test_landmark_stream_mixed_50_batches_agreement():
    """50 mixed insert/delete batches through the exact engine and the
    landmark engine: hot-set agreement clears the floor, and the hot/cold
    machinery engaged (cold rows served, 'landmark' in the stats)."""
    g_ref = DynamicGraph(emb_dim=16, k=5)
    g_lm = DynamicGraph(emb_dim=16, k=5)
    ref = _engine(g_ref)
    lm = _engine(g_lm, backend="landmark", landmark=LM_CFG)
    backends = []
    for b in _mixed_batches():
        ref.step(b)
        backends.append(lm.step(b).backend)
    assert backends[-1] == "landmark"
    summary = lm.transport_summary()["landmark"]
    assert summary["streaming"] and summary["batches"] > 0
    assert summary["cold_rows"] > 0  # the low-rank pass served rows
    assert summary["assign_chunks"] >= summary["resamples"] > 0
    ids = np.flatnonzero(g_ref.alive & (g_ref.labels == UNLABELED))
    hot = (lm._touched_at[ids] >= 0) & (lm.batches - lm._touched_at[ids] <= LM_CFG["hot_ttl"])
    assert hot.sum() > 0
    pr = g_ref.f[ids] >= 0.5
    pl = g_lm.f[ids] >= 0.5
    assert (pr[hot] == pl[hot]).mean() >= 0.98  # the agreement contract


def test_landmark_auto_latch(monkeypatch):
    """backend=None + a landmark config: the registry takes landmark once
    the state is ready and the rows clear the threshold, and the decision
    latches; without a config the same engine never takes it."""
    monkeypatch.setattr(ops, "LANDMARK_AUTO_MIN_ROWS", 256)
    eng = _engine(DynamicGraph(emb_dim=16, k=5), landmark=LM_CFG)
    backends = [eng.step(b).backend for b in _mixed_batches()]
    assert eng._lm_streaming
    flip = backends.index("landmark")
    assert flip > 0 and set(backends[:flip]) <= {"ref", "none"}
    assert all(b == "landmark" for b in backends[flip:] if b != "none")
    eng2 = _engine(DynamicGraph(emb_dim=16, k=5))
    assert eng2._lm is None
    spec = StreamSpec(total_vertices=600, batch_size=100, seed=3, class_sep=6.0, noise=0.9)
    assert all(eng2.step(b).backend != "landmark" for b, _ in gaussian_mixture_stream(spec))


def test_landmark_config_validation():
    with pytest.raises(ValueError, match="invalid LandmarkConfig"):
        LandmarkConfig(num_landmarks=0)
    with pytest.raises(ValueError, match="invalid LandmarkConfig"):
        _engine(DynamicGraph(emb_dim=8, k=3), landmark=dict(assign_k=0))
    eng = _engine(DynamicGraph(emb_dim=8, k=3), backend="landmark")
    assert eng._lm.cfg == LandmarkConfig()  # the knob alone activates the default
    assert _engine(DynamicGraph(emb_dim=8, k=3), landmark=True)._lm.cfg == LandmarkConfig()


# ------------------------------------------------------------------ #
# durability
# ------------------------------------------------------------------ #
def _landmark_engine(**kw):
    return _engine(DynamicGraph(emb_dim=16, k=5), backend="landmark", landmark=LM_CFG, **kw)


@pytest.mark.parametrize("ingest", ["host", "device"])
def test_landmark_checkpoint_roundtrip(tmp_path, ingest):
    """Stop a hot/cold stream mid-way, checkpoint, restore, go on: labels
    bit-identical to the uninterrupted stream (working-set clock,
    assignments and latch all round-trip)."""
    batches = _mixed_batches()
    cut = 20
    full, part = _landmark_engine(ingest=ingest), _landmark_engine(ingest=ingest)
    for i, b in enumerate(batches):
        full.step(b)
        if i < cut:
            part.step(b)
    assert part._lm_streaming  # the cut lands after the latch
    part.checkpoint(str(tmp_path))
    rest = StreamEngine.restore(str(tmp_path), device="cpu")
    assert rest._lm_streaming and rest._lm.ready
    np.testing.assert_array_equal(rest._touched_at, part._touched_at)
    for name in ("assign_idx", "assign_w", "lm_emb", "lm_valid"):
        assert getattr(rest._lm, name).equal(getattr(part._lm, name)), name
    for b in batches[cut:]:
        rest.step(b)
    assert full.graph.f.tobytes() == rest.graph.f.tobytes()
    s_full = full.transport_summary()["landmark"]
    s_rest = rest.transport_summary()["landmark"]
    assert (s_rest["batches"], s_rest["cold_rows"]) == (s_full["batches"], s_full["cold_rows"])


def test_landmark_restore_with_another_geometry_starts_fresh(tmp_path):
    eng = _landmark_engine()
    for b in _mixed_batches()[:20]:
        eng.step(b)
    eng.checkpoint(str(tmp_path))
    same = StreamEngine.restore(str(tmp_path), device="cpu",
                                landmark=dict(LM_CFG, hot_ttl=5))
    assert same._lm.ready and same._lm_streaming and same._lm.cfg.hot_ttl == 5
    other = StreamEngine.restore(str(tmp_path), device="cpu",
                                 landmark=dict(LM_CFG, num_landmarks=16))
    assert not other._lm.ready and not other._lm_streaming
    assert other.landmark_batches == 0 and (other._touched_at == -1).all()
    off = StreamEngine.restore(str(tmp_path), device="cpu", backend=None, landmark=None)
    assert off._lm is None and off.step(_mixed_batches()[20]).backend == "ref"
    meta = json.loads(bytes(eng.checkpoint_state()["meta"]))
    assert meta["landmark"]["streaming"] and meta["landmark"]["num_landmarks"] == 32


# ------------------------------------------------------------------ #
# the port against the JAX package
# ------------------------------------------------------------------ #
def _assign_sets(idx, w):
    """Per row, the set of landmark slots with weight (empty slots carry
    no weight, and the two packages name them differently)."""
    return [frozenset(i[x > 0].tolist()) for i, x in zip(idx, w)]


def _check_states(ts: LandmarkState, js, n):
    assert np.array_equal(ts.lm_ids, js.lm_ids)
    assert ts.lm_emb.numpy().tobytes() == np.asarray(js.lm_emb).tobytes()
    assert ts.lm_valid.numpy().tobytes() == np.asarray(js.lm_valid).tobytes()
    assert (ts.assigned_upto, ts.sampled_alive, ts.resamples) == \
        (js.assigned_upto, js.sampled_alive, js.resamples)
    t_idx, t_w = ts.assign_idx.numpy(), ts.assign_w.numpy()
    j_idx, j_w = np.asarray(js.assign_idx), np.asarray(js.assign_w)
    assert t_idx.shape == j_idx.shape
    assert _assign_sets(t_idx[:n], t_w[:n]) == _assign_sets(j_idx[:n], j_w[:n])
    # weights by landmark id, so the order of equal-set slots does not matter
    for r in range(n):
        tw = dict(zip(t_idx[r].tolist(), t_w[r].tolist()))
        jw = dict(zip(j_idx[r].tolist(), j_w[r].tolist()))
        assert all(abs(tw[i] - jw[i]) <= 1e-6 for i in jw if jw[i] > 0), r


@pytest.mark.parametrize("with_store", [False, True])
def test_landmark_state_matches_reference(with_store):
    """Activation, an incremental refresh and a resample, on the same
    graph in both packages (staged from the host graph, or served from the
    embedding store)."""
    spec = dict(total_vertices=2600, batch_size=650, seed=4, class_sep=6.0, noise=0.9,
                frac_deleted=0.1, frac_labeled=0.05)
    jb = [b for b, _ in jsynth.gaussian_mixture_stream(jsynth.StreamSpec(**spec))]
    jg = jdyn.DynamicGraph(emb_dim=16, k=5)
    cfg = dict(num_landmarks=40, assign_k=4, hot_ttl=2)
    js = jlm.LandmarkState(jlm.LandmarkConfig(**cfg), 16)
    ts = LandmarkState(LandmarkConfig(**cfg), 16, device="cpu")
    jstore = tstore = None
    events = []
    chunks = 0  # argkmin calls the assignment needs: the rows not yet assigned
    for i, b in enumerate(jb):
        jg.apply_batch(b)
        tg = graph_from_reference(jg.state_arrays(), emb_dim=16, k=5)
        if with_store:
            jstore, tstore = JaxEmbeddingStore(16), EmbeddingStore(16, device="cpu")
            jstore.backfill(jg.embn, jg.alive, np.full(jg.num_nodes, -np.inf, np.float32))
            tstore.backfill(tg.embn, tg.alive, np.full(tg.num_nodes, -np.inf, np.float32))
        before, upto = js.resamples, js.assigned_upto
        js.refresh(jg, jstore)
        ts.refresh(tg, tstore)
        events.append("resample" if js.resamples > before else "incremental")
        chunks += -(-(tg.num_nodes - (0 if events[-1] == "resample" else upto)) // 1024)
        assert ts.assign_chunks == chunks
        _check_states(ts, js, tg.num_nodes)
        lm_f = ts.landmark_values(tg)
        assert lm_f.tobytes() == np.asarray(js.landmark_values(jg)).tobytes()
        t_est, t_sum = ts.cold_values(lm_f)
        j_est, j_sum = js.cold_values(lm_f)
        assert np.abs(t_est - np.asarray(j_est)).max() <= 1e-6
        assert np.abs(t_sum - np.asarray(j_sum)).max() <= 1e-6
        # the next batch's labels: the committed F moves, fL with it
        jg.f[:] = np.random.default_rng(i).uniform(0, 1, jg.num_nodes).astype(np.float32)
    assert events[0] == "resample" and "incremental" in events
    assert events.count("resample") >= 2  # activation and a later resample


def _check_engines(jeng, teng):
    jg, tg = jeng.graph, teng.graph
    for name in GRAPH:
        assert getattr(jg, name).tobytes() == getattr(tg, name).tobytes(), name
    assert np.array_equal(jeng._touched_at, teng._touched_at)
    ids = np.flatnonzero(tg.alive & (tg.labels == UNLABELED))
    assert np.abs(jg.f[ids] - tg.f[ids]).max(initial=0.0) <= 20 * DELTA


@pytest.mark.parametrize("ingest", ["host", "device"])
def test_landmark_engine_matches_reference(ingest):
    """Over the 50-batch mixed stream: graph bytes, hot masks and the cold
    rows each batch serves equal; labels within 20·δ; the same batches on
    the hot/cold split, the same cold rows served."""
    jb = [b for b, _ in jsynth.gaussian_mixture_stream(jsynth.StreamSpec(**SPEC_50))]
    tb = _mixed_batches()
    jeng = JaxStreamEngine(jdyn.DynamicGraph(emb_dim=16, k=5), delta=DELTA,
                           backend="landmark", landmark=LM_CFG, ingest=ingest)
    teng = _engine(DynamicGraph(emb_dim=16, k=5), backend="landmark", landmark=LM_CFG,
                   ingest=ingest)
    for j, t in zip(jb, tb):
        jeng.submit(j)
        teng.submit(t)
        jp, tp = jeng._pending, teng._pending
        assert (jp.cold_ids is None) == (tp.cold_ids is None)
        if tp.cold_ids is not None:
            assert np.array_equal(jp.cold_ids, tp.cold_ids)
        assert jp.bucket == tp.bucket and jp.backend == tp.backend
        js, ts = jeng.drain(), teng.drain()
        assert (js.frontier_size, js.num_unlabeled) == (ts.frontier_size, ts.num_unlabeled)
        _check_engines(jeng, teng)
    sj = jeng.transport_summary()["landmark"]
    st = teng.transport_summary()["landmark"]
    for key in ("streaming", "num_landmarks", "batches", "cold_rows", "resamples"):
        assert sj[key] == st[key], key
    assert st["cold_rows"] > 0


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_landmark_checkpoint_restores_across_packages(tmp_path, direction):
    """A landmark engine's checkpoint from one package restores in the
    other: graph, clock, latch, counters and factorization equal; then
    both go on with the same batches, labels within 20·δ."""
    jb = [b for b, _ in jsynth.gaussian_mixture_stream(jsynth.StreamSpec(**SPEC_50))]
    tb = _mixed_batches()
    d = str(tmp_path)
    cut = 20
    if direction == "jax_to_port":
        src = JaxStreamEngine(jdyn.DynamicGraph(emb_dim=16, k=5), delta=DELTA,
                              backend="landmark", landmark=LM_CFG, ingest="device")
        for b in jb[:cut]:
            src.step(b)
        src.checkpoint(d)
        dst = persistence.restore_engine(d, device="cpu")
        jeng, teng = src, dst
    else:
        src = _engine(DynamicGraph(emb_dim=16, k=5), backend="landmark", landmark=LM_CFG,
                      ingest="device")
        for b in tb[:cut]:
            src.step(b)
        src.checkpoint(d)
        dst = JaxStreamEngine.restore(d)
        jeng, teng = dst, src
    assert dst._lm_streaming and dst._lm.ready and dst.backend == "landmark"
    assert (dst.commits, dst.batches, dst.landmark_batches, dst.landmark_cold_rows) == \
        (src.commits, src.batches, src.landmark_batches, src.landmark_cold_rows)
    assert np.array_equal(dst._touched_at, src._touched_at)
    assert np.array_equal(teng._lm.lm_ids, jeng._lm.lm_ids)
    for name in ("lm_emb", "lm_valid", "assign_w", "assign_idx"):
        assert np.asarray(getattr(jeng._lm, name)).tobytes() == \
            np.asarray(getattr(teng._lm, name)).tobytes(), name
    assert jeng.graph.f.tobytes() == teng.graph.f.tobytes()
    for j, t in zip(jb[cut:cut + 10], tb[cut:cut + 10]):
        assert jeng.step(j).backend == teng.step(t).backend == "landmark"
        _check_engines(jeng, teng)


def test_store_landmark_hooks_match_reference():
    rng = np.random.default_rng(0)
    embn = rng.normal(0, 1, (300, 12)).astype(np.float32)
    embn /= np.linalg.norm(embn, axis=1, keepdims=True)
    alive = np.ones(300, bool)
    kth = np.full(300, -np.inf, np.float32)
    js, ts = JaxEmbeddingStore(12), EmbeddingStore(12, device="cpu")
    js.backfill(embn, alive, kth)
    ts.backfill(embn, alive, kth)
    assert ts.landmark_rows(17, 290).numpy().tobytes() == \
        np.asarray(js.landmark_rows(17, 290)).tobytes()
    ids = np.array([5, 0, 299, 5, 123])
    assert ts.landmark_gather(ids).numpy().tobytes() == \
        np.asarray(js.landmark_gather(ids)).tobytes()
