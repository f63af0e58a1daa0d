"""The port's ``StreamEngine(mesh=...)``: bit for bit against its
single-device engine under every transport, and its halo layout against
the reference's.

Mirrors ``tests/test_stream_sharded.py`` and ``test_stream_transport.py``.
The reference forces 8 virtual CPU devices in a subprocess; the port's
mesh runs in process, ``DeviceMesh.local(8, device="cpu")``.  Held: over
a mixed insert/delete stream the mesh engine's labels, iteration counts
and convergence equal the single-device engine's under ``allgather``,
``halo`` (pipelined submit/drain included) and ``auto``; one plan per
ladder rung; the halo plans, export counts, export budgets and staged host
arrays are the reference's bytes; labels within 20·δ of the reference
engine's.  δ is 1e-3 in most cases: equality of bits does not depend on
it, and the sweeps (eight shards' worth of small CPU ops each) are fewer.
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

from repro.core.snapshot import apply_halo_layout as japply_halo_layout
from repro.core.snapshot import build_host_problem as jbuild_host_problem
from repro.core.stream import StreamEngine as JaxStreamEngine
from repro.data import synth as jsynth
from repro.graph import dynamic as jdyn
from repro.graph import partition as jpart
from repro_torch.core import stream as stream_module
from repro_torch.core.distributed import DeviceMesh
from repro_torch.core.snapshot import build_host_problem
from repro_torch.core.stream import StreamEngine
from repro_torch.data.synth import StreamSpec, gaussian_mixture_stream, locality_stream
from repro_torch.graph import partition
from repro_torch.graph.dynamic import UNLABELED, BatchUpdate, DynamicGraph
from repro_torch.kernels import ops
from repro_torch.kernels.landmark_propagate import LandmarkConfig

torch.set_num_threads(1)

DELTA = 1e-3
MIXED = dict(total_vertices=320, batch_size=16, seed=11, class_sep=6.0, noise=0.9,
             frac_deleted=0.2, frac_unlabeled=0.79)
NONE = np.zeros(0, np.int64)


def _mesh(n=8):
    return DeviceMesh.local(n, device="cpu")


def _engine(g, **kw):
    return StreamEngine(g, delta=kw.pop("delta", DELTA), device="cpu", **kw)


def _graph(spec=None):
    return DynamicGraph(emb_dim=(spec or StreamSpec(**MIXED)).emb_dim, k=5)


def _empty_batch(dim=4):
    return BatchUpdate(ins_emb=np.zeros((0, dim), np.float32),
                       ins_labels=np.zeros(0, np.int8), del_ids=NONE)


def _seed_batch(rng, dim=4, n=24):
    emb = rng.normal(0, 1, (n, dim)).astype(np.float32)
    emb[0, 0], emb[1, 0] = 3.0, -3.0
    labels = np.full(n, UNLABELED, np.int8)
    labels[0], labels[1] = 1, 0
    return BatchUpdate(ins_emb=emb, ins_labels=labels, del_ids=NONE)


def _drive(eng, batches, pipelined=False):
    """Stats of every batch, stepped or pipelined (submit t+1 before t is
    drained)."""
    if not pipelined:
        return [eng.step(b) for b in batches]
    stats = [st for b in batches if (st := eng.submit(b)) is not None]
    return stats + [eng.drain()]


RUNS = {
    "allgather": (dict(transport="allgather"), False),
    "allgather_pipelined": (dict(transport="allgather"), True),
    "halo": (dict(transport="halo"), False),
    "halo_pipelined": (dict(transport="halo"), True),
    "auto": (dict(transport="auto"), False),
}


@pytest.fixture(scope="module")
def mixed():
    """The mixed stream through the single-device engine and through an
    8-shard mesh engine per transport (stepped and pipelined)."""
    batches = [b for b, _ in gaussian_mixture_stream(StreamSpec(**MIXED))]
    assert len(batches) == 20 and any(len(b.del_ids) for b in batches)
    single = _engine(_graph())
    out = {"batches": batches, "single": (single, _drive(single, batches))}
    for name, (kw, pipelined) in RUNS.items():
        eng = _engine(_graph(), mesh=_mesh(), **kw)
        out[name] = (eng, _drive(eng, batches, pipelined))
    return out


@pytest.mark.parametrize("name", list(RUNS))
def test_sharded_stream_bit_identical(mixed, name):
    single, s_stats = mixed["single"]
    eng, stats = mixed[name]
    assert eng.graph.f.tobytes() == single.graph.f.tobytes()
    assert [(s.iterations, s.converged, s.num_unlabeled) for s in stats] == \
        [(s.iterations, s.converged, s.num_unlabeled) for s in s_stats]
    assert eng.committed_view().f.tobytes() == single.committed_view().f.tobytes()
    assert all(u % 8 == 0 for u, _ in eng.bucket_keys), eng.bucket_keys
    assert len(eng.bucket_keys) >= 3  # the ladder regrew
    solved = [s for s in stats if s.transport != "none"]
    assert {s.transport for s in solved} <= {"allgather", "halo"}
    if eng.transport != "auto":
        assert {s.transport for s in solved} == {eng.transport}
    summary = eng.transport_summary()
    assert summary["mesh_devices"] == 8 and summary["requested"] == eng.transport
    assert set(summary["rung_modes"].values()) <= {"allgather", "halo"}


def test_plans_once_per_rung_and_transport_counts(mixed):
    eng = mixed["allgather"][0]
    rungs = len(eng.bucket_keys)
    assert eng.plan_builds == rungs < eng.batches
    halo = mixed["halo"][0]
    solved = sum(s.transport != "none" for s in mixed["halo"][1])
    assert halo.plan_builds <= len(halo.bucket_keys)
    assert halo.transport_overflows == 0 and halo.halo_batches == solved
    for e, t in ((eng, "allgather"), (halo, "halo")):
        per_sweep = e.transport_summary()["transport_bytes_per_sweep"]
        assert set(per_sweep) == {t} and per_sweep[t] > 0
    # all-gather copies N·(4 + 1) bytes a sweep into the one device's buffer
    u = max(u for u, _ in eng.bucket_keys)
    assert eng.transport_summary()["transport_bytes_per_sweep"]["allgather"] <= u * 5


def test_halo_layout_and_labels_match_reference(monkeypatch):
    """Each Δ_t's halo plan, export counts, rung export budget and staged
    host arrays on the 8-shard mesh are the reference's bytes (its
    ``build_halo_plan`` and ``apply_halo_layout`` on its own host
    snapshot); the labels stay within 20·δ of the reference engine's."""
    kw = dict(MIXED, total_vertices=160)
    tb = [b for b, _ in gaussian_mixture_stream(StreamSpec(**kw))]
    jb = [b for b, _ in jsynth.gaussian_mixture_stream(jsynth.StreamSpec(**kw))]
    plans, staged = [], []
    real_plan, real_apply = partition.build_halo_plan, stream_module.apply_halo_layout
    monkeypatch.setattr(partition, "build_halo_plan",
                        lambda nbr, n: plans.append(real_plan(nbr, n)) or plans[-1])
    monkeypatch.setattr(stream_module, "apply_halo_layout",
                        lambda host, plan: staged.append(real_apply(host, plan)) or staged[-1])
    eng = _engine(_graph(), mesh=_mesh(), transport="halo")
    gj = jdyn.DynamicGraph(emb_dim=StreamSpec(**kw).emb_dim, k=5)
    jeng = JaxStreamEngine(gj, delta=DELTA, backend="ref")
    budgets = {}
    for t, (b, j) in enumerate(zip(tb, jb)):
        n_before = len(plans)
        st = eng.step(b)
        jeng.step(j)
        hj = jbuild_host_problem(gj, auto_bucket=True, row_multiple=8, max_k=eng.max_k,
                                 warned=set())
        if st.transport == "none":
            assert len(plans) == n_before
            continue
        assert len(plans) == n_before + 1 and len(staged) == len(plans), t
        jplan = jpart.build_halo_plan(hj.nbr, 8)
        got = plans[-1]
        for name in ("nbr", "perm", "inv_perm", "export_counts"):
            assert getattr(got, name).tobytes() == getattr(jplan, name).tobytes(), (t, name)
        assert (got.export_max, got.rows_per_shard) == (jplan.export_max, jplan.rows_per_shard)
        sj = japply_halo_layout(hj, jplan)
        for name in ("nbr", "wgt", "wl0", "wl1", "valid"):
            assert getattr(staged[-1], name).tobytes() == getattr(sj, name).tobytes(), (t, name)
        budgets.setdefault(hj.bucket_key, jpart.export_budget(jplan, len(hj.unl_ids)))
        assert st.transport == "halo" and st.bucket == hj.bucket_key
        g = eng.graph
        unl = np.flatnonzero(g.alive & (g.labels == UNLABELED))
        assert np.abs(g.f[unl] - gj.f[unl]).max(initial=0) <= 20 * DELTA, t
    assert eng._export_budgets == budgets and budgets
    for name in ("src", "dst", "wgt", "knn_idx", "knn_wgt", "labels", "alive"):
        assert getattr(eng.graph, name).tobytes() == getattr(gj, name).tobytes(), name


def test_bucket_rows_pad_to_mesh_multiple():
    """row_multiple rounds every row bucket up so shapes shard evenly."""
    spec = StreamSpec(total_vertices=700, batch_size=70, seed=2, class_sep=6.0, noise=0.9)
    g = DynamicGraph(emb_dim=spec.emb_dim, k=5)
    for batch, _ in gaussian_mixture_stream(spec):
        g.apply_batch(batch)
        host = build_host_problem(g, auto_bucket=True, row_multiple=8)
        assert host.bucket_key[0] % 8 == 0
        plain = build_host_problem(g, auto_bucket=True)
        assert 0 <= host.bucket_key[0] - plain.bucket_key[0] < 8


def test_env_backend_hint_resolves_through_registry(monkeypatch):
    """REPRO_BACKEND is a fleet-wide hint resolved through the registry:
    bsr has a sharded form, so the hint holds on a mesh too; a hint naming
    a backend with no sharded form degrades to the auto scan there."""
    monkeypatch.setenv("REPRO_BACKEND", "bsr")
    assert ops.select_backend(None, device="cpu", sharded=True) == "bsr"
    assert ops.select_backend(None, device="cpu", num_rows=64) == "bsr"
    assert ops.select_backend("bsr", device="cpu", sharded=True) == "bsr"
    assert "bsr" in ops.backend_candidates(None, device="cpu", sharded=True)
    spec = ops.backend_spec("bsr")
    ops.register_backend(dataclasses.replace(spec, sharded=False))
    try:
        assert ops.select_backend(None, device="cpu", sharded=True) == "ref"
        assert ops.select_backend(None, device="cpu", num_rows=64) == "bsr"
        assert "bsr" not in ops.backend_candidates(None, device="cpu", sharded=True)
        # the engine pins the hint once: a mesh engine degrades it to auto
        eng = _engine(_graph(), mesh=_mesh(2))
        assert eng._backend_knob == "auto" and "bsr" not in eng._backend_candidates
    finally:
        ops.register_backend(spec)
    eng = _engine(_graph(), mesh=_mesh(2))
    assert eng._backend_knob == "bsr" and eng._row_multiple == 2 * ops.bsr_block_size("cpu")
    monkeypatch.setenv("REPRO_BACKEND", "ref")
    assert eng._backend_knob == "bsr"  # read once, at construction


def test_landmark_env_hint(monkeypatch):
    """REPRO_BACKEND=landmark is a fleet-wide hint like any other; a
    standalone ``run_propagation`` solves exactly."""
    monkeypatch.setenv("REPRO_BACKEND", "landmark")
    assert ops.select_backend(None, device="cpu") == "landmark"
    assert ops.backend_candidates(None, device="cpu") == ("landmark",)
    from repro_torch.core.propagate import PropagationProblem, propagate

    p = PropagationProblem(nbr=torch.full((4, 2), -1, dtype=torch.int32),
                           wgt=torch.zeros(4, 2), wl0=torch.ones(4), wl1=torch.zeros(4),
                           valid=torch.ones(4, dtype=torch.bool))
    f0, fr = torch.full((4,), 0.5), torch.ones(4, dtype=torch.bool)
    res = ops.run_propagation(p, f0, fr, device="cpu")
    assert torch.equal(res.f, propagate(p, f0, fr).f)
    eng = _engine(_graph())  # the hint configures the landmark state
    assert eng._backend_knob == "landmark" and eng._lm is not None


def test_mesh_bsr_engine_same_bits_across_transports():
    """A bsr mesh engine stages in the halo layout under both transports,
    so the tile layout and the labels are the same bits; within 2e-3 (the
    reference's bsr-vs-ref bound) of the exact engine."""
    spec = StreamSpec(total_vertices=160, batch_size=40, seed=3, class_sep=6.0, noise=0.9)
    batches = [b for b, _ in gaussian_mixture_stream(spec)]
    runs = {}
    for tr in ("allgather", "halo"):
        eng = _engine(_graph(spec), mesh=_mesh(2), backend="bsr", transport=tr)
        stats = [eng.step(b) for b in batches]
        assert {s.backend for s in stats} == {"bsr"} and eng.bsr_batches == len(batches)
        runs[tr] = eng
    assert runs["halo"].graph.f.tobytes() == runs["allgather"].graph.f.tobytes()
    exact = _engine(_graph(spec))
    for b in batches:
        exact.step(b)
    g = exact.graph
    unl = np.flatnonzero(g.alive & (g.labels == UNLABELED))
    assert np.abs(runs["halo"].graph.f[unl] - g.f[unl]).max() <= 2e-3
    assert runs["halo"].transport_summary()["slot_budgets"]


def test_bsr_slot_overflow_rides_ell_cuda_on_the_mesh(caplog):
    """A bsr rung whose budget a Δ_t overflows runs that Δ_t on its ell_cuda
    twin under the same transport, warned once per rung; labels stay the
    exact engine's bits for that batch's solve."""
    spec = StreamSpec(total_vertices=160, batch_size=40, seed=5, class_sep=6.0, noise=0.9)
    batches = [b for b, _ in gaussian_mixture_stream(spec)]
    eng = _engine(_graph(spec), mesh=_mesh(2), backend="bsr", transport="halo")
    eng.step(batches[0])
    for key in eng._slot_budgets:
        eng._slot_budgets[key] = 0  # every later batch overflows
    caplog.set_level(logging.WARNING, logger="repro_torch.core.stream")
    stats = [eng.step(b) for b in batches[1:]]
    fallen = [s for s in stats if s.backend == "ell_cuda"]
    assert fallen and eng.backend_overflows == len(fallen)
    assert all(s.transport == "halo" for s in stats)
    warned = [r for r in caplog.records if "tile slots" in r.getMessage()]
    assert 1 <= len(warned) <= len(eng.bucket_keys)


# ---------------------------------------------------------------------- #
# the transport knob (test_stream_transport.py)
# ---------------------------------------------------------------------- #
def test_transport_knob_validation(monkeypatch):
    g = DynamicGraph(emb_dim=4, k=3)
    with pytest.raises(ValueError, match="unknown transport"):
        _engine(g, transport="ring")
    with pytest.raises(ValueError, match="requires mesh"):
        _engine(g, transport="halo")
    # the env var is a fleet-wide hint, ignored on mesh-less engines
    monkeypatch.setenv("REPRO_STREAM_TRANSPORT", "halo")
    eng = _engine(g)
    assert eng.transport == "halo"
    st = eng.step(_seed_batch(np.random.default_rng(0)))
    assert st.converged and st.transport == "single"
    monkeypatch.setenv("REPRO_STREAM_TRANSPORT", "bogus")
    with pytest.raises(ValueError, match="REPRO_STREAM_TRANSPORT"):
        _engine(DynamicGraph(emb_dim=4, k=3))


def test_stream_stats_report_transport():
    eng = _engine(DynamicGraph(emb_dim=4, k=3), mesh=_mesh(), transport="allgather")
    st = eng.step(_seed_batch(np.random.default_rng(1)))
    assert st.transport == "allgather"
    st = eng.step(_empty_batch())  # a no-op commits without a collective
    assert st.transport == "none" and st.iterations == 0
    assert eng.transport_summary()["requested"] == "allgather"


def test_halo_empty_frontier_noop_commits():
    """A no-op Δ_t on a halo engine stages nothing but still commits, and
    the next batch resumes; labels match a mesh-less engine's bits."""
    def run(**kw):
        rng = np.random.default_rng(2)
        g = DynamicGraph(emb_dim=4, k=3)
        eng = _engine(g, delta=1e-4, **kw)
        eng.step(_seed_batch(rng))
        st = eng.step(_empty_batch())
        assert st.converged and st.transport == "none"
        st = eng.step(BatchUpdate(
            ins_emb=rng.normal([3, 0, 0, 0], 0.1, (8, 4)).astype(np.float32),
            ins_labels=np.full(8, UNLABELED, np.int8), del_ids=NONE))
        assert st.converged and eng.commits == 3
        return g

    assert run(mesh=_mesh(), transport="halo").f.tobytes() == run().f.tobytes()


def test_halo_rung_change_rebuilds_plan_once_per_rung():
    """A stream crossing several rungs builds one halo plan per rung; the
    per-batch layout never counts as a plan build."""
    spec = StreamSpec(total_vertices=700, batch_size=70, seed=5, emb_dim=2, class_sep=6.0,
                      noise=0.9)
    eng = _engine(DynamicGraph(emb_dim=2, k=5), mesh=_mesh(), transport="halo")
    for batch, _ in locality_stream(spec):
        eng.step(batch)
    rungs = len(eng.bucket_keys)
    assert rungs >= 2, eng.bucket_keys
    assert eng.plan_builds <= rungs + eng.transport_overflows
    assert eng.halo_batches + eng.transport_overflows == eng.batches


def test_auto_single_device_mesh_takes_allgather():
    """auto on a one-shard mesh has no bytes to save: all-gather on every
    rung, no halo layout built."""
    eng = _engine(DynamicGraph(emb_dim=4, k=3), mesh=_mesh(1), transport="auto")
    eng.step(_seed_batch(np.random.default_rng(3)))
    summary = eng.transport_summary()
    assert set(summary["rung_modes"].values()) == {"allgather"}
    assert summary["halo_batches"] == 0


def test_auto_measured_transport_probes_and_caches(monkeypatch):
    """transport='auto:measured' (constructor or env): one real sweep per
    transport is timed at rung entry and the winner cached; every rung gets
    a mode, at least one rung a probe, and the labels are the heuristic
    auto engine's bits.  Two shards: there the rungs' export budgets stay
    under the shard size, so the probe runs (on eight shards of this
    stream every budget reaches it and halo could copy no fewer rows)."""
    spec = StreamSpec(total_vertices=300, batch_size=60, seed=6, emb_dim=2, class_sep=6.0,
                      noise=0.9)
    batches = [b for b, _ in locality_stream(spec)]
    eng_m = _engine(DynamicGraph(emb_dim=2, k=5), mesh=_mesh(2), transport="auto:measured")
    eng_a = _engine(DynamicGraph(emb_dim=2, k=5), mesh=_mesh(2), transport="auto")
    for b in batches:
        eng_m.step(b)
        eng_a.step(b)
    summary = eng_m.transport_summary()
    assert summary["requested"] == "auto:measured"
    assert set(summary["rung_modes"].values()) <= {"allgather", "halo"}
    assert len(summary["rung_modes"]) == len(eng_m.bucket_keys)
    probed = [p for p in summary["measured_sweep_ms"].values()
              if set(p) == {"allgather", "halo"}]
    assert probed and all(v > 0 for p in probed for v in p.values()), summary
    assert eng_m.graph.f.tobytes() == eng_a.graph.f.tobytes()
    monkeypatch.setenv("REPRO_STREAM_TRANSPORT", "auto:measured")
    assert _engine(DynamicGraph(emb_dim=2, k=5), mesh=_mesh()).transport == "auto:measured"


def test_halo_export_overflow_falls_back_with_warning(caplog):
    """A batch whose export counts exceed the rung's budget runs on
    all-gather for that Δ_t, keeps the labels bit-identical and warns once
    per rung."""
    spec = StreamSpec(total_vertices=600, batch_size=60, seed=7, emb_dim=2, class_sep=6.0,
                      noise=0.9, frac_deleted=0.1, frac_unlabeled=0.89)
    batches = [b for b, _ in locality_stream(spec)]
    ref = _engine(DynamicGraph(emb_dim=2, k=5))
    eng = _engine(DynamicGraph(emb_dim=2, k=5), mesh=_mesh(), transport="halo")
    caplog.set_level(logging.WARNING, logger="repro_torch.core.stream")
    overflow_seen = False
    for i, b in enumerate(batches):
        st = eng.step(b)
        ref.step(b)
        if i == 2:  # sabotage every known budget: later batches overflow
            for key in list(eng._export_budgets):
                eng._export_budgets[key] = 1
        if i > 2 and st.transport == "allgather":
            overflow_seen = True
        assert eng.graph.f.tobytes() == ref.graph.f.tobytes(), i
    assert overflow_seen and eng.transport_overflows > 0
    warned = [r for r in caplog.records if "overflow" in r.getMessage()]
    assert 1 <= len(warned) <= len(eng.bucket_keys)


def test_landmark_engine_on_the_mesh_is_bit_identical():
    """The landmark engine on an 8-shard mesh streams (latch, cold rows
    served) and equals the single-device landmark engine bit for bit: the
    approximation is in the staging, which the mesh does not change."""
    spec = StreamSpec(total_vertices=600, batch_size=20, seed=11, class_sep=6.0, noise=0.9,
                      frac_deleted=0.2, frac_labeled=0.05)
    batches = [b for b, _ in gaussian_mixture_stream(spec)]
    assert any(len(b.del_ids) for b in batches)
    cfg = LandmarkConfig(num_landmarks=32, assign_k=4, hot_ttl=3)
    g_m, g_s = _graph(spec), _graph(spec)
    eng_m = _engine(g_m, mesh=_mesh(), backend="landmark", landmark=cfg, ingest="device")
    eng_s = _engine(g_s, backend="landmark", landmark=cfg, ingest="device")
    for b in batches:
        st_m, st_s = eng_m.step(b), eng_s.step(b)
        assert (st_m.iterations, st_m.backend, st_m.num_unlabeled) == \
            (st_s.iterations, st_s.backend, st_s.num_unlabeled)
        assert st_m.bucket[0] % 8 == 0 and st_m.bucket[0] - st_s.bucket[0] < 8
    assert g_m.f.tobytes() == g_s.f.tobytes()
    assert st_m.backend == "landmark" and st_m.transport in ("allgather", "halo")
    s = eng_m.transport_summary()["landmark"]
    assert s["streaming"] and s["batches"] > 0 and s["cold_rows"] > 0
    assert s == eng_s.transport_summary()["landmark"]
    assert eng_m.ingestor.store.n_shards == 8
