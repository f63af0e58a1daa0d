"""The port's checkpoints: the manager, the preemption guard and straggler
monitor, crash-safe engine persistence and the service's checkpoint policy.

Mirrors the manager, guard and straggler tests of ``tests/test_resilience.py``
(not its gradient compression nor its mesh test) and the single-device tests
of ``tests/test_checkpoint_restore.py`` (rung metadata: backends and ``bsr``
slot budgets), on the CPU, including the fault injection: a victim process
killed mid-drain, restored from its latest complete checkpoint and replayed,
bit-identical to an uninterrupted run.  Then both cross-package directions:
the two packages write the same layout, so a checkpoint of the JAX engine
restores into the port, and one of the port into the JAX engine, with
byte-identical graph and store arrays and query answers, and both go on
streaming to the same graph (labels within 20·δ).
"""

import json
import logging
import os
import shutil
import signal
import subprocess
import sys
import textwrap
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jckpt
from repro.core.stream import StreamEngine as JaxStreamEngine
from repro.data import synth as jsynth
from repro.graph import dynamic as jdyn
from repro_torch.checkpoint import manager as ckpt
from repro_torch.core import persistence
from repro_torch.core.stream import StreamEngine
from repro_torch.data.synth import StreamSpec, gaussian_mixture_stream
from repro_torch.graph.dynamic import UNLABELED, DynamicGraph
from repro_torch.serving.lp_service import LPService
from repro_torch.training.resilience import PreemptionGuard, StragglerMonitor

torch.set_num_threads(1)

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
SPEC = StreamSpec(total_vertices=300, batch_size=60, seed=7, class_sep=6.0, noise=0.9)
# the fault-injection stream, shared by the victim and the oracle
KILL_SPEC = dict(total_vertices=320, batch_size=40, seed=9, emb_dim=4, class_sep=6.0,
                 noise=0.9, frac_deleted=0.12, frac_unlabeled=0.85, frac_labeled=0.03)
KILL_AT = 5  # the batch whose drain the victim dies in (of 8)
GRAPH_KEYS = ("emb", "embn", "f", "labels", "alive", "knn_idx", "knn_wgt", "src", "dst",
              "wgt")
DELTA = 1e-4


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.normal(0, 1, (8, 16)).astype(np.float32)),
            "nested": {"b": torch.from_numpy(rng.normal(0, 1, (4,))).to(torch.bfloat16),
                       "step": torch.tensor(7, dtype=torch.int32)}}


def _batches(spec_kw=None):
    spec = SPEC if spec_kw is None else StreamSpec(**spec_kw)
    return [b for b, _ in gaussian_mixture_stream(spec)]


def _engine(g, **kw):
    return StreamEngine(g, delta=DELTA, device="cpu", **kw)


def _restore(directory, **kw):
    return StreamEngine.restore(directory, device="cpu", **kw)


def _assert_graphs_equal(g, g_ref):
    for name in GRAPH_KEYS:
        assert getattr(g, name).tobytes() == getattr(g_ref, name).tobytes(), name


def _assert_answers_equal(a, b, n):
    ids = np.arange(-3, n + 3)
    for got, want in zip(a.device_view().query(ids), b.device_view().query(ids)):
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes()


def _service(eng, **kw):
    kw.setdefault("window_ops", 10_000)
    kw.setdefault("window_ms", 1e9)  # admission only via flush()
    kw.setdefault("max_pending_ops", 100_000)
    return LPService(eng, **kw)


def _feed(svc, batch):
    svc.mutate(ins_emb=batch.ins_emb, ins_labels=batch.ins_labels, del_ids=batch.del_ids)
    svc.flush()
    svc.sync()


# ---------------------------------------------------------------------- #
# tests/test_resilience.py: the manager, the guard, the straggler monitor
# ---------------------------------------------------------------------- #
def _assert_trees_equal(a, b):
    assert set(a) == set(b)
    for key in a:
        if isinstance(a[key], dict):
            _assert_trees_equal(a[key], b[key])
        else:
            assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape
            assert torch.equal(a[key], b[key]), key


def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 5, t)
    assert ckpt.latest_step(str(tmp_path)) == 5
    _assert_trees_equal(ckpt.restore(str(tmp_path), 5, t), t)


def test_checkpoint_incomplete_ignored(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree())
    os.makedirs(tmp_path / "step_00000009")  # a torn write: no .complete marker
    assert ckpt.latest_step(str(tmp_path)) == 1


def test_manager_keeps_last_n(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save_sync(s, _tree())
    steps = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert steps == ["step_00000003", "step_00000004"]
    assert mgr.latest_step() == 4


def test_manager_async_then_restore(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path))
    t = _tree(3)
    mgr.save_async(10, t)
    mgr.wait()
    _assert_trees_equal(mgr.restore(t), t)


def test_manager_async_copies_at_the_call(tmp_path):
    """``save_async`` takes its host copies in the caller's thread: a
    tensor changed in place right after the call does not reach the file."""
    mgr = ckpt.CheckpointManager(str(tmp_path))
    t = {"w": torch.arange(1 << 16, dtype=torch.float32)}
    want = t["w"].clone()
    mgr.save_async(1, t)
    t["w"].fill_(-1.0)
    mgr.wait()
    assert torch.equal(mgr.restore({"w": want})["w"], want)


def test_manager_async_failure_surfaces(tmp_path):
    """A failed async write re-raises at the next wait()/save_async()/
    save_sync(), once, and the manager stays usable afterwards."""
    ckdir = tmp_path / "ck"
    mgr = ckpt.CheckpointManager(str(ckdir))
    t = _tree()
    mgr.save_async(1, t)
    mgr.wait()
    shutil.rmtree(ckdir)  # sabotage: the directory becomes a plain file
    ckdir.write_text("not a directory")
    mgr.save_async(2, t)
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()  # delivered once, then cleared
    mgr.save_async(3, t)
    with pytest.raises(OSError):
        mgr.save_async(4, t)
    mgr.save_async(5, t)
    with pytest.raises(OSError):
        mgr.save_sync(6, t)
    ckdir.unlink()
    mgr.save_sync(7, t)
    assert mgr.latest_step() == 7


def test_save_rejects_removed_wait_param(tmp_path):
    with pytest.raises(TypeError):
        ckpt.save(str(tmp_path), 1, _tree(), wait=False)


def test_latest_step_and_gc_survive_malformed_entries(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), keep=2)
    t = _tree()
    mgr.save_sync(1, t)
    (tmp_path / "step_x").write_text("junk")
    os.makedirs(tmp_path / "step_notanumber")
    os.makedirs(tmp_path / "step_00000042.tmp")
    assert ckpt.latest_step(str(tmp_path)) == 1
    mgr.save_sync(2, t)  # runs _gc: must not raise, must reap the tmp
    assert not (tmp_path / "step_00000042.tmp").exists()
    assert (tmp_path / "step_x").exists()
    assert (tmp_path / "step_notanumber").exists()
    assert mgr.latest_step() == 2


def test_restore_rejects_a_different_tree(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree())
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(str(tmp_path), 1, {"a": torch.zeros(8, 16)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), 1, {**_tree(), "a": torch.zeros(8, 15)})
    with pytest.raises(FileNotFoundError):
        ckpt.load_flat(str(tmp_path), 2)


def test_layout_is_the_references(tmp_path):
    """The port and the JAX package write the same files for the same
    tree: manifests equal, every arr_<i>.npy byte-identical, and each
    package restores the other's checkpoint."""
    t = _tree(4)
    jt = {"a": jnp.asarray(t["a"].numpy()),
          "nested": {"b": jnp.asarray(t["nested"]["b"].float().numpy(), jnp.bfloat16),
                     "step": jnp.asarray(7, jnp.int32)}}
    ckpt.save(str(tmp_path / "port"), 3, t)
    jckpt.save(str(tmp_path / "jax"), 3, jt)
    step = "step_00000003"
    files = sorted(os.listdir(tmp_path / "port" / step))
    assert files == sorted(os.listdir(tmp_path / "jax" / step))
    for name in files:
        assert (tmp_path / "port" / step / name).read_bytes() == \
            (tmp_path / "jax" / step / name).read_bytes(), name
    _assert_trees_equal(ckpt.restore(str(tmp_path / "jax"), 3, t), t)
    back = jckpt.restore(str(tmp_path / "port"), 3, jt)
    assert np.asarray(back["a"]).tobytes() == np.asarray(jt["a"]).tobytes()
    assert np.asarray(back["nested"]["b"]).tobytes() == np.asarray(jt["nested"]["b"]).tobytes()
    flat = ckpt.load_flat(str(tmp_path / "jax"), 3)
    assert set(flat) == {"a", "['nested']['b']", "['nested']['step']"}


def test_straggler_end_step_without_start_is_noop(caplog):
    mon = StragglerMonitor(threshold=2.0, window=16)
    with caplog.at_level(logging.WARNING, "repro_torch.training.resilience"):
        assert mon.end_step() is None
    assert any("without start_step" in r.message for r in caplog.records)
    assert len(mon.times) == 0
    mon.start_step()
    assert mon.end_step() is None
    assert len(mon.times) == 1
    assert mon.end_step() is None
    assert len(mon.times) == 1
    for _ in range(10):
        assert mon.observe(0.1) is None
    assert mon.observe(0.5) is not None


def test_straggler_monitor_flags_outlier():
    mon = StragglerMonitor(threshold=2.0, window=16)
    for _ in range(10):
        assert mon.observe(0.1) is None
    ev = mon.observe(0.5)
    assert ev is not None and ev.seconds >= 0.5 and abs(ev.median - 0.1) < 0.02
    assert mon.observe(0.11) is None


def test_preemption_guard_installs_both_signals_and_rearms():
    old_term, old_int = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)
    guard = PreemptionGuard()
    try:
        assert signal.getsignal(signal.SIGTERM) == guard._handler
        assert signal.getsignal(signal.SIGINT) == guard._handler
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.requested
    finally:
        guard.restore()
    assert signal.getsignal(signal.SIGTERM) == old_term
    assert signal.getsignal(signal.SIGINT) == old_int
    assert not guard.requested
    with guard as g:  # the same guard, as a context manager
        assert g is guard
        assert signal.getsignal(signal.SIGTERM) == guard._handler
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.requested
    assert signal.getsignal(signal.SIGTERM) == old_term
    assert not guard.requested


def test_preemption_guard_custom_signals():
    old_term, old_usr1 = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGUSR1)
    with PreemptionGuard(signals=(signal.SIGUSR1,)) as guard:
        assert signal.getsignal(signal.SIGTERM) == old_term
        os.kill(os.getpid(), signal.SIGUSR1)
        assert guard.requested
    assert signal.getsignal(signal.SIGUSR1) == old_usr1
    none_guard = PreemptionGuard(signals=())
    assert not none_guard.requested
    none_guard.restore()


def test_preemption_guard_off_the_main_thread_raises():
    """``signal.signal`` works only on the main thread; the guard does not
    swallow that."""
    errors = []

    def build():
        try:
            PreemptionGuard()
        except ValueError as e:
            errors.append(e)

    th = threading.Thread(target=build)
    th.start()
    th.join(30.0)
    assert not th.is_alive() and len(errors) == 1


# ---------------------------------------------------------------------- #
# tests/test_checkpoint_restore.py, single device
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("ingest", ["host", "device"])
def test_engine_checkpoint_restore_roundtrip(tmp_path, ingest):
    """Checkpoint mid-stream, restore, replay the rest: every graph array,
    the counters and the committed view match the uninterrupted engine bit
    for bit; with device ingest the store (count, capacity, k-th weights)
    too."""
    batches = _batches()
    g_ref = DynamicGraph(emb_dim=SPEC.emb_dim, k=5)
    ref = _engine(g_ref, ingest=ingest)
    for b in batches:
        ref.step(b)
    g = DynamicGraph(emb_dim=SPEC.emb_dim, k=5)
    eng = _engine(g, ingest=ingest)
    for b in batches[:3]:
        eng.step(b)
    eng.checkpoint(str(tmp_path))
    assert ckpt.latest_step(str(tmp_path)) == eng.commits

    r = _restore(str(tmp_path))
    assert r.commits == eng.commits and r.batches == eng.batches
    assert r.bucket_keys == eng.bucket_keys
    assert r.committed_view().commit_id == eng.commits
    _assert_graphs_equal(r.graph, g)
    if ingest == "device":
        store, orig = r.ingestor.store, eng.ingestor.store
        assert (store.count, store.capacity) == (orig.count, orig.capacity)
        for name in ("emb", "valid", "kth"):
            assert torch.equal(getattr(store, name), getattr(orig, name)), name
    else:
        assert r.ingestor is None
    for b in batches[3:]:
        r.step(b)
    _assert_graphs_equal(r.graph, g_ref)
    _assert_answers_equal(r, ref, g_ref.num_nodes)


def test_checkpoint_refuses_in_flight(tmp_path):
    batches = _batches()
    eng = _engine(DynamicGraph(emb_dim=SPEC.emb_dim, k=5))
    eng.submit(batches[0])
    assert eng.in_flight
    with pytest.raises(RuntimeError, match="in flight"):
        eng.checkpoint(str(tmp_path))
    with pytest.raises(RuntimeError, match="in flight"):
        eng.checkpoint_state()
    eng.drain()
    eng.checkpoint(str(tmp_path))
    assert ckpt.latest_step(str(tmp_path)) == eng.commits


def test_restore_latest_default_and_step_selection(tmp_path):
    with pytest.raises(FileNotFoundError, match="no committed checkpoint"):
        _restore(str(tmp_path))
    batches = _batches()
    eng = _engine(DynamicGraph(emb_dim=SPEC.emb_dim, k=5))
    eng.step(batches[0])
    eng.checkpoint(str(tmp_path))
    first = eng.commits
    eng.step(batches[1])
    eng.checkpoint(str(tmp_path))
    assert _restore(str(tmp_path)).commits == eng.commits
    assert _restore(str(tmp_path), step=first).commits == first


def test_meta_holds_every_key_the_reference_reads(tmp_path):
    eng = _engine(DynamicGraph(emb_dim=SPEC.emb_dim, k=5), ingest="device")
    eng.step(_batches()[0])
    state = eng.checkpoint_state()
    meta = json.loads(bytes(state["meta"]))
    for key in ("version", "platform", "emb_dim", "k", "knn_block", "delta", "tau",
                "max_iters", "max_degree", "backend", "block_rows", "interpret", "max_k",
                "transport", "mesh_devices", "backend_knob", "backend_candidates", "ingest",
                "ingest_order", "commits", "batches", "bucket_keys", "transport_modes",
                "export_budgets", "backend_modes", "slot_budgets", "measured", "halo_batches",
                "transport_overflows", "bsr_batches", "backend_overflows", "store_count"):
        assert key in meta, key
    assert (meta["mesh_devices"], meta["transport"], meta["measured"]) == (0, "auto", {})
    assert meta["platform"] == "cpu" and meta["ingest"] == "device"
    assert all(isinstance(v, np.ndarray) for v in state.values())


def test_restore_keeps_rung_metadata_on_the_same_knob(tmp_path):
    """A ``bsr`` engine restored with its own knob keeps its rung backends
    and slot budgets (a bsr rung stays bsr) and replays bit-identically."""
    batches = _batches()
    g_ref = DynamicGraph(emb_dim=SPEC.emb_dim, k=5)
    ref = _engine(g_ref, backend="bsr")
    for b in batches:
        ref.step(b)
    eng = _engine(DynamicGraph(emb_dim=SPEC.emb_dim, k=5), backend="bsr")
    for b in batches[:3]:
        eng.step(b)
    eng.checkpoint(str(tmp_path))
    r = _restore(str(tmp_path))
    assert r.backend == "bsr"
    assert r._backend_modes == eng._backend_modes and r._backend_modes
    assert r._slot_budgets == eng._slot_budgets
    assert (r.bsr_batches, r.backend_overflows) == (eng.bsr_batches, eng.backend_overflows)
    for b in batches[3:]:
        r.step(b)
    _assert_graphs_equal(r.graph, g_ref)
    _assert_answers_equal(r, ref, g_ref.num_nodes)


def test_restore_drops_stale_rung_metadata_on_knob_change(tmp_path):
    """Rung decisions whose validity breaks (bsr → the default knob) are
    dropped and re-derived; the restored engine goes on as a fresh default
    engine would from the same graph."""
    batches = _batches()
    eng = _engine(DynamicGraph(emb_dim=SPEC.emb_dim, k=5), backend="bsr")
    for b in batches[:3]:
        eng.step(b)
    eng.checkpoint(str(tmp_path))
    r = _restore(str(tmp_path), backend=None)
    assert r._backend_modes == {} and r._slot_budgets == {} and r.bsr_batches == 0
    twin = _restore(str(tmp_path), backend=None)
    for b in batches[3:]:
        assert r.step(b).backend == "ref"
        twin.step(b)
    _assert_graphs_equal(r.graph, twin.graph)


def test_service_checkpoint_cadence_async(tmp_path):
    g = DynamicGraph(emb_dim=SPEC.emb_dim, k=5)
    svc = _service(_engine(g), checkpoint_every=2, checkpoint_dir=str(tmp_path))
    batches = _batches()
    for b in batches:
        _feed(svc, b)
    svc._ckpt_mgr.wait()
    st = svc.stats()
    assert st.checkpoints_written >= 2
    assert svc.engine.commits - st.last_checkpoint_commit < 2
    assert ckpt.latest_step(str(tmp_path)) == st.last_checkpoint_commit
    r = _restore(str(tmp_path))
    for b in batches[r.batches:]:
        r.step(b)
    _assert_graphs_equal(r.graph, g)


def test_service_shutdown_writes_final_sync_checkpoint(tmp_path):
    g = DynamicGraph(emb_dim=SPEC.emb_dim, k=5)
    svc = _service(_engine(g), checkpoint_dir=str(tmp_path))
    batches = _batches()
    for b in batches[:2]:
        _feed(svc, b)
    svc.mutate(ins_emb=batches[2].ins_emb, ins_labels=batches[2].ins_labels,
               del_ids=batches[2].del_ids)  # left un-synced: shutdown commits it
    step = svc.shutdown()
    assert step == svc.engine.commits == 3
    assert ckpt.latest_step(str(tmp_path)) == step
    _assert_graphs_equal(_restore(str(tmp_path)).graph, g)
    svc2 = _service(_engine(DynamicGraph(emb_dim=SPEC.emb_dim, k=5)))
    _feed(svc2, batches[0])
    assert svc2.shutdown() is None


def test_service_async_checkpoint_failure_surfaces(tmp_path):
    ckdir = tmp_path / "ck"
    svc = _service(_engine(DynamicGraph(emb_dim=SPEC.emb_dim, k=5)), checkpoint_every=1,
                   checkpoint_dir=str(ckdir))
    batches = _batches()
    _feed(svc, batches[0])
    svc._ckpt_mgr.wait()
    shutil.rmtree(ckdir)  # sabotage: every later write fails
    ckdir.write_text("not a directory")
    _feed(svc, batches[1])
    with pytest.raises(RuntimeError, match="durable state is stale"):
        for b in batches[2:]:
            _feed(svc, b)
    _feed(svc, batches[-1])  # delivered once; the service goes on


def test_service_preemption_drains_checkpoints_halts(tmp_path):
    g = DynamicGraph(emb_dim=SPEC.emb_dim, k=5)
    svc = _service(_engine(g), checkpoint_dir=str(tmp_path))
    guard = svc.arm_preemption(PreemptionGuard(signals=()))
    batches = _batches()
    svc.start()
    for b in batches[:2]:
        _feed(svc, b)
    svc.mutate(ins_emb=batches[2].ins_emb, ins_labels=batches[2].ins_labels,
               del_ids=batches[2].del_ids)
    svc.flush()
    assert svc.engine.in_flight
    guard.requested = True
    svc.pump()  # any clock tick observes the guard
    st = svc.stats()
    assert st.preempted and not svc.engine.in_flight
    assert st.last_checkpoint_commit == svc.engine.commits == 3
    assert ckpt.latest_step(str(tmp_path)) == 3
    with pytest.raises(RuntimeError, match="preempted"):
        svc.mutate(ins_emb=batches[3].ins_emb)
    svc.stop()
    assert not svc.driver_running
    _assert_graphs_equal(_restore(str(tmp_path)).graph, g)


def test_service_checkpoint_policy_validation(tmp_path):
    eng = _engine(DynamicGraph(emb_dim=4, k=3))
    with pytest.raises(ValueError, match="requires checkpoint_dir"):
        LPService(eng, checkpoint_every=4)
    with pytest.raises(ValueError, match="checkpoint_every"):
        LPService(eng, checkpoint_every=0, checkpoint_dir=str(tmp_path))


VICTIM = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, {src!r})
    import torch
    torch.set_num_threads(1)
    from repro_torch.core.stream import StreamEngine
    from repro_torch.data.synth import StreamSpec, gaussian_mixture_stream
    from repro_torch.graph.dynamic import DynamicGraph
    from repro_torch.serving.lp_service import LPService

    spec = StreamSpec(**{spec!r})
    batches = [b for b, _ in gaussian_mixture_stream(spec)]
    g = DynamicGraph(emb_dim=spec.emb_dim, k=5)
    eng = StreamEngine(g, delta=1e-4, ingest="device", device="cpu")
    svc = LPService(eng, window_ops=10_000, window_ms=1e9, max_pending_ops=100_000,
                    checkpoint_every=1, checkpoint_dir={dir!r})
    for b in batches[:{kill}]:
        svc.mutate(ins_emb=b.ins_emb, ins_labels=b.ins_labels, del_ids=b.del_ids)
        svc.flush()
        svc.sync()
    b = batches[{kill}]
    svc.mutate(ins_emb=b.ins_emb, ins_labels=b.ins_labels, del_ids=b.del_ids)
    svc.flush()
    assert eng.in_flight
    eng.drain = lambda: os._exit(137)  # die mid-drain of batch {kill}
    svc.sync()
    raise SystemExit("unreachable: the drain should have killed us")
""")


def test_kill_mid_drain_restore_replay(tmp_path):
    """A victim process dies with ``os._exit`` inside the drain of batch
    KILL_AT (the in-flight solve is lost, an async checkpoint write may be
    torn); restore from the latest complete checkpoint and replay the rest
    here: graph and answers bit-identical to the uninterrupted run (device
    ingest, so the store's crash path is exercised too)."""
    ckdir = str(tmp_path / "ck")
    out = subprocess.run(
        [sys.executable, "-c", VICTIM.format(src=SRC, spec=KILL_SPEC, dir=ckdir, kill=KILL_AT)],
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 137, (out.returncode, out.stderr[-3000:])
    batches = _batches(KILL_SPEC)
    g_ref = DynamicGraph(emb_dim=KILL_SPEC["emb_dim"], k=5)
    ref = _engine(g_ref, ingest="device")
    for b in batches:
        ref.step(b)
    r = _restore(ckdir)
    assert 0 < r.batches <= KILL_AT  # never the lost batch
    for b in batches[r.batches:]:
        r.step(b)
    _assert_graphs_equal(r.graph, g_ref)
    for name in ("emb", "valid", "kth"):
        assert torch.equal(getattr(r.ingestor.store, name), getattr(ref.ingestor.store, name))
    _assert_answers_equal(r, ref, g_ref.num_nodes)


# ---------------------------------------------------------------------- #
# across packages
# ---------------------------------------------------------------------- #
XSPEC = dict(total_vertices=240, batch_size=60, emb_dim=8, seed=8, class_sep=6.0, noise=0.9)


def _store_arrays(store):
    return {name: np.asarray(getattr(store, name)) if not isinstance(
        getattr(store, name), torch.Tensor) else getattr(store, name).numpy()
        for name in ("emb", "valid", "kth")}


def _check_across(jeng, teng):
    jg, tg = jeng.graph, teng.graph
    for name in GRAPH_KEYS:
        if name != "f":
            assert getattr(jg, name).tobytes() == getattr(tg, name).tobytes(), name
    unl = np.flatnonzero(tg.alive & (tg.labels == UNLABELED))
    assert np.abs(jg.f[unl] - tg.f[unl]).max(initial=0) <= 20 * DELTA
    js, ts = _store_arrays(jeng.ingestor.store), _store_arrays(teng.ingestor.store)
    for name in js:
        assert js[name].tobytes() == ts[name].tobytes(), name


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_restores_across_packages(tmp_path, direction):
    """Two batches through one package's device-ingest engine, checkpoint,
    restore in the other package: graph arrays, store arrays, committed
    labels and device-view answers byte-identical; then both go on with
    the same batches to the same graph, labels within 20·δ."""
    jb = [b for b, _ in jsynth.gaussian_mixture_stream(jsynth.StreamSpec(**XSPEC))]
    tb = [b for b, _ in gaussian_mixture_stream(StreamSpec(**XSPEC))]
    d = str(tmp_path)
    if direction == "jax_to_port":
        src = JaxStreamEngine(jdyn.DynamicGraph(8, k=4), delta=DELTA, backend="ref",
                              ingest="device")
        for b in jb[:2]:
            src.step(b)
        src.checkpoint(d)
        dst = persistence.restore_engine(d, device="cpu")
        jeng, teng = src, dst
    else:
        src = _engine(DynamicGraph(8, k=4), ingest="device")
        for b in tb[:2]:
            src.step(b)
        src.checkpoint(d)
        dst = JaxStreamEngine.restore(d, backend="ref", block_rows=512, interpret=None)
        jeng, teng = dst, src
    assert (dst.commits, dst.batches) == (src.commits, src.batches)
    assert dst.ingestor.store.count == src.ingestor.store.count
    for name in GRAPH_KEYS:
        assert getattr(dst.graph, name).tobytes() == getattr(src.graph, name).tobytes(), name
    _check_across(jeng, teng)
    for a, b in zip(src.committed_view().query(np.arange(-2, 125)),
                    dst.committed_view().query(np.arange(-2, 125))):
        assert a.tobytes() == b.tobytes()
    _assert_answers_equal(src, dst, src.graph.num_nodes)
    for j, t in zip(jb[2:], tb[2:]):
        assert jeng.step(j).converged and teng.step(t).converged
        _check_across(jeng, teng)
