"""Durable engine state: crash-safe checkpoint/restore for the stream.

Counterpart of ``repro.core.persistence``.  A restart would otherwise throw
away the engine's incremental state and force the full recomputation DynLP
exists to avoid.  This module writes all of it through the atomic
``checkpoint.manager`` format (``step_<N>/`` + manifest + ``.complete``
marker), so a restarted engine resumes bit-identically:

  * the ``DynamicGraph`` buffers (embeddings, labels, alive, fractional
    labels ``f``, kNN lists, undirected edge arrays),
  * the ``EmbeddingStore`` contents and per-row k-th weights (device
    ingest), so the restored selector prunes exactly as before,
  * the commit/batch counters and the rung metadata (per-rung backends,
    ``bsr`` slot budgets, transport modes, halo export budgets and the
    ``auto:measured`` probe cache),
  * the ``landmark`` backend's factorization (landmark ids and rows, the
    assignment table) and its working-set clock and latch, so a restored
    hot/cold stream replays identically.

Keys and meta are the reference's, so a checkpoint written by either
package restores in the other.  ``mesh_devices`` is the mesh's shard count
(0 without a mesh); a mesh engine's checkpoint holds full host arrays (the
sharded store's included), so it restores onto any mesh or none: the
restores are elastic.  ``platform`` is the torch device type.  Not saved:
device buffers and read views, which are rebuilt on demand.

Checkpoints are commit-boundary snapshots: state taken with a batch in
flight would mix batch t's host mutations with batch t-1's committed
labels, so ``engine_state`` refuses while ``engine.in_flight``.
"""

from __future__ import annotations

import json
import logging

import numpy as np

from repro_torch.checkpoint import manager
from repro_torch.core.distributed import DeviceMesh
from repro_torch.core.snapshot import LabelView
from repro_torch.core.stream import StreamEngine
from repro_torch.device import resolve_device
from repro_torch.graph.dynamic import DynamicGraph

logger = logging.getLogger(__name__)

STATE_VERSION = 1

# the reference engine's ``block_rows`` default: the port's kernels have no
# row block, but the reference's restore reads the key
REFERENCE_BLOCK_ROWS = 512

_UNSET = object()  # "use the checkpointed value" override sentinel


def _ingest_mode(engine: StreamEngine) -> str:
    if engine.ingestor is None:
        return "host"
    return "device" if hasattr(engine.ingestor, "store") else "custom"


def _by_rung(d: dict, cast=lambda v: v) -> dict:
    return {f"{u}x{k}": cast(v) for (u, k), v in d.items()}


def engine_state(engine: StreamEngine) -> dict:
    """Flat ``{name: array}`` snapshot of the engine's incremental state,
    every array a host copy taken now (the graph mutates in place and the
    store's tensors change with the next window, so an async writer must
    not read them later)."""
    if engine.in_flight:
        raise RuntimeError(
            "cannot snapshot with a batch in flight — drain() first "
            "(checkpoints are commit-boundary snapshots)")
    g = engine.graph
    state = {f"graph_{k}": v for k, v in g.state_arrays().items()}
    meta = {
        "version": STATE_VERSION,
        "platform": engine.device.type,
        # graph hyperparameters (reconstruct the DynamicGraph)
        "emb_dim": g.emb_dim,
        "k": g.k,
        "knn_block": g.knn_block,
        # engine hyperparameters (reconstruct the StreamEngine)
        "delta": float(engine.delta),
        "tau": None if engine.tau is None else float(engine.tau),
        "max_iters": int(engine.max_iters),
        "max_degree": engine.max_degree,
        "backend": engine.backend,
        "block_rows": REFERENCE_BLOCK_ROWS,
        "interpret": None,
        "max_k": engine.max_k,  # resolved: int or None
        "transport": engine.transport,
        "mesh_devices": engine.mesh.n_devices if engine.mesh is not None else 0,
        "backend_knob": engine._backend_knob,
        "backend_candidates": list(engine._backend_candidates),
        "ingest": _ingest_mode(engine),
        "ingest_order": engine.ingest_order,
        # stream position + ladder history
        "commits": int(engine.commits),
        "batches": int(engine.batches),
        "bucket_keys": sorted([int(u), int(k)] for u, k in engine.bucket_keys),
        # per-rung metadata, keyed "UxK" (validity-scoped on restore)
        "transport_modes": _by_rung(engine._transport_modes),
        "export_budgets": _by_rung(engine._export_budgets, int),
        "backend_modes": _by_rung(engine._backend_modes),
        "slot_budgets": _by_rung(engine._slot_budgets, int),
        # the auto:measured probe cache
        "measured": _by_rung(engine._measured),
        "halo_batches": int(engine.halo_batches),
        "transport_overflows": int(engine.transport_overflows),
        "bsr_batches": int(engine.bsr_batches),
        "backend_overflows": int(engine.backend_overflows),
    }
    store = getattr(engine.ingestor, "store", None)
    if store is not None:
        # one copy each, straight to the host, as full arrays whatever the
        # mesh (a sharded store's shards concatenated)
        for k, v in store.host_state().items():
            state[f"store_{k}"] = v
        meta["store_count"] = int(store.count)
    lm = engine._lm
    if lm is not None:
        state["landmark_touched_at"] = engine._touched_at.copy()
        meta["landmark"] = {
            "streaming": engine._lm_streaming,
            "batches": int(engine.landmark_batches),
            "cold_rows": int(engine.landmark_cold_rows),
            "ready": lm.ready,
            **lm.state_meta(),
        }
        if lm.ready:
            for k, v in lm.state_arrays().items():
                state[f"landmark_{k}"] = v
    state["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8).copy()
    return state


def save_engine(engine: StreamEngine, directory: str, step: int | None = None) -> str:
    """Write one atomic engine checkpoint; ``step`` defaults to the commit
    counter (one checkpoint per commit id, latest wins on restore)."""
    step = engine.commits if step is None else step
    return manager.save(directory, step, engine_state(engine))


def _rungs(d: dict, cast=lambda v: v) -> dict:
    return {tuple(int(x) for x in key.split("x")): cast(v) for key, v in d.items()}


def restore_engine(
    directory: str,
    step: int | None = None,
    *,
    mesh: DeviceMesh | None = None,
    transport: object = _UNSET,
    backend: object = _UNSET,
    max_k: object = _UNSET,
    read_placement: object = "auto",
    ingest: object = _UNSET,
    landmark: object = _UNSET,
    device=None,
) -> StreamEngine:
    """Rebuild a ``StreamEngine`` from the latest (or given) checkpoint, on
    ``device`` (``None`` → ``cuda``, or the mesh's first device).

    Elastic: the checkpoint holds full host arrays, so ``mesh=`` is
    whatever mesh is wanted now (none, the original, or another shard
    count); buffers, plans and the sharded store re-stage onto it.
    Keyword overrides replace the checkpointed knobs; a saved ``"halo"``
    transport degrades to the auto default on a mesh-less restore.  A
    checkpoint of the reference's restores here when its backend is one
    the port has, or with ``backend=`` naming one.

    Rung metadata reinstalls only where it stays valid, else it is
    re-derived at rung entry as on a fresh stream (the labels are the same
    either way):

      * backend decisions and ``bsr`` slot budgets: the same shard count
        and the same resolved knob and candidate backends (a ``bsr`` rung
        must stay a ``bsr`` rung for replayed labels to stay
        bit-identical);
      * transport modes and export budgets: the same shard count and the
        same transport knob, ``auto:measured`` excepted (it re-derives its
        modes from the probe cache, so cache hits are seen);
      * the ``auto:measured`` probe cache: the same shard count and the
        same platform (the times are the hardware's).

    ``landmark`` defaults to the saved configuration.  The saved landmark
    state (factorization, working-set clock, latch, counters) reinstalls
    when the engine's configuration keeps its geometry (the number of
    landmarks and ``assign_k``); another geometry starts a fresh
    factorization.
    """
    dev = resolve_device(device) if mesh is None or device is not None else mesh.device
    if step is None:
        step = manager.latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {directory}")
    state = manager.load_flat(directory, step)
    meta = json.loads(bytes(state["meta"]))
    if meta.get("version") != STATE_VERSION:
        raise ValueError(f"checkpoint state version {meta.get('version')} != "
                         f"supported {STATE_VERSION}")

    g = DynamicGraph(meta["emb_dim"], k=meta["k"], knn_block=meta["knn_block"])
    g.load_state_arrays({k[len("graph_"):]: v for k, v in state.items()
                         if k.startswith("graph_")})

    if ingest is _UNSET:
        ingest = meta["ingest"]
        if ingest == "custom":
            raise ValueError(
                "checkpoint was taken with a custom ingest selector; pass "
                "ingest=<selector instance> (or 'host'/'device') to restore_engine")
    if ingest == "device" and "store_valid" in state:
        # load the saved store instead of letting the engine backfill it
        # from the graph: the same rows, but the capacity rung and the
        # k-th pruning thresholds stay exact
        from repro_torch.ingest import DeviceIngestor

        ingestor = DeviceIngestor(meta["emb_dim"], device=dev, mesh=mesh)
        ingestor.store.load_state_arrays(
            {"emb": state["store_emb"], "valid": state["store_valid"],
             "kth": state["store_kth"]}, count=meta["store_count"])
        ingest = ingestor

    if transport is _UNSET:
        transport = meta["transport"]
        if transport == "halo" and mesh is None:
            transport = None  # elastic: a mesh-less restore degrades to auto

    lm_meta = meta.get("landmark")
    if landmark is _UNSET:
        landmark = ({key: lm_meta[key] for key in ("num_landmarks", "assign_k", "hot_ttl",
                                                   "resample_factor", "dead_frac_max")}
                    if lm_meta is not None else None)

    engine = StreamEngine(
        g,
        delta=meta["delta"],
        tau=meta["tau"],
        max_iters=meta["max_iters"],
        max_degree=meta["max_degree"],
        backend=meta["backend"] if backend is _UNSET else backend,
        max_k=meta["max_k"] if max_k is _UNSET else max_k,
        ingest=ingest,
        ingest_order=meta.get("ingest_order", "arrival"),
        read_placement=read_placement,
        landmark=landmark,
        mesh=mesh,
        transport=transport,
        device=dev,
    )
    if lm_meta is not None and engine._lm is not None:
        cfg = engine._lm.cfg
        if (cfg.num_landmarks, cfg.assign_k) == (lm_meta["num_landmarks"],
                                                 lm_meta["assign_k"]):
            if "landmark_touched_at" in state:
                engine._touched_at = np.asarray(state["landmark_touched_at"],
                                                np.int64).copy()
            engine._lm_streaming = bool(lm_meta["streaming"])
            engine.landmark_batches = int(lm_meta["batches"])
            engine.landmark_cold_rows = int(lm_meta["cold_rows"])
            if lm_meta.get("ready") and "landmark_ids" in state:
                engine._lm.load_state(
                    {k: state[f"landmark_{k}"]
                     for k in ("ids", "emb", "lm_valid", "assign_idx", "assign_w")},
                    lm_meta)
    engine.commits = int(meta["commits"])
    engine.batches = int(meta["batches"])
    engine.bucket_keys = {(int(u), int(k)) for u, k in meta["bucket_keys"]}
    # the committed read view resumes at the saved commit id, so a restored
    # device view answers exactly as the original's did
    engine._view = LabelView.from_graph(g, commit_id=engine.commits)

    n_dev = mesh.n_devices if mesh is not None else 0
    same_mesh = meta["mesh_devices"] == n_dev
    if (same_mesh and meta["backend_knob"] == engine._backend_knob
            and list(meta["backend_candidates"]) == list(engine._backend_candidates)):
        engine._backend_modes = _rungs(meta["backend_modes"])
        engine._slot_budgets = _rungs(meta["slot_budgets"], int)
        engine.bsr_batches = int(meta["bsr_batches"])
        engine.backend_overflows = int(meta["backend_overflows"])
    if (same_mesh and meta["transport"] == engine.transport
            and engine.transport != "auto:measured"):
        engine._transport_modes = _rungs(meta["transport_modes"])
        engine._export_budgets = _rungs(meta["export_budgets"], int)
        engine.halo_batches = int(meta["halo_batches"])
        engine.transport_overflows = int(meta["transport_overflows"])
    if same_mesh and meta["platform"] == engine.device.type:
        engine._measured = _rungs(meta["measured"], dict)
    logger.info("restored engine from %s step %d: %d nodes, %d commits, mesh %d -> %d "
                "shards, %d cached probe rungs, on %s", directory, step, g.num_nodes,
                engine.commits, meta["mesh_devices"], n_dev, len(engine._measured), dev)
    return engine
