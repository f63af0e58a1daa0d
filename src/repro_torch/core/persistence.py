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
    ``bsr`` slot budgets).

Keys and meta are the reference's, so a checkpoint written by either
package restores in the other.  Keys that have no meaning on one device
hold what a mesh-less reference engine writes: ``mesh_devices`` 0,
``transport`` "auto", empty transport and probe-cache entries.  ``platform``
is the torch device type.  Not saved: device buffers and read views, which
are rebuilt on demand.

Checkpoints are commit-boundary snapshots: state taken with a batch in
flight would mix batch t's host mutations with batch t-1's committed
labels, so ``engine_state`` refuses while ``engine.in_flight``.
"""

from __future__ import annotations

import json
import logging

import numpy as np

from repro_torch.checkpoint import manager
from repro_torch.core.snapshot import LabelView
from repro_torch.core.stream import StreamEngine
from repro_torch.device import resolve_device
from repro_torch.graph.dynamic import DynamicGraph
from repro_torch.kernels import ops

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


def _backend_knob(backend: str | None) -> str:
    """The backend knob as the reference pins it ("auto", or the name)."""
    return "auto" if backend in (None, "auto") else ops.backend_spec(backend).name


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
        "transport": "auto",
        "mesh_devices": 0,
        "backend_knob": _backend_knob(engine.backend),
        "backend_candidates": list(engine._backend_candidates),
        "ingest": _ingest_mode(engine),
        "ingest_order": engine.ingest_order,
        # stream position + ladder history
        "commits": int(engine.commits),
        "batches": int(engine.batches),
        "bucket_keys": sorted([int(u), int(k)] for u, k in engine.bucket_keys),
        # per-rung metadata, keyed "UxK" (validity-scoped on restore)
        "transport_modes": {},
        "export_budgets": {},
        "backend_modes": _by_rung(engine._backend_modes),
        "slot_budgets": _by_rung(engine._slot_budgets, int),
        "measured": {},
        "halo_batches": 0,
        "transport_overflows": 0,
        "bsr_batches": int(engine.bsr_batches),
        "backend_overflows": int(engine.backend_overflows),
    }
    store = getattr(engine.ingestor, "store", None)
    if store is not None:
        # one copy each, straight to the host: the live tensors, not
        # ``store.state_arrays()``'s device clones
        for k in ("emb", "valid", "kth"):
            state[f"store_{k}"] = getattr(store, k).to("cpu", copy=True).numpy()
        meta["store_count"] = int(store.count)
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
    backend: object = _UNSET,
    max_k: object = _UNSET,
    read_placement: object = "auto",
    ingest: object = _UNSET,
    device=None,
) -> StreamEngine:
    """Rebuild a ``StreamEngine`` from the latest (or given) checkpoint, on
    ``device`` (``None`` → ``cuda``).

    Keyword overrides replace the checkpointed knobs.  A checkpoint of the
    reference's restores here when its backend is one the port has, or
    with ``backend=`` naming one.  The backend decisions and ``bsr`` slot
    budgets reinstall only for a mesh-less checkpoint whose resolved knob
    and candidate backends equal the new engine's (a ``bsr`` rung must stay
    a ``bsr`` rung for replayed labels to stay bit-identical); otherwise
    they are re-derived at rung entry, as on a fresh stream, and the labels
    are the same either way.
    """
    dev = resolve_device(device)
    if step is None:
        step = manager.latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {directory}")
    state = manager.load_flat(directory, step)
    meta = json.loads(bytes(state["meta"]))
    if meta.get("version") != STATE_VERSION:
        raise ValueError(f"checkpoint state version {meta.get('version')} != "
                         f"supported {STATE_VERSION}")
    if meta.get("landmark") is not None:
        raise ValueError("checkpoint was taken with the landmark backend, which the "
                         "port does not have yet")

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

        ingestor = DeviceIngestor(meta["emb_dim"], device=dev)
        ingestor.store.load_state_arrays(
            {"emb": state["store_emb"], "valid": state["store_valid"],
             "kth": state["store_kth"]}, count=meta["store_count"])
        ingest = ingestor

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
        device=dev,
    )
    engine.commits = int(meta["commits"])
    engine.batches = int(meta["batches"])
    engine.bucket_keys = {(int(u), int(k)) for u, k in meta["bucket_keys"]}
    # the committed read view resumes at the saved commit id, so a restored
    # device view answers exactly as the original's did
    engine._view = LabelView.from_graph(g, commit_id=engine.commits)

    if (meta["mesh_devices"] == 0
            and meta["backend_knob"] == _backend_knob(engine.backend)
            and list(meta["backend_candidates"]) == list(engine._backend_candidates)):
        engine._backend_modes = _rungs(meta["backend_modes"])
        engine._slot_budgets = _rungs(meta["slot_budgets"], int)
        engine.bsr_batches = int(meta["bsr_batches"])
        engine.backend_overflows = int(meta["backend_overflows"])
    logger.info("restored engine from %s step %d: %d nodes, %d commits, on %s",
                directory, step, g.num_nodes, engine.commits, dev)
    return engine
