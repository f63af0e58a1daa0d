"""Streaming engine for dynamic batch updates, on one device or a mesh.

Counterpart of ``repro.core.stream``.
``DynLP.step`` builds a fresh problem per Δ_t and waits for its solve;
``StreamEngine`` is the amortized version:

  * **Bucket ladder** — every snapshot is padded up the geometric
    ``(U_bucket, K_bucket)`` ladder (``snapshot.bucket`` ×
    ``snapshot.bucket_k``), so an unbounded stream touches a bounded set of
    shapes (``snapshot.ladder_size``).
  * **Two buffer generations per rung** — per bucket the engine keeps two
    device copies of ``(nbr, wgt, wl0, wl1, valid)`` and stages batch t+1
    (``copy_`` into the existing tensors) into the generation *not* read
    by batch t's in-flight solve.  A rung allocates its buffers once; a
    ``StreamStats.recompiled`` batch is one that entered a rung for the
    first time, so ``recompile_count`` ≤ ``ladder_size``.
  * **Overlap** — ``submit`` applies Δ_t on the host, stages it, queues its
    solve and returns; only the NEXT ``submit`` (or ``drain``) waits for
    it.  The frontier loop syncs the host once per sweep, so a side CUDA
    stream alone would not free the caller: each solve runs on one worker
    thread, which on a CUDA device queues its work on a side stream behind
    an event recorded after the staged tensors.  Those tensors stay
    referenced until ``drain``; the graph's ``f`` is read only at
    ``drain``.  With device ingest, batch t+1's argkmin runs on the
    caller's stream while batch t's solve runs on the side stream.  On the
    CPU the same code runs, without the streams.

``step`` (submit + drain) keeps ``DynLP.step``'s semantics and gives its
bits: the same host snapshot, supernode init and backend on the same inputs
(tests/test_torch_stream.py).  The solve goes through the backend registry
of ``kernels.ops``: each rung's backend is resolved once, at rung entry.

A ``bsr`` rung stages every snapshot in the paper's Step-1 component order
(``core.components.component_order``), so the adjacency densifies into
tiles, derives the per-edge tile-slot map on the host
(``kernels.bsr_spmv.ell_bsr_layout``) and fixes one tile-slot budget per
rung.  A Δ_t whose slot requirement exceeds the rung's budget runs on
``ell_cuda`` instead, warned once per rung and counted in
``backend_overflows``.  Solved rows fold back through the order's inverse
at ``drain``.

The ``landmark`` backend changes the staging, not the solve: once its
lazily sampled landmark state is ready and the registry resolves the
engine's knob to ``"landmark"`` (a decision that then latches), snapshots
restrict to the hot working set (rows a Δ_t touched within the last
``hot_ttl`` batches), cold unlabeled neighbors fold their committed labels
into the supernode weights (``snapshot.build_host_problem(hot=)``), and
each commit runs the low-rank cold pass of ``kernels.landmark_propagate``
over the cold rows.  Its labels answer for a hot-set agreement floor
against the exact engine, not for equal bits.

With ``mesh=`` (a ``core.distributed.DeviceMesh``) the same stream spans
the mesh's shards: rows of every bucket are cut into contiguous shard
blocks (buckets padded to a multiple of the shard count), each shard's
solve runs on its own device, and one partition plan per ladder rung is
reused for every batch in it.  ``transport=`` picks the per-sweep
collective: ``"allgather"`` copies every shard's full F block;
``"halo"`` copies only each shard's export prefix, with the export budget
fixed once per rung (``StreamHaloPlan``) and the export row layout
re-derived per Δ_t on the host; a batch whose exports overflow the budget
runs on all-gather for that Δ_t, warned once per rung.  ``"auto"`` (the
default, or ``REPRO_STREAM_TRANSPORT`` when ``transport`` is left out)
takes halo for a rung iff its budgeted export fraction is at most
``AUTO_EXPORT_FRACTION``; ``"auto:measured"`` times one real sweep per
transport at rung entry and caches the winner (persisted in checkpoints).
Labels equal the single-device engine's bit for bit under every transport;
a ``bsr`` rung stages in the halo row layout under both transports, so its
labels are the same bits across them too.  Each solve runs on the worker
thread, on one side stream per mesh device, ordered after the staging by
one event per device.

Reads: ``committed_view()`` is the last commit's labels on the host;
``device_view()`` the same labels on the device (``DeviceLabelView``),
published lazily on the first call and then at every drain, on a read
stream of its own.  ``read_placement`` places it: ``"auto"`` is the
engine's device without a mesh, and with one the mesh's read replica (a
visible card outside the mesh) or else ``core.distributed.view_sharding``;
a device or a ``ViewSharding`` may be given.  ``checkpoint`` /
``checkpoint_state`` / ``restore`` persist the engine at a commit boundary
(``core.persistence``).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import logging
import os
import time

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core import distributed
from repro_torch.core.components import compact_labels, component_order
from repro_torch.core.dynlp import gprime_components
from repro_torch.core.init_labels import supernode_init
from repro_torch.core.propagate import PropagateResult, PropagationProblem
from repro_torch.core.snapshot import (DeviceLabelView, HostSnapshot, LabelView, ViewSharding,
                                       apply_halo_layout, bucket, bucket_k, build_host_problem,
                                       publish_device_view, reorder_host_snapshot)
from repro_torch.device import resolve_device
from repro_torch.graph import partition
from repro_torch.graph.dynamic import UNLABELED, BatchUpdate, DynamicGraph
from repro_torch.kernels import ops
from repro_torch.kernels.bsr_spmv import ell_bsr_layout
from repro_torch.kernels.landmark_propagate import LandmarkConfig, LandmarkState

logger = logging.getLogger(__name__)

TRANSPORTS = ("allgather", "halo", "auto", "auto:measured")

# auto takes halo for a rung iff its export budget would move at most this
# fraction of the all-gather's rows per sweep (the reference's threshold)
AUTO_EXPORT_FRACTION = 0.5


@dataclasses.dataclass
class StreamStats:
    iterations: int
    converged: bool
    num_components: int
    frontier_size: int
    num_unlabeled: int
    wall_ms: float
    max_residual: float
    bucket: tuple[int, int]  # (U_bucket, K_bucket) device shape this Δ_t;
    # (0, 0) for a no-op Δ_t whose empty frontier staged nothing
    recompiled: bool  # True iff this Δ_t allocated a rung's buffers first
    transport: str = "single"  # collective this Δ_t rode: "single" (no mesh),
    # "allgather", "halo", or "none" (no-op Δ_t, nothing solved)
    backend: str = "none"  # "ref" / "ell_cuda" / "bsr" / "landmark"; "none"
    # for a no-op Δ_t; a bsr rung's slot-budget overflow shows up as an
    # "ell_cuda" batch; a "landmark" batch solved the hot working set only


@dataclasses.dataclass
class _Pending:
    job: concurrent.futures.Future | None  # the solve; None for a no-op Δ_t
    batch: int  # the Δ_t's index (``StreamEngine.batches`` at its submit)
    unl_ids: np.ndarray
    t0: float
    num_components: int
    frontier_size: int
    bucket: tuple[int, int]
    recompiled: bool
    # post-batch host state captured at submit: becomes the committed
    # LabelView at drain, with the solved rows folded over view_f
    view_labels: np.ndarray
    view_alive: np.ndarray
    view_f: np.ndarray
    transport: str = "single"
    backend: str = "none"
    keep: tuple = ()  # device tensors the in-flight solve reads
    # bsr batches were solved in component order: the solved row of
    # original row i is rows[i] (None = staged unpermuted)
    rows: np.ndarray | None = None
    # landmark batches only: the cold unlabeled rows left out of the
    # staged hot problem, which drain serves through the low-rank pass
    cold_ids: np.ndarray | None = None


@dataclasses.dataclass
class _Staging:
    """One Δ_t's staging decision: backend, row order, slot map."""

    staged: HostSnapshot  # possibly row-permuted
    backend: str
    transport: str = "single"  # "single" | "allgather" | "halo"
    plan: object | None = None  # StreamShardPlan / StreamHaloPlan (mesh only)
    rows: np.ndarray | None = None  # original row -> staged row (fold-back)
    perm: np.ndarray | None = None  # staged row -> original row (f0/frontier)
    slot: np.ndarray | None = None  # bsr per-edge tile-slot map
    num_slots: int = 0  # bsr tile-slot budget (0 otherwise)


_FIELDS = tuple(f.name for f in dataclasses.fields(PropagationProblem))


class StreamEngine:
    """Stateful streaming DynLP over a ``DynamicGraph``, on one device or a
    ``DeviceMesh``."""

    def __init__(
        self,
        graph: DynamicGraph,
        delta: float = 1e-4,
        tau: float | None = None,
        max_iters: int = 200_000,
        max_degree: int | None = None,
        backend: str | None = None,
        max_k: int | None | str = "auto",
        ingest: object = None,
        ingest_order: str = "arrival",
        read_placement: object = "auto",
        landmark: object = None,
        mesh: distributed.DeviceMesh | None = None,
        transport: str | None = None,
        device: str | torch.device | None = None,
    ):
        # mesh: shard the stream's rows over a DeviceMesh; the engine lives
        # on the mesh's first device, and a device= that differs is refused
        if mesh is not None and not isinstance(mesh, distributed.DeviceMesh):
            raise TypeError(f"mesh must be a core.distributed.DeviceMesh or None, got "
                            f"{type(mesh).__name__}")
        if mesh is None:
            self.device = resolve_device(device)
        else:
            if device is not None and distributed._normalize(device) != mesh.device:
                raise ValueError(f"device={device!r} differs from the mesh's first device "
                                 f"{mesh.device}")
            self.device = mesh.device
        self.mesh = mesh
        self.graph = graph
        # ingest: who nominates kNN candidates for arriving batches.
        # None/"host" = the blockwise host staging path (graph default);
        # "device" = a DeviceIngestor running the argkmin kernel over the
        # device-resident embedding store, adopting any rows already in
        # the graph; or a selector instance.  Labels and topology are
        # bit-identical either way.
        if ingest in (None, "host"):
            self.ingestor = None
        elif ingest == "device":
            from repro_torch.ingest import DeviceIngestor
            self.ingestor = DeviceIngestor(graph.emb_dim, device=self.device, mesh=mesh)
            if graph.num_nodes:
                self.ingestor.attach(graph)
        elif isinstance(ingest, str):
            raise ValueError(f"unknown ingest mode {ingest!r}; want "
                             "'host', 'device', or a selector instance")
        else:
            self.ingestor = ingest
        # ingest_order: "arrival" keeps the caller's row order; "locality"
        # orders each batch by data.synth.cosine_locality_order before ids
        # are assigned (engines sharing a stream agree if they share this)
        if ingest_order not in ("arrival", "locality"):
            raise ValueError(f"unknown ingest_order {ingest_order!r}; want "
                             "'arrival' or 'locality'")
        self.ingest_order = ingest_order
        self.delta = delta
        self.tau = tau
        self.max_iters = max_iters
        self.max_degree = max_degree
        if backend not in (None, "auto"):
            ops.backend_spec(backend)  # unknown names fail here, not mid-stream
        self.backend = backend
        # transport: the per-sweep collective of a sharded solve.  An
        # explicit "halo" demands a mesh; left out, REPRO_STREAM_TRANSPORT
        # replaces the "auto" default, a fleet-wide hint that a mesh-less
        # engine ignores
        if transport is not None and transport not in TRANSPORTS:
            raise ValueError(f"unknown transport {transport!r}; want one of {TRANSPORTS}")
        if transport == "halo" and mesh is None:
            raise ValueError("transport='halo' requires mesh= (a single-device stream has "
                             "no collective)")
        if transport is None:
            transport = os.environ.get("REPRO_STREAM_TRANSPORT", "auto")
            if transport not in TRANSPORTS:
                raise ValueError(f"REPRO_STREAM_TRANSPORT={transport!r} invalid; want one "
                                 f"of {TRANSPORTS}")
        self.transport = transport
        # the REPRO_BACKEND hint is read once, here: the row padding and the
        # candidate set depend on it, so rungs resolve with use_env=False.
        # A hint with no sharded form degrades to auto on a mesh.
        knob = backend
        if knob in (None, "auto"):
            env = os.environ.get("REPRO_BACKEND", "auto")
            knob = (env if env != "auto" and (mesh is None or ops.backend_spec(env).sharded)
                    else "auto")
        self._backend_knob = knob
        # only when bsr is among the backends the knob could resolve to
        # does the engine pad rows to the tile edge and measure tile fill
        self._backend_candidates = (
            ops.backend_candidates(None, device=self.device, sharded=mesh is not None)
            if knob == "auto" else (ops.backend_spec(knob).name,))
        self._bsr_block = ops.bsr_block_size(self.device.type)
        # rows shard evenly over the mesh, and every shard's rows tile
        # evenly into BSR block rows
        row_multiple = mesh.n_devices if mesh is not None else 1
        if "bsr" in self._backend_candidates:
            row_multiple *= self._bsr_block
        self._row_multiple = row_multiple if row_multiple > 1 else None
        # per-rung mesh state: plans, the transport fixed at rung entry and
        # a halo rung's export budget, the auto:measured probe times
        self._plans: dict[tuple, distributed.StreamShardPlan] = {}
        self.plan_builds = 0  # partition plans built: ≤ rungs touched
        self._transport_modes: dict[tuple[int, int], str] = {}
        self._export_budgets: dict[tuple[int, int], int] = {}
        self._overflow_warned: set[tuple[int, int]] = set()
        self.halo_batches = 0  # batches solved on the halo transport
        self.transport_overflows = 0  # halo batches sent to all-gather
        self._measured: dict[tuple[int, int], dict] = {}  # auto:measured
        self.probe_cache_hits = 0  # rungs decided from a restored probe cache
        # bytes each transport's gathers copied, and its sweeps
        self.transport_bytes = {t: 0 for t in distributed.TRANSPORTS}
        self.transport_sweeps = {t: 0 for t in distributed.TRANSPORTS}
        # max_k caps the ELL neighbor axis (heaviest-edge truncation);
        # "auto" = 4x the graph's kNN k, None = uncapped
        if isinstance(max_k, str) and max_k != "auto":
            raise ValueError(
                f"max_k={max_k!r} invalid; want an int, None (uncapped), "
                "or 'auto' (4x the graph's kNN k)")
        self.max_k = 4 * graph.k if max_k == "auto" else max_k
        # per-engine max_k truncation-warning dedup
        self._max_k_warned: set[tuple[int, int]] = set()
        # per-rung backend, resolved through the registry at rung entry,
        # and a bsr rung's tile-slot budget
        self._backend_modes: dict[tuple[int, int], str] = {}
        self._slot_budgets: dict[tuple[int, int], int] = {}
        self._slot_overflow_warned: set[tuple[int, int]] = set()
        self.bsr_batches = 0  # batches solved on the bsr backend
        self.backend_overflows = 0  # bsr batches sent to ell_cuda
        # landmark: the approximate hot/cold backend's configuration
        # (kernels.landmark_propagate).  None = off, unless the backend knob
        # names "landmark" (then a default config); True = the default
        # config; a dict or a LandmarkConfig tunes it.  With backend
        # None/"auto" and a config, the registry may take landmark once the
        # state is ready; the first such decision latches for the engine's
        # lifetime, so every later rung keeps one contract.
        if landmark is None and knob == "landmark":
            landmark = True
        if landmark is True:
            landmark = LandmarkConfig()
        elif isinstance(landmark, dict):
            landmark = LandmarkConfig(**landmark)
        self._lm = (LandmarkState(landmark, graph.emb_dim, device=self.device)
                    if landmark is not None else None)
        self._lm_streaming = False  # the hot/cold latch
        # the batch each vertex was last touched by; the hot working set is
        # every vertex touched within hot_ttl batches
        self._touched_at = np.full(graph.num_nodes, -1, np.int64)
        self.landmark_batches = 0  # batches solved on the hot/cold split
        self.landmark_cold_rows = 0  # cold rows served by the low-rank pass
        # bucket_key -> two generations of device problem buffers; the
        # generation toggles per commit so the in-flight solve never shares
        # storage with the snapshot being staged
        self._buffers: dict[tuple[int, int], list[PropagationProblem | None]] = {}
        self._gen: dict[tuple[int, int], int] = {}
        self._pending: _Pending | None = None
        self.bucket_keys: set[tuple[int, int]] = set()
        self.recompile_count = 0  # batches that entered a rung first
        self.batches = 0
        self.commits = 0  # batches whose results have been drained
        # query-side committed snapshot, replaced at every drain
        self._view = LabelView.from_graph(graph, commit_id=0)
        # its device twin: published on the first ``device_view()`` call,
        # then at every drain; on a CUDA device publication and reads run
        # on a stream of their own (one per device of a sharded view)
        self._read_placement = _resolve_placement(read_placement, mesh, self.device)
        devs = (self._read_placement.devices if isinstance(self._read_placement, ViewSharding)
                else (self._read_placement,))
        self._read_streams = {d: torch.cuda.Stream(device=d) for d in dict.fromkeys(devs)
                              if d.type == "cuda"}
        self._device_view: DeviceLabelView | None = None
        self._worker = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="stream-solve")
        self._closed = False
        # the solve's side stream, one per device of a mesh
        self._sides = {d: torch.cuda.Stream(device=d)
                       for d in (mesh.distinct if mesh is not None else (self.device,))
                       if d.type == "cuda"}
        self._side = self._sides.get(self.device)

    # ------------------------------------------------------------------ #
    def _resolve_rung_backend(self, key: tuple[int, int], nbr_staged: np.ndarray,
                              n_valid: int):
        """Fix the rung's backend at rung entry through the registry.

        When bsr is a candidate, the tile fill of this first snapshot (in
        the order bsr stages) goes to the registry, and a bsr rung's
        tile-slot budget is the layout's requirement scaled by how far the
        rung can still fill (``key[0] / n_valid``: block rows densify as
        rows arrive), padded up the ``bucket_k`` ladder and capped at BS
        rows × K edges.  Returns (backend, layout or None)."""
        bl = fill = None
        if "bsr" in self._backend_candidates:
            bl = ell_bsr_layout(nbr_staged, self._bsr_block)
            fill = bl.fill
        backend = ops.select_backend(self._backend_knob, device=self.device, num_rows=key[0],
                                     sharded=self.mesh is not None, block_fill=fill,
                                     use_env=False)  # the hint was read at construction
        self._backend_modes[key] = backend
        if backend == "bsr":
            grow = key[0] / max(1, n_valid)
            cap = min(key[0] // self._bsr_block, key[1] * self._bsr_block)
            self._slot_budgets[key] = min(
                bucket_k(int(np.ceil(bl.num_slots * grow))), max(cap, 1))
            logger.info("stream backend: rung %s -> bsr (block fill %.4f, slot budget %d)",
                        key, fill, self._slot_budgets[key])
        else:
            logger.info("stream backend: rung %s -> %s", key, backend)
        return backend, bl

    def _slot_overflow(self, key: tuple[int, int], needed: int) -> None:
        """Record a bsr tile-budget overflow (warned once per rung)."""
        if key not in self._slot_overflow_warned:
            self._slot_overflow_warned.add(key)
            logger.warning(
                "stream bsr: rung %s needs %d tile slots but its budget is %d; "
                "this batch runs on ell_cuda (warned once per rung)", key, needed,
                self._slot_budgets[key])
        self.backend_overflows += 1

    def _note_touched(self, effect) -> None:
        """Stamp the vertices a Δ_t touched with the current batch index."""
        g = self.graph
        if len(self._touched_at) < g.num_nodes:
            grown = np.full(g.num_nodes, -1, np.int64)
            grown[: len(self._touched_at)] = self._touched_at
            self._touched_at = grown
        self._touched_at[effect.affected] = self.batches
        self._touched_at[effect.new_ids] = self.batches

    def _landmark_gate(self) -> np.ndarray | None:
        """Whether this Δ_t streams the hot/cold split: the hot row mask,
        or None for exact staging.

        The decision precedes the snapshot build (the restriction changes
        the rung the batch lands in), so the registry is asked with the
        full unlabeled count and the state's readiness, and the first
        "landmark" verdict latches: later batches stay on the hot/cold
        contract even when deletions shrink the graph under the auto
        threshold."""
        g = self.graph
        lm = self._lm
        if not lm.ready:
            lm.refresh(g, getattr(self.ingestor, "store", None))  # lazy activation
        if not self._lm_streaming:
            n_unl = int((g.alive & (g.labels == UNLABELED)).sum())
            resolved = ops.select_backend(self._backend_knob, device=self.device,
                                          num_rows=bucket(n_unl), sharded=self.mesh is not None,
                                          landmark_ready=lm.ready, use_env=False)
            if resolved != "landmark" or not lm.ready:
                return None
            self._lm_streaming = True
            logger.info("stream landmark: hot/cold split active (%d landmarks, hot_ttl %d, "
                        "%d unlabeled rows)", lm.num_landmarks, lm.cfg.hot_ttl, n_unl)
        age = self.batches - self._touched_at
        return (self._touched_at >= 0) & (age <= lm.cfg.hot_ttl)

    def _landmark_commit(self, p: _Pending) -> None:
        """A hot/cold batch's commit: refresh the factorization (new rows
        get assignments; the landmark labels are re-read in O(L)) and fold
        the low-rank estimates over the batch's cold unlabeled rows; rows
        with no assignment keep their committed labels."""
        g = self.graph
        lm = self._lm
        lm.refresh(g, getattr(self.ingestor, "store", None))
        est, wsum = lm.cold_values(lm.landmark_values(g))
        ids = p.cold_ids
        sel = ids[wsum[ids] > 0]
        g.f[sel] = est[sel]
        p.view_f[sel] = est[sel]
        self.landmark_batches += 1
        self.landmark_cold_rows += len(sel)

    def _stage_single(self, host: HostSnapshot) -> _Staging:
        """Resolve a Δ_t's staging: the rung's backend; a bsr rung puts the
        rows in component order and derives the slot map, or sends the
        batch to ell_cuda when its slots exceed the rung's budget."""
        key = host.bucket_key
        backend = self._backend_modes.get(key)
        order = bl = staged = inv = None
        if backend is None:
            if "bsr" in self._backend_candidates:
                order = component_order(host.nbr)
                staged, inv = reorder_host_snapshot(host, order)
                backend, bl = self._resolve_rung_backend(key, staged.nbr,
                                                         len(host.unl_ids))
            else:
                backend, bl = self._resolve_rung_backend(key, host.nbr,
                                                         len(host.unl_ids))
        if backend != "bsr":
            return _Staging(staged=host, backend=backend)
        if order is None:
            order = component_order(host.nbr)
            staged, inv = reorder_host_snapshot(host, order)
        if bl is None:
            bl = ell_bsr_layout(staged.nbr, self._bsr_block)
        if bl.num_slots > self._slot_budgets[key]:
            self._slot_overflow(key, bl.num_slots)
            return _Staging(staged=host, backend="ell_cuda")
        self.bsr_batches += 1
        return _Staging(staged=staged, backend="bsr", rows=inv[: len(host.unl_ids)],
                        perm=order, slot=bl.slot, num_slots=self._slot_budgets[key])

    # ------------------------------------------------------------------ #
    def _plan_for(self, key: tuple[int, int], backend: str, num_slots: int = 0,
                  export_max: int | None = None) -> distributed.StreamShardPlan:
        """The rung's plan, all-gather or (with ``export_max``, the budget
        fixed at rung entry) halo: built once and reused for every batch in
        the rung.  A bsr rung's slot overflow adds its ell_cuda twin, a halo
        rung's export overflow its all-gather twin."""
        pkey = (key, backend, num_slots, export_max)
        plan = self._plans.get(pkey)
        if plan is None:
            kw = dict(backend=backend, delta=self.delta, max_iters=self.max_iters,
                      block_size=self._bsr_block if backend == "bsr" else 0,
                      num_slots=num_slots if backend == "bsr" else 0)
            plan = (distributed.build_stream_plan(self.mesh, key, **kw) if export_max is None
                    else distributed.build_stream_halo_plan(self.mesh, key, export_max, **kw))
            self._plans[pkey] = plan
            self.plan_builds += 1
        return plan

    def _stage_mesh(self, host: HostSnapshot) -> _Staging:
        """Resolve a mesh Δ_t: the rung's backend, transport and plan.

        The backend, transport and budgets are decided once, at rung entry:
        ``"auto"`` lays out the rung's first snapshot and takes halo iff the
        budgeted export fraction is at most ``AUTO_EXPORT_FRACTION``
        (``"auto:measured"`` times one real sweep per transport instead; a
        one-shard mesh always takes all-gather).  Within a halo rung the
        export layout is re-derived from every batch's topology; a batch
        whose export counts overflow the budget runs on the rung's
        all-gather twin (warned once per rung).  A bsr rung stages in the
        halo layout under BOTH transports, so the tile layout, and the
        labels, are the same in both; a batch whose slot requirement
        overflows the rung's budget runs on the rung's ell_cuda twin under
        the same transport routing (warned once per rung)."""
        key = host.bucket_key
        nd = self.mesh.n_devices
        backend = self._backend_modes.get(key)
        mode = self._transport_modes.get(key)
        allgather_only = (self.transport == "allgather"
                          or (self.transport in ("auto", "auto:measured") and nd == 1))
        bsr_possible = backend == "bsr" or (backend is None
                                            and "bsr" in self._backend_candidates)
        # the halo layout doubles as the bsr row order: derive it whenever
        # the rung needs halo bytes or bsr tiles
        need_layout = bsr_possible or mode == "halo" or (mode is None and not allgather_only)
        layout = partition.build_halo_plan(host.nbr, nd) if need_layout else None
        bl = None
        if backend is None:
            backend, bl = self._resolve_rung_backend(
                key, layout.nbr if layout is not None else host.nbr, len(host.unl_ids))
        if mode is None:
            if allgather_only:
                mode = "allgather"
            else:
                budget = partition.export_budget(layout, len(host.unl_ids))
                if self.transport == "auto:measured":
                    mode = self._measured_mode(key)
                    if mode is None:
                        mode = self._measure_rung_transport(key, host, layout, budget, backend)
                else:
                    frac = budget * nd / key[0]
                    mode = ("halo" if self.transport == "halo" or frac <= AUTO_EXPORT_FRACTION
                            else "allgather")
                    if mode == "allgather":
                        logger.info("stream transport: rung %s export fraction %.2f > %.2f; "
                                    "auto takes all-gather", key, frac, AUTO_EXPORT_FRACTION)
                if mode == "halo":
                    self._export_budgets[key] = budget
            self._transport_modes[key] = mode

        staged, rows, perm = host, None, None
        if backend == "bsr" or mode == "halo":
            if layout is None:
                layout = partition.build_halo_plan(host.nbr, nd)
            staged = apply_halo_layout(host, layout)
            rows = layout.inv_perm[: len(host.unl_ids)]
            perm = layout.perm
        slot, num_slots = None, 0
        backend_this = backend
        if backend == "bsr":
            if bl is None:
                bl = ell_bsr_layout(staged.nbr, self._bsr_block)
            if bl.num_slots > self._slot_budgets[key]:
                # this Δ_t rides the rung's ell_cuda twin but keeps the
                # rung's transport routing below
                self._slot_overflow(key, bl.num_slots)
                backend_this = "ell_cuda"
            else:
                slot, num_slots = bl.slot, self._slot_budgets[key]
                self.bsr_batches += 1

        if mode == "halo":
            budget = self._export_budgets[key]
            if int(layout.export_counts.max()) > budget:
                if key not in self._overflow_warned:
                    self._overflow_warned.add(key)
                    logger.warning(
                        "stream halo: rung %s export count %d overflows the budget %d; "
                        "this batch runs on all-gather (warned once per rung)", key,
                        int(layout.export_counts.max()), budget)
                self.transport_overflows += 1
            else:
                self.halo_batches += 1
                return _Staging(staged=staged, backend=backend_this, transport="halo",
                                plan=self._plan_for(key, backend_this, num_slots, budget),
                                rows=rows, perm=perm, slot=slot, num_slots=num_slots)
        return _Staging(staged=staged, backend=backend_this, transport="allgather",
                        plan=self._plan_for(key, backend_this, num_slots), rows=rows,
                        perm=perm, slot=slot, num_slots=num_slots)

    def _measured_mode(self, key) -> str | None:
        """The persisted ``auto:measured`` probe cache: a rung this engine
        (or the one it was restored from) already timed takes the winner
        without probing again.  None on a miss."""
        cached = self._measured.get(key)
        if cached is None:
            return None
        mode = "halo" if cached["halo"] <= cached["allgather"] else "allgather"
        self.probe_cache_hits += 1
        logger.info("stream transport: rung %s probe-cache hit (halo %.4f ms vs all-gather "
                    "%.4f ms); taking %s", key, cached["halo"], cached["allgather"], mode)
        return mode

    def _measure_rung_transport(self, key, host, layout, budget, backend) -> str:
        """``auto:measured``: time one real sweep per transport on the rung's
        first snapshot (``measure_transports``) and cache the winner.  The
        probes stage throwaway copies and never touch the engine's
        buffers."""
        if budget >= key[0] // self.mesh.n_devices:
            return "allgather"  # halo copies no fewer rows: skip the probe
        staged = apply_halo_layout(host, layout)
        bsr_kw = {}
        if backend == "bsr":
            bsr_kw = dict(slot=ell_bsr_layout(staged.nbr, self._bsr_block).slot,
                          block_size=self._bsr_block, num_slots=self._slot_budgets[key])
        times = measure_transports(self.mesh, staged, budget, backend=backend,
                                   delta=self.delta, **bsr_kw)
        mode = "halo" if times["halo"] <= times["allgather"] else "allgather"
        self._measured[key] = {t: round(v, 4) for t, v in times.items()}
        logger.info("stream transport: rung %s measured halo %.4f ms vs all-gather %.4f ms a "
                    "sweep; taking %s", key, times["halo"], times["allgather"], mode)
        return mode

    # ------------------------------------------------------------------ #
    def _commit(self, host: HostSnapshot, plan=None) -> tuple[object, bool]:
        """Copy a host snapshot into the rung's next buffer generation (on a
        mesh, each shard's rows into that shard's tensors); returns the
        buffers and whether the rung was entered first."""
        key = host.bucket_key
        first = key not in self._buffers
        slots = self._buffers.setdefault(key, [None, None])
        gen = self._gen.get(key, 1) ^ 1
        self._gen[key] = gen
        arrays = {name: np.ascontiguousarray(getattr(host, name)) for name in _FIELDS}
        if plan is not None:
            if slots[gen] is None:
                slots[gen] = plan.put_problem(*(arrays[name] for name in _FIELDS))
            else:
                m = plan.rows_per_shard
                for sh, part in enumerate(slots[gen].shards):
                    for name, a in arrays.items():
                        getattr(part, name).copy_(torch.from_numpy(a[sh * m:(sh + 1) * m]))
        elif slots[gen] is None:  # this generation's first batch allocates it
            slots[gen] = PropagationProblem(
                **{name: torch.from_numpy(a).to(self.device, copy=True)
                   for name, a in arrays.items()})
        else:
            for name, a in arrays.items():
                getattr(slots[gen], name).copy_(torch.from_numpy(a))
        self.bucket_keys.add(key)
        return slots[gen], first

    def _solve(self, problem, f0, frontier, st: _Staging, slot, ready,
               batch: int) -> PropagateResult:
        """The worker thread's job: the solve of Δ_t ``batch``, on the side
        streams behind ``ready`` (one event per device), finished before the
        job returns."""
        with telemetry.span("solve.run", batch=batch):
            if st.plan is not None:
                with contextlib.ExitStack() as streams:
                    for dev, side in self._sides.items():
                        side.wait_event(ready[dev])
                        streams.enter_context(torch.cuda.stream(side))
                    res = ops.run_propagation(problem, f0, frontier, delta=self.delta,
                                              max_iters=self.max_iters, backend=st.backend,
                                              shard_plan=st.plan, slot=slot,
                                              num_slots=st.num_slots or None)
                    for side in self._sides.values():
                        side.synchronize()
                return res
            if self._side is not None:
                self._side.wait_event(ready[self.device])
            tiled = {}
            if st.backend == "bsr":
                tiled = dict(slot=slot, num_slots=st.num_slots, block_size=self._bsr_block)
            res = ops.run_propagation(problem, f0, frontier, delta=self.delta,
                                      max_iters=self.max_iters, backend=st.backend,
                                      device=self.device, stream=self._side, **tiled)
            if self._side is not None:
                self._side.synchronize()
            return res

    # ------------------------------------------------------------------ #
    def submit(self, batch: BatchUpdate) -> StreamStats | None:
        """Apply Δ_t, stage it, queue its solve; returns the now-complete
        stats of the PREVIOUS batch (None on the first call)."""
        if self._closed:
            raise RuntimeError("StreamEngine is closed")
        with telemetry.span("engine.submit", batch=self.batches):
            return self._submit(batch)

    def _submit(self, batch: BatchUpdate) -> StreamStats | None:
        t0 = time.perf_counter()
        g = self.graph
        dev = self.device

        # ---- Step 0: arrival ordering (ids follow row order) ----
        if self.ingest_order == "locality" and len(batch.ins_emb) > 2:
            from repro_torch.data.synth import cosine_locality_order
            order = cosine_locality_order(np.asarray(batch.ins_emb, np.float32))
            batch = dataclasses.replace(
                batch, ins_emb=np.asarray(batch.ins_emb)[order],
                ins_labels=np.asarray(batch.ins_labels)[order])

        # ---- Step 1: change adjustment & sparsification (host) ----
        with telemetry.span("graph.apply_batch"):
            effect = g.apply_batch(batch, tau=self.tau, selector=self.ingestor)
        m = len(effect.new_ids)
        if self._lm is not None:
            self._note_touched(effect)

        # ``effect.affected`` is alive-filtered, so the frontier is nonempty
        # iff some affected vertex is unlabeled
        if not (len(effect.affected) and (g.labels[effect.affected] == UNLABELED).any()):
            # no-op Δ_t: the solve would run zero sweeps, so nothing is
            # staged or queued; the batch still commits at drain
            prev = self.drain()
            unl_ids = np.flatnonzero(g.alive & (g.labels == UNLABELED))
            self._pending = _Pending(
                job=None, batch=self.batches, unl_ids=unl_ids, t0=t0, num_components=0,
                frontier_size=0, bucket=(0, 0), recompiled=False, transport="none",
                backend="none", view_labels=g.labels.copy(), view_alive=g.alive.copy(),
                view_f=g.f.copy())
            self.batches += 1
            return prev

        with telemetry.span("stage.build"):
            # the landmark gate, before the snapshot build (the hot
            # restriction changes the rung this Δ_t lands in)
            hot = self._landmark_gate() if self._lm is not None else None
            cold_ids = (None if hot is None
                        else np.flatnonzero(g.alive & (g.labels == UNLABELED) & ~hot))

            # ---- stage batch t while batch t-1 still propagates ----
            host = build_host_problem(g, max_degree=self.max_degree, auto_bucket=True,
                                      row_multiple=self._row_multiple, max_k=self.max_k,
                                      warned=self._max_k_warned, hot=hot)
            if hot is not None:
                # the hot/cold contract overrides the rung's registry scan: a
                # hot problem is small by design, and an exact backend there
                # would mislabel approximate batches
                self._backend_modes[host.bucket_key] = "landmark"
            u = len(host.unl_ids)
            u_pad = len(host.valid)
            frontier = np.zeros(u_pad, bool)
            aff_rows = host.remap[effect.affected]
            frontier[aff_rows[aff_rows >= 0]] = True
        # a bsr batch stages its rows in component order; ``host`` stays in
        # the original order for the supernode init and f0 below, which
        # map through ``st.rows``/``st.perm``
        with telemetry.span("stage.resolve"):
            st = self._stage_mesh(host) if self.mesh is not None else self._stage_single(host)
        with telemetry.span("stage.commit"):
            problem, recompiled = self._commit(st.staged, st.plan)
            put = (st.plan.put_row if st.plan is not None
                   else (lambda a: torch.from_numpy(a).to(dev)))
            frontier_dev = put(frontier if st.perm is None else frontier[st.perm])
            slot_dev = None if st.slot is None else put(st.slot)

        # ---- Step 2: supernode label initialization (as DynLP.step) ----
        n_components = 0
        with telemetry.span("stage.init"):
            new_unl = effect.new_ids[g.labels[effect.new_ids] == UNLABELED]
            if m and len(new_unl):
                comp_local = gprime_components(effect, m, dev)
                local_idx = torch.from_numpy(new_unl - effect.new_ids[0]).to(dev)
                comp = compact_labels(comp_local)[local_idx]
                n_components = int(comp.max()) + 1
                rows = host.remap[new_unl]
                f_init = supernode_init(comp, torch.from_numpy(host.wl0[rows]).to(dev),
                                        torch.from_numpy(host.wl1[rows]).to(dev),
                                        num_segments=max(m, 1))
                g.f[new_unl] = f_init.cpu().numpy()

        # ---- drain batch t-1: f0 below reads its labels ----
        prev = self.drain()

        # ---- Step 3: queue this batch's solve ----
        with telemetry.span("stage.queue"):
            f0 = np.full(u_pad, 0.5, np.float32)
            f0[:u] = g.f[host.unl_ids]
            f0_dev = put(f0 if st.perm is None else f0[st.perm])
            ready = {}  # after every staged tensor, the slot map too, on each device
            for d in self._sides:
                ready[d] = torch.cuda.Event()
                ready[d].record(torch.cuda.current_stream(d))
            job = self._worker.submit(self._solve, problem, f0_dev, frontier_dev, st, slot_dev,
                                      ready, self.batches)
            self.recompile_count += recompiled
            self._pending = _Pending(
                job=job, batch=self.batches, unl_ids=host.unl_ids, t0=t0,
                num_components=n_components, frontier_size=int(frontier.sum()),
                bucket=host.bucket_key, recompiled=recompiled, transport=st.transport,
                backend=st.backend, rows=st.rows, cold_ids=cold_ids,
                # labels/alive fixed by apply_batch; f holds batch t-1's
                # committed labels plus this batch's supernode inits
                view_labels=g.labels.copy(), view_alive=g.alive.copy(), view_f=g.f.copy(),
                keep=(problem, f0_dev, frontier_dev, slot_dev))
            self.batches += 1
        return prev

    # ------------------------------------------------------------------ #
    def drain(self) -> StreamStats | None:
        """Wait for the in-flight solve and fold its labels back into the
        host graph; returns its stats (None if nothing is pending).

        Draining COMMITS the batch: the committed ``LabelView`` is rebuilt
        here, so ``committed_view()`` readers flip from batch t-1's labels
        to batch t's at once."""
        p, self._pending = self._pending, None
        if p is None:
            return None
        with telemetry.span("engine.drain", batch=p.batch):
            res = None  # a no-op batch: nothing was solved
            if p.job is not None:
                with telemetry.span("engine.drain_wait"):
                    res = p.job.result()  # re-raises a failed solve here
            with telemetry.span("engine.fold"):
                iterations, converged, resid = 0, True, 0.0
                if res is not None:
                    f = res.f.cpu().numpy()
                    solved = f[p.rows] if p.rows is not None else f[: len(p.unl_ids)]
                    self.graph.f[p.unl_ids] = solved
                    p.view_f[p.unl_ids] = solved
                    iterations, converged, resid = (res.iterations, res.converged,
                                                    res.max_residual)
                    if p.transport in self.transport_bytes:
                        self.transport_bytes[p.transport] += res.transport_bytes
                        self.transport_sweeps[p.transport] += res.iterations
                if p.cold_ids is not None:
                    self._landmark_commit(p)
                self.commits += 1
                self._view = LabelView(f=p.view_f, labels=p.view_labels,
                                       alive=p.view_alive, commit_id=self.commits)
                # republish only once a device reader exists: engines that
                # never serve device reads pay nothing per commit
                if self._device_view is not None:
                    self._device_view = self._publish(self._view)
        return StreamStats(
            iterations=iterations, converged=converged,
            num_components=p.num_components, frontier_size=p.frontier_size,
            num_unlabeled=len(p.unl_ids),
            wall_ms=(time.perf_counter() - p.t0) * 1e3, max_residual=resid,
            bucket=p.bucket, recompiled=p.recompiled, transport=p.transport,
            backend=p.backend)

    def poll(self) -> StreamStats | None:
        """Non-blocking ``drain``: commit the in-flight batch only if its
        solve has finished; otherwise return None without waiting.  An
        unfinished poll yields the interpreter lock once, so a caller that
        spins on ``poll`` does not starve the solve thread."""
        p = self._pending
        if p is None:
            return None
        if p.job is not None and not p.job.done():
            time.sleep(0)
            return None
        return self.drain()

    @property
    def in_flight(self) -> bool:
        """True while a submitted batch has not been drained (committed)."""
        return self._pending is not None

    def transport_summary(self) -> dict:
        """JSON-friendly account of the sharded transport and the per-rung
        backend decisions: the requested knobs, each rung's transport mode,
        export budget, backend and bsr tile-slot budget, how many batches
        rode halo or bsr and how many overflowed to their fallbacks, the
        ``auto:measured`` probe times, the bytes each transport's gathers
        copied a sweep, and the landmark split (its batches, cold rows
        served, resamples and argkmin assignment chunks)."""
        def by_rung(d):
            return {f"{u}x{k}": v for (u, k), v in sorted(d.items())}

        return {
            "requested": self.transport,
            "mesh_devices": self.mesh.n_devices if self.mesh is not None else 0,
            "rung_modes": by_rung(self._transport_modes),
            "export_budgets": by_rung(self._export_budgets),
            "halo_batches": self.halo_batches,
            "overflows": self.transport_overflows,
            "plan_builds": self.plan_builds,
            "measured_sweep_ms": by_rung(self._measured),
            "probe_cache_hits": self.probe_cache_hits,
            "transport_bytes_per_sweep": {
                t: self.transport_bytes[t] / self.transport_sweeps[t]
                for t in self.transport_bytes if self.transport_sweeps[t]},
            "requested_backend": self.backend or "auto",
            "rung_backends": by_rung(self._backend_modes),
            "slot_budgets": by_rung(self._slot_budgets),
            "bsr_batches": self.bsr_batches,
            "backend_overflows": self.backend_overflows,
            "landmark": {
                "configured": self._lm is not None,
                "streaming": self._lm_streaming,
                "num_landmarks": self._lm.num_landmarks if self._lm else 0,
                "batches": self.landmark_batches,
                "cold_rows": self.landmark_cold_rows,
                "resamples": self._lm.resamples if self._lm else 0,
                "assign_chunks": self._lm.assign_chunks if self._lm else 0,
            },
        }

    def committed_view(self) -> LabelView:
        """The query-side snapshot of the last COMMITTED batch: safe to read
        while a later batch is in flight (it advances only at drain).
        Before any commit it reflects the graph the engine was built on."""
        return self._view

    def _publish(self, view: LabelView) -> DeviceLabelView:
        return publish_device_view(view, self._read_placement, self._read_streams)

    def device_view(self) -> DeviceLabelView:
        """The committed snapshot on the device: a read is one gather
        (``DeviceLabelView.query``).  Published on the first call, then at
        every drain.  Safe to call while another thread drains: views are
        immutable and swap in one assignment, so a reader gets the previous
        commit's view or the new one, never a mix (the service's reads rely
        on this to stay off its write lock)."""
        dv = self._device_view
        if dv is None or dv.commit_id != self._view.commit_id:
            dv = self._publish(self._view)
            self._device_view = dv
        return dv

    def step(self, batch: BatchUpdate) -> StreamStats:
        """Synchronous Δ_t update with ``DynLP.step`` semantics."""
        self.submit(batch)
        return self.drain()

    def close(self) -> None:
        """Stop the solve thread once the in-flight solve, if any, has
        finished (a pending batch can still be drained afterwards); a
        later ``submit`` raises."""
        self._closed = True
        self._worker.shutdown(wait=True)

    # ------------------------------------------------------------------ #
    def checkpoint(self, directory: str, step: int | None = None) -> str:
        """Write one atomic checkpoint of the engine's state (graph
        buffers, embedding store, rung metadata, counters) under
        ``directory``; ``step`` defaults to the commit counter.  Raises
        while a batch is in flight: ``drain()`` first.  See
        ``core.persistence``."""
        from repro_torch.core import persistence

        return persistence.save_engine(self, directory, step)

    def checkpoint_state(self) -> dict:
        """The flat checkpoint dict, host copies taken now (for
        ``CheckpointManager.save_async``); same commit-boundary rule as
        ``checkpoint``."""
        from repro_torch.core import persistence

        return persistence.engine_state(self)

    @classmethod
    def restore(cls, directory: str, step: int | None = None,
                **overrides) -> "StreamEngine":
        """Rebuild an engine from the latest (or given) checkpoint; keyword
        overrides replace the checkpointed knobs, ``device`` included.  See
        ``core.persistence.restore_engine``."""
        from repro_torch.core import persistence

        return persistence.restore_engine(directory, step, **overrides)

    def predictions(self, cutoff: float = 0.5) -> tuple[np.ndarray, np.ndarray]:
        """(global ids, binary predictions) for alive unlabeled vertices."""
        g = self.graph
        ids = np.flatnonzero(g.alive & (g.labels == UNLABELED))
        return ids, (g.f[ids] >= cutoff).astype(np.int8)


def _resolve_placement(read_placement, mesh, device: torch.device):
    """The engine's read placement: ``"auto"``/None is the engine's device
    without a mesh and ``core.distributed.read_placement(mesh)`` with one;
    a device (or its name) or a ``ViewSharding`` is taken as given."""
    if read_placement is None or (isinstance(read_placement, str)
                                  and read_placement == "auto"):
        return distributed.read_placement(mesh) if mesh is not None else device
    if isinstance(read_placement, ViewSharding):
        return ViewSharding(tuple(distributed._normalize(d) for d in read_placement.devices))
    if isinstance(read_placement, (str, torch.device)):
        try:
            dev = torch.device(read_placement)
        except RuntimeError as e:
            raise ValueError(f"read_placement={read_placement!r}: want 'auto', a device or a "
                             "ViewSharding") from e
        return distributed._normalize(dev)
    raise ValueError(f"read_placement={read_placement!r}: want 'auto', a device or a "
                     "ViewSharding")


def measure_transports(mesh: distributed.DeviceMesh, staged: HostSnapshot, export_max: int, *,
                       backend: str, delta: float, slot=None, block_size: int = 0,
                       num_slots: int = 0) -> dict[str, float]:
    """One real sweep of ``staged`` (rows in the halo layout) per
    transport, in ms: probe plans with ``max_iters=1``, every row on the
    frontier from 0.5, one warm-up run each, then one timed run (CUDA
    events on every card of the mesh, the longest; the host clock on the
    CPU).  The ``auto:measured`` probe of ``StreamEngine``."""
    key = staged.bucket_key
    tiled = dict(block_size=block_size, num_slots=num_slots) if backend == "bsr" else {}
    times = {}
    for tr in distributed.TRANSPORTS:
        build = (distributed.build_stream_plan if tr == "allgather" else
                 functools.partial(distributed.build_stream_halo_plan, export_max=export_max))
        plan = build(mesh, key, backend=backend, delta=delta, max_iters=1, **tiled)
        problem = plan.put_problem(staged.nbr, staged.wgt, staged.wl0, staged.wl1,
                                   staged.valid)
        f0 = plan.put_row(np.full(key[0], 0.5, np.float32))
        fr = plan.put_row(staged.valid)
        sl = plan.put_row(slot) if slot is not None else None
        plan(problem, f0, fr, slot=sl)  # warm-up
        times[tr] = distributed.timed_ms(mesh, lambda: plan(problem, f0, fr, slot=sl))
    return times
