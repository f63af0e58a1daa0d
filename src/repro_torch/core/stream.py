"""Streaming engine for dynamic batch updates, single device.

Counterpart of the single-device half of ``repro.core.stream``.
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

Reads: ``committed_view()`` is the last commit's labels on the host;
``device_view()`` the same labels on the device (``DeviceLabelView``),
published lazily on the first call and then at every drain, on a read
stream of its own.  ``checkpoint`` / ``checkpoint_state`` / ``restore``
persist the engine at a commit boundary (``core.persistence``).

Not ported yet (the engine does not define them): the mesh
(``mesh=``/``transport=``, the mesh keys of ``transport_summary``, the mesh
read replica and ``view_sharding``), the ``landmark`` staging, and in
checkpoints the ``auto:measured`` probe cache and the landmark state.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import logging
import time

import numpy as np
import torch

from repro_torch.core.components import compact_labels, component_order
from repro_torch.core.dynlp import gprime_components
from repro_torch.core.init_labels import supernode_init
from repro_torch.core.propagate import PropagateResult, PropagationProblem
from repro_torch.core.snapshot import (DeviceLabelView, HostSnapshot, LabelView, bucket_k,
                                       build_host_problem, publish_device_view,
                                       reorder_host_snapshot)
from repro_torch.device import resolve_device
from repro_torch.graph.dynamic import UNLABELED, BatchUpdate, DynamicGraph
from repro_torch.kernels import ops
from repro_torch.kernels.bsr_spmv import ell_bsr_layout

logger = logging.getLogger(__name__)


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
    transport: str = "single"  # "single", or "none" (no-op Δ_t)
    backend: str = "none"  # "ref" / "ell_cuda" / "bsr"; "none" for a no-op
    # Δ_t; a bsr rung's slot-budget overflow shows up as an "ell_cuda" batch


@dataclasses.dataclass
class _Pending:
    job: concurrent.futures.Future | None  # the solve; None for a no-op Δ_t
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


@dataclasses.dataclass
class _Staging:
    """One Δ_t's staging decision: backend, row order, slot map."""

    staged: HostSnapshot  # possibly row-permuted
    backend: str
    rows: np.ndarray | None = None  # original row -> staged row (fold-back)
    perm: np.ndarray | None = None  # staged row -> original row (f0/frontier)
    slot: np.ndarray | None = None  # bsr per-edge tile-slot map
    num_slots: int = 0  # bsr tile-slot budget (0 otherwise)


_FIELDS = tuple(f.name for f in dataclasses.fields(PropagationProblem))


class StreamEngine:
    """Stateful streaming DynLP over a ``DynamicGraph``, on one device."""

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
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
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
            self.ingestor = DeviceIngestor(graph.emb_dim, device=self.device)
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
        # only when bsr is among the backends the knob could resolve to
        # does the engine pad rows to the tile edge and measure tile fill
        self._backend_candidates = ops.backend_candidates(backend, device=self.device)
        self._bsr_block = ops.bsr_block_size(self.device.type)
        # every rung's rows must tile evenly into BSR block rows
        self._row_multiple = (self._bsr_block if "bsr" in self._backend_candidates
                              else None)
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
        # then at every drain, on the engine's device; on a CUDA device
        # publication and reads run on a stream of their own.  The only
        # placement is "auto" (None alike): the reference's other values
        # place the mesh's read replica, which the port does not have yet
        if not (read_placement is None or (isinstance(read_placement, str)
                                           and read_placement == "auto")):
            raise ValueError(f"read_placement={read_placement!r}: only 'auto' (the "
                             "engine's device) until the mesh read replica is ported")
        self._read_stream = (torch.cuda.Stream(device=self.device)
                             if self.device.type == "cuda" else None)
        self._device_view: DeviceLabelView | None = None
        self._worker = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="stream-solve")
        self._closed = False
        self._side = (torch.cuda.Stream(device=self.device)
                      if self.device.type == "cuda" else None)

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
        backend = ops.select_backend(self.backend, device=self.device, num_rows=key[0],
                                     block_fill=fill)
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

    def _commit(self, host: HostSnapshot) -> tuple[PropagationProblem, bool]:
        """Copy a host snapshot into the rung's next buffer generation;
        returns the buffers and whether the rung was entered first."""
        key = host.bucket_key
        first = key not in self._buffers
        slots = self._buffers.setdefault(key, [None, None])
        gen = self._gen.get(key, 1) ^ 1
        self._gen[key] = gen
        arrays = {name: torch.from_numpy(np.ascontiguousarray(getattr(host, name)))
                  for name in _FIELDS}
        if slots[gen] is None:  # this generation's first batch allocates it
            slots[gen] = PropagationProblem(
                **{name: t.to(self.device, copy=True) for name, t in arrays.items()})
        else:
            for name, t in arrays.items():
                getattr(slots[gen], name).copy_(t)
        self.bucket_keys.add(key)
        return slots[gen], first

    def _solve(self, problem, f0, frontier, st: _Staging, slot, ready) -> PropagateResult:
        """The worker thread's job: the solve, on the side stream behind
        ``ready``, finished before the job returns."""
        if self._side is not None:
            self._side.wait_event(ready)
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
        effect = g.apply_batch(batch, tau=self.tau, selector=self.ingestor)
        m = len(effect.new_ids)

        # ``effect.affected`` is alive-filtered, so the frontier is nonempty
        # iff some affected vertex is unlabeled
        if not (len(effect.affected) and (g.labels[effect.affected] == UNLABELED).any()):
            # no-op Δ_t: the solve would run zero sweeps, so nothing is
            # staged or queued; the batch still commits at drain
            prev = self.drain()
            self.batches += 1
            unl_ids = np.flatnonzero(g.alive & (g.labels == UNLABELED))
            self._pending = _Pending(
                job=None, unl_ids=unl_ids, t0=t0, num_components=0, frontier_size=0,
                bucket=(0, 0), recompiled=False, transport="none", backend="none",
                view_labels=g.labels.copy(), view_alive=g.alive.copy(), view_f=g.f.copy())
            return prev

        # ---- stage batch t while batch t-1 still propagates ----
        host = build_host_problem(g, max_degree=self.max_degree, auto_bucket=True,
                                  row_multiple=self._row_multiple, max_k=self.max_k,
                                  warned=self._max_k_warned)
        u = len(host.unl_ids)
        u_pad = len(host.valid)
        frontier = np.zeros(u_pad, bool)
        aff_rows = host.remap[effect.affected]
        frontier[aff_rows[aff_rows >= 0]] = True
        # a bsr batch stages its rows in component order; ``host`` stays in
        # the original order for the supernode init and f0 below, which
        # map through ``st.rows``/``st.perm``
        st = self._stage_single(host)
        problem, recompiled = self._commit(st.staged)
        frontier_dev = torch.from_numpy(
            frontier if st.perm is None else frontier[st.perm]).to(dev)
        slot_dev = None if st.slot is None else torch.from_numpy(st.slot).to(dev)

        # ---- Step 2: supernode label initialization (as DynLP.step) ----
        n_components = 0
        new_unl = effect.new_ids[g.labels[effect.new_ids] == UNLABELED]
        if m and len(new_unl):
            comp_local = gprime_components(effect, m, dev)
            local_idx = torch.from_numpy(new_unl - effect.new_ids[0]).to(dev)
            comp = compact_labels(comp_local)[local_idx]
            n_components = int(comp.max()) + 1
            rows = host.remap[new_unl]
            rows = torch.from_numpy(rows if st.rows is None else st.rows[rows]).to(dev)
            f_init = supernode_init(comp, problem.wl0[rows], problem.wl1[rows],
                                    num_segments=max(m, 1))
            g.f[new_unl] = f_init.cpu().numpy()

        # ---- drain batch t-1: f0 below reads its labels ----
        prev = self.drain()

        # ---- Step 3: queue this batch's solve ----
        f0 = np.full(u_pad, 0.5, np.float32)
        f0[:u] = g.f[host.unl_ids]
        f0_dev = torch.from_numpy(f0 if st.perm is None else f0[st.perm]).to(dev)
        ready = None
        if self._side is not None:  # after every staged tensor, the slot map too
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(dev))
        job = self._worker.submit(self._solve, problem, f0_dev, frontier_dev, st, slot_dev,
                                  ready)
        self.recompile_count += recompiled
        self.batches += 1
        self._pending = _Pending(
            job=job, unl_ids=host.unl_ids, t0=t0, num_components=n_components,
            frontier_size=int(frontier.sum()), bucket=host.bucket_key,
            recompiled=recompiled, transport="single", backend=st.backend, rows=st.rows,
            # labels/alive fixed by apply_batch; f holds batch t-1's
            # committed labels plus this batch's supernode inits
            view_labels=g.labels.copy(), view_alive=g.alive.copy(), view_f=g.f.copy(),
            keep=(problem, f0_dev, frontier_dev, slot_dev))
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
        if p.job is None:  # no-op batch: nothing was solved
            iterations, converged, resid = 0, True, 0.0
        else:
            res = p.job.result()  # re-raises a failed solve here
            f = res.f.cpu().numpy()
            solved = f[p.rows] if p.rows is not None else f[: len(p.unl_ids)]
            self.graph.f[p.unl_ids] = solved
            p.view_f[p.unl_ids] = solved
            iterations, converged, resid = res.iterations, res.converged, res.max_residual
        self.commits += 1
        self._view = LabelView(f=p.view_f, labels=p.view_labels,
                               alive=p.view_alive, commit_id=self.commits)
        # republish only once a device reader exists: engines that never
        # serve device reads pay nothing per commit
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
        """JSON-friendly account of the per-rung backend decisions: the
        requested backend, each rung's backend and bsr tile-slot budget, and
        how many batches rode bsr or overflowed to ell_cuda.  (The
        reference's mesh keys come with the mesh.)"""
        def by_rung(d):
            return {f"{u}x{k}": v for (u, k), v in sorted(d.items())}

        return {
            "requested_backend": self.backend or "auto",
            "rung_backends": by_rung(self._backend_modes),
            "slot_budgets": by_rung(self._slot_budgets),
            "bsr_batches": self.bsr_batches,
            "backend_overflows": self.backend_overflows,
        }

    def committed_view(self) -> LabelView:
        """The query-side snapshot of the last COMMITTED batch: safe to read
        while a later batch is in flight (it advances only at drain).
        Before any commit it reflects the graph the engine was built on."""
        return self._view

    def _publish(self, view: LabelView) -> DeviceLabelView:
        return publish_device_view(view, self.device, self._read_stream)

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
