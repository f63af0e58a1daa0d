"""Request-level label-propagation serving on the streaming engine.

Counterpart of ``repro.serving.lp_service``.  ``LPService`` turns the
batch-oriented ``core.stream.StreamEngine`` into a front-end for the two
request kinds a label service sees:

  * **queries** — labels and confidences for arbitrary node sets, served
    from the engine's last *committed* view, so reads never block on an
    in-flight propagation and never see a torn half-applied batch.  A read
    is one gather against the committed ``DeviceLabelView``, on the view's
    own stream.
  * **mutations** — ``add_points(embeddings, labels=...)`` /
    ``remove_points(ids)`` / ``relabel(ids, labels)`` (callers never build
    edge lists; with ``StreamEngine(ingest="device")`` the kNN delta comes
    from the argkmin kernel).  Mutations coalesce into one ``BatchUpdate``
    per *admission window*, which closes at ``window_ops`` operations or
    ``window_ms`` milliseconds, whichever comes first, and is admitted
    through ``StreamEngine.submit``, so the host staging of window t+1
    overlaps the solve of window t.

Commit flow: ``submit`` pipelines; ``poll`` (from ``pump`` / ``mutate``)
commits a finished solve without blocking; ``sync`` flushes the open window
and blocks until everything admitted has committed, after which queries
see every prior mutation (read-your-writes).  Each mutation gets a
``MutationTicket``, whose commit latency feeds the service stats.

Async serving: ``start()`` (or ``with service:``) launches a background
``serving.engine.ServiceDriver`` thread.  It clocks admission (window
deadlines fire with zero caller traffic), commits finished solves off every
caller's path, and fuses concurrent readers' tickets into one gather
(``query_async`` returns the ticket; ``query`` submits one and waits).
Each fused batch is answered from one immutable view.  Without the driver
the service is caller-clocked, and ``query`` is a single gather.

Backpressure: when queued + in-flight operations would exceed
``max_pending_ops``, ``mutate`` either blocks draining the backlog
(default) or raises ``Backpressure`` (``reject_on_overload=True``).

Durability: ``checkpoint_every``/``checkpoint_dir`` snapshot the engine's
state (``core.persistence``) at quiescent commit boundaries through
``CheckpointManager.save_async`` (the caller pays only the host copies),
and ``arm_preemption()`` turns SIGTERM/SIGINT into "drain in-flight,
checkpoint, exit clean"; a restarted process resumes bit-identically with
``StreamEngine.restore``.  Async write failures re-raise at the next
``mutate``/``sync``: a service whose snapshots fail never pretends its
state is durable.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time

import numpy as np

from repro_torch import telemetry
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.snapshot import LabelView
from repro_torch.core.stream import StreamEngine, StreamStats
from repro_torch.graph.dynamic import UNLABELED, BatchUpdate
from repro_torch.serving.engine import ReadBatcher, ReadTicket, ServiceDriver
from repro_torch.training.resilience import PreemptionGuard


class Backpressure(RuntimeError):
    """Raised when the mutation queue bound would be exceeded and the
    service was configured to reject rather than block."""


@dataclasses.dataclass
class MutationTicket:
    """Tracks one mutation from enqueue to commit."""

    ticket: int
    ops: int  # inserted vertices + delete requests in this mutation
    enqueued_at: float  # perf_counter at enqueue
    committed_at: float | None = None
    commit_id: int | None = None  # engine commit that made it visible

    @property
    def committed(self) -> bool:
        """Whether the mutation has landed in a committed view."""
        return self.committed_at is not None

    @property
    def latency_ms(self) -> float | None:
        """Enqueue-to-commit latency, or None while still pending."""
        if self.committed_at is None:
            return None
        return (self.committed_at - self.enqueued_at) * 1e3


@dataclasses.dataclass(frozen=True)
class QueryResult:
    """Answer for one query request, consistent as of ``commit_id``."""

    ids: np.ndarray  # (Q,) the requested global ids
    pred: np.ndarray  # (Q,) int8 — 0/1, or UNLABELED for dead/unknown ids
    confidence: np.ndarray  # (Q,) float32 — 1.0 for seeds, 0.0 dead/unknown
    commit_id: int  # committed batch the answer reflects


@dataclasses.dataclass(frozen=True)
class ServiceStats:
    """Point-in-time counters for one LPService instance."""

    queries: int
    query_nodes: int
    queries_while_inflight: int  # reads served while a solve was pending
    driver_running: bool  # background driver alive right now
    read_batches: int  # fused device gathers the driver executed
    read_tickets: int  # read tickets those gathers fulfilled
    deadline_admissions: int  # windows the driver's clock force-admitted
    mutations: int
    ops_accepted: int
    rejected: int  # mutations refused by backpressure
    batches_admitted: int
    batches_committed: int
    pending_ops: int  # queued (window) + in-flight right now
    recompiles: int  # rungs entered for the first time (bucket-ladder bounded)
    bucket_rungs: int
    commit_latency_ms: dict  # p50/p95/p99/max over the last <=4096 commits
    transport: dict  # StreamEngine.transport_summary(): requested backend,
    # per-rung backends and bsr slot budgets, bsr batch + overflow counts
    checkpoints_written: int = 0  # policy snapshots taken (async + final)
    last_checkpoint_commit: int = 0  # engine commit the newest covers
    preempted: bool = False  # drain-checkpoint-halt shutdown has run


@dataclasses.dataclass
class _QueuedMutation:
    ticket: MutationTicket
    ins_emb: np.ndarray
    ins_labels: np.ndarray
    del_ids: np.ndarray
    rel_ids: np.ndarray
    rel_labels: np.ndarray


class LPService:
    """Query/mutation front-end over a ``StreamEngine`` (see module doc).

    Caller-clocked by default: ``mutate`` and ``pump`` check the
    admission deadline and harvest finished solves; ``query`` is a pure
    read (one gather against the committed device view).  With
    the background driver running (``start()`` / ``with service:``),
    the clock moves off the callers: deadlines fire on their own,
    commits land as soon as the device finishes, and concurrent reads
    fuse into one device gather.
    """

    def __init__(
        self,
        engine: StreamEngine,
        *,
        window_ops: int = 64,
        window_ms: float = 50.0,
        max_pending_ops: int = 1024,
        reject_on_overload: bool = False,
        cutoff: float = 0.5,
        driver_poll_ms: float = 2.0,
        checkpoint_every: int | None = None,
        checkpoint_dir: str | None = None,
        checkpoint_keep: int = 3,
    ):
        if window_ops < 1:
            raise ValueError("window_ops must be >= 1")
        if max_pending_ops < window_ops:
            raise ValueError("max_pending_ops must be >= window_ops")
        # checkpoint policy: every ``checkpoint_every`` commits the full
        # engine state snapshots to ``checkpoint_dir`` OFF the caller
        # path (CheckpointManager.save_async — callers only pay the host
        # copy), always at a quiescent commit boundary.  A directory
        # without a cadence still arms the preemption/shutdown final
        # snapshot.
        if checkpoint_every is not None:
            if checkpoint_every < 1:
                raise ValueError("checkpoint_every must be >= 1")
            if checkpoint_dir is None:
                raise ValueError(
                    "checkpoint_every requires checkpoint_dir")
        self.checkpoint_every = checkpoint_every
        self._ckpt_mgr = (CheckpointManager(checkpoint_dir,
                                            keep=checkpoint_keep)
                          if checkpoint_dir is not None else None)
        self._last_ckpt_commit = engine.commits
        self.checkpoints_written = 0
        self._ckpt_error: BaseException | None = None
        self._guard: PreemptionGuard | None = None
        self.preempted = False
        self.engine = engine
        self.window_ops = window_ops
        self.window_ms = window_ms
        self.max_pending_ops = max_pending_ops
        self.reject_on_overload = reject_on_overload
        self.cutoff = cutoff
        self.driver_poll_ms = driver_poll_ms

        self._window: list[_QueuedMutation] = []
        self._window_ops = 0
        self._window_t0: float | None = None  # opened when first op queued
        self._inflight: list[MutationTicket] = []
        self._inflight_ops = 0
        self._next_ticket = 0
        # Rolling window: a long-lived service must not grow a per-
        # mutation history (or re-percentile it) without bound.
        self._commit_latency_ms: collections.deque[float] = \
            collections.deque(maxlen=4096)
        # One reentrant lock guards the engine's WRITE side (window
        # state, submit/poll/drain) — callers and the driver thread both
        # clock the service through it.  Reads deliberately take only
        # ``_stats_lock``: committed views are immutable and swapped
        # atomically at drain, so the read path never queues behind a
        # mutation's host staging (which holds ``_lock`` for the whole
        # ``submit``).
        self._lock = threading.RLock()
        self._stats_lock = threading.Lock()
        self._driver: ServiceDriver | None = None
        self._batcher: ReadBatcher | None = None
        # (read_batches, read_tickets, deadline_admissions) accumulated
        # over stopped drivers — stats survive stop/start cycles
        self._drained_reads = (0, 0, 0)

        self.queries = 0
        self.query_nodes = 0
        self.queries_while_inflight = 0
        self.mutations = 0
        self.ops_accepted = 0
        self.rejected = 0
        self.batches_admitted = 0
        self.batches_committed = 0

    # ------------------------------------------------------------------ #
    # driver lifecycle
    # ------------------------------------------------------------------ #
    def start(self) -> "LPService":
        """Launch the background driver (idempotent).  From here on,
        admission deadlines fire and solves commit without caller
        traffic, and reads batch across concurrent callers."""
        with self._lock:
            if self._driver is None:
                self._batcher = ReadBatcher()
                self._driver = ServiceDriver(self, self._batcher,
                                             poll_ms=self.driver_poll_ms)
                self._driver.start()
        return self

    def stop(self):
        """Stop the driver: in-flight read tickets are drained (every
        ticket is fulfilled), then the service is caller-clocked again.
        Queued mutations stay queued — ``close``/``sync`` flushes them."""
        with self._lock:
            driver, self._driver = self._driver, None
            self._batcher = None
        if driver is not None:
            driver.stop()
            rb, rt, da = self._drained_reads
            self._drained_reads = (rb + driver.read_batches,
                                   rt + driver.read_tickets,
                                   da + driver.deadline_admissions)

    def close(self):
        """Stop the driver and flush: every queued mutation is admitted
        and every admitted batch committed (read-your-writes for any
        subsequent direct reads)."""
        self.stop()
        self.sync()

    def __enter__(self) -> "LPService":
        return self.start()

    def __exit__(self, *exc):
        self.close()

    @property
    def driver_running(self) -> bool:
        """Whether the background commit driver thread is alive."""
        d = self._driver
        return d is not None and d.is_alive()

    # ------------------------------------------------------------------ #
    # durability: checkpoint policy + preemption-driven shutdown
    # ------------------------------------------------------------------ #
    def arm_preemption(self, guard: PreemptionGuard | None = None
                       ) -> PreemptionGuard:
        """Install (or adopt) a ``PreemptionGuard``: once SIGTERM/SIGINT
        is delivered, the next ``pump()`` tick — the driver's, or any
        caller's — drains in-flight work, writes one final synchronous
        checkpoint (when a ``checkpoint_dir`` is configured), and halts
        the driver so the process can exit clean.  Afterwards
        ``preempted`` is True and new mutations are refused; restart and
        ``StreamEngine.restore`` to resume.  Returns the guard (use it
        as a context manager to guarantee handler restoration)."""
        with self._lock:
            self._guard = guard if guard is not None else PreemptionGuard()
            return self._guard

    def shutdown(self) -> int | None:
        """Graceful "drain in-flight, checkpoint, exit clean": stop the
        driver, flush + commit every queued mutation, then write one
        final SYNCHRONOUS checkpoint.  Returns the checkpointed commit
        id (None when no ``checkpoint_dir`` is configured).  The
        preemption path does the same dance from inside ``pump()``."""
        self.stop()
        self.sync()
        if self._ckpt_mgr is None:
            return None
        with self._lock:
            return self._checkpoint_sync()

    def _checkpoint_sync(self) -> int:
        """Final/forced snapshot at the current (quiescent) commit."""
        step = self.engine.commits
        self._ckpt_mgr.save_sync(step, self.engine.checkpoint_state())
        self._last_ckpt_commit = step
        self.checkpoints_written += 1
        return step

    def _maybe_checkpoint(self):
        """Policy snapshot at a commit boundary (called from ``_resolve``
        with ``_lock`` held).  Only fires when the engine is quiescent —
        ``_admit`` resolves the PREVIOUS batch's tickets with the next
        already in flight, and a snapshot there would tear — so a cadence
        point reached mid-pipeline simply waits for the next quiescent
        commit.  Write failures never kill the driver thread: they are
        recorded and re-raised to the next ``mutate``/``sync`` caller."""
        if (self._ckpt_mgr is None or self.checkpoint_every is None
                or self.preempted or self.engine.in_flight):
            return
        if (self.engine.commits - self._last_ckpt_commit
                < self.checkpoint_every):
            return
        try:
            self._ckpt_mgr.save_async(self.engine.commits,
                                      self.engine.checkpoint_state())
        except Exception as e:  # surfaced at the next mutate()/sync()
            if self._ckpt_error is None:
                self._ckpt_error = e
            return
        self._last_ckpt_commit = self.engine.commits
        self.checkpoints_written += 1

    def _raise_ckpt_error(self):
        """Surface an async checkpoint-write failure to the caller (the
        durability contract: a service whose snapshots are failing must
        not keep accepting writes as if its state were durable)."""
        if self._ckpt_error is not None:
            err, self._ckpt_error = self._ckpt_error, None
            raise RuntimeError(
                "engine checkpointing failed; durable state is stale "
                f"(last good commit {self._last_ckpt_commit})") from err

    def _handle_preemption(self):
        """Drain in-flight, checkpoint, halt — with ``_lock`` held.

        Runs on whichever thread's ``pump()`` first observes the guard:
        possibly the driver's own, so the driver is HALTED (flag only),
        never joined here — ``stop()``/``shutdown()`` from another
        thread completes the join."""
        self.preempted = True
        self._admit()
        st = self.engine.drain()
        if st is not None:
            self._resolve(st)
        if self._ckpt_mgr is not None:
            try:
                self._checkpoint_sync()
            except Exception as e:  # the exit path must still halt
                if self._ckpt_error is None:
                    self._ckpt_error = e
        d = self._driver
        if d is not None:
            d.halt()

    # ------------------------------------------------------------------ #
    # read path
    # ------------------------------------------------------------------ #
    def query(self, node_ids, cutoff: float | None = None) -> QueryResult:
        """Labels + confidences for ``node_ids`` from the last committed
        snapshot (one device gather; ids from a batch that has
        not committed yet answer ``UNLABELED`` at confidence 0).  With
        the driver running this enqueues a ticket and waits — concurrent
        callers' bursts fuse into one gather; reads never block on an
        in-flight solve either way."""
        ticket = self.query_async(node_ids, cutoff)
        if ticket is not None:
            return ticket.wait()
        ids = np.asarray(node_ids, np.int64).reshape(-1)
        # lock-free view fetch: ``_view``/``_device_view`` swap atomically
        # at drain, so reads never wait on a mutation's staging
        view = self.engine.device_view()
        inflight = self.engine.in_flight
        pred, conf = view.query(ids, self.cutoff if cutoff is None else cutoff)
        with self._stats_lock:
            self.queries += 1
            self.query_nodes += len(ids)
            self.queries_while_inflight += inflight
        return QueryResult(ids=ids, pred=pred, confidence=conf,
                           commit_id=view.commit_id)

    def query_async(self, node_ids, cutoff: float | None = None
                    ) -> ReadTicket | None:
        """Enqueue a read for the driver's next fused gather; returns the
        ticket (``.wait()`` for the ``QueryResult``), or None when the
        driver is not running — use ``query`` for the synchronous path."""
        batcher = self._batcher
        if batcher is None:
            return None
        ids = np.asarray(node_ids, np.int64).reshape(-1)
        try:
            return batcher.submit(
                ids, self.cutoff if cutoff is None else cutoff)
        except RuntimeError:
            return None  # raced a stop(): caller falls back to sync path

    def _serve_reads(self, tickets) -> list[QueryResult]:
        """Driver-side: answer a batch of tickets with ONE fused gather
        from ONE committed view — the never-torn guarantee: a commit
        landing mid-burst flips whole batches between immutable views,
        never individual lanes."""
        view = self.engine.device_view()
        inflight = self.engine.in_flight
        ids_cat = np.concatenate([t.ids for t in tickets]) \
            if tickets else np.zeros(0, np.int64)
        cut_cat = np.concatenate(
            [np.full(len(t.ids), t.cutoff, np.float32) for t in tickets]) \
            if tickets else np.zeros(0, np.float32)
        pred, conf = view.query(ids_cat, cut_cat)
        out, off = [], 0
        for t in tickets:
            q = len(t.ids)
            out.append(QueryResult(
                ids=t.ids, pred=pred[off:off + q],
                confidence=conf[off:off + q], commit_id=view.commit_id))
            off += q
        with self._stats_lock:
            self.queries += len(tickets)
            self.query_nodes += len(ids_cat)
            self.queries_while_inflight += inflight * len(tickets)
        return out

    def committed_view(self) -> LabelView:
        """Snapshot handle over the last committed labels."""
        return self.engine.committed_view()

    # ------------------------------------------------------------------ #
    # write path
    # ------------------------------------------------------------------ #
    def add_points(
        self,
        embeddings: np.ndarray,
        labels: np.ndarray | None = None,
    ) -> MutationTicket:
        """Insert points by embedding — the embedding-first front door.

        ``embeddings`` is (M, D); ``labels`` is (M,) ground truth (0/1,
        or ``UNLABELED``/None for points the propagation should label).
        The service derives the graph delta itself — on device when the
        engine was built with ``ingest="device"`` —
        so callers never construct edge lists.  Returns the mutation's
        ticket; ``sync()`` for read-your-writes."""
        return self.mutate(ins_emb=embeddings, ins_labels=labels)

    def remove_points(self, ids) -> MutationTicket:
        """Delete points by global id (their edges vanish with them)."""
        return self.mutate(del_ids=ids)

    def relabel(self, ids, labels) -> MutationTicket:
        """Change the ground-truth labels of existing points (0/1, or
        ``UNLABELED`` to demote a seed back to propagated)."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        labels = np.asarray(labels, np.int8).reshape(-1)
        if len(ids) != len(labels):
            raise ValueError(
                f"relabel ids length {len(ids)} != labels {len(labels)}")
        return self.mutate(rel_ids=ids, rel_labels=labels)

    def mutate(
        self,
        ins_emb: np.ndarray | None = None,
        ins_labels: np.ndarray | None = None,
        del_ids: np.ndarray | None = None,
        rel_ids: np.ndarray | None = None,
        rel_labels: np.ndarray | None = None,
    ) -> MutationTicket:
        """Enqueue one mutation (inserts, deletes and/or relabels) for
        the current admission window; returns its ticket.  May admit a
        batch (window full or deadline passed) and, under backpressure,
        may block until the backlog drains — or raise ``Backpressure``
        if configured to reject.

        Prefer the typed ``add_points`` / ``remove_points`` / ``relabel``
        wrappers; constructing raw ``BatchUpdate`` deltas and calling
        ``engine.submit`` directly is deprecated for service callers —
        it bypasses admission windows, backpressure and tickets."""
        dim = self.engine.graph.emb_dim
        emb = (np.zeros((0, dim), np.float32) if ins_emb is None
               else np.asarray(ins_emb, np.float32).reshape(-1, dim))
        if ins_labels is None:
            labels = np.full(len(emb), UNLABELED, np.int8)
        else:
            labels = np.asarray(ins_labels, np.int8).reshape(-1)
        if len(labels) != len(emb):
            raise ValueError(
                f"ins_labels length {len(labels)} != ins_emb rows {len(emb)}")
        dels = (np.zeros(0, np.int64) if del_ids is None
                else np.asarray(del_ids, np.int64).reshape(-1))
        rels = (np.zeros(0, np.int64) if rel_ids is None
                else np.asarray(rel_ids, np.int64).reshape(-1))
        rlabs = (np.zeros(0, np.int8) if rel_labels is None
                 else np.asarray(rel_labels, np.int8).reshape(-1))
        if len(rels) != len(rlabs):
            raise ValueError(
                f"rel_labels length {len(rlabs)} != rel_ids {len(rels)}")
        ops = len(emb) + len(dels) + len(rels)
        if ops == 0:
            raise ValueError(
                "empty mutation: no inserts, deletes or relabels")

        with self._lock:
            if self.preempted:
                raise RuntimeError(
                    "service preempted: state was checkpointed and the "
                    "driver halted — restart and restore to resume")
            self._raise_ckpt_error()
            self.pump()  # harvest a finished solve / deadline-flush first
            if self._pending_ops() + ops > self.max_pending_ops:
                if self.reject_on_overload:
                    self.rejected += 1
                    raise Backpressure(
                        f"mutation of {ops} ops over bound: "
                        f"{self._pending_ops()} pending, "
                        f"max_pending_ops={self.max_pending_ops}")
                self._relieve(ops)

            ticket = MutationTicket(ticket=self._next_ticket, ops=ops,
                                    enqueued_at=time.perf_counter())
            self._next_ticket += 1
            self._window.append(
                _QueuedMutation(ticket, emb, labels, dels, rels, rlabs))
            self._window_ops += ops
            if self._window_t0 is None:
                self._window_t0 = time.perf_counter()
            self.mutations += 1
            self.ops_accepted += ops
            if self._window_ops >= self.window_ops:
                self._admit()
            return ticket

    def pump(self) -> StreamStats | None:
        """Advance the service without blocking: commit the in-flight
        batch if its solve finished, then admit the open window if it hit
        the size or deadline bound.  Returns commit stats if one landed.
        With the driver running this happens continuously on its own."""
        with self._lock:
            st = self.engine.poll()
            if st is not None:
                self._resolve(st)
            if self._window and (
                    self._window_ops >= self.window_ops
                    or (time.perf_counter() - self._window_t0) * 1e3
                    >= self.window_ms):
                self._admit()
            if (self._guard is not None and self._guard.requested
                    and not self.preempted):
                self._handle_preemption()
            return st

    def _driver_pump(self) -> int:
        """One driver clock tick; returns 1 iff the deadline (not size)
        force-admitted the window — the driver's admission counter.

        Non-blocking on the write lock: a mutation mid-staging holds it
        for tens of milliseconds, and stalling the driver there would
        queue every fused read behind the write path — the exact
        coordinated delay the async model exists to remove.  A skipped
        tick costs nothing: the mutating caller's own ``pump`` runs on
        lock release, and the driver retries within ``poll_ms``."""
        if not self._lock.acquire(blocking=False):
            return 0
        try:
            was_open = self._window_t0 is not None
            under = self._window_ops < self.window_ops
            self.pump()
            return int(was_open and under and self._window_t0 is None)
        finally:
            self._lock.release()

    def _time_to_deadline(self) -> float:
        """Seconds until the open window's ``window_ms`` deadline (driver
        sleep bound); 1s when no window is open.  Lock-free: ``_window_t0``
        is read once (atomic), and a stale value only mistimes one tick."""
        t0 = self._window_t0
        if t0 is None:
            return 1.0
        return max(0.0, t0 + self.window_ms / 1e3 - time.perf_counter())

    def flush(self) -> BatchUpdate | None:
        """Force-admit the open window regardless of size/deadline;
        returns the coalesced ``BatchUpdate`` (None if nothing queued)."""
        with self._lock:
            st = self.engine.poll()
            if st is not None:
                self._resolve(st)
            return self._admit()

    def sync(self) -> StreamStats | None:
        """Flush + block until every admitted batch has committed.  After
        ``sync()`` returns, queries observe all prior mutations
        (read-your-writes) — including reads fused by the driver, which
        are answered from the view this drain publishes.  Returns the
        last commit's stats."""
        with self._lock:
            self._raise_ckpt_error()
            self._admit()
            st = self.engine.drain()
            if st is not None:
                self._resolve(st)
            return st

    # ------------------------------------------------------------------ #
    def _pending_ops(self) -> int:
        return self._window_ops + self._inflight_ops

    def _relieve(self, incoming: int):
        """Blockingly shrink the backlog until ``incoming`` fits."""
        if incoming > self.max_pending_ops:
            self.rejected += 1  # can never fit: rejected even in block mode
            raise Backpressure(
                f"single mutation of {incoming} ops exceeds "
                f"max_pending_ops={self.max_pending_ops}")
        while self._pending_ops() + incoming > self.max_pending_ops:
            if self._inflight:
                st = self.engine.drain()
                if st is not None:
                    self._resolve(st)
            elif self._window:
                self._admit()
            else:  # pragma: no cover — nothing left to shed
                break

    def _admit(self) -> BatchUpdate | None:
        """Coalesce the window into one BatchUpdate and submit it."""
        if not self._window:
            return None
        window, self._window = self._window, []
        ops, self._window_ops = self._window_ops, 0
        self._window_t0 = None
        with telemetry.span("service.admit"):
            batch = BatchUpdate(
                ins_emb=np.concatenate([q.ins_emb for q in window]),
                ins_labels=np.concatenate([q.ins_labels for q in window]),
                del_ids=np.concatenate([q.del_ids for q in window]),
                rel_ids=np.concatenate([q.rel_ids for q in window]),
                rel_labels=np.concatenate([q.rel_labels for q in window]),
            )
        # submit internally drains the previous batch — those are the
        # current in-flight tickets, resolved below if that drain ran.
        prev = self.engine.submit(batch)
        if prev is not None:
            self._resolve(prev)
        self._inflight = [q.ticket for q in window]
        self._inflight_ops = ops
        self.batches_admitted += 1
        return batch

    def _resolve(self, stats: StreamStats):
        """Mark the in-flight tickets committed (their batch drained)."""
        now = time.perf_counter()
        for t in self._inflight:
            t.committed_at = now
            t.commit_id = self.engine.commits
            self._commit_latency_ms.append(t.latency_ms)
        self._inflight = []
        self._inflight_ops = 0
        self.batches_committed += 1
        self._maybe_checkpoint()

    # ------------------------------------------------------------------ #
    def stats(self) -> ServiceStats:
        """Current service counters plus commit-latency percentiles."""
        lat = self._commit_latency_ms
        pct = {}
        if lat:
            arr = np.asarray(lat)
            pct = {
                "p50": round(float(np.percentile(arr, 50)), 3),
                "p95": round(float(np.percentile(arr, 95)), 3),
                "p99": round(float(np.percentile(arr, 99)), 3),
                "max": round(float(arr.max()), 3),
                "count": len(lat),
            }
        d = self._driver
        rb, rt, da = self._drained_reads
        if d is not None:
            rb += d.read_batches
            rt += d.read_tickets
            da += d.deadline_admissions
        return ServiceStats(
            queries=self.queries,
            query_nodes=self.query_nodes,
            queries_while_inflight=self.queries_while_inflight,
            driver_running=self.driver_running,
            read_batches=rb,
            read_tickets=rt,
            deadline_admissions=da,
            mutations=self.mutations,
            ops_accepted=self.ops_accepted,
            rejected=self.rejected,
            batches_admitted=self.batches_admitted,
            batches_committed=self.batches_committed,
            pending_ops=self._pending_ops(),
            recompiles=self.engine.recompile_count,
            bucket_rungs=len(self.engine.bucket_keys),
            commit_latency_ms=pct,
            transport=self.engine.transport_summary(),
            checkpoints_written=self.checkpoints_written,
            last_checkpoint_commit=self._last_ckpt_commit,
            preempted=self.preempted,
        )
