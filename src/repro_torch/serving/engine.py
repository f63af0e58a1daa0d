"""Serving engines: the LP service's async machinery and the LM
continuous batcher.

Counterpart of ``repro.serving.engine``.  Two independent serving shapes
live here:

  * ``ServiceDriver`` / ``ReadBatcher`` / ``ReadTicket`` — the async
    machinery behind ``serving.lp_service.LPService``.  A background thread
    clocks the service (admission-window deadlines fire with zero caller
    traffic, finished solves commit off every caller's critical path) and
    fuses the read tickets of concurrent callers into ONE gather against
    the engine's committed ``DeviceLabelView``.
  * ``ServeEngine`` — slot-based continuous batching over an LM
    ``decode_step``: a fixed pool of B slots, prefill into a free slot,
    then the whole pool decodes one token per step.  The batch axis of
    every cache leaf is probed once at init by differencing
    ``cache_shape(b)`` vs ``cache_shape(b+1)``.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch


class ReadTicket:
    """One caller's pending read: ids in, (QueryResult | error) out.

    Handed out by ``LPService.query_async``; the driver fulfils batches
    of these with one fused device gather.  ``wait`` blocks the caller;
    ``completed_at`` stamps fulfilment time so an open-loop load can
    measure latency from the *scheduled* arrival, not the wait call.
    """

    __slots__ = ("ids", "cutoff", "enqueued_at", "completed_at",
                 "result", "error", "_done")

    def __init__(self, ids: np.ndarray, cutoff: float):
        self.ids = ids
        self.cutoff = cutoff
        self.enqueued_at = time.perf_counter()
        self.completed_at: float | None = None
        self.result = None
        self.error: BaseException | None = None
        self._done = threading.Event()

    def _fulfil(self, result=None, error=None):
        self.result = result
        self.error = error
        self.completed_at = time.perf_counter()
        self._done.set()

    @property
    def done(self) -> bool:
        """True once the driver has fulfilled (or failed) this ticket."""
        return self._done.is_set()

    def wait(self, timeout: float | None = None):
        """Block until fulfilled; returns the ``QueryResult`` (raises the
        driver-side error, or TimeoutError on timeout)."""
        if not self._done.wait(timeout):
            raise TimeoutError("read ticket not fulfilled in time")
        if self.error is not None:
            raise self.error
        return self.result


class ReadBatcher:
    """Thread-safe queue of pending ``ReadTicket``s.

    Callers ``submit``; the driver ``take_all``s and serves the whole
    batch from ONE committed view in one fused gather — which is also
    the coherence argument: every ticket in a batch is answered from
    the same immutable snapshot, so a commit landing mid-burst flips
    readers atomically between views, never within one.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._tickets: list[ReadTicket] = []
        self._wake = threading.Event()
        self._closed = False

    def submit(self, ids: np.ndarray, cutoff: float) -> ReadTicket:
        """Queue a read for the driver's next fused gather."""
        t = ReadTicket(ids, cutoff)
        with self._lock:
            if self._closed:
                raise RuntimeError("read batcher is closed (driver stopped)")
            self._tickets.append(t)
        self._wake.set()
        return t

    def take_all(self) -> list[ReadTicket]:
        """Drain the queue (driver side): all tickets, atomically."""
        with self._lock:
            tickets, self._tickets = self._tickets, []
        return tickets

    @property
    def pending(self) -> int:
        """Tickets queued but not yet taken by the driver."""
        with self._lock:
            return len(self._tickets)

    def close(self) -> list[ReadTicket]:
        """Refuse new submissions; returns whatever was still queued so
        the driver can drain it."""
        with self._lock:
            self._closed = True
            tickets, self._tickets = self._tickets, []
        return tickets

    def wait_for_work(self, timeout: float):
        """Park the driver until a submit arrives or ``timeout`` lapses."""
        self._wake.wait(timeout)
        self._wake.clear()


class ServiceDriver(threading.Thread):
    """Background clock for an ``LPService``.

    One loop iteration: fulfil every queued read ticket with a single
    fused gather, then ``pump`` the service under its lock — committing
    a finished solve and force-admitting the open window once its
    ``window_ms`` deadline passes, with NO caller traffic required.
    Between iterations the thread sleeps on the batcher's wake event,
    capped by the time to the next admission deadline (so deadlines
    fire promptly) and ``poll_ms`` (so finished solves commit promptly).

    ``stop`` drains: in-flight tickets are fulfilled before the thread
    exits, and the batcher is closed so late submitters get a clean
    error instead of hanging.
    """

    def __init__(self, service, batcher: ReadBatcher, poll_ms: float = 2.0):
        super().__init__(name="lp-service-driver", daemon=True)
        self._svc = service
        self._batcher = batcher
        self._poll_s = poll_ms / 1e3
        self._halt = threading.Event()
        self.read_batches = 0  # fused gathers executed
        self.read_tickets = 0  # tickets fulfilled by those gathers
        self.deadline_admissions = 0  # windows admitted by the clock

    def run(self):
        """Driver loop: fuse queued reads, pump the service's admission
        clock, exit only after a halt request has drained stragglers."""
        while True:
            tickets = self._batcher.take_all()
            if tickets:
                self._serve(tickets)
            admitted = self._svc._driver_pump()
            self.deadline_admissions += admitted
            if self._halt.is_set():
                if self._batcher.pending:
                    continue  # drain stragglers before exiting
                break
            self._batcher.wait_for_work(
                min(self._poll_s, self._svc._time_to_deadline()))

    def _serve(self, tickets: list[ReadTicket]):
        try:
            results = self._svc._serve_reads(tickets)
        except BaseException as e:  # tickets must not hang
            for t in tickets:
                t._fulfil(error=e)
            if not isinstance(e, Exception):
                raise
            return
        self.read_batches += 1
        self.read_tickets += len(tickets)
        for t, r in zip(tickets, results):
            t._fulfil(result=r)

    def halt(self):
        """Signal the loop to exit WITHOUT joining.  Safe to call from
        the driver thread itself — the service's preemption handler runs
        inside ``pump()``, which the driver may be clocking — where
        ``stop()``'s self-join would deadlock.  The loop still drains
        queued tickets before exiting; call ``stop()`` from another
        thread afterwards to join and close the batcher."""
        self._halt.set()
        self._batcher._wake.set()

    def stop(self, timeout: float = 30.0):
        """Signal, drain in-flight tickets, join; then fulfil anything
        that raced past the close with an error so no caller hangs."""
        self.halt()
        self.join(timeout)
        for t in self._batcher.close():
            t._fulfil(error=RuntimeError("service driver stopped"))


# ---------------------------------------------------------------------- #
# LM serving: slot-based continuous batching
# ---------------------------------------------------------------------- #

@dataclasses.dataclass
class Request:
    """One decode request: prompt tokens in, generated tokens out."""

    uid: int
    prompt: np.ndarray  # (S,) int32
    max_new: int = 16
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Slot-based continuous-batching decode loop over ``model`` (a
    ``TransformerLM``, which holds its weights; its cache lives on the
    model's device).

    A request is prefilled token by token through the POOL's
    ``decode_step`` at its slot's own position, adopting only that slot's
    rows of the returned cache; then ``step`` decodes one token for every
    active slot, each at its own ``pos``, and adopts the whole cache.
    Greedy: argmax, ties to the first index.  Every step ends in a host
    sync (the argmax comes back to numpy).  Counts: ``steps`` (pooled
    steps), ``prefill_calls`` (``decode_step`` calls for prompt tokens) and
    ``decode_calls`` (all ``decode_step`` calls, = their sum).
    """

    def __init__(self, model, max_batch: int = 4, s_max: int = 256):
        self.model = model
        self.b = max_batch
        self.s_max = s_max
        self.cache = model.init_cache(max_batch, s_max)
        sa = model.cache_shape(max_batch, s_max)
        sb = model.cache_shape(max_batch + 1, s_max)
        self.batch_axes = {
            key: next(i for i, (x, y) in enumerate(zip(sa[key].shape, sb[key].shape))
                      if x != y) for key in sa}
        self.pos = np.zeros(max_batch, np.int64)
        self.slots: list[Request | None] = [None] * max_batch
        self._decode = model.decode_step
        self.steps = 0
        self.prefill_calls = 0
        self.decode_calls = 0

    # ------------------------------------------------------------------ #
    def _free_slot(self) -> int | None:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def _call(self, tokens: np.ndarray, pos: np.ndarray):
        dev = self.model.device
        self.decode_calls += 1
        return self._decode(self.cache, {
            "tokens": torch.as_tensor(tokens, dtype=torch.int64).to(dev),
            "pos": torch.as_tensor(pos, dtype=torch.int64).to(dev)})

    def _commit_slot(self, new_cache, slot: int):
        """Adopt only ``slot``'s rows from new_cache (other slots frozen)."""
        for key, new in new_cache.items():
            axis = self.batch_axes[key]
            self.cache[key].narrow(axis, slot, 1).copy_(new.narrow(axis, slot, 1))

    def submit(self, req: Request) -> bool:
        """Prefill ``req`` into a free slot; False when all slots busy."""
        slot = self._free_slot()
        if slot is None:
            return False
        self.pos[slot] = 0
        self.slots[slot] = req
        logits = None
        for tok in req.prompt:  # slot-local prefill at the slot's own pos
            logits, cache = self._call(np.full((self.b, 1), int(tok)), self.pos.copy())
            self.prefill_calls += 1
            self._commit_slot(cache, slot)
            self.pos[slot] += 1
        req.out.append(int(torch.argmax(logits[slot, -1])))
        return True

    # ------------------------------------------------------------------ #
    def step(self):
        """One batched decode step for every active slot."""
        if not any(s is not None for s in self.slots):
            return
        toks = np.zeros((self.b, 1), np.int64)
        for i, req in enumerate(self.slots):
            if req is not None and req.out:
                toks[i, 0] = req.out[-1]
        # per-slot positions: continuous batching, every slot at its own pos
        logits, self.cache = self._call(toks, self.pos)
        self.steps += 1
        nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            self.pos[i] += 1
            req.out.append(int(nxt[i]))
            if len(req.out) >= req.max_new:
                req.done = True
                self.slots[i] = None

    def run(self, requests: list[Request], max_steps: int = 1_000):
        """Drive all ``requests`` to completion (admit-as-slots-free)."""
        pending = list(requests)
        while (pending or any(s is not None for s in self.slots)) \
                and self.steps < max_steps:
            while pending and self._free_slot() is not None:
                self.submit(pending.pop(0))
            self.step()
        return [r for r in requests if r.done]
