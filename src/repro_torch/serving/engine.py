"""The LP service's async machinery: read tickets, the fusing batcher and
the background driver.

Counterpart of the LP half of ``repro.serving.engine`` (its LM decode loop,
``Request`` / ``ServeEngine``, is not ported yet).  A background thread
clocks an ``LPService`` (admission-window deadlines fire with zero caller
traffic, finished solves commit off every caller's critical path) and
fuses the read tickets of concurrent callers into ONE gather against the
engine's committed ``DeviceLabelView``.
"""

from __future__ import annotations

import threading
import time

import numpy as np


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
