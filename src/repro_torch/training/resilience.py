"""Fault tolerance: preemption and stragglers.

Counterpart of the first half of ``repro.training.resilience`` (its
gradient compression is not ported yet):

* ``PreemptionGuard`` — SIGTERM/SIGINT turn into a "checkpoint now, then
  exit cleanly" flag that a loop polls between steps (``LPService`` polls
  it at every ``pump``).
* ``StragglerMonitor`` — per-step wall times; a step slower than
  ``threshold ×`` the rolling median flags a straggler.  It logs and
  counts; what a fleet does with the flag is the caller's.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import signal
import statistics
import time

logger = logging.getLogger(__name__)


class PreemptionGuard:
    """Turn SIGTERM/SIGINT into a "checkpoint now, then exit cleanly" flag.

    Handlers install on construction (both signals by default) and are
    re-armable: ``restore()`` puts the previous handlers back AND resets
    ``requested``, so the same guard can be installed again with
    ``install()``.  ``signal.signal`` works only on the main thread, so
    the guard is built there (elsewhere ``install`` raises ``ValueError``).
    The context-manager form restores the handlers even if the block
    raises::

        with PreemptionGuard() as guard:
            ...
            if guard.requested:
                checkpoint_and_exit()
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.requested = False
        self._signals = tuple(signals)
        self._old = {}
        self.install()

    def install(self):
        """(Re-)register the signal handlers.  Idempotent."""
        for sig in self._signals:
            if sig not in self._old:
                self._old[sig] = signal.signal(sig, self._handler)
        return self

    def _handler(self, signum, frame):
        self.requested = True

    def restore(self):
        """Restore the pre-install handlers and reset ``requested`` so the
        guard can be re-armed with ``install()``."""
        for sig, old in self._old.items():
            signal.signal(sig, old)
        self._old = {}
        self.requested = False

    def __enter__(self):
        return self.install()

    def __exit__(self, exc_type, exc, tb):
        self.restore()
        return False


@dataclasses.dataclass
class StragglerEvent:
    step: int
    seconds: float
    median: float


class StragglerMonitor:
    """Rolling-median step-time watchdog."""

    def __init__(self, threshold: float = 2.5, window: int = 32):
        self.threshold = threshold
        self.times = collections.deque(maxlen=window)
        self.events: list[StragglerEvent] = []
        self._t0 = None
        self._step = 0

    def start_step(self):
        self._t0 = time.perf_counter()

    def end_step(self) -> StragglerEvent | None:
        if self._t0 is None:
            # an end without a start carries no timing: warn and ignore it
            logger.warning("StragglerMonitor.end_step() without start_step();"
                           " ignoring this step")
            return None
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self._step += 1
        event = None
        if len(self.times) >= 8:
            med = statistics.median(self.times)
            if dt > self.threshold * med:
                event = StragglerEvent(self._step, dt, med)
                self.events.append(event)
        self.times.append(dt)
        return event

    def observe(self, seconds: float) -> StragglerEvent | None:
        """Test/offline path: feed a duration directly."""
        self._t0 = time.perf_counter() - seconds
        return self.end_step()
