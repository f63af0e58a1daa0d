"""Fault tolerance and gradient compression.

Counterpart of ``repro.training.resilience``:

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

import torch

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


# --------------------------------------------------------------------- #
# int8 error-feedback gradient compression
# --------------------------------------------------------------------- #
def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def init_error_state(params):
    return _tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                     params)


def compress(g: torch.Tensor, err: torch.Tensor):
    """Returns (int8 codes, fp32 scale, new error).  g+err is quantized to
    symmetric int8 (``torch.round`` rounds half to even, as ``jnp.round``);
    the quantization residual becomes the next error."""
    g32 = g.to(torch.float32) + err
    scale = torch.max(torch.abs(g32)) / torch.full((), 127.0, device=g32.device) + 1e-12
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    new_err = g32 - q.to(torch.float32) * scale
    return q, scale, new_err


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_tree(grads, err_state):
    """Tree version; returns (codes, scales, new_err)."""
    out = _tree_map(compress, grads, err_state)  # a (q, scale, err) tuple a leaf
    return tuple(_tree_map(lambda t, i=i: t[i], out) for i in range(3))


def decompress_tree(codes, scales):
    return _tree_map(decompress, codes, scales)


def make_compressed_allreduce(mesh):
    """Compressed mean-reduce over ``mesh`` (a ``DeviceMesh``):
    ``allreduce(codes, scales)`` takes one tree of int8 codes and one of
    fp32 scales a shard (lists in shard order, each shard's on its own
    device) and returns one tree a shard of the fp32 mean on that shard's
    device.  Each shard's codes and scales are copied to every other
    device, decompressed there and summed in shard order."""

    def allreduce(codes: list, scales: list) -> list:
        n = mesh.n_devices
        if len(codes) != n or len(scales) != n:
            raise ValueError(f"{len(codes)} code trees and {len(scales)} scale trees "
                             f"for {n} shards")

        def mean_on(dev):
            def leaf(*qs_and_ss):
                qs, ss = qs_and_ss[:n], qs_and_ss[n:]
                total = None
                for q, s in zip(qs, ss):
                    part = decompress(q.to(dev, non_blocking=True), s.to(dev, non_blocking=True))
                    total = part if total is None else total + part
                return total / torch.full((), float(n), device=dev)
            return _tree_map(leaf, *codes, *scales)

        return [mean_on(dev) for dev in mesh.devices]

    return allreduce
