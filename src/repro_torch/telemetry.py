"""The port's recorder: spans and counters on the host clock, off by default.

    from repro_torch import telemetry

    telemetry.enable()
    clf.fit(X, y)
    rec = telemetry.take()      # the spans and counters so far, then cleared
    telemetry.disable()

``span(name)`` is a context manager around one step of the program;
``count(name, n)`` adds to a counter.  Off, ``span`` is one test of a module
global and returns a shared no-op object: no clock read, no allocation, no
lock; ``count`` returns at the same test.  Nothing turns the recorder on but
``enable()``, and it adds no device synchronize: a span's times are the
host's, and a step that only queues device work ends when the host returns.

Each ``Span`` holds its ``name``; ``t0`` and ``t1`` from
``time.perf_counter_ns()``; its ``id`` and its ``parent``'s (the span open
around it on the same thread, or None); ``batch``, the engine's Δ_t index
(given to the engine's outer span and to the worker's solve, and inherited
from the parent otherwise); and the ``thread`` it ran on.  Spans stay in
memory, at most ``MAX_SPANS`` of them; the ones past that are counted under
``telemetry.dropped``.

The spans a fit records (each inside the one above it, ``PERF.md`` §3):

* ``fit.init_stack``, ``service.admit`` (the window's concatenation),
  ``fit.readback`` (the committed predictions read back);
* ``engine.submit`` and its steps ``graph.apply_batch``, ``stage.build``,
  ``stage.resolve``, ``stage.commit``, ``stage.init``, ``engine.drain``,
  ``stage.queue``; ``engine.drain``'s ``engine.drain_wait`` and
  ``engine.fold``; ``solve.run`` on the worker thread;
* ``graph.apply_batch``'s ``graph.delete``, ``graph.append``,
  ``ingest.select`` (with ``ingest.store_append``, ``ingest.search`` and
  ``ingest.readback`` under device ingest), ``graph.rerank``,
  ``graph.merge``, ``graph.edges``, ``graph.gprime``, ``graph.relabel`` and
  ``graph.finalize``;
* ``kernels.build``, when the CUDA sources compile.

Counters: ``graph.flagged_rows``, ``graph.rerank_store_rows`` (new rows
whose lists were re-selected on the card from the device store: every row
under single-device ingest, none on the host selector or a mesh),
``solve.host_wait_ns`` (the host's time blocked in the frontier loop's one
sync a sweep), ``kernels.builds`` and ``ingest.new_shapes`` (a store update
or argkmin shape seen first).
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import NamedTuple

MAX_SPANS = 1 << 20


class Span(NamedTuple):
    name: str
    t0: int  # perf_counter_ns
    t1: int
    id: int
    parent: int | None  # the id of the span open around it on its thread
    batch: int | None  # the engine's Δ_t index
    thread: int


@dataclasses.dataclass
class Record:
    spans: list[Span]
    counters: dict[str, int]


_on = False
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count()
_spans: list[Span] = []
_counters: dict[str, int] = {}


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    __slots__ = ("name", "batch", "id", "parent", "t0")

    def __init__(self, name: str, batch: int | None):
        self.name = name
        self.batch = batch

    def __enter__(self):
        stack = _stack()
        top = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = top.id if top is not None else None
        if self.batch is None and top is not None:
            self.batch = top.batch
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _stack().pop()
        if _on:
            _add(Span(self.name, self.t0, t1, self.id, self.parent, self.batch,
                      threading.get_ident()))
        return False


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _add(s: Span) -> None:
    with _lock:
        if len(_spans) < MAX_SPANS:
            _spans.append(s)
        else:
            _counters["telemetry.dropped"] = _counters.get("telemetry.dropped", 0) + 1


def span(name: str, batch: int | None = None):
    """A context manager that records ``name`` around its body while the
    recorder is on; ``batch`` names the Δ_t (children inherit it)."""
    if not _on:
        return _OFF
    return _Open(name, batch)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while the recorder is on."""
    if not _on:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def enabled() -> bool:
    return _on


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    """Stop recording; what was recorded stays until ``take``."""
    global _on
    _on = False


def take() -> Record:
    """The spans and counters recorded so far; the recorder starts empty."""
    global _spans, _counters
    with _lock:
        rec = Record(spans=_spans, counters=_counters)
        _spans, _counters = [], {}
    return rec
