"""Spans and counters recorded from the benchmark's side of the program.

A ``Hook`` names a function or method of the program (``"module:attr"`` or
``"module:Class.method"``) and the span its calls go under.  ``install``
wraps each one for the measured window and gives back the function that
puts the originals back; the program's files are not touched.  Every call
records a span (host clock, ``perf_counter_ns``, on whatever thread it ran)
and, where the hook has a ``capture``, the value ``capture(args, kwargs,
result)`` returns, under the span's name.
"""

from __future__ import annotations

import dataclasses
import importlib
import threading
import time
from collections import defaultdict
from typing import Callable


@dataclasses.dataclass(frozen=True)
class Hook:
    target: str  # "package.module:attr" or "package.module:Class.method"
    name: str  # the span the calls go under
    capture: Callable | None = None  # (args, kwargs, result) -> value
    timed: bool = True  # False: capture only (calls too many or short to time)


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    t0: int  # perf_counter_ns
    t1: int
    item: int | None  # the window's item (a fit) it ran in
    thread: int


class SpanLog:
    """Spans and captured values of one run, in memory until it ends."""

    def __init__(self):
        self.spans: list[Span] = []
        self.values: dict[str, list] = defaultdict(list)
        self.item: int | None = None  # set by the driver as items start
        self._lock = threading.Lock()

    def add(self, name: str, t0: int, t1: int) -> None:
        with self._lock:
            self.spans.append(Span(name, t0, t1, self.item, threading.get_ident()))

    def capture(self, name: str, value) -> None:
        with self._lock:
            self.values[name].append(value)

    def total_s(self, name: str) -> float:
        """Seconds spent in ``name`` over the window's items."""
        return sum(s.t1 - s.t0 for s in self.spans
                   if s.name == name and s.item is not None) / 1e9


def _resolve(target: str):
    module, _, path = target.partition(":")
    owner = importlib.import_module(module)
    *parents, attr = path.split(".")
    for p in parents:
        owner = getattr(owner, p)
    return owner, attr


def install(hooks, log: SpanLog) -> Callable[[], None]:
    """Wrap every hook's target (each (target, name) pair once); returns
    the function that restores the originals."""
    undo = []
    seen = set()
    for h in hooks:
        if (h.target, h.name) in seen:
            continue
        seen.add((h.target, h.name))
        owner, attr = _resolve(h.target)
        orig = owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)

        def wrapper(*args, _orig=orig, _h=h, **kwargs):
            if not _h.timed:
                res = _orig(*args, **kwargs)
            else:
                t0 = time.perf_counter_ns()
                try:
                    res = _orig(*args, **kwargs)
                finally:
                    log.add(_h.name, t0, time.perf_counter_ns())
            if _h.capture is not None:
                log.capture(_h.name, _h.capture(args, kwargs, res))
            return res

        setattr(owner, attr, wrapper)
        undo.append((owner, attr, orig))

    def restore():
        for owner, attr, orig in reversed(undo):
            setattr(owner, attr, orig)

    return restore
