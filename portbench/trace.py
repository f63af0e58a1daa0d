"""The device trace of a ``--trace 1`` window (``torch.profiler``, CUDA only).

Every kernel, copy and set the card ran is read back as ``(name, start,
end)`` in the profiler's clock (ns).  Host spans (``perf_counter_ns``) are put
on that clock by a marker: after a synchronize the host notes its clock and
launches one spin kernel, whose start in the trace gives the offset.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict

import torch

MARKER_CYCLES = 1000  # the alignment kernel's spin


@dataclasses.dataclass(frozen=True)
class DeviceEvent:
    name: str
    start: int  # ns, profiler clock
    end: int


def _ns(ev, what: str) -> int:
    if hasattr(ev, f"{what}_ns"):
        return int(getattr(ev, f"{what}_ns")())
    return int(getattr(ev, f"{what}_us")() * 1000)


class DeviceTrace:
    """Profiles the card between ``start`` and ``stop``."""

    def __init__(self):
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.events: list[DeviceEvent] = []
        self.offset = 0  # profiler ns - perf_counter ns

    def start(self) -> None:
        torch.cuda.synchronize()
        self._prof.__enter__()
        torch.cuda.synchronize()
        self._marker_host = time.perf_counter_ns()
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        evs = []
        for ev in self._prof.profiler.kineto_results.events():
            if ev.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            start = _ns(ev, "start")
            end = start + _ns(ev, "duration")
            evs.append(DeviceEvent(ev.name(), start, end))
        evs.sort(key=lambda e: e.start)
        if evs:
            self.offset = evs[0].start - self._marker_host
            evs = evs[1:]  # the marker
        self.events = evs

    def to_trace(self, host_ns: int) -> int:
        return host_ns + self.offset

    def kernels(self, substring: str, lo: int, hi: int) -> list[DeviceEvent]:
        """Events whose name holds ``substring`` and that start in [lo, hi)."""
        return [e for e in self.events if substring in e.name and lo <= e.start < hi]


def busy_intervals(events, lo: int, hi: int) -> list[tuple[int, int]]:
    """The union of the events' intervals, clipped to [lo, hi)."""
    out: list[list[int]] = []
    for e in events:
        a, b = max(e.start, lo), min(e.end, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def idle_gaps(busy, lo: int, hi: int) -> list[tuple[int, int]]:
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def top_ops(events, lo: int, hi: int, n: int = 10) -> list[list]:
    """The ``n`` device operations that took most time, by name."""
    by = defaultdict(int)
    for e in events:
        if lo <= e.start < hi:
            by[e.name[:120]] += e.end - e.start
    return [[name, ns / 1e9] for name, ns in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def gaps_by_host(gaps, spans, to_trace, n: int = 10) -> list[list]:
    """Idle seconds by what the host was doing: each gap goes to the
    innermost span (the latest started) open at its midpoint, or to
    ``"outside any span"``."""
    placed = sorted(((to_trace(s.t0), to_trace(s.t1), s.name) for s in spans),
                    key=lambda x: x[0])
    by = defaultdict(int)
    for a, b in gaps:
        mid = (a + b) // 2
        name = "outside any span"
        for s0, s1, sname in placed:
            if s0 > mid:
                break
            if s1 > mid:
                name = sname
        by[name] += b - a
    return [[name, ns / 1e9] for name, ns in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
