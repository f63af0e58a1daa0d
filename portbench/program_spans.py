"""The program's own spans and counters, for the per-layer metrics that read them.

``repro_torch.telemetry`` records spans and counters inside the program
(``PERF.md`` §3).  A reader of them calls ``start()`` as it loads: the
harness loads per-layer readers only in a ``--trace 1`` run, after the warm
fit, so the recorder is on for a traced run's window and off in every
other run.  The first reading after the window turns the recorder off and
takes what it holds; the run's readers share that take.  A span counts if
it started and ended inside the window; a counter counts from ``start()``
to that first reading, in which the harness runs nothing of the program but
the window.

The take is also summed up once, on standard error, as one line
``program spans: {...}``: each span's self time a fit, the counters a fit,
the share of ``graph.apply_batch`` and of ``engine.submit`` outside
``graph.apply_batch`` that their steps cover, and, with the device trace,
the window's idle device seconds by innermost program span.  The idle gaps
are cut at every span's start and end first, so that ``trace.gaps_by_host``,
which gives a gap to the span open at its midpoint, splits a gap that
outlasts a step among the steps it covers.

Against a program without the recorder, nothing starts and every reading
is None.
"""

from __future__ import annotations

import bisect
import json
import sys
from collections import defaultdict

from portbench import trace as tr

_taken: tuple | None = None  # ((window.t0, window.t1), spans, counters)


def _recorder():
    try:
        from repro_torch import telemetry
    except ImportError:
        return None
    return telemetry


def start() -> None:
    """Turn the program's recorder on, empty."""
    rec = _recorder()
    if rec is not None:
        rec.take()
        rec.enable()


def record(run):
    """The window's spans and the counters, taken once per window; None
    without the recorder."""
    global _taken
    w = run.window
    if _taken is None or _taken[0] != (w.t0, w.t1):
        rec = _recorder()
        if rec is None:
            return None
        rec.disable()
        got = rec.take()
        spans = [s for s in got.spans if s.t0 >= w.t0 and s.t1 <= w.t1]
        _taken = ((w.t0, w.t1), spans, got.counters)
        print("program spans: " + json.dumps(summary(run, spans, got.counters)),
              file=sys.stderr)
    return _taken[1], _taken[2]


def span_s(run, name: str) -> float | None:
    """Seconds a fit in the spans named ``name``."""
    got = record(run)
    if got is None:
        return None
    return sum(s.t1 - s.t0 for s in got[0] if s.name == name) / 1e9 / run.window.items


def counter(run, name: str) -> float | None:
    """The counter ``name`` a fit."""
    got = record(run)
    if got is None:
        return None
    return got[1].get(name, 0) / run.window.items


def self_ns(spans) -> dict[str, int]:
    """Each span name's time less its children's, summed."""
    out = defaultdict(int)
    name = {s.id: s.name for s in spans}
    for s in spans:
        out[s.name] += s.t1 - s.t0
        if s.parent in name:
            out[name[s.parent]] -= s.t1 - s.t0
    return dict(out)


def split_at(gaps, points) -> list[tuple[int, int]]:
    """The gaps cut at every point that falls inside one."""
    pts = sorted(points)
    out = []
    for a, b in gaps:
        i = bisect.bisect_right(pts, a)
        while i < len(pts) and pts[i] < b:
            out.append((a, pts[i]))
            a = pts[i]
            i += 1
        out.append((a, b))
    return out


def summary(run, spans, counters) -> dict:
    items = run.window.items
    total = defaultdict(int)
    children = defaultdict(int)
    name = {s.id: s.name for s in spans}
    for s in spans:
        total[s.name] += s.t1 - s.t0
        if s.parent in name:
            children[(name[s.parent], s.name)] += s.t1 - s.t0
    apply_ns = total["graph.apply_batch"]
    under_apply = sum(v for (p, _), v in children.items() if p == "graph.apply_batch")
    staging_ns = total["engine.submit"] - children[("engine.submit", "graph.apply_batch")]
    under_submit = sum(v for (p, c), v in children.items()
                       if p == "engine.submit" and c != "graph.apply_batch")
    out = {
        "fits": items,
        "self_s": {k: v / 1e9 / items for k, v in
                   sorted(self_ns(spans).items(), key=lambda kv: -kv[1])},
        "counters": {k: v / items for k, v in sorted(counters.items())},
        "cover": {"graph.apply_batch": under_apply / apply_ns if apply_ns else None,
                  "engine.submit": under_submit / staging_ns if staging_ns else None},
    }
    if run.trace is not None:
        busy = tr.busy_intervals(run.trace.events, run.lo, run.hi)
        gaps = tr.idle_gaps(busy, run.lo, run.hi)
        edges = [run.trace.to_trace(t) for s in spans for t in (s.t0, s.t1)]
        idle = tr.gaps_by_host(split_at(gaps, edges), spans, run.trace.to_trace,
                               n=len(total) + 1)
        idle_ns = sum(b - a for a, b in gaps)
        blind = sum(s for n, s in idle if n in ("graph.apply_batch", "engine.submit",
                                                "outside any span"))
        out["idle_s"] = idle
        out["idle_total_s"] = idle_ns / 1e9
        out["idle_unsplit_share"] = blind / (idle_ns / 1e9) if idle_ns else None
    return out
