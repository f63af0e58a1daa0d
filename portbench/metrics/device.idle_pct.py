"""device.idle_pct: the share of the traced window in which no kernel, copy
or set ran on the card, in %."""

from portbench.trace import busy_intervals


def read(run):
    if run.trace is None or run.hi <= run.lo:
        return None
    busy = sum(b - a for a, b in busy_intervals(run.trace.events, run.lo, run.hi))
    return 100.0 * (1.0 - busy / (run.hi - run.lo))
