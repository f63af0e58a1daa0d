"""commit_p50_ms: the median (NumPy's, linear between ranks) over the
window's Δ_t of the time from the driver's call that enqueued a Δ_t to the
return of the call after which the driver saw it committed (host clock)."""

import numpy as np


def read(run):
    ms = run.window.commit_ms
    return float(np.percentile(ms, 50)) if ms else None
