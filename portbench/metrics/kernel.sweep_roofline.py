"""kernel.sweep_roofline: the least time of the window's sweeps
(``rooflines.sweep_bound_s``, by bytes, each at its frontier's rows) over
the device time of the sweep kernel in the trace, in %."""

from portbench import layers, rooflines

HOOKS = (layers.SWEEP,)


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    sweeps = run.spans.values["solve.sweep"]
    ks = run.trace.kernels("ell_propagate_kernel", run.lo, run.hi)
    if not sweeps or not ks:
        return None
    bound = sum(rooflines.sweep_bound_s(s["n"], s["k"], s["nf"], int(s["rows"]), run.peaks)[0]
                for s in sweeps)
    return 100.0 * bound / (sum(e.end - e.start for e in ks) / 1e9)
