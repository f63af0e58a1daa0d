"""kernel.argkmin_roofline: the least time of the window's argkmin calls
(``rooflines.argkmin_bound_s``, by operations at each call's width) over the device
time of the argkmin kernels in the trace, in %."""

from portbench import layers, rooflines

HOOKS = (layers.SELECT,)


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    calls = run.spans.values["ingest.select"]
    ks = run.trace.kernels("argkmin", run.lo, run.hi)
    if not calls or not ks:
        return None
    bound = sum(rooflines.argkmin_bound_s(pk=run.peaks, **c)[0] for c in calls)
    return 100.0 * bound / (sum(e.end - e.start for e in ks) / 1e9)
