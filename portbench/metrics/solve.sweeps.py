"""solve.sweeps: the frontier loop's sweeps a fit (``StreamStats.iterations``
of each commit)."""

from portbench import layers

HOOKS = (layers.DRAIN,)


def read(run):
    its = [v for v in run.spans.values["engine.drain"] if v is not None]
    return sum(its) / run.window.items if its else None
