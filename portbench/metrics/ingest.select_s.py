"""ingest.select_s: host seconds in ``DeviceIngestor.select`` a fit (the
store append, the argkmin kernel, the D2H copies its lists end in)."""

from portbench import layers

HOOKS = (layers.SELECT,)


def read(run):
    return run.spans.total_s("ingest.select") / run.window.items
