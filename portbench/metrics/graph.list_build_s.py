"""graph.list_build_s: host seconds a fit in ``DynamicGraph.apply_batch``
less its select: the canonical lists, the merges and the edge refresh."""

from portbench import layers

HOOKS = (layers.APPLY_BATCH, layers.SELECT)


def read(run):
    s = run.spans
    return (s.total_s("graph.apply_batch") - s.total_s("ingest.select")) / run.window.items
