"""stage.snapshot_s: host seconds a fit in ``StreamEngine.submit`` less
``apply_batch``: the snapshot build, G' components, supernode init and the
staging of the solve."""

from portbench import layers

HOOKS = (layers.SUBMIT, layers.APPLY_BATCH)


def read(run):
    s = run.spans
    return (s.total_s("engine.submit") - s.total_s("graph.apply_batch")) / run.window.items
