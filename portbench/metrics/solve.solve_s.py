"""solve.solve_s: host seconds a fit in the frontier loop
(``kernels.ops.run_propagation`` on the engine's worker thread)."""

from portbench import layers

HOOKS = (layers.SOLVE,)


def read(run):
    return run.spans.total_s("solve.run") / run.window.items
