"""fit_vertices_per_s: every vertex of every fit in the window over all of
the window's time, from its start to the last fit's commit (host clock)."""


def read(run):
    w = run.window
    return w.units / w.seconds if w.seconds > 0 else None
