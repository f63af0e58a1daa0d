"""graph.flagged_rows: rows a Δ_t whose list the batch may beat and that pay a
merge, the program's ``graph.flagged_rows`` counter."""

from portbench import program_spans

program_spans.start()


def read(run):
    return program_spans.counter(run, "graph.flagged_rows")
