"""graph.edges_s: host seconds a fit in the program's ``graph.edges`` span,
the undirected edge arrays rebuilt from the lists (``_rebuild_edges``)."""

from portbench import program_spans

program_spans.start()


def read(run):
    return program_spans.span_s(run, "graph.edges")
