"""graph.merge_s: host seconds a Δ_t in the program's ``graph.merge`` span, the
flagged rows' merges of the batch's new rows into their lists."""

from portbench import program_spans

program_spans.start()


def read(run):
    return program_spans.span_s(run, "graph.merge")
