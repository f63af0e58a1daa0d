"""graph.rerank_s: host seconds a fit in the program's ``graph.rerank`` span,
the canonical re-selection of the new rows' lists (the candidates' rows
gathered, ``pair_weights``, ``topk_pairs``)."""

from portbench import program_spans

program_spans.start()


def read(run):
    return program_spans.span_s(run, "graph.rerank")
