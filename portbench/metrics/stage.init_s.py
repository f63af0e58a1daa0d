"""stage.init_s: host seconds a fit in the program's ``stage.init`` span, the
supernode initialization (G' components, ``supernode_init`` and its read
back)."""

from portbench import program_spans

program_spans.start()


def read(run):
    return program_spans.span_s(run, "stage.init")
