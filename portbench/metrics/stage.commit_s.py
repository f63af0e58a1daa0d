"""stage.commit_s: host seconds a fit in the program's ``stage.commit`` span,
the snapshot's copies into the rung's device buffers and the frontier's."""

from portbench import program_spans

program_spans.start()


def read(run):
    return program_spans.span_s(run, "stage.commit")
