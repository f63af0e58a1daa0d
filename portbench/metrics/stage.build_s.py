"""stage.build_s: host seconds a fit in the program's ``stage.build`` span,
the host snapshot of the batch (``build_host_problem``) and its frontier."""

from portbench import program_spans

program_spans.start()


def read(run):
    return program_spans.span_s(run, "stage.build")
