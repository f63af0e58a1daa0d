"""solve.host_wait_s: host seconds a fit blocked in the frontier loop's one
sync a sweep, the program's ``solve.host_wait_ns`` counter."""

from portbench import program_spans

program_spans.start()


def read(run):
    ns = program_spans.counter(run, "solve.host_wait_ns")
    return None if ns is None else ns / 1e9
