"""Host ms a frame in the program's ``path_trace`` span: the traversal
calls of the regen loop, wrapper glue and launch (kernel 1 on the demo)."""

from benchmark import program_spans

COUNTERS = program_spans.counters("path_trace")


def read(ctx):
    return program_spans.ms_per_step(ctx, COUNTERS)
