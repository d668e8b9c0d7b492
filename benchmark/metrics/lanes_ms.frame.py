"""Host ms a frame in the program's ``path_lanes`` span: regen's lane
stacks, sort key and argsort, gathers, log append, refill and the final
log indexing and sample reduction."""

from benchmark import program_spans

COUNTERS = program_spans.counters("path_lanes")


def read(ctx):
    return program_spans.ms_per_step(ctx, COUNTERS)
