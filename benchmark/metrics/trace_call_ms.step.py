"""Host ms a step in the program's ``path_trace`` span: the standard
loop's traversal calls, the no-grad finder (kernel 1) and the
differentiable recompute epilogue."""

from benchmark import program_spans

COUNTERS = program_spans.counters("path_trace")


def read(ctx):
    return program_spans.ms_per_step(ctx, COUNTERS)
