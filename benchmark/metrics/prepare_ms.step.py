"""Host ms a step in the program's ``render_prepare`` span: the standard
loop's ``prepare_trace_inputs`` and light tables."""

from benchmark import program_spans

COUNTERS = program_spans.counters("render_prepare")


def read(ctx):
    return program_spans.ms_per_step(ctx, COUNTERS)
