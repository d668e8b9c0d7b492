"""Host ms a frame in the program's ``render_prepare`` span: regen's
``prepare_trace_inputs`` (kernel operands, light and trace tables)."""

from benchmark import program_spans

COUNTERS = program_spans.counters("render_prepare")


def read(ctx):
    return program_spans.ms_per_step(ctx, COUNTERS)
