"""Host ms a frame in the program's ``post_passes`` span: the
progressive update and the display transform after the frame's trace."""

from benchmark import program_spans

COUNTERS = program_spans.counters("post_passes")


def read(ctx):
    return program_spans.ms_per_step(ctx, COUNTERS)
