"""Host ms a step in the program's ``path_shade`` span: the standard
loop's shading, sky, emission, BRDF sample and next ray, which also build
the autograd graph."""

from benchmark import program_spans

COUNTERS = program_spans.counters("path_shade")


def read(ctx):
    return program_spans.ms_per_step(ctx, COUNTERS)
