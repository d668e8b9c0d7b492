"""Host ms a frame in the program's ``path_shade`` span: shading, sky,
emission, the BRDF sample and the next ray of each regen iteration."""

from benchmark import program_spans

COUNTERS = program_spans.counters("path_shade")


def read(ctx):
    return program_spans.ms_per_step(ctx, COUNTERS)
