"""Host ms a step in the program's ``path_lanes`` span: the standard
loop's tile rays, group compaction, unsort and the tiles' cat."""

from benchmark import program_spans

COUNTERS = program_spans.counters("path_lanes")


def read(ctx):
    return program_spans.ms_per_step(ctx, COUNTERS)
