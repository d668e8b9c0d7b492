"""Host ms a frame in the program's ``regen_sync`` span: the host
blocked on the device at each regen iteration's ``.tolist()`` of the lane
counts."""

from benchmark import program_spans

COUNTERS = program_spans.counters("regen_sync")


def read(ctx):
    return program_spans.ms_per_step(ctx, COUNTERS)
