"""The device's idle ms a step inside the program's ``trace_recompute``
span, in its own segments (a nested leaf's time not counted), on the
device trace's clock (span_clock.py): the part of
``recompute_ms.step``'s host time the card spends idle."""

from benchmark import span_clock


def read(ctx):
    return span_clock.idle_ms(ctx, "trace_recompute")
