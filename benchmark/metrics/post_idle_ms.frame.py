"""The device's idle ms a frame inside the program's ``post_passes``
span, in its own segments (a nested leaf's time not counted), on the
device trace's clock (span_clock.py): the part of ``post_ms.frame``'s
host time the card spends idle."""

from benchmark import span_clock


def read(ctx):
    return span_clock.idle_ms(ctx, "post_passes")
