"""The device's idle ms a step inside the program's ``path_trace`` span,
in its own segments (a nested leaf's time not counted), on the device
trace's clock (span_clock.py): the part of ``trace_call_ms.step``'s host
time the card spends idle."""

from benchmark import span_clock


def read(ctx):
    return span_clock.idle_ms(ctx, "path_trace")
