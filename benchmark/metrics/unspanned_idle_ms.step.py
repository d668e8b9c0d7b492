"""The device's idle ms a step outside every leaf span of the program:
the traced window's idle time (``window_s - busy_s``, as ``idle_share``)
less the idle time inside the leaf spans (span_clock.py). The loss,
autograd's backward and the Adam step, outside ``render_radiance``."""

from benchmark import span_clock


def read(ctx):
    return span_clock.idle_ms(ctx, "unspanned")
