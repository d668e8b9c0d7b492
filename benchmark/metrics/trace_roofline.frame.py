"""Share of the ray-tracing kernels' roofline, in %: the least time one
card needs for the traversal work the window traced, counted by the
benchmark's own reference BVH, over the device time of the kernels that
``benchmark/kernels/`` lists. No number where none of them ran."""

from benchmark import trace


def read(ctx):
    den = trace.kernel_seconds(ctx["events"], ctx["kernels"])
    if den <= 0.0:
        return None
    return 100.0 * ctx["ref_least_s"] * ctx["steps"] / den
