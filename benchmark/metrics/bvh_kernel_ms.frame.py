"""Device ms a frame of the BVH traversal kernel (csrc/trace_bvh.cu,
``trace_bvh_kernel``): its events' time in the traced window over the
window's frames. None where the kernel did not run."""

from benchmark import trace


def read(ctx):
    s = trace.kernel_seconds(ctx["events"], ["trace_bvh_kernel"])
    if s <= 0.0:
        return None
    return s * 1e3 / ctx["steps"]
