"""Host ms a frame in the program's ``trace_epilogue`` span: ops/intersect.py
``lite_epilogue``, the recompute of u, v and w_d from the winners of the
lite kernel (kernel 3 on the grid). A program without the span gives no
counter path, and the metric reads None."""

from benchmark import harness, program_spans


def _resolves(path: str) -> bool:
    try:
        harness._counter(path)
    except (ImportError, AttributeError):
        return False
    return True


COUNTERS = [p for p in program_spans.counters("trace_epilogue")
            if _resolves(p)]


def read(ctx):
    return program_spans.ms_per_step(ctx, COUNTERS)
