"""Host ms a step in the program's ``trace_recompute`` span: ops/intersect.py
``_diff_epilogue``, the differentiable recompute of t, u and v of each
winner the no-grad finder chose, from the live triangle table (one
``isect_cols`` row gather and its dots; autograd's graph for them). A
program without the span gives no counter path, and the metric reads
None."""

from benchmark import harness, program_spans


def _resolves(path: str) -> bool:
    try:
        harness._counter(path)
    except (ImportError, AttributeError):
        return False
    return True


COUNTERS = [p for p in program_spans.counters("trace_recompute")
            if _resolves(p)]


def read(ctx):
    return program_spans.ms_per_step(ctx, COUNTERS)
