"""Millions of lanes a frame handed to the BVH traversal
(render/traverse.py ``trace_bvh``), live or not: the change of the
program's counter ``trace_bvh.lanes`` over the traced window. The
standard loop hands every lane of every tile to each bounce's traversal,
so at 1080p and 5 bounces this reads 5 x 2,073,600 / 1e6. A program
without the counter gives no counter path, and the metric reads None."""

from benchmark import harness

PATH = "gdpathtracing_torch.render.traverse:trace_bvh.lanes"


def _resolves(path: str) -> bool:
    try:
        harness._counter(path)
    except (ImportError, AttributeError):
        return False
    return True


COUNTERS = [PATH] if _resolves(PATH) else []


def read(ctx):
    if not COUNTERS:
        return None
    return ctx["counters"][PATH] / 1e6 / ctx["steps"]
