"""Regen iterations a frame that shade in the torch body (render/regen.py
``_shade_torch``) rather than in the ``regen_shade`` kernel: the change of
the program's counter ``_shade_torch.iterations`` over the traced window.
A program without the counter gives no counter path, and the metric reads
None."""

from benchmark import harness

PATH = "gdpathtracing_torch.render.regen:_shade_torch.iterations"


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
    return ctx["counters"][PATH] / ctx["steps"]
