"""Readers of the program's own spans (``gdpathtracing_torch.utils.
telemetry``) for the per-layer metrics in ``metrics/``.

A program without the telemetry module gives no counter paths, and its
metrics read None: the run leaves them out instead of failing.
"""

from __future__ import annotations

import importlib
import importlib.util

MODULE = "gdpathtracing_torch.utils.telemetry"


def _has_telemetry() -> bool:
    try:
        return importlib.util.find_spec(MODULE) is not None
    except ModuleNotFoundError:  # no program at all
        return False


def counters(span: str) -> list[str]:
    """The counter path of ``span``'s cumulative seconds, for a metric's
    ``COUNTERS``; empty where the program has no telemetry module."""
    return [f"{MODULE}:SPANS.{span}.seconds"] if _has_telemetry() else []


def ms_per_step(ctx, paths: list[str]) -> float | None:
    """Host milliseconds a unit of the window inside the span of
    ``paths`` (its :func:`counters`): the change of its seconds over the
    traced window over the window's steps. The traced window runs under
    the profiler, whose cost a launch lands in the span that launches,
    so these read above an untraced frame's share."""
    if not paths:
        return None
    return 1e3 * ctx["counters"][paths[0]] / ctx["steps"]


def setup_seconds(span: str) -> float | None:
    """The span's cumulative seconds in this process: its set-up time,
    which ends before the window opens."""
    if not _has_telemetry():
        return None
    return getattr(importlib.import_module(MODULE).SPANS, span).seconds
