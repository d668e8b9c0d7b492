"""The program's spans on the device trace's clock, and the device's idle
time inside each of them, for the per-layer metrics ``*_idle_ms.*``.

While a torch.profiler session runs, the program's timeline
(``gdpathtracing_torch.utils.telemetry``, ``session()``) records its spans
``(name, thread, start ns, end ns)`` and stamps each hand-written kernel's
launch ``(kernel symbol, ns)`` just before it, on the host's
``time.time_ns()`` clock. The device trace gives its events in seconds
after the trace's start. The program's own ``clock_knots`` and
``to_trace`` (the placement ``Engine.profile`` uses) carry the spans onto
the trace's clock from the launches made on an idle card; the spans are
checked against the harness's synchronisations (:func:`steps_apart`) and
then go through the program's ``summarise``, the arithmetic of
``Engine.profile``.

A program without ``session()`` and ``clock_knots()``, a window without
stamps, with records dropped, with stamps that do not pair with the
trace's kernels, with no kernel started on an idle card, or whose spans
fail the check gives None: the run leaves the metrics out instead of
failing.
"""

from __future__ import annotations

import importlib

from benchmark import trace

MODULE = "gdpathtracing_torch.utils.telemetry"


def _busy_inside(a: int, b: int, busy) -> int:
    """The busy time of the sorted disjoint ``busy`` intervals
    (:func:`trace.union`'s) inside [a, b]."""
    return sum(max(0, min(b, y) - max(a, x)) for x, y, _, _ in busy
               if x < b and y > a)


def _ns(events) -> list[tuple[str, int, int]]:
    return [(n, round(a * 1e9), round(b * 1e9)) for n, a, b in events]


def steps_apart(records, events, outer_names) -> bool:
    """Whether the device shows an idle instant between every two steps:
    in each gap between the union of the outer spans' ``records`` (one
    interval a step; the harness synchronises after each), against the
    device ``events`` ``(name, start, end)`` on the same clock. False
    without such a gap, where there is nothing to check."""
    outer = trace.union([(n, a, b) for n, _, a, b in records
                         if n in outer_names])
    busy = trace.union(events)
    gaps = [(p[1], q[0]) for p, q in zip(outer, outer[1:])]
    return bool(gaps) and all(_busy_inside(a, b, busy) < b - a
                              for a, b in gaps)


def _session():
    """(the telemetry module, its last session), or (None, None) where the
    program has no ``session()`` or ``clock_knots()``."""
    try:
        mod = importlib.import_module(MODULE)
    except ImportError:
        return None, None
    if not all(hasattr(mod, f) for f in ("session", "clock_knots",
                                         "to_trace")):
        return None, None
    return mod, mod.session()


def idle_seconds(ctx) -> dict | None:
    """{leaf span: the device's idle seconds inside its own segments in
    the traced window, ``"unspanned"``: the window's idle seconds
    (``window_s - busy_s``, as ``idle_share``) less all of those}, or None
    (see the module's docstring). Kept in ``ctx`` for the next reader."""
    if "span_idle" not in ctx:
        ctx["span_idle"] = _idle_seconds(ctx)
    return ctx["span_idle"]


def _idle_seconds(ctx) -> dict | None:
    mod, ses = _session()
    events = ctx.get("events")
    if ses is None or ses.dropped or not ses.stamps or not events:
        return None
    ev = _ns(events)
    ks = mod.clock_knots(ev, ses.stamps)
    if ks is None:
        return None
    clock = mod.to_trace(ks)
    rec = [(n, tid, clock(a), clock(b)) for n, tid, a, b in ses.records]
    if not steps_apart(rec, ev, mod.OUTER_SPANS):
        return None
    counts: dict[str, tuple[float, int]] = {}
    for n, _, a, b in rec:  # host seconds and segments from the records
        sec, cnt = counts.get(n, (0.0, 0))
        counts[n] = (sec + (b - a) * 1e-9, cnt + 1)
    sm = mod.summarise(ev, rec, round(ctx["window_s"] * 1e9), counts,
                       ses.dropped, None)
    out = {n: sm.spans[n].idle_s for n in mod.LEAF_SPANS if n in sm.spans}
    out["unspanned"] = ctx["window_s"] - ctx["busy_s"] - sum(out.values())
    return out


def idle_ms(ctx, span: str) -> float | None:
    """The device's idle ms a unit of the window inside the leaf ``span``
    (or ``"unspanned"``), or None."""
    idle = idle_seconds(ctx)
    if idle is None:
        return None
    return 1e3 * idle.get(span, 0.0) / ctx["steps"]
