"""The port's spans and counters, and the profiler view that places the
spans among the device's operations.

A span (``with SPANS.path_trace: ...``) adds the host wall time of its
block (two ``time.perf_counter_ns()`` reads) to ``seconds`` and one to
``count``: plain numbers, read by attribute path, e.g.
``gdpathtracing_torch.utils.telemetry:SPANS.regen_sync.seconds``. A span
never synchronises the device, launches a device operation or enters
``torch.profiler.record_function``, so a device trace sees nothing of it.

The leaf spans (``LEAF_SPANS``) say where the frame loop's host time goes.
On one thread they never overlap: a leaf entered inside another pauses the
outer one until it ends, so each leaf's seconds are its own. Together they
cover the outer spans ``engine_step`` and ``render_radiance``. The set-up
spans ``kernels_load`` and ``scene_build`` are leaves too, and so is
``trace_epilogue`` (ops/intersect.py ``lite_epilogue``) and so is
``trace_recompute`` (ops/intersect.py ``_diff_epilogue``, the
differentiable recompute of each winner's hit record): each pauses the
``path_trace`` it runs in.

While the timeline is on, each span also records ``(name, thread, start,
end)`` stamped with ``time.time_ns()``, the clock torch.profiler stamps
its events with, and each kernel wrapper stamps its launch ``(kernel
symbol, ns)`` just before it (:func:`launched`), at most ``TIMELINE_CAP``
of each. Nesting is tracked per thread: the backward pass may recompute a
checkpointed bounce on autograd's device thread. The timeline joins any
torch.profiler session by itself: the profiler's start turns it on,
emptied, and its stop turns it off (torch's ``_run_on_profiler_start``
and ``_run_on_profiler_stop`` are wrapped once, at import), so spans and
launches read one module flag and nothing else. :func:`session` reads the
last session's records and stamps; :func:`clock_knots` and
:func:`to_trace` carry them onto the device trace's clock, which need not
keep pace with ``time_ns()``. :class:`timeline` turns the timeline on for
a block whatever the profiler does.

``COUNTERS`` lists the program's counters by the same kind of path: each
kernel wrapper's ``.launches``, regen's ``.iterations``, the regen
iterations that shade in the torch body (``_shade_torch.iterations``) and
the lanes handed to the BVH traversal (``trace_bvh.lanes``).
"""
from __future__ import annotations

import bisect
import importlib
import json
import os
import re
import socket
import threading
from pathlib import Path
from time import perf_counter_ns, time_ns
from types import SimpleNamespace
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

LEAF_SPANS = ("render_prepare", "path_trace", "path_shade", "path_lanes",
              "regen_sync", "post_passes", "kernels_load", "scene_build",
              "trace_epilogue", "trace_recompute")
OUTER_SPANS = ("engine_step", "render_radiance")
TIMELINE_CAP = 1 << 20

COUNTERS = tuple(
    f"gdpathtracing_torch.{mod}:{fn}.launches" for mod, fn in (
        ("ops.intersect", "closest_hit_rows"), ("ops.intersect", "occluded"),
        ("ops.intersect", "closest_hit_rows_nee"),
        ("ops.intersect", "closest_hit_sc_lite"),
        ("ops.intersect", "closest_hit_rows_sc"),
        ("ops.intersect", "march_step_sc"),
        ("ops.intersect", "soft_occluded"),
        ("ops.intersect", "closest_hit_classic"),
        ("ops.intersect", "closest_hit_loop"),
        ("ops.megakernel", "mega_step"), ("ops.fused", "fused_paths"),
        ("render.traverse", "trace_bvh"), ("ops.shade", "regen_shade"),
        ("ops.shade", "regen_shade_lite"), ("ops.lanes", "regen_lane_key"),
        ("ops.lanes", "regen_lane_refill"), ("ops.shade", "path_shade_bvh"))
) + (
    "gdpathtracing_torch.render.regen:render_radiance_regen.iterations",
    "gdpathtracing_torch.render.regen:_shade_torch.iterations",
    "gdpathtracing_torch.render.traverse:trace_bvh.lanes")


def read(path: str):
    """The value at ``"module:attr.attr"``, a counter of ``COUNTERS`` or a
    span's ``seconds`` or ``count``."""
    mod, attr = path.split(":")
    obj = importlib.import_module(mod)
    for a in attr.split("."):
        obj = getattr(obj, a)
    return obj


class _State:
    """One thread's spans: the innermost open leaf (``cur``, -1 for none)
    and the start of its current segment (perf ns ``t0``; wall ns ``w0``,
    kept only while the timeline is on, 0 for none), the leaves it paused
    (``paused``), the (perf ns, wall ns) starts of the open outer spans
    (``outer``), and the nanoseconds and counts this thread added to each
    span. A thread writes only its own state, so no lock is taken."""

    __slots__ = ("tid", "cur", "t0", "w0", "paused", "outer", "ns", "count")

    def __init__(self, n: int):
        self.tid = threading.get_native_id()
        self.cur, self.t0, self.w0 = -1, 0, 0
        self.paused, self.outer = [], []
        self.ns, self.count = [0] * n, [0] * n


_NAMES = LEAF_SPANS + OUTER_SPANS
_states: list[_State] = []  # every thread's, appended once per thread


class _Local(threading.local):
    def __init__(self):
        self.st = _State(len(_NAMES))
        _states.append(self.st)


_local = _Local()
_on = False            # the timeline
_joined = False        # ... turned on by a profiler session
_records: list = []
_stamps: list = []
_dropped = 0


def _start() -> list:
    """Turn the timeline on, emptied; returns its records."""
    global _on, _records, _stamps, _dropped
    for st in _states:
        st.w0 = 0
    _records, _stamps, _dropped, _on = [], [], 0, True
    return _records


def _profiler_turned(on: bool) -> None:
    """A profiler session started (``on``) or stopped: join it, or leave
    the one joined; a :class:`timeline` block keeps the timeline as it
    is."""
    global _on, _joined
    if on and (_joined or not _on):
        _start()
        _joined = True
    elif not on and _joined:
        _on = _joined = False


def _hook(name: str, on: bool) -> None:
    fn = getattr(_autograd_profiler, name, None)
    if fn is None or getattr(fn, "joins_timeline", False):
        return

    def run(*args, **kwargs):
        out = fn(*args, **kwargs)
        _profiler_turned(on)
        return out
    run.joins_timeline = True
    setattr(_autograd_profiler, name, run)


_hook("_run_on_profiler_start", True)
_hook("_run_on_profiler_stop", False)


def _record(i: int, tid: int, w0: int, w1: int) -> None:
    global _dropped
    if len(_records) < TIMELINE_CAP:
        _records.append((_NAMES[i], tid, w0, w1))
    else:
        _dropped += 1


def _segment(st: _State, ended: int) -> None:
    """Timeline on: the segment of leaf ``ended`` (-1: none) ends now and
    the thread's next segment starts."""
    wall = time_ns()
    if ended >= 0 and st.w0:
        _record(ended, st.tid, st.w0, wall)
    st.w0 = wall


def launched(wrapper, symbol: str) -> None:
    """Count a launch of the kernel ``symbol`` (its name as the device
    trace shows it) in ``wrapper.launches``; called just before the
    launch. While the timeline is on, it also stamps ``(symbol,
    time_ns())``."""
    global _dropped
    wrapper.launches += 1
    if _on:
        if len(_stamps) < TIMELINE_CAP:
            _stamps.append((symbol, time_ns()))
        else:
            _dropped += 1


class Session(NamedTuple):
    """The timeline's last session (:func:`session`)."""
    records: list  # (span name, thread, start ns, end ns)
    stamps: list   # (kernel symbol, ns just before its launch)
    dropped: int   # records and stamps past TIMELINE_CAP, left out


def session() -> Session:
    """The records and stamps of the timeline's last session, the one
    running included: a profiler session's stay readable after it ends,
    until the next session starts."""
    return Session(_records, _stamps, _dropped)


class Span:
    """A leaf span (see the module's docstring)."""

    __slots__ = ("name", "i")

    def __init__(self, name: str):
        self.name, self.i = name, _NAMES.index(name)

    @property
    def seconds(self) -> float:
        return sum(st.ns[self.i] for st in _states) * 1e-9

    @property
    def count(self) -> int:
        return sum(st.count[self.i] for st in _states)

    def __enter__(self) -> None:
        now = perf_counter_ns()
        st = _local.st
        cur = st.cur
        if cur >= 0:  # pause the enclosing leaf
            st.ns[cur] += now - st.t0
        st.paused.append(cur)
        st.cur = self.i
        st.t0 = now
        if _on:
            _segment(st, cur)

    def __exit__(self, exc_type, exc, tb) -> None:
        now = perf_counter_ns()
        st = _local.st
        i = self.i
        st.ns[i] += now - st.t0
        st.count[i] += 1
        st.cur = st.paused.pop()  # resume the enclosing leaf
        st.t0 = now
        if _on:
            _segment(st, i)


class OuterSpan(Span):
    """An outer span: it holds leaves and pauses none."""

    __slots__ = ()

    def __enter__(self) -> None:
        _local.st.outer.append((perf_counter_ns(), time_ns() if _on else 0))

    def __exit__(self, exc_type, exc, tb) -> None:
        now = perf_counter_ns()
        st = _local.st
        t0, w0 = st.outer.pop()
        st.ns[self.i] += now - t0
        st.count[self.i] += 1
        if _on and w0:
            _record(self.i, st.tid, w0, time_ns())


SPANS = SimpleNamespace(**{n: Span(n) for n in LEAF_SPANS},
                        **{n: OuterSpan(n) for n in OUTER_SPANS})


class timeline:
    """``with timeline() as records:`` turns the timeline on, emptied, for
    the block, whatever the profiler does; ``records`` is the list of
    ``(name, thread, start ns, end ns)`` the spans append to. A segment
    open when it starts is left out."""

    def __enter__(self) -> list:
        global _joined
        _joined = False
        return _start()

    def __exit__(self, *exc) -> bool:
        global _on
        _on = False
        return False


# ---------------------------------------------------------------------------
# The profiler view: spans on the device trace's clock
# ---------------------------------------------------------------------------

def _union(iv) -> list[tuple[int, int]]:
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _intersect(a, b) -> list[tuple[int, int]]:
    """The intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if lo < hi:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _length(iv) -> int:
    return sum(b - a for a, b in iv)


class SpanTime(NamedTuple):
    host_s: float  # the span's seconds in the profiled block
    count: int     # the span's count in the profiled block
    idle_s: float  # the device's idle seconds inside the span's intervals


class ProfileSummary(NamedTuple):
    """What :class:`Profile` saw; times on the device trace's clock."""
    window_s: float        # the profiled block's wall time
    busy_s: float          # the union of the device operations' intervals
    ops: int               # device operations (kernels, copies, fills)
    op_s: dict             # device seconds by operation name
    spans: dict            # span name -> SpanTime, for each span that ran
    leaf_idle_share: float  # of the device's idle time inside the outer
    #                         spans, the share inside leaf spans (nan
    #                         without an outer span or idle time)
    dropped: int           # span records past TIMELINE_CAP, left out
    trace: str | None      # the trace file written, if any


def summarise(events, records, window_ns: int, counts: dict, dropped: int,
              trace: str | None) -> ProfileSummary:
    """A :class:`ProfileSummary` of device ``events`` ``(name, start ns,
    end ns)`` and span ``records`` (the timeline's) on one clock; ``counts``
    maps a span's name to its (seconds, count) in the block."""
    busy = _union((a, b) for _, a, b in events)
    op_s = {}
    for name, a, b in events:
        op_s[name] = op_s.get(name, 0.0) + (b - a) * 1e-9
    by_span = {}
    for name, _, a, b in records:
        by_span.setdefault(name, []).append((a, b))

    def idle(iv):
        return _length(iv) - _length(_intersect(iv, busy))

    spans = {}
    for name, (sec, cnt) in counts.items():
        iv = _union(by_span.get(name, []))
        spans[name] = SpanTime(sec, cnt, idle(iv) * 1e-9)
    outer = _union(iv for n in OUTER_SPANS for iv in by_span.get(n, []))
    leaves = _intersect(_union(iv for n in LEAF_SPANS
                               for iv in by_span.get(n, [])), outer)
    idle_outer = idle(outer)
    return ProfileSummary(
        window_s=window_ns * 1e-9, busy_s=_length(busy) * 1e-9,
        ops=len(events), op_s=op_s, spans=spans,
        leaf_idle_share=idle(leaves) / idle_outer if idle_outer
        else float("nan"), dropped=dropped, trace=trace)


# The trace's clock. A launch's stamp precedes its kernel's start by the
# launch-to-start lag (10-60 us on an H100 when the card is idle), and by
# the kernel's wait in the stream's queue when the card is busy. Under the
# profiler a launch call is now and then much slower (ms), and the trace's
# clock runs apart from time_ns() by up to ms within a profiled second.
LAUNCH_GAP_NS = 5_000    # least idle time before a kernel launched on an
#                          idle card: its own lag is at least that
LAG_SPREAD_NS = 50_000   # spread of the lags of launches on an idle card
NEIGHBOURS = 3           # launches on each side a slow launch is set against


def launch_pairs(events, stamps) -> list[tuple[int, int]] | None:
    """(stamp ns, its kernel's start ns), a pair a launch, by stamp, from
    device ``events`` ``(name, start ns, end ns)`` and launch ``stamps``
    ``(symbol, ns)``; None where a stamped symbol has another number of
    events than of stamps (a launch the trace lost, or one made before
    the timeline joined the session, would pair every later stamp with
    the wrong launch).

    The k-th stamp of a symbol pairs with the k-th event, by start, whose
    name holds the symbol as a whole word (``occlusion_kernel`` is not
    ``soft_occlusion_kernel``)."""
    by_sym: dict[str, list[int]] = {}
    for sym, t in stamps:
        by_sym.setdefault(sym, []).append(t)
    names = {e[0] for e in events}
    out = []
    for sym, ts in by_sym.items():
        pat = re.compile(rf"(?<![A-Za-z0-9_]){re.escape(sym)}"
                         rf"(?![A-Za-z0-9_])")
        hit = {n for n in names if pat.search(n)}
        starts = sorted(a for n, a, _ in events if n in hit)
        if len(starts) != len(ts):
            return None
        out += zip(sorted(ts), starts)
    return sorted(out)


def idle_launches(events, stamps) -> list[tuple[int, int]] | None:
    """``(stamp ns, stamp - kernel start)`` of each :func:`launch_pairs`
    pair whose kernel could have been launched on an idle card, by stamp;
    None where the stamps do not pair.

    Each pair bounds the trace clock's offset from the stamps' from below,
    by the launch's lag. A kernel that starts less than ``LAUNCH_GAP_NS``
    after the card's previous work ended waited in the stream's queue,
    which adds its wait to the lag; a kernel launched on an idle card
    starts at least its own lag after the card's last work."""
    ps = launch_pairs(events, stamps)
    if ps is None:
        return None
    ev = sorted((a, b) for _, a, b in events)
    starts, reach = [a for a, _ in ev], []
    for _, b in ev:  # the latest end of the work started so far
        reach.append(max(b, reach[-1]) if reach else b)

    def idle_before(e: int) -> bool:
        i = bisect.bisect_left(starts, e)
        return i == 0 or e - reach[i - 1] >= LAUNCH_GAP_NS
    return [(s, s - e) for s, e in ps if idle_before(e)]


def clock_knots(events, stamps) -> list[tuple[int, int]] | None:
    """The trace clock's offset from the stamps' along the session:
    ``(stamp ns, stamp - kernel start)`` at the launches that bound it,
    by stamp; None without one. ``events`` and ``stamps`` as
    :func:`launch_pairs`'.

    Of the :func:`idle_launches`, a knot is each but a slow launch: one
    whose bound the best of its ``NEIGHBOURS`` on its left and the best of
    those on its right both beat by more than ``LAG_SPREAD_NS``. A clock
    that runs apart moves the bounds on one side with it, so the knots
    follow it at any rate; a slow launch drops below both sides and is
    left out. The first and the last launch, with one side, are knots."""
    cand = idle_launches(events, stamps)
    if not cand:
        return None
    o = [x for _, x in cand]
    k = NEIGHBOURS
    out = []
    for i, (s, x) in enumerate(cand):
        left, right = o[max(0, i - k):i], o[i + 1:i + 1 + k]
        if not (left and right) \
                or x >= min(max(left), max(right)) - LAG_SPREAD_NS:
            out.append((s, x))
    return out


def to_trace(knots):
    """A function of a stamp-clock ns giving its time on the trace's
    clock: less the offset interpolated between the ``knots`` (held
    before the first and after the last)."""
    at = [s for s, _ in knots]

    def fn(t: int) -> int:
        i = bisect.bisect(at, t)
        if i == 0 or i == len(knots):
            return t - knots[min(i, len(knots) - 1)][1]
        (s0, o0), (s1, o1) = knots[i - 1], knots[i]
        return t - o0 - (o1 - o0) * (t - s0) // (s1 - s0)
    return fn


def _write_trace(prof, records, logdir: Path) -> str:
    """Export the profiler's chrome trace into ``logdir`` (named as
    ``torch.profiler.tensorboard_trace_handler`` names it) with the spans
    added as complete events of category ``program_span``."""
    logdir.mkdir(parents=True, exist_ok=True)
    path = logdir / (f"{socket.gethostname()}_{os.getpid()}."
                     f"{time_ns()}.pt.trace.json")
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    doc["traceEvents"].extend(
        {"ph": "X", "cat": "program_span", "name": name, "pid": pid,
         "tid": tid, "ts": (a - base) / 1e3, "dur": (b - a) / 1e3}
        for name, tid, a, b in records)
    path.write_text(json.dumps(doc))
    return str(path)


class Profile:
    """torch.profiler around a block of the frame loop, with the program's
    spans on the device trace's clock: ``with Profile(device, logdir) as
    p: ...``, then ``p.summary`` (a :class:`ProfileSummary`). The profiler
    records device activity only on the card (a host op's record costs
    more than the op), host activity on the CPU, where the CPU's operations
    stand for the device's. The timeline joins the profiler's session.
    With ``logdir`` the trace, spans included, is written there.
    Afterwards ``p.session`` is the timeline's :class:`Session`,
    ``p.trace_start_ns`` the trace's start as the profiler gives it,
    ``p.events`` the device operations ``(name, start ns, end ns)``
    after it, ``p.knots`` the :func:`clock_knots` of the launch stamps,
    which place the spans among them (None where none pair: then the
    trace's start alone places them, as on the CPU)."""

    def __init__(self, device, logdir=None):
        self.cuda = torch.device(device).type == "cuda"
        self.logdir = None if logdir is None else Path(logdir)
        self.summary: ProfileSummary | None = None

    def __enter__(self):
        act = torch.profiler.ProfilerActivity
        self._prof = torch.profiler.profile(
            activities=[act.CUDA if self.cuda else act.CPU],
            on_trace_ready=self._ready)
        self._before = {n: (s.seconds, s.count)
                        for n, s in vars(SPANS).items()}
        self._prof.__enter__()
        self._t0 = time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self._t1 = time_ns()
        self._prof.__exit__(*exc)
        return False

    def _ready(self, prof) -> None:
        # The events' times are microseconds after the trace's start.
        self.session = session()
        start = self.trace_start_ns = \
            prof.profiler.kineto_results.trace_start_ns()
        kind = torch.autograd.DeviceType.CUDA if self.cuda \
            else torch.autograd.DeviceType.CPU
        self.events = events = [
            (e.name, start + round(e.time_range.start * 1e3),
             start + round(e.time_range.end * 1e3))
            for e in prof.events() if e.device_type == kind]
        counts = {}
        for n, s in vars(SPANS).items():
            sec = s.seconds - self._before[n][0]
            cnt = s.count - self._before[n][1]
            if cnt:
                counts[n] = (sec, cnt)
        records = self.session.records
        self.knots = clock_knots(events, self.session.stamps)
        if self.knots is not None:
            clock = to_trace(self.knots)
            records = [(n, t, clock(a), clock(b)) for n, t, a, b in records]
        path = None if self.logdir is None \
            else _write_trace(prof, records, self.logdir)
        self.summary = summarise(events, records, self._t1 - self._t0,
                                 counts, self.session.dropped, path)
