"""The port's spans and counters (gdpathtracing_torch/utils/telemetry.py):
the leaf spans cover the frame loop without overlapping, they change
nothing the program computes, they launch nothing a profiler records,
they sit on the profiler's clock, per-thread accounting loses nothing, and
every counter path the benchmark reads resolves."""

from __future__ import annotations

import json
import re
import sys
import threading
from pathlib import Path
from time import time_ns
from types import SimpleNamespace

import pytest
import torch

from gdpathtracing_torch import Engine, RenderConfig, Traversal
from gdpathtracing_torch.diff import inverse
from gdpathtracing_torch.render.renderer import render_radiance
from gdpathtracing_torch.scene.demo import (build_demo_scene,
                                            build_sphere_grid, demo_camera,
                                            grid_camera)
from gdpathtracing_torch.utils import telemetry
from gdpathtracing_torch.utils.telemetry import (LEAF_SPANS, OUTER_SPANS,
                                                 SPANS, Profile)

REPO = Path(__file__).resolve().parents[1]
PALLAS = RenderConfig(traversal=Traversal.PALLAS, bounces=3, spp=1)


@pytest.fixture(scope="module")
def scene():
    return build_demo_scene(device="cpu")


@pytest.fixture(scope="module")
def mid_grid():
    """The mid sphere grid: a superchunk scene on kernel 3's lite path."""
    return build_sphere_grid(n=4, sphere_detail=12, device="cpu")


def _engine_frame(scene, config=PALLAS):
    eng = Engine(scene, config)
    eng.step(demo_camera(8, 8))  # regen, the default PALLAS frame loop
    return eng.step(demo_camera(8, 8))


# Regen with NEE: kernel 2 after shading, or kernel 4 and the late fold.
NEE = {"nee": PALLAS.replace(nee=True),
       "fused_nee": PALLAS.replace(nee=True, regen_fuse_nee=True)}


def _diff_render(scene, camera=None, config=PALLAS):
    albedo = scene.mat_albedo.clone().requires_grad_(True)
    rad = render_radiance(inverse.replace_albedo(scene, albedo),
                          camera or demo_camera(16, 12),
                          config.replace(differentiable=True), 3).radiance
    return rad, albedo


def _leaves_by_thread(records):
    out = {}
    for name, tid, a, b in records:
        if name in LEAF_SPANS:
            out.setdefault(tid, []).append((a, b))
    return out


@pytest.mark.parametrize("case", ["engine_step", "engine_step_nee",
                                  "engine_step_fused_nee", "render_radiance",
                                  "render_radiance_grid"])
def test_leaf_spans_cover_the_loop_without_overlap(scene, mid_grid, case):
    """An 8x8 Engine.step through regen (without NEE, with it, with it
    fused), and a differentiable 16x12 render_radiance through the
    standard loop, on the demo and on the mid grid (kernel 3 as finder,
    ``lite_epilogue``, then the recompute)."""
    if case == "render_radiance":
        def run():
            _diff_render(scene)
    elif case == "render_radiance_grid":
        def run():
            _diff_render(mid_grid, grid_camera(16, 12, n=4))
        case = "render_radiance"
    else:
        config = NEE.get(case.removeprefix("engine_step_"), PALLAS)

        def run():
            _engine_frame(scene, config)
        case = "engine_step"
    with telemetry.timeline() as records:
        run()
    for iv in _leaves_by_thread(records).values():
        iv.sort()
        assert all(b0 <= a1 for (_, b0), (a1, _) in zip(iv, iv[1:]))
    last = [r for r in records if r[0] == case][-1]
    inside = sum(min(b, last[3]) - max(a, last[2])
                 for name, tid, a, b in records
                 if name in LEAF_SPANS and tid == last[1]
                 and a < last[3] and b > last[2])
    assert 0.8 <= inside / (last[3] - last[2]) <= 1.0


@pytest.mark.parametrize("nee", list(NEE))
def test_regen_traversal_calls_lie_in_path_trace(scene, monkeypatch, nee):
    """Every traversal call of a regen NEE frame (the closest hit, kernel 2
    or kernel 4) runs inside one ``path_trace`` segment, whichever span
    makes it."""
    from gdpathtracing_torch.render import regen

    calls = []

    def watched(fn, name):
        def call(*args, **kwargs):
            t0 = time_ns()
            out = fn(*args, **kwargs)
            calls.append((name, threading.get_native_id(), t0, time_ns()))
            return out
        return call

    get_trace_fn = regen.get_trace_fn
    monkeypatch.setattr(regen, "get_trace_fn", lambda config: watched(
        get_trace_fn(config), "trace"))
    for name in ("occluded_pallas", "trace_occlude_pallas"):
        monkeypatch.setattr(regen, name, watched(getattr(regen, name), name))
    with telemetry.timeline() as records:
        _engine_frame(scene, NEE[nee])
    kernel = "trace_occlude_pallas" if nee == "fused_nee" \
        else "occluded_pallas"
    assert any(c[0] == kernel for c in calls)
    traced = [r for r in records if r[0] == "path_trace"]
    for name, tid, t0, t1 in calls:
        assert any(r[1] == tid and r[2] <= t0 and t1 <= r[3]
                   for r in traced), name


@pytest.mark.parametrize("what", ["frame", "gradient", "frame_joined"])
def test_timeline_changes_nothing(scene, what):
    """A frame and a gradient with the timeline on, and a frame whose
    timeline joined a profiler session, equal those with it off."""
    def run():
        if what != "gradient":
            return _engine_frame(scene)
        rad, albedo = _diff_render(scene)
        (g,) = torch.autograd.grad(rad.square().mean(), [albedo])
        return torch.cat([rad.flatten(), g.flatten()])

    off = run()
    if what == "frame_joined":
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            on = run()
        assert any(r[0] == "engine_step" for r in telemetry.session().records)
    else:
        with telemetry.timeline():
            on = run()
    assert torch.equal(off, on)


# The callers of ops/intersect.py lite_epilogue on the mid grid: the lite
# dispatch of trace_pallas (regen, the standard loop) and regen's march.
# Regen with NEE: its grid iterations trace through trace_pallas and its
# epilogue (without NEE, regen_shade_lite takes kernel 3's raw winners).
GRID_LOOPS = {"regen": PALLAS.replace(nee=True),
              "standard": PALLAS.replace(regen=False),
              "march": PALLAS.replace(regen_march=True)}


@pytest.mark.parametrize("loop", list(GRID_LOOPS))
def test_trace_epilogue_pauses_path_trace(mid_grid, loop):
    """An 8x8 Engine.step on the mid grid: each ``lite_epilogue`` call
    adds to ``trace_epilogue``, whose segments never overlap those of
    ``path_trace``, the span it runs in."""
    eng = Engine(mid_grid, GRID_LOOPS[loop])
    before = SPANS.trace_epilogue.seconds, SPANS.trace_epilogue.count
    with telemetry.timeline() as records:
        eng.step(grid_camera(8, 8, n=4))
    assert SPANS.trace_epilogue.seconds > before[0]
    assert SPANS.trace_epilogue.count > before[1]
    epi = [r for r in records if r[0] == "trace_epilogue"]
    trace = [r for r in records if r[0] == "path_trace"]
    assert epi and trace
    for _, tid, a, b in epi:
        assert not any(t == tid and a < b1 and a1 < b
                       for _, t, a1, b1 in trace)
        # ... and each lies between two segments of its path_trace.
        assert any(t == tid and b1 == a for _, t, _, b1 in trace)
        assert any(t == tid and a1 == b for _, t, a1, _ in trace)


# The differentiable standard loop's finders: kernel 1 (trace_pallas_diff)
# and kernel 4 (trace_occlude_pallas_diff, NEE on a flat scene) on the
# demo, kernel 3 and lite_epilogue (trace_pallas_diff) on the mid grid.
RECOMPUTE = {"demo": ("trace_pallas_diff", PALLAS),
             "demo_nee": ("trace_occlude_pallas_diff",
                          PALLAS.replace(nee=True)),
             "grid": ("trace_pallas_diff", PALLAS)}


@pytest.mark.parametrize("where", list(RECOMPUTE))
def test_trace_recompute_pauses_path_trace(scene, mid_grid, monkeypatch,
                                           where):
    """A differentiable 16x12 render_radiance: ``trace_recompute`` counts
    one recompute for each call of the differentiable finder, and its
    segments lie between two of the ``path_trace`` it runs in."""
    from gdpathtracing_torch.render import integrator

    name, config = RECOMPUTE[where]
    calls = []
    real = getattr(integrator, name)

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    monkeypatch.setattr(integrator, name, counted)
    sc, cam = (mid_grid, grid_camera(16, 12, n=4)) if where == "grid" \
        else (scene, demo_camera(16, 12))
    before = SPANS.trace_recompute.seconds, SPANS.trace_recompute.count
    with telemetry.timeline() as records:
        _diff_render(sc, cam, config)
    assert calls
    assert SPANS.trace_recompute.count - before[1] == len(calls)
    assert SPANS.trace_recompute.seconds > before[0]
    rec = [r for r in records if r[0] == "trace_recompute"]
    trace = [r for r in records if r[0] == "path_trace"]
    assert len(rec) == len(calls) and trace
    for _, tid, a, b in rec:
        assert not any(t == tid and a < b1 and a1 < b
                       for _, t, a1, b1 in trace)
        assert any(t == tid and b1 == a for _, t, _, b1 in trace)
        assert any(t == tid and a1 == b for _, t, a1, _ in trace)


@pytest.mark.parametrize("where", ["demo", "grid"])
def test_torch_shade_counter_follows_regen_iterations(scene, mid_grid,
                                                      where):
    """With NEE every regen iteration shades in the torch body; without
    it every iteration shades in a kernel's entry (its plain version here,
    as on the card the kernel), so the counter stays put, on a flat scene
    and on a superchunk one alike."""
    from gdpathtracing_torch.render import regen

    sc, cam = (scene, demo_camera(8, 8)) if where == "demo" \
        else (mid_grid, grid_camera(8, 8, n=4))
    for cfg, follows in ((PALLAS.replace(nee=True), True), (PALLAS, False)):
        before = regen._shade_torch.iterations, \
            regen.render_radiance_regen.iterations
        Engine(sc, cfg).step(cam)
        rise = regen.render_radiance_regen.iterations - before[1]
        assert rise > 0
        assert regen._shade_torch.iterations - before[0] == \
            (rise if follows else 0)


IDLE_READERS = [f"{m}_idle_ms.frame" for m in (
    "prepare", "trace_call", "shade", "lanes", "post", "unspanned")] + [
    f"{m}_idle_ms.step" for m in (
        "trace_call", "shade", "lanes", "recompute", "unspanned")]


@pytest.mark.parametrize("metric", ["epilogue_ms.frame",
                                    "torch_shade_iterations.frame",
                                    "recompute_ms.step", "epilogue_ms.step",
                                    *IDLE_READERS])
def test_new_readers_read_none_without_their_source(monkeypatch, metric):
    """The readers of the spans ``trace_epilogue`` and ``trace_recompute``
    and of the counter ``_shade_torch.iterations`` give no counter path
    and read None on a program that lacks them, and the readers of the
    device's idle time inside the spans read a number from a session and
    None on a program without ``session()``, as the benchmark's runs of an
    older program need."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    from benchmark import harness
    from gdpathtracing_torch.render import regen

    path = REPO / "benchmark" / "metrics" / f"{metric}.py"
    if metric in IDLE_READERS:
        ses, ctx = _window()
        monkeypatch.setattr(telemetry, "session", lambda: ses)
        assert harness.load_module(path).read(dict(ctx)) >= 0.0
        monkeypatch.delattr(telemetry, "session")
        assert harness.load_module(path).read(dict(ctx)) is None
        return
    assert harness.load_module(path).COUNTERS
    monkeypatch.setattr(telemetry, "SPANS", SimpleNamespace(**{
        n: s for n, s in vars(SPANS).items()
        if n not in ("trace_epilogue", "trace_recompute")}))
    monkeypatch.delattr(regen._shade_torch, "iterations")
    mod = harness.load_module(path)
    assert mod.COUNTERS == []
    assert mod.read({"counters": {}, "steps": 6}) is None


@pytest.mark.parametrize("timeline", [False, True], ids=["off", "on"])
def test_spans_record_nothing_in_a_profiler(timeline):
    def spans():
        for _ in range(100):
            with SPANS.engine_step, SPANS.path_shade, SPANS.path_trace:
                pass

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        if timeline:
            with telemetry.timeline():
                spans()
        else:
            spans()
    assert not [e.name for e in prof.events() if e.name.startswith("aten")]
    assert not [e for e in prof.events()
                if any(n in e.name for n in LEAF_SPANS + OUTER_SPANS)]


def test_aten_ops_lie_inside_their_span_on_the_profilers_clock(tmp_path):
    x = torch.randn(192, 192)
    with Profile("cpu", tmp_path) as prof:
        for _ in range(3):
            with SPANS.path_shade:
                y = x @ x
            with SPANS.path_lanes:
                y = torch.argsort(y.flatten())
    doc = json.loads(Path(prof.summary.trace).read_text())
    spans = [e for e in doc["traceEvents"]
             if e.get("cat") == "program_span"]
    ops = [e for e in doc["traceEvents"] if e.get("cat") == "cpu_op"
           and e["name"] in ("aten::mm", "aten::argsort")]
    assert len(ops) == 6 and len(spans) == 6
    for op in ops:
        owner = "path_shade" if op["name"] == "aten::mm" else "path_lanes"
        assert any(s["name"] == owner and s["ts"] <= op["ts"]
                   and op["ts"] + op["dur"] <= s["ts"] + s["dur"]
                   for s in spans), op
    sm = prof.summary.spans
    assert sm["path_shade"].count == 3 and sm["path_lanes"].count == 3
    assert 0.0 <= sm["path_shade"].idle_s < sm["path_shade"].host_s


def test_threads_keep_their_own_spans():
    """More threads than cores, a short switch interval: every span is
    counted once, each thread's leaves nest and pause, never overlap, and
    every launch stamp is kept."""
    n_threads, n = 16, 300
    before = SPANS.path_trace.count, SPANS.path_shade.count
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    counted = SimpleNamespace(launches=0)

    def work():
        for _ in range(n):
            with SPANS.path_shade:
                with SPANS.path_trace:
                    telemetry.launched(counted, "trace_bvh_kernel")

    try:
        with telemetry.timeline() as records:
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert SPANS.path_trace.count - before[0] == n_threads * n
    assert SPANS.path_shade.count - before[1] == n_threads * n
    assert len(telemetry.session().stamps) == n_threads * n
    by_thread = _leaves_by_thread(records)
    assert len(by_thread) == n_threads
    for iv in by_thread.values():
        iv.sort()
        assert all(b0 <= a1 for (_, b0), (a1, _) in zip(iv, iv[1:]))


def test_every_counter_path_resolves():
    """The registered counters, which are every counter the package
    defines, and every ``COUNTERS`` path and set-up reader of
    ``benchmark/metrics/``."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    from benchmark import harness

    pkg = REPO / "gdpathtracing_torch"
    defined = {
        f"gdpathtracing_torch."
        f"{'.'.join(f.relative_to(pkg).with_suffix('').parts)}:{m[1]}"
        for f in pkg.rglob("*.py")
        for m in re.finditer(r"^(\w+\.(?:launches|iterations|lanes)) = 0$",
                             f.read_text(), re.M)}
    assert len(defined) >= 14 and defined == set(telemetry.COUNTERS)
    assert "gdpathtracing_torch.ops.shade:regen_shade.launches" in defined
    for path in telemetry.COUNTERS:
        assert isinstance(telemetry.read(path), int), path
    paths = []
    for f in sorted((REPO / "benchmark" / "metrics").glob("*.py")):
        mod = harness.load_module(f)
        paths += getattr(mod, "COUNTERS", [])
        if f.name.endswith(".setup.py"):
            assert isinstance(mod.read({}), float), f.name
    assert len(paths) >= 11  # regen's iterations and the ten span readers
    for path in paths:
        assert isinstance(harness._counter(path), (int, float)), path


# ---------------------------------------------------------------------------
# The timeline in a profiler session, the launch stamps, and the trace's
# start estimated from them (benchmark/span_clock.py)
# ---------------------------------------------------------------------------

def _profiled(run):
    """``run()`` inside a CPU torch.profiler session; (wall ns at the
    session's start and end)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        t0 = time_ns()
        run()
        t1 = time_ns()
    return t0, t1


def test_timeline_joins_each_profiler_session(scene):
    """A 16x16 Engine.step in a CPU profiler session turns the timeline on
    with no ``timeline()`` call; the next session's records are its own;
    nothing is recorded once the profiler has stopped. Between sessions
    the viewer renders a frame unprofiled, as the benchmark warms up."""
    eng = Engine(scene, PALLAS)
    cam = demo_camera(16, 16)
    spans = set(LEAF_SPANS + OUTER_SPANS)
    for _ in range(2):
        eng.step(cam)
        assert not telemetry._on
        t0, t1 = _profiled(lambda: eng.step(cam))
        records = telemetry.session().records
        assert {"engine_step", "render_radiance", "path_lanes",
                "post_passes"} <= {r[0] for r in records} <= spans
        assert all(t0 <= a <= b <= t1 for _, _, a, b in records)
        assert sum(r[0] == "engine_step" for r in records) == 1
    n = len(records)
    eng.step(cam)
    with SPANS.path_shade:
        pass
    assert len(telemetry.session().records) == n
    assert not telemetry._on


def test_timeline_leaves_a_session_as_its_profiler_stops():
    """The timeline turns off as the profiler stops: a span after it
    records nothing. Two sessions with no span between them keep their
    own records. A ``timeline()`` block keeps the timeline on through a
    profiler session inside it."""
    def run():
        with SPANS.engine_step, SPANS.path_shade:
            pass
    _profiled(run)
    n = len(telemetry.session().records)
    assert n == 2 and not telemetry._on
    with SPANS.engine_step, SPANS.path_lanes:
        pass
    assert len(telemetry.session().records) == n
    _profiled(lambda: None)
    assert telemetry.session().records == [] and not telemetry._on
    with telemetry.timeline() as records:
        _profiled(run)
        assert telemetry._on
        run()
    assert len(records) == 4 and not telemetry._on


def test_launch_helper_counts_and_stamps(monkeypatch):
    """``_launch`` counts each launch in its wrapper's ``.launches`` as
    before, and with the timeline on stamps ``<name>_kernel`` before the
    C function runs; with it off it stamps nothing."""
    import contextlib

    from gdpathtracing_torch.ops import intersect

    called = []

    def fake(*args):
        called.append(time_ns())
        return 0
    monkeypatch.setattr(intersect, "_c_function", lambda *a: fake)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: SimpleNamespace(cuda_stream=0))
    x = torch.zeros(4)
    wrapper = intersect.closest_hit_rows
    before = wrapper.launches
    intersect._launch("closest_hit_rows", (x, x), 4, 5, wrapper=wrapper)
    assert wrapper.launches == before + 1
    with telemetry.timeline():
        intersect._launch("closest_hit_rows", (x, x), 4, 5,
                          wrapper=wrapper)
        stamps = telemetry.session().stamps
    assert wrapper.launches == before + 2
    assert len(stamps) == 1 and stamps[0][0] == "closest_hit_rows_kernel"
    assert stamps[0][1] <= called[-1]
    intersect._launch("closest_hit_rows", (x, x), 4, 5, wrapper=wrapper)
    assert len(telemetry.session().stamps) == 1


def test_every_launch_counts_in_its_own_wrapper():
    """Each kernel launch of the package (``_launch`` and the BVH
    traversal's ``launched``) counts in the ``.launches`` of the function
    that makes it, a path of ``COUNTERS``, as before the helper."""
    import ast

    pkg = REPO / "gdpathtracing_torch"
    found = set()
    for f in pkg.rglob("*.py"):
        mod = "gdpathtracing_torch." + ".".join(
            f.relative_to(pkg).with_suffix("").parts)
        for fn in ast.walk(ast.parse(f.read_text())):
            if not isinstance(fn, ast.FunctionDef) or fn.name in (
                    "_launch", "launched"):
                continue
            for call in ast.walk(fn):
                if not (isinstance(call, ast.Call) and isinstance(
                        call.func, ast.Name)):
                    continue
                if call.func.id == "_launch":
                    (w,) = [k.value for k in call.keywords
                            if k.arg == "wrapper"]
                elif call.func.id == "launched":
                    w = call.args[0]
                else:
                    continue
                # _classic launches for the wrapper its callers name.
                name = w.id if w.id != "wrapper" else None
                if name is None:
                    continue
                owner = fn.name if fn.name != "_launch_kernel" else "trace_bvh"
                assert name == owner, (f, fn.name)
                found.add(f"{mod}:{name}.launches")
    classic = {f"gdpathtracing_torch.ops.intersect:{n}.launches"
               for n in ("closest_hit_classic", "closest_hit_loop")}
    assert found | classic == {c for c in telemetry.COUNTERS
                               if c.endswith(".launches")}


T0 = 1_760_000_000_123_456_789   # the trace's start on the host clock, ns
MS = 1_000_000


def _window(steps=3, lag_us=(7, 5, 9), busy_gap=False, dropped=0,
            stretch=0.0):
    """A synthetic traced window of ``steps`` frames, 10 ms apart: the
    timeline's session (records and stamps on the host clock) and the
    harness's ctx (device events in seconds after the trace's start). A
    frame: ``engine_step`` over 6 ms holding render_prepare (1 ms),
    path_trace (2 ms) with kernel 1 for 1 ms of it, launched ``lag_us``
    before it starts, path_shade (1 ms) with an elementwise op for 0.3 ms,
    post_passes (2 ms). ``busy_gap``: a copy keeps the card busy from
    before frame 0's end to after frame 1's start. ``stretch``: the
    trace's clock runs that much faster than the host's."""
    records, stamps, events = [], [], []

    def dev(t):  # host ns after the trace's start -> trace seconds
        return t * (1.0 + stretch) * 1e-9
    for k in range(steps):
        o = k * 10 * MS + MS
        for name, a, b in (("render_prepare", 0, 1), ("path_trace", 1, 3),
                           ("path_shade", 3, 4), ("post_passes", 4, 6)):
            records.append((name, 1, T0 + o + a * MS, T0 + o + b * MS))
        records.append(("engine_step", 1, T0 + o, T0 + o + 6 * MS))
        k0 = o + 3 * MS // 2
        events.append(("void closest_hit_rows_kernel(float const*)",
                       dev(k0), dev(k0 + MS)))
        stamps.append(("closest_hit_rows_kernel",
                       T0 + k0 - lag_us[k % len(lag_us)] * 1000))
        s0 = o + 32 * MS // 10
        events.append(("elementwise", dev(s0), dev(s0 + 3 * MS // 10)))
    if busy_gap:
        events.append(("Memcpy DtoD", dev(6.5 * MS), dev(11.5 * MS)))
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    from benchmark import trace
    ctx = {"events": events, "busy_s": trace.busy_seconds(events),
           "window_s": steps * 10 * MS * 1e-9, "steps": steps}
    return telemetry.Session(records, stamps, dropped), ctx


def test_clock_knots_take_the_offset_from_idle_launches():
    """Each launch whose kernel starts on an idle card bounds the trace
    clock's offset, early by its lag; one queued behind other work (it
    starts a few us after that work ends) bounds nothing, and one whose
    lag the launches on both sides beat by more than the lags' spread is
    no knot. The offset is interpolated between the knots. Whole words of
    a symbol only: soft_occlusion_kernel is not occlusion_kernel. A
    symbol with a stamp more than events pairs nothing."""
    us = 1_000
    events = [("void soft_occlusion_kernel<1>(float*)", 500 * us, 600 * us),
              ("mega_step_kernel", MS, 1500 * us),
              # queued: launched at 1.2 ms, 2 us after the mega step
              ("void occlusion_kernel(float*)", 1502 * us, 1800 * us),
              # idle, but its lag of 90 us loses to 30 and 4 us around it
              ("occlusion_kernel", 4 * MS, 5 * MS),
              ("occlusion_kernel", 6 * MS, 6100 * us)]
    stamps = [("occlusion_kernel", T0 + 1200 * us),
              ("occlusion_kernel", T0 + 4 * MS - 90 * us),
              ("mega_step_kernel", T0 + MS - 30 * us),
              ("occlusion_kernel", T0 + 6 * MS - 4 * us)]
    assert telemetry.idle_launches(events, stamps) == [
        (T0 + MS - 30 * us, T0 - 30 * us),
        (T0 + 4 * MS - 90 * us, T0 - 90 * us),
        (T0 + 6 * MS - 4 * us, T0 - 4 * us)]
    ks = telemetry.clock_knots(events, stamps)
    assert ks == [(T0 + MS - 30 * us, T0 - 30 * us),
                  (T0 + 6 * MS - 4 * us, T0 - 4 * us)]
    clock = telemetry.to_trace(ks)
    assert clock(T0) == 30 * us
    assert clock(T0 + 10 * MS) == 10 * MS + 4 * us
    mid = T0 + (7 * MS - 34 * us) // 2
    assert clock(mid) == mid - T0 + 17 * us
    assert telemetry.clock_knots(events, [("trace_bvh_kernel", T0)]) is None
    assert telemetry.clock_knots(events, stamps + stamps[:1]) is None
    assert telemetry.clock_knots(events, stamps[:1]) is None


def test_clock_knots_take_a_queued_kernel_that_starts_sooner():
    """A kernel queued behind work that ends 2 us after its launch starts
    sooner after it than the launches on an idle card around it (lags 30
    and 40 us): its bound lies above their clock, so it is a knot too and
    no stamped kernel starts before its launch on the placed clock. One
    queued longer (50 us after its launch) is no knot."""
    us = 1_000
    events = [("mega_step_kernel", MS, 1100 * us),
              ("fused_paths_kernel", 2 * MS, 2500 * us),
              # queued: launched at 2.498 ms, 2 us before fused_paths ends
              ("occlusion_kernel", 2500 * us, 2600 * us),
              # queued: launched at 2.55 ms, starts 50 us after it
              ("soft_occlusion_kernel", 2600 * us, 2700 * us),
              ("mega_step_kernel", 4 * MS, 4100 * us)]
    stamps = [("mega_step_kernel", T0 + MS - 30 * us),
              ("fused_paths_kernel", T0 + 2 * MS - 35 * us),
              ("occlusion_kernel", T0 + 2498 * us),
              ("soft_occlusion_kernel", T0 + 2550 * us),
              ("mega_step_kernel", T0 + 4 * MS - 40 * us)]
    ks = telemetry.clock_knots(events, stamps)
    assert ks == [(T0 + MS - 30 * us, T0 - 30 * us),
                  (T0 + 2 * MS - 35 * us, T0 - 35 * us),
                  (T0 + 2498 * us, T0 - 2 * us),
                  (T0 + 4 * MS - 40 * us, T0 - 40 * us)]
    clock = telemetry.to_trace(ks)
    lag = [e - clock(s) for s, e in telemetry.launch_pairs(events, stamps)]
    assert min(lag) == 0 and max(lag) > 40 * us


def test_clock_knots_follow_a_trace_clock_that_runs_apart():
    """A trace clock 5% faster than the host's puts frame 2's kernel 1 ms
    later than a single offset taken at frame 0 says; a knot at each
    frame's launch places every stamp within its lag of its kernel, and
    after none."""
    ses, ctx = _window(stretch=0.05)
    ev = [(n, round(a * 1e9), round(b * 1e9)) for n, a, b in ctx["events"]]
    ks = telemetry.clock_knots(ev, ses.stamps)
    assert len(ks) == 3
    for clock, most in ((telemetry.to_trace(ks), 9_500),
                        (telemetry.to_trace(ks[:1]), 1_010_000)):
        lag = [e - clock(s) for s, e in telemetry.launch_pairs(
            ev, ses.stamps)]
        assert min(lag) >= 0 and max(lag) <= most
    assert max(lag) >= 990_000


def test_clock_knots_leave_out_a_slow_launch(monkeypatch):
    """A launch 1 ms slower than the launches on either side of it (the
    profiler's callback at the launch call, say) is no knot: the offset is
    interpolated past it, and each leaf's idle time reads as without it.
    Kept, it would put frame 2's spans 1 ms early."""
    from benchmark import span_clock

    def idle(lags):
        ses, ctx = _window(steps=5, lag_us=lags)
        monkeypatch.setattr(telemetry, "session", lambda: ses)
        ev = [(n, round(a * 1e9), round(b * 1e9))
              for n, a, b in ctx["events"]]
        return telemetry.clock_knots(ev, ses.stamps), \
            span_clock.idle_seconds(ctx), ses
    ks, slow, ses = idle((7, 5, 1000, 9, 6))
    assert [s for s, _ in ks] == [t for i, (_, t) in
                                  enumerate(ses.stamps) if i != 2]
    _, even, _ = idle((7, 5, 8, 9, 6))
    for name in ("render_prepare", "path_trace", "path_shade",
                 "post_passes", "unspanned"):
        assert slow[name] == pytest.approx(even[name], abs=5 * 10e-6)


@pytest.mark.parametrize("fault", ["no_stamps", "dropped", "busy_gap",
                                   "lost_stamp", "queued", "one_step"])
def test_span_clock_reads_none_when_it_cannot_place_the_spans(monkeypatch,
                                                              fault):
    """No stamps, records dropped, a card busy across a gap between two
    steps, a launch without its stamp (every later stamp would pair with
    the launch before its own, a frame early), every kernel queued behind
    a copy that covers its launch and ends 2 us before it starts (no
    launch gives its own lag) or no gap to check: no idle time is
    read."""
    from benchmark import span_clock

    ses, ctx = _window(busy_gap=fault == "busy_gap",
                       dropped=int(fault == "dropped"),
                       steps=1 if fault == "one_step" else 3)
    if fault == "no_stamps":
        ses = ses._replace(stamps=[])
    elif fault == "lost_stamp":
        ses = ses._replace(stamps=ses.stamps[1:])
    elif fault == "queued":
        ctx["events"] += [("Memcpy HtoD", a - 5e-4, a - 2e-6)
                          for n, a, _ in ctx["events"] if "kernel" in n]
    monkeypatch.setattr(telemetry, "session", lambda: ses)
    assert span_clock.idle_seconds(ctx) is None
    ses, ctx = _window()
    monkeypatch.setattr(telemetry, "session", lambda: ses)
    assert span_clock.idle_seconds(ctx) is not None


def test_leaf_and_unspanned_idle_add_up_to_the_window(monkeypatch):
    """Each leaf's idle time is its length less the device's busy time
    inside it, to within the launches' lags; the unspanned idle time is
    the window's idle time outside every span, counted here us by us: so
    ``window_s - busy_s`` less the leaves' idle time is the idle time no
    span holds."""
    from benchmark import span_clock

    ses, ctx = _window()
    monkeypatch.setattr(telemetry, "session", lambda: ses)
    idle = span_clock.idle_seconds(ctx)
    want = {"render_prepare": 1.0, "path_trace": 1.0, "path_shade": 0.7,
            "post_passes": 2.0}
    for name, ms in want.items():
        assert idle[name] == pytest.approx(3 * ms * 1e-3, abs=3 * 10e-6)
    n_us = round(ctx["window_s"] * 1e6)
    free = torch.ones(n_us, dtype=torch.bool)
    for _, a, b in ctx["events"]:
        free[round(a * 1e6):round(b * 1e6)] = False
    for _, _, a, b in ses.records:
        free[(a - T0) // 1000:(b - T0) // 1000] = False
    assert idle["unspanned"] == pytest.approx(int(free.sum()) * 1e-6,
                                              abs=3 * 10e-6)
    assert span_clock.idle_ms(ctx, "path_trace") == pytest.approx(
        1e3 * idle["path_trace"] / 3)
