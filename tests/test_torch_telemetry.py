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


@pytest.mark.parametrize("what", ["frame", "gradient"])
def test_timeline_changes_nothing(scene, what):
    def run():
        if what == "frame":
            return _engine_frame(scene)
        rad, albedo = _diff_render(scene)
        (g,) = torch.autograd.grad(rad.square().mean(), [albedo])
        return torch.cat([rad.flatten(), g.flatten()])

    off = run()
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


@pytest.mark.parametrize("metric", ["epilogue_ms.frame",
                                    "torch_shade_iterations.frame",
                                    "recompute_ms.step", "epilogue_ms.step"])
def test_new_readers_read_none_without_their_source(monkeypatch, metric):
    """The readers of the spans ``trace_epilogue`` and ``trace_recompute``
    and of the counter ``_shade_torch.iterations`` give no counter path
    and read None on a program that lacks them, as the benchmark's runs of
    an older program need."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    from benchmark import harness
    from gdpathtracing_torch.render import regen

    path = REPO / "benchmark" / "metrics" / f"{metric}.py"
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
    counted once and each thread's leaves nest and pause, never overlap."""
    n_threads, n = 16, 300
    before = SPANS.path_trace.count, SPANS.path_shade.count
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        for _ in range(n):
            with SPANS.path_shade:
                with SPANS.path_trace:
                    pass

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
