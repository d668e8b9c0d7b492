"""One run of one cell: set up the system under test, measure the window,
check the outputs against the plain reference, and build the result.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the names in ``BENCHMARK.json``:
``configs/<config>.json`` (the program's scene builder, camera and render
settings) beside ``configs/<config>.py`` (the scene as the reference
builds it), ``traffic/<mix>.json`` (a loop of ``traffic.py`` and its
parameters), ``metrics/<metric>.py`` (a reader ``read(ctx)``),
``kernels/<symbol>.json`` (a device kernel that traces rays) and
``limits/<cell>.json`` (the limits of the cell's compared numbers).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import check, trace
from benchmark.reference import render as ref_render
from benchmark.traffic import LOOPS

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "gdpathtracing_tpu")


def load_module(path: Path):
    """A module from a file whose name need not be an identifier."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_file_" + path.stem.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, root: Path = ROOT) -> SimpleNamespace:
    """The cell ``name`` of ``BENCHMARK.json``: its entry, configuration,
    traffic, the per-layer metrics it reports (name -> reader) and the
    end-to-end metrics."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    bdir = root / "benchmark"
    conf = json.loads((bdir / "configs" / f"{cell['config']}.json")
                      .read_text())
    traffic = json.loads((bdir / "traffic" / f"{cell['traffic']}.json")
                         .read_text())

    def reports(m):
        return name in m.get("workloads", [name])

    return SimpleNamespace(
        name=name, dir=bdir, entry=cell, config=conf, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if reports(m)],
        per_layer={m["name"]: (m, load_module(bdir / "metrics"
                                              / f"{m['name']}.py"))
                   for m in bench["per_layer"] if reports(m)})


def reference_scene(cell, device, width=None, height=None):
    """The reference's description of the cell's scene, prepared on
    ``device`` at the camera's size (or ``width`` x ``height``)."""
    desc_mod = load_module(cell.dir / "configs" / cell.config["reference"])
    args = cell.config["camera"]["args"]
    transform, fov = desc_mod.camera()
    desc = desc_mod.description()
    return desc, (lambda: ref_render.prepare(
        desc, transform, fov, width or args["width"],
        height or args["height"], device))


def _call(spec: dict, **extra):
    mod, fn = spec["builder"].split(":")
    return getattr(importlib.import_module(mod), fn)(**spec["args"], **extra)


def system(cell, device, width=None, height=None) -> SimpleNamespace:
    """The system under test: the program's scene, camera and config."""
    import gdpathtracing_torch as gpt
    from gdpathtracing_torch.diff import inverse
    from gdpathtracing_torch.ops.build import load_libraries
    if device.type == "cuda":
        load_libraries()
    render = {**cell.config["render"], **cell.traffic.get("render", {})}
    render["traversal"] = gpt.Traversal[render["traversal"]]
    cam_args = dict(cell.config["camera"]["args"])
    if width:
        cam_args.update(width=width, height=height)
    camera = _call(dict(cell.config["camera"], args=cam_args))
    return SimpleNamespace(
        scene=_call(cell.config["scene"], device=device),
        camera=camera.to(device), config=gpt.RenderConfig(**render),
        device=device, Engine=gpt.Engine, inverse=inverse,
        render_radiance=gpt.render_radiance)


def _counter(path: str):
    mod, attr = path.split(":")
    obj = importlib.import_module(mod)
    for a in attr.split("."):
        obj = getattr(obj, a)
    return obj


def p95(values) -> float:
    """The 95th percentile by nearest rank."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def end_to_end(times, window_s: float, setup_s: float) -> dict:
    """The end-to-end metrics of a window of steps that took ``times``
    seconds each: its wall time over the steps completed, the 95th
    percentile of every step, and the set-up time."""
    step_ms = window_s / len(times) * 1e3
    return {"frame_ms": step_ms, "step_ms": step_ms,
            "frame_ms_p95": p95(times) * 1e3, "setup_s": setup_s}


def run_cell(cell, seed: int, seconds: float, traced: bool, device,
             t_start: float, width=None, height=None) -> dict:
    """One run; returns the result's fields (``correct`` ... ``checks``)."""
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    desc, prepare_ref = reference_scene(cell, device, width, height)
    sut = system(cell, device, width, height)
    loop = LOOPS[cell.traffic["loop"]](sut, cell.traffic, seed,
                                      {"albedo": desc.albedo()})
    loop.setup()
    sync()
    cuda = device.type == "cuda"
    peak_setup = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    counters = [c for _, mod in cell.per_layer.values()
                for c in getattr(mod, "COUNTERS", [])] if traced else []
    before = {c: _counter(c) for c in counters}
    max_steps = int(cell.traffic.get("trace_steps", 1 << 30)) if traced \
        else 1 << 30
    prof = None
    if traced:
        loop.spans = {}
        # Device activity only: a host op's record costs more than the op.
        act = [torch.profiler.ProfilerActivity.CUDA] if cuda \
            else [torch.profiler.ProfilerActivity.CPU]
        prof = torch.profiler.profile(activities=act)
        prof.__enter__()
    times = []
    t_open = time.perf_counter()
    setup_s = t_open - t_start
    while True:
        t0 = time.perf_counter()
        loop.step()
        sync()
        t1 = time.perf_counter()
        times.append(t1 - t0)
        if t1 - t_open >= seconds or len(times) >= max_steps:
            break
    window_s = t1 - t_open
    if prof is not None:
        prof.__exit__(None, None, None)
    peak_window = torch.cuda.max_memory_allocated(device) if cuda else 0
    attempted, failed = loop.attempted_failed()
    ctx = {"steps": len(times), "window_s": window_s,
           "kernels": trace.tracing_symbols(cell.dir / "kernels"),
           "peak_window_bytes": peak_window, "spans": loop.spans or {},
           "counters": {c: _counter(c) - before[c] for c in counters}}
    if prof is not None:
        kind = torch.autograd.DeviceType.CUDA if cuda \
            else torch.autograd.DeviceType.CPU
        ctx["events"] = trace.device_events(prof, kind)
        del prof
        ctx["busy_s"] = trace.busy_seconds(ctx["events"])
    # The program's state goes before the reference runs; what the check
    # compares was kept by the loop.
    loop.release()
    sut = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = prepare_ref()
    numbers, counts = loop.numbers(ref)
    q = np.quantile(times, [0.0, 0.5, 0.95, 1.0]) * 1e3
    print(f"set-up {setup_s:.2f} s, window {window_s:.2f} s ({len(times)} "
          f"steps; ms min {q[0]:.1f} median {q[1]:.1f} p95 {q[2]:.1f} max "
          f"{q[3]:.1f}), reference check {time.perf_counter() - t_ref:.2f} s",
          file=sys.stderr)
    ok, checks = check.judge(numbers, check.limits(cell.dir, cell.name))
    frame = ref_render.Counts(*(float(np.mean([getattr(c, f) for c in counts]))
                                for f in ref_render.Counts._fields))
    ctx["ref_least_s"], bound = trace.least_seconds(
        frame, ref.tables.cols.shape[0])
    if traced:
        metrics = {}
        for name, (m, mod) in cell.per_layer.items():
            value = mod.read(ctx)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": m["unit"]}
    else:
        values = end_to_end(times, window_s, setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": max(peak_setup, peak_window)}
    out = {"correct": bool(ok and failed == 0), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = ctx.get("busy_s", 0.0)
        dev["window_s"] = window_s
        out["breakdown"] = {"device_ops": trace.top_ops(ctx["events"]),
                            "idle_gaps": trace.idle_gaps(ctx["events"])}
        out["roofline"] = {"bound": bound, "card": trace.power_limit()
                           if cuda else "cpu",
                           "least_s_per_step": ctx["ref_least_s"]}
    out["checks"] = checks
    return out


def forbidden_modules() -> list[str]:
    """Modules of JAX or of the JAX package in this process, compared by
    whole top-level name."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})
