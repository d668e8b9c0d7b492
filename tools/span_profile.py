"""Where the host time of a frame and of an inverse step goes, by the
program's spans (gdpathtracing_torch/utils/telemetry.py), and where the
device idles inside them.

    python3 tools/span_profile.py [--width 1920 --height 1080]
        [--frames 20] [--out out/span_profile] [--device cuda|cpu]

On the card (``--device cuda``, the default; it stops if there is none): the demo room (the benchmark's ``demo`` configuration) as
``Engine.step`` frames and as inverse-rendering steps (image MSE,
``torch.autograd.grad``, Adam on the albedo table). It prints

- the host cost of one span with the timeline off and on, of the outer
  span and of one launch's count and stamp with the timeline off and
  joined to a profiler session, and the span records and
  launch stamps of a traced demo.bvh frame (``RenderConfig()``) with the
  host time the timeline adds to it;
- the median frame with the timeline off and on, and under
  ``Engine.profile`` (the profiler's collection and the trace's writing
  counted apart);
- for one profiled frame and one profiled step: each leaf span's host ms
  and the device's idle ms inside it, and the share of the idle time
  inside the outer spans that falls inside leaf spans;
- the clock check: the share of the trace's kernel launch calls (CUDA
  runtime events, on the profiler's host clock) that lie inside an
  ``engine_step`` span.

The summary is also written as JSON to ``<out>/summary.json``, the traces
to ``<out>/``. ``--device cpu`` runs it on the CPU, where the CPU's
operations stand for the device's; every heading then says ``cpu``, and
no number of such a run is the card's.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gdpathtracing_torch import (Engine, RenderConfig,  # noqa: E402
                                 Traversal, render_radiance)
from gdpathtracing_torch.diff import inverse  # noqa: E402
from gdpathtracing_torch.ops.build import load_libraries  # noqa: E402
from gdpathtracing_torch.scene.demo import (build_demo_scene,  # noqa: E402
                                            demo_camera)
from gdpathtracing_torch.utils import telemetry  # noqa: E402
from gdpathtracing_torch.utils.telemetry import (LEAF_SPANS,  # noqa: E402
                                                 SPANS, Profile)


def span_cost_ns(n: int = 200_000, repeats: int = 7, cuda: bool = True
                 ) -> dict:
    """Host ns of one ``with`` span (enter and exit, the loop's own cost
    taken off): the least and the median of ``repeats`` loops of ``n``,
    a leaf and an outer span with the timeline off, a leaf with it on;
    then an outer span and one launch's count and stamp
    (``telemetry.launched``, less a bare ``.launches += 1``), each with
    the timeline off and joined to a profiler session; the kinds in
    turns."""
    def loop(span) -> float:
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with span:
                pass
        return (time.perf_counter_ns() - t0) / n

    def bare() -> float:
        t0 = time.perf_counter_ns()
        for _ in range(n):
            pass
        return (time.perf_counter_ns() - t0) / n

    counted = SimpleNamespace(launches=0)

    def launch() -> float:
        launched = telemetry.launched
        t0 = time.perf_counter_ns()
        for _ in range(n):
            launched(counted, "trace_bvh_kernel")
        t1 = time.perf_counter_ns()
        for _ in range(n):
            counted.launches += 1
        return (2 * t1 - t0 - time.perf_counter_ns()) / n

    act = torch.profiler.ProfilerActivity
    runs = {k: [] for k in ("leaf_off", "outer_off", "leaf_on", "outer_on",
                            "launch_off", "launch_on")}
    for _ in range(repeats):
        b = bare()
        runs["leaf_off"].append(loop(SPANS.path_lanes) - b)
        runs["outer_off"].append(loop(SPANS.engine_step) - b)
        runs["launch_off"].append(launch())
        with telemetry.timeline():
            runs["leaf_on"].append(loop(SPANS.path_lanes) - b)
        with torch.profiler.profile(
                activities=[act.CUDA if cuda else act.CPU]):
            runs["outer_on"].append(loop(SPANS.engine_step) - b)
            runs["launch_on"].append(launch())
    return {k: {"min": min(v), "median": statistics.median(v)}
            for k, v in runs.items()}


def traced_bvh_frame(scene, cam, sync) -> dict:
    """Span records and launch stamps of one demo.bvh frame (``Engine.step``
    under ``RenderConfig()``) whose timeline joined a profiler session."""
    eng = Engine(scene, RenderConfig())
    eng.step(cam)
    sync()
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[
            act.CUDA if scene.device.type == "cuda" else act.CPU]):
        eng.step(cam)
        sync()
    ses = telemetry.session()
    return {"records": len(ses.records), "stamps": len(ses.stamps),
            "dropped": ses.dropped}


def timed(step, sync, n: int) -> list[float]:
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        step()
        sync()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def table(sm) -> dict:
    spans = {n: {"host_ms": sm.spans[n].host_s * 1e3,
                 "count": sm.spans[n].count,
                 "idle_ms": sm.spans[n].idle_s * 1e3}
             for n in sm.spans}
    return {"window_ms": sm.window_s * 1e3, "busy_ms": sm.busy_s * 1e3,
            "device_ops": sm.ops, "leaf_idle_share": sm.leaf_idle_share,
            "spans": spans, "trace": sm.trace}


def print_table(what: str, t: dict, outer: str | None) -> None:
    """Each leaf span's host ms and the device's idle ms inside it, as a
    share of the idle time inside ``outer`` (or, for None, the window).
    ``what`` names the device the numbers come from."""
    if outer:
        o = t["spans"][outer]
        base_ms, idle_ms = o["host_ms"], o["idle_ms"]
        print(f"{what}: window {t['window_ms']:.1f} ms, busy "
              f"{t['busy_ms']:.2f} ms, {t['device_ops']} device operations;"
              f" {outer} {base_ms:.1f} ms, device idle {idle_ms:.1f} ms "
              f"inside it, {t['leaf_idle_share']:.4f} of that inside leaf "
              f"spans")
    else:
        base_ms = t["window_ms"]
        idle_ms = t["window_ms"] - t["busy_ms"]
        print(f"{what}: window {base_ms:.1f} ms, busy {t['busy_ms']:.2f} "
              f"ms, {t['device_ops']} device operations, device idle "
              f"{idle_ms:.1f} ms")
    leaf_ms = sum(t["spans"][n]["host_ms"] for n in LEAF_SPANS
                  if n in t["spans"])
    print(f"  {'span':16s} {'host ms':>9s} {'count':>6s} {'idle ms':>9s} "
          f"{'idle share':>10s}")
    for n in LEAF_SPANS:
        if n in t["spans"]:
            s = t["spans"][n]
            print(f"  {n:16s} {s['host_ms']:9.2f} {s['count']:6d} "
                  f"{s['idle_ms']:9.2f} {s['idle_ms'] / idle_ms:10.4f}")
    print(f"  leaf spans: {leaf_ms:.2f} ms of {base_ms:.2f} "
          f"({leaf_ms / base_ms:.4f})")


def launches_inside(trace: str, outer: str = "engine_step") -> float:
    """The share of the trace's kernel launch calls that lie inside an
    ``outer`` span on the trace's clock (nan without launch events)."""
    ev = json.loads(Path(trace).read_text())["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in ev
                   if e.get("cat") == "program_span" and e["name"] == outer)
    calls = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in ev
             if e.get("cat") == "cuda_runtime"
             and "LaunchKernel" in e.get("name", "")]
    if not calls:
        return float("nan")
    inside = sum(any(a <= c0 and c1 <= b for a, b in spans)
                 for c0, c1 in calls)
    return inside / len(calls)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--frames", type=int, default=20)
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--out", default="out/span_profile")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cpu only when asked for: its numbers are not the "
                        "card's")
    args = p.parse_args()
    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        sys.exit("span_profile: no CUDA device; pass --device cpu to run "
                 "on the CPU")
    dev = torch.device(args.device)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out = Path(args.out)
    card = "cpu"
    if cuda:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
        load_libraries()
    print(f"on {card}, torch {torch.__version__}")
    res = {"device": args.device, "card": card,
           "span_cost": span_cost_ns(cuda=cuda)}
    print(f"[{card}] span cost (ns, loop taken off):", res["span_cost"])

    scene = build_demo_scene(device=dev)
    cam = demo_camera(args.width, args.height)
    bvh = res["bvh_frame"] = traced_bvh_frame(scene, cam, sync)
    cost = res["span_cost"]
    # A traced frame's records: two outer spans and leaf segments, each
    # paying the difference of the timeline on to off.
    bvh["added_us"] = 1e-3 * (
        bvh["records"] * (cost["leaf_on"]["median"]
                          - cost["leaf_off"]["median"])
        + bvh["stamps"] * (cost["launch_on"]["median"]
                           - cost["launch_off"]["median"]))
    print(f"[{card}] traced demo.bvh frame: {bvh['records']} span records, "
          f"{bvh['stamps']} launch stamps, {bvh['dropped']} dropped; the "
          f"timeline adds ~{bvh['added_us']:.1f} us of host time to it")
    cfg = RenderConfig(traversal=Traversal.PALLAS, bounces=5, spp=1)
    eng = Engine(scene, cfg)
    eng.reset(cam)
    timed(lambda: eng.step(cam), sync, 3)
    off = timed(lambda: eng.step(cam), sync, args.frames)
    with telemetry.timeline():
        on = timed(lambda: eng.step(cam), sync, args.frames)
    prof_ms, post_ms, frames = [], [], []
    for k in range(3):
        t0 = time.perf_counter()
        with eng.profile(out / "frame") as prof:
            t1 = time.perf_counter()
            eng.step(cam)
            sync()
            t2 = time.perf_counter()
        prof_ms.append((t2 - t1) * 1e3)
        post_ms.append((time.perf_counter() - t0 - (t2 - t1)) * 1e3)
        frames.append(table(prof.summary))
    res["frame_ms"] = {"timeline_off": off, "timeline_on": on,
                       "profiled": prof_ms,
                       "profile_collect_and_write": post_ms}
    med = {k: statistics.median(v) for k, v in res["frame_ms"].items()}
    print(f"[{card}] frame ms, medians:",
          {k: round(v, 3) for k, v in med.items()})
    res["frames"] = frames
    for k, t in enumerate(frames):
        print_table(f"[{card}] profiled frame {k}", t, "engine_step")
        share = launches_inside(t["trace"]) if cuda else float("nan")
        t["launch_calls_inside_engine_step"] = share
        print(f"  kernel launch calls inside engine_step: {share:.4f}")

    # The inverse step of the benchmark's demo.inverse cell.
    dcfg = cfg.replace(differentiable=True)
    with torch.no_grad():
        target = render_radiance(
            inverse.replace_albedo(scene, scene.mat_albedo * 0.9), cam, dcfg,
            1 << 21).radiance
    param = scene.mat_albedo.clone().requires_grad_(True)
    opt = torch.optim.Adam([param], lr=1e-3)
    frame = [0]

    def inv_step():
        loss = inverse.render_loss(param, inverse.replace_albedo, scene, cam,
                                   dcfg, target, frame[0])
        (grad,) = torch.autograd.grad(loss, [param])
        param.grad = grad
        opt.step()
        with torch.no_grad():
            param.clamp_(0.0, 1.0)
        frame[0] += 1

    timed(inv_step, sync, 2)
    res["step_ms"] = timed(inv_step, sync, args.steps)
    print(f"[{card}] inverse step ms, median "
          f"{statistics.median(res['step_ms']):.1f}")
    steps = []
    for k in range(2):
        with Profile(dev, out / "step") as prof:
            inv_step()
            sync()
        steps.append(table(prof.summary))
        print_table(f"[{card}] profiled inverse step {k}", steps[-1], None)
    res["steps"] = steps
    out.mkdir(parents=True, exist_ok=True)
    (out / "summary.json").write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
