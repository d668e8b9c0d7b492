#!/usr/bin/env python3
"""The traversal kernels of several builds, timed in turns on one GPU.

    python3 tools/two_level_turns.py --other parent=DIR [--other NAME=DIR]
                                     [--only NAME ...]

Builds ``closest_hit_rows.cu`` (kernel 1), ``closest_hit_sc_lite.cu``
(kernel 3), ``closest_hit_rows_sc.cu`` (kernel 6), ``march_step_sc.cu``
(kernel 7), ``occlusion.cu`` (kernel 2), ``closest_hit_rows_nee.cu``
(kernel 4), ``mega_step.cu`` (kernel 10) and ``fused_paths.cu`` (kernel
11) from this checkout's ``gdpathtracing_torch/csrc`` ("change") and from each
``DIR`` (another ``csrc`` directory, for example the parent commit's,
unpacked with ``git archive`` into a directory that .gitignore lists), with
ops/build.py's flags, and prints ptxas' registers, shared memory and
spills for each. Then, on the operands of chip_smoke.py phase 2 (built by
gdpathtracing_torch/ops/tiles.py for both), it launches every build's
kernel on the same tensors, checks that each output equals the plain
version bit for bit, and times the builds in turns, forward then backward
(other, change, change, other), each with CUDA events over 20 launches.
The tiles:
- kernels 3 and 6: the middle 262144-ray tile of a 1080p frame of the
  bench's sphere grid (n=10; kernel 6 the n=14 grid), primary rays and one
  BRDF bounce from their hits;
- kernel 7: chip_smoke.py's march rounds on the n=10 tile (``tiles.
  march_rounds``: primary rays from the spawn state and from the first
  round's carried best, bounce-1 rays, and primary rays with every
  superchunk queued, kernel 3's walk entry by entry);
- kernel 2: 393216 shadow rays (the regen wavefront) from the hits around
  the middle of a 1080p frame toward sampled light points, on the demo
  and on the grid (its 376 flat chunks);
- kernel 1: the demo's middle tile, primary rays and bounce-1 rays;
  kernel 4: that tile's bounce-1 rays with the shadow rays of its primary
  hits; kernel 10: its camera paths at bounce 0 and bounce 1, without and
  with NEE (with it, both of its walks);
- kernel 11: the middle tile's camera paths, 5 bounces, on the demo and on
  the mid grid (n=4, 34 chunks walked flat).
Per tile it also prints the tests the rays need, the thread-slots of one
thread per ray and of the block-cooperative walks (every kernel timed:
``ops.intersect.two_level_slots``, ``any_hit_slots``), and the bound of
chip_smoke.py (kernels 10 and 11 without their shading operations).
``--only`` keeps the named kernels (C entry names). The last line is one
JSON object with every time.

Needs one CUDA device and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ITERS = 20
# Each C entry point: its source and its operands (pointers, ints, floats;
# then the stream).
ENTRIES = {"closest_hit_rows": (8, 2, 0), "closest_hit_sc_lite": (8, 3, 0),
           "closest_hit_rows_sc": (9, 3, 0), "march_step_sc": (10, 4, 0),
           "occlusion": (9, 2, 0), "closest_hit_rows_nee": (13, 2, 0),
           "mega_step": (11, 6, 8), "fused_paths": (11, 3, 7)}
PEAK_FP32 = 67e12  # float32 outside the tensor cores, H100 SXM at 700 W
OPS_PER_TEST, OPS_PER_SLAB = 45, 25  # as chip_smoke.py


def build(label: str, csrc: Path, out_dir: Path, names) -> dict:
    """nvcc every kernel of ``names`` from ``csrc`` in parallel; by name, a
    function that launches it on the current stream with the tensors'
    pointers, the ints and the floats, and raises if the launch was
    refused."""
    import torch

    from gdpathtracing_torch.ops.build import NVCC_FLAGS, nvcc_path

    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        so = out_dir / f"{name}-{label}.so"
        procs[name] = (so, subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(so),
             str(csrc / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed on {csrc / name}.cu:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {label} {name}: {line.strip()}")
        n_ptrs, n_ints, n_floats = ENTRIES[name]
        fn = getattr(ctypes.CDLL(str(so)), name)
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints \
            + [ctypes.c_float] * n_floats + [ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def launch(tensors, ints, floats, fn=fn, name=name):
            err = fn(*(t.data_ptr() for t in tensors), *ints, *floats,
                     torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"{label} {name}: cudaError {err}")

        fns[name] = launch
    return fns


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    metavar="NAME=DIR",
                    help="another csrc directory, timed against this one")
    ap.add_argument("--only", nargs="+", choices=sorted(ENTRIES),
                    default=sorted(ENTRIES), help="the kernels to time")
    args = ap.parse_args()
    others = [tuple(o.split("=", 1)) for o in args.other]
    if not others:
        sys.exit("give at least one --other NAME=DIR")

    import torch

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this needs a GPU")
    sys.path.insert(0, str(ROOT))
    from gdpathtracing_torch.config import RenderConfig, Traversal
    from gdpathtracing_torch.ops import fused as fu
    from gdpathtracing_torch.ops import intersect as ti
    from gdpathtracing_torch.ops import megakernel as mk
    from gdpathtracing_torch.ops import tiles as kt
    from gdpathtracing_torch.scene.demo import (build_demo_scene,
                                                build_sphere_grid,
                                                demo_camera, grid_camera)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card (nvidia-smi --query-gpu=name,power.limit): {card}")
    out_dir = ROOT / "build" / "turns"
    builds = {"change": build("change", ROOT / "gdpathtracing_torch" / "csrc",
                              out_dir, args.only)}
    for label, d in others:
        builds[label] = build(label, Path(d).resolve(), out_dir, args.only)
    order = [label for label, _ in others]
    order = order + ["change", "change"] + order[::-1]

    cfg = RenderConfig(traversal=Traversal.PALLAS)
    tile = cfg.tile_rays
    first = kt.middle_tile(cfg)
    W, H = kt.W, kt.H

    # (kernel, scene label, rays label, input tensors, outputs (shapes and
    # dtypes), ints, floats, plain outputs, tests, slab tests, cooperative
    # slots or None, thread-per-ray slots or None)
    tiles = []

    def two_level_tiles(name, n_grid):
        scene = build_sphere_grid(n=n_grid, sphere_detail=16)
        prep = ti.prepare_trace_inputs(scene)
        primary, hit, s, seed = kt.middle_rays(
            scene, grid_camera(W, H, n=n_grid), prep, cfg, tile, first)
        bounce, active = kt.bounce_rays(s, hit, seed, cfg)
        if name == "march_step_sc":
            march_tiles(prep, primary, bounce, active)
            return
        geo = (prep.sc_bounds, prep.chunk_bounds, prep.mu_pad, prep.mv_pad,
               prep.mw_pad)
        e = prep.mu_pad.shape[1]
        for what, (o4t, d4t) in {"primary": ti.pack_rays(primary, None),
                                 "bounce 1": ti.pack_rays(bounce, active)
                                 }.items():
            n = o4t.shape[1]
            if name == "closest_hit_sc_lite":
                tens, rows = (o4t, d4t, *geo), ti.LITE_R
                want = ti.closest_hit_sc_lite_plain(o4t, d4t, *geo, prep.scc)
            else:
                tens, rows = (o4t, d4t, *geo, prep.tab), ti.OUT_R
                want = ti.closest_hit_rows_sc_plain(o4t, d4t, *geo, prep.tab,
                                                    prep.scc)
            work = ti.walk_two_level_plain(o4t, d4t, *geo, prep.scc)
            tiles.append((name, f"n={n_grid} grid", what, tens,
                          [((rows, n), torch.float32)], (n, e, prep.scc), (),
                          [want], float(work.walk.steps.sum()),
                          float(work.slab_tests.sum()),
                          float(work.slots[::ti.BN].sum()),
                          float(work.chunk_sweeps[::ti.BN].sum())
                          * ti.BN * ti.BT))

    def march_tiles(prep, primary, bounce, active):
        """Kernel 7's rounds of chip_smoke.py phase 2 (ops/tiles.py
        ``march_rounds``); the full queue also with kernel 3 on its rays."""
        e = prep.mu_pad.shape[1]
        geo = (prep.sc_bounds, prep.chunk_bounds, prep.mu_pad, prep.mv_pad,
               prep.mw_pad)
        for rd in kt.march_rounds(prep, primary, bounce, active, cfg):
            n = rd.o4t.shape[1]
            tens = (rd.o4t, rd.d4t, rd.init, rd.queue, *geo)
            counts = {}
            want = ti.march_step_sc_plain(*tens, prep.scc, counts=counts)
            tiles.append(("march_step_sc", "n=10 grid", rd.what, tens,
                          [((ti.LITE_R, n), torch.float32)],
                          (n, e, prep.scc, rd.queue.shape[0] // (n // ti.BN)),
                          (), [want], float(want[2].sum()),
                          counts["slab_tests"], counts["slots"],
                          counts["thread_slots"]))

    def occlusion_tiles():
        for label, scene, cam in (
                ("demo", build_demo_scene(), demo_camera(W, H)),
                ("n=10 grid", build_sphere_grid(n=10, sphere_detail=16),
                 grid_camera(W, H, n=10))):
            prep = ti.prepare_trace_inputs(scene)
            tens, _ = kt.wavefront_shadow_rays(scene, cam, prep, cfg)
            n, e = tens[0].shape[1], prep.mu.shape[1]
            counts = {}
            want = ti.occluded_plain(*tens, counts=counts)
            tiles.append(("occlusion", label, "shadow rays", tens,
                          [((n,), torch.int32)], (n, e), (), [want.occ],
                          float(want.tests.sum()), counts["slab_tests"],
                          counts["slots"], counts["thread_slots"]))

    def flat_tiles(name):
        scene = build_demo_scene()
        cam = demo_camera(W, H)
        prep = ti.prepare_trace_inputs(scene)
        e, nc = prep.mu.shape[1], prep.mu.shape[1] // ti.BT
        if name == "closest_hit_rows":
            for what, tens in kt.rows_tiles(scene, cam, prep, cfg).items():
                n = tens[0].shape[1]
                counts = {}
                want = ti.closest_hit_rows_plain(*tens, counts=counts)
                tiles.append((name, "demo", what, tens,
                              [((ti.OUT_R, n), torch.float32)], (n, e), (),
                              [want], float(want[45].sum()), float(n * nc),
                              counts["slots"], counts["thread_slots"]))
            return
        if name == "closest_hit_rows_nee":
            _, hit, s, seed = kt.middle_rays(scene, cam, prep, cfg, tile,
                                             first)
            bounce, active = kt.bounce_rays(s, hit, seed, cfg)
            pend = kt.shadow_queries(s, hit, seed, prep, cfg)
            tens = kt.rows_nee_operands(prep, bounce, active, pend)
            n = tens[0].shape[1]
            counts = {}
            rows_p, occ_p = ti.closest_hit_rows_nee_plain(*tens,
                                                          counts=counts)
            tiles.append((name, "demo", "bounce 1 + shadow rays", tens,
                          [((ti.OUT_R, n), torch.float32),
                           ((n,), torch.int32)], (n, e), (), [rows_p, occ_p],
                          counts["tests"], counts["slab_tests"],
                          counts["slots"], counts["thread_slots"]))
            return
        # Kernel 10: the camera paths at bounce 0 and, from the plain
        # version's state, bounce 1, without and with NEE.
        cray, pseed = kt.camera_rays(cam, cfg, tile, first, prep.mu.device)
        for nee in (False, True):
            mcfg = cfg.replace(traversal=Traversal.MEGA, nee=nee)
            lt = mk._build_light_block(prep.lights if nee else None,
                                       prep.mu.device)
            geo = (prep.bounds, prep.sub_bounds, prep.mu, prep.mv, prep.mw,
                   prep.tab, lt)
            state = mk.pack_state(cray, pseed, cam.far)
            n = state[0].shape[1]
            for b in (0, 1):
                counts = {}
                want = mk.mega_step_plain(*state, *geo, b, mcfg,
                                          counts=counts)
                tiles.append((name, "demo",
                              f"camera paths, bounce {b}"
                              + (", NEE" if nee else ""), (*state, *geo),
                              [(tuple(state[0].shape), torch.float32),
                               (tuple(state[1].shape), torch.int32)],
                              (n, e, lt.shape[0], b, int(nee),
                               mcfg.rr_start),
                              (mcfg.ray_eps, mcfg.rr_min_p,
                               *mk.sky_constants(mcfg)),
                              list(want), counts["tests"],
                              float((2 if nee else 1) * n * nc),
                              counts["slots"], counts["thread_slots"]))
                state = want

    def fused_tiles():
        fcfg = cfg.replace(traversal=Traversal.FUSED)
        for label, scene, cam in (
                ("demo", build_demo_scene(), demo_camera(W, H)),
                ("mid grid", build_sphere_grid(n=4, sphere_detail=12),
                 grid_camera(W, H, n=4))):
            prep = ti.prepare_trace_inputs(scene)
            tens = kt.fused_operands(scene, cam, prep, cfg)
            n, e = tens[0].shape[1], prep.mu.shape[1]
            counts = {}
            want = fu.fused_paths_plain(*tens, fcfg, counts=counts)
            tiles.append(("fused_paths", label, "camera paths, 5 bounces",
                          tens, [((7, n), torch.float32),
                                 ((n,), torch.int32)],
                          (n, e, fcfg.bounces),
                          (fcfg.ray_eps, *mk.sky_constants(fcfg)), list(want),
                          counts["tests"],
                          float(fcfg.bounces * n * (e // ti.BT)),
                          counts["slots"], counts["thread_slots"]))

    for name in args.only:
        if name in ("closest_hit_sc_lite", "march_step_sc"):
            two_level_tiles(name, 10)
        elif name == "closest_hit_rows_sc":
            two_level_tiles(name, 14)
        elif name == "occlusion":
            occlusion_tiles()
        elif name == "fused_paths":
            fused_tiles()
        else:
            flat_tiles(name)

    def cuda_ms(fn):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ITERS):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / ITERS

    results = []
    for (name, where, what, tens, out_spec, ints, floats, want, needed,
         slabs, coop, per_ray) in tiles:
        dev = tens[0].device
        outs = [torch.empty(shape, dtype=dt, device=dev)
                for shape, dt in out_spec]
        for label, fns in builds.items():
            for o in outs:
                o.fill_(-1)
            fns[name](tens + tuple(outs), ints, floats)
            torch.cuda.synchronize()
            for o, w in zip(outs, want):
                if not torch.equal(o.view(torch.int32), w.view(torch.int32)):
                    sys.exit(f"{label} {name}, {where} {what}: differs from "
                             f"the plain version")
        ms = {label: [] for label in builds}
        for label in order:
            ms[label].append(cuda_ms(
                lambda f=builds[label][name]: f(tens + tuple(outs), ints,
                                                floats)))
        n = tens[0].shape[-1]
        bound_ms = (needed * OPS_PER_TEST + slabs * OPS_PER_SLAB) \
            / PEAK_FP32 * 1e3
        row = dict(kernel=name, scene=where, rays=what, n=n,
                   ms={k: sum(v) / len(v) for k, v in ms.items()},
                   ms_turns=ms, tests=needed, slab_tests=slabs,
                   slots_cooperative=coop, slots_thread_per_ray=per_ray,
                   bound_ms=bound_ms)
        results.append(row)
        times = ", ".join(f"{k} {v:.4f}" for k, v in row["ms"].items())
        shares = []
        if coop is not None:
            shares.append(f"{needed / max(coop, 1.0):.3f} cooperative")
        if per_ray is not None:
            shares.append(f"{needed / max(per_ray, 1.0):.3f} thread per ray")
        print(f"{name}, {where}, {what} ({n} rays) on {card}: {times} ms "
              f"(turns {order}); bound {bound_ms:.4f} ms; {needed:.4g} tests"
              + (f", useful share of thread-slots {', '.join(shares)}"
                 if shares else ""))
    print(json.dumps({"card": card, "turns": order, "tiles": results}))


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"done in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
