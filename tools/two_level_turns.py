#!/usr/bin/env python3
"""Kernels 3, 6 and 7 of several builds, timed in turns on one GPU.

    python3 tools/two_level_turns.py --other parent=DIR [--other NAME=DIR]

Builds ``closest_hit_sc_lite.cu`` (kernel 3), ``closest_hit_rows_sc.cu``
(kernel 6) and ``march_step_sc.cu`` (kernel 7) from this checkout's
``gdpathtracing_torch/csrc`` ("change") and from each ``DIR`` (another
``csrc`` directory, for example the parent commit's, unpacked with ``git
archive`` into a directory that .gitignore lists), with ops/build.py's
flags, and prints ptxas' registers, shared memory and spills for each.
Then, on the operands of chip_smoke.py phase 2 (the middle 262144-ray
tile of a 1080p frame, primary rays and one BRDF bounce from their hits:
kernel 3 on the bench's sphere grid, n=10; kernel 6 on the n=14 grid;
kernel 7 on the grid with every superchunk queued), it launches every
build's kernel on the same tensors, checks that each output equals the
plain version bit for bit, and times the builds in turns, forward then
backward (other, change, change, other), each with CUDA events over 20
launches. Per tile it also prints the ray-triangle and slab tests the rays
need, the thread-slots of a thread per ray and of the block-cooperative
walk (``ops.intersect.two_level_slots``), and the bound of chip_smoke.py.
The last line is one JSON object with every time.

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
W, H = 1920, 1080
ITERS = 20
NAMES = ("closest_hit_sc_lite", "closest_hit_rows_sc", "march_step_sc")
# Pointer operands of each C entry point (then N, E, scc[, ql], stream).
N_PTRS = {"closest_hit_sc_lite": 8, "closest_hit_rows_sc": 9,
          "march_step_sc": 10}
N_INTS = {"closest_hit_sc_lite": 3, "closest_hit_rows_sc": 3,
          "march_step_sc": 4}
PEAK_FP32 = 67e12  # float32 outside the tensor cores, H100 SXM at 700 W
OPS_PER_TEST, OPS_PER_SLAB = 45, 25  # as chip_smoke.py


def build(label: str, csrc: Path, out_dir: Path) -> dict:
    """nvcc every kernel of NAMES from ``csrc`` in parallel; by name, a
    function that launches it on the current stream with the tensors'
    pointers and the ints, and raises if the launch was refused."""
    import torch

    from gdpathtracing_torch.ops.build import NVCC_FLAGS, nvcc_path

    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in NAMES:
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
        fn = getattr(ctypes.CDLL(str(so)), name)
        fn.argtypes = [ctypes.c_void_p] * N_PTRS[name] \
            + [ctypes.c_int] * N_INTS[name] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def launch(tensors, ints, fn=fn, name=name):
            err = fn(*(t.data_ptr() for t in tensors), *ints,
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
    args = ap.parse_args()
    others = [tuple(o.split("=", 1)) for o in args.other]
    if not others:
        sys.exit("give at least one --other NAME=DIR")

    import torch

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this needs a GPU")
    sys.path.insert(0, str(ROOT))
    from gdpathtracing_torch.config import RenderConfig, Traversal
    from gdpathtracing_torch.core import rng
    from gdpathtracing_torch.ops import intersect as ti
    from gdpathtracing_torch.render import brdf
    from gdpathtracing_torch.render.shading import get_shading_data
    from gdpathtracing_torch.render.types import Ray
    from gdpathtracing_torch.scene.demo import build_sphere_grid, grid_camera

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card (nvidia-smi --query-gpu=name,power.limit): {card}")
    out_dir = ROOT / "build" / "turns"
    builds = {"change": build("change", ROOT / "gdpathtracing_torch" / "csrc",
                              out_dir)}
    for label, d in others:
        builds[label] = build(label, Path(d).resolve(), out_dir)
    order = [label for label, _ in others]
    order = order + ["change", "change"] + order[::-1]

    cfg = RenderConfig(traversal=Traversal.PALLAS)
    tile = cfg.tile_rays
    first = (W * H // 2) // tile * tile

    def tile_rays(scene, cam, prep):
        """The middle tile's primary rays and one BRDF bounce from their
        hits, packed (chip_smoke.py's middle_rays and bounce_rays)."""
        dev = prep.mu_pad.device
        pids = torch.arange(tile, device=dev) + first
        seed = rng.prng_seed(pids % W,
                             torch.div(pids, W, rounding_mode="floor"), 0)
        ray, seed = cam.to(dev).generate_rays(pids, seed, cfg)
        hit = ti.trace_pallas(scene, ray, None, prep)
        s = get_shading_data(scene, hit, ray)
        (r1, r2), _ = rng.pcg2d(seed)
        bounce = Ray(s.position + s.normal * cfg.ray_eps,
                     brdf.sample_brdf(s, r1, r2))
        return {"primary": ti.pack_rays(ray, None),
                "bounce 1": ti.pack_rays(bounce, hit.hit)}

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
    for n_grid, name in ((10, "closest_hit_sc_lite"),
                         (14, "closest_hit_rows_sc"),
                         (10, "march_step_sc")):
        scene = build_sphere_grid(n=n_grid, sphere_detail=16)
        prep = ti.prepare_trace_inputs(scene)
        rays = tile_rays(scene, grid_camera(W, H, n=n_grid), prep)
        geo = (prep.sc_bounds, prep.chunk_bounds, prep.mu_pad, prep.mv_pad,
               prep.mw_pad)
        e = prep.mu_pad.shape[1]
        nsc = prep.sc_bounds.shape[1]
        for what, (o4t, d4t) in rays.items():
            n = o4t.shape[1]
            if name == "closest_hit_sc_lite":
                rows, tens, ints = ti.LITE_R, (o4t, d4t, *geo), (n, e,
                                                                 prep.scc)
                want = ti.closest_hit_sc_lite_plain(o4t, d4t, *geo, prep.scc)
            elif name == "closest_hit_rows_sc":
                rows, tens, ints = ti.OUT_R, (o4t, d4t, *geo, prep.tab), (
                    n, e, prep.scc)
                want = ti.closest_hit_rows_sc_plain(o4t, d4t, *geo, prep.tab,
                                                    prep.scc)
            else:
                init = torch.stack([torch.full((n,), 1e9, device=o4t.device),
                                    torch.full((n,), float(ti.BIG_E),
                                               device=o4t.device)])
                queue = torch.arange(nsc, dtype=torch.int32,
                                     device=o4t.device).repeat(n // ti.BN)
                rows, tens, ints = ti.LITE_R, (o4t, d4t, init, queue, *geo), (
                    n, e, prep.scc, nsc)
                want = ti.march_step_sc_plain(o4t, d4t, init, queue, *geo,
                                              prep.scc)
            out = torch.empty((rows, n), device=o4t.device)
            for label, fns in builds.items():
                out.fill_(float("nan"))
                fns[name](tens + (out,), ints)
                torch.cuda.synchronize()
                if not torch.equal(out.view(torch.int32),
                                   want.view(torch.int32)):
                    sys.exit(f"{label} {name}, {what}: differs from the "
                             f"plain version")
            ms = {label: [] for label in builds}
            for label in order:
                ms[label].append(cuda_ms(
                    lambda f=builds[label][name]: f(tens + (out,), ints)))
            work = ti.walk_two_level_plain(o4t, d4t, *geo, prep.scc)
            needed = float(work.walk.steps.sum())
            slabs = float(work.slab_tests.sum())
            coop = float(work.slots[::ti.BN].sum())
            per_ray = float(work.chunk_sweeps[::ti.BN].sum()) * ti.BN * ti.BT
            bound_ms = (needed * OPS_PER_TEST + slabs * OPS_PER_SLAB) \
                / PEAK_FP32 * 1e3
            row = dict(kernel=name, grid=n_grid, rays=what, n=n,
                       ms={k: sum(v) / len(v) for k, v in ms.items()},
                       ms_turns=ms, tests=needed, slab_tests=slabs,
                       slots_cooperative=coop, slots_thread_per_ray=per_ray,
                       bound_ms=bound_ms)
            results.append(row)
            times = ", ".join(f"{k} {v:.4f}" for k, v in row["ms"].items())
            share = f"{needed / max(per_ray, 1.0):.3f} thread per ray"
            if name != "march_step_sc":  # kernel 7 walks a thread per ray
                share = f"{needed / max(coop, 1.0):.3f} cooperative, {share}"
            print(f"{name} n={n_grid} grid, {what} ({n} rays) on {card}: "
                  f"{times} ms (turns {order}); bound {bound_ms:.4f} ms; "
                  f"{needed:.4g} tests, useful share of thread-slots "
                  f"{share}")
    print(json.dumps({"card": card, "turns": order, "tiles": results}))


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"done in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
