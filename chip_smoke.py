#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (gdpathtracing_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit on failure:

1. builds the three CUDA kernels from csrc/ with nvcc, in parallel, and
   prints ptxas' registers, shared memory and spills;
2. holds each kernel against its plain PyTorch version on the demo scene at
   the main paths' shapes, bit for bit, and times both with CUDA events:
   - kernel 1 (closest hit): primary rays of the 262144-ray tile through
     the middle of a 1080p frame, then one bounce of BRDF-sampled rays
     from their hits;
   - kernel 2 (occlusion): 393216 shadow rays (the regen wavefront) from
     the hits around the middle of the frame toward sampled light points;
   - kernel 4 (both in one pass): the middle tile's bounce-1 rays with the
     shadow rays of its primary hits;
3. renders 1920x1080 demo frames (1 spp, 5 bounces) through render_radiance
   for each main path, with every launch count and the regen iteration
   count set to 0 just before and read just after: the standard loop
   (regen=False), the default regen loop, regen with NEE and the standard
   loop with NEE; checks the launches against the regen iterations and the
   tiles, and prints ms/frame and Msegments/s. Then it traces one more
   frame of the path with torch.profiler and prints the device kernels
   launched, the device's busy time (the union of their intervals), the
   share of it in each traversal kernel, the largest other kernels, and
   the device's idle share of the median frame;
4. renders 64x48 on the GPU and on the CPU for each of those paths, and
   compares each pair.

The last line of standard output is a JSON object with the device; the line
before it lists each kernel with its launches, error, times and bound.
Needs one CUDA device and imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
W, H = 1920, 1080
SMALL_W, SMALL_H, SMALL_FRAME = 64, 48, 3
KERNEL_ITERS, PLAIN_ITERS = 20, 2
# The card's peaks (NVIDIA H100 SXM data sheet, at 700 W): float32 outside
# the tensor cores, and HBM3.
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12
# Float operations one ray-triangle test needs (csrc/trace_common.cuh
# `intersect` and its tests) for rays (o, 1) and (d, 0): three origin dot
# products (3 mul + 3 add each), three direction ones (3 mul + 2 add), one
# division, u and v (2 mul + 2 add), u + v, and 6 comparisons (|w_d|,
# t > 0, t against the best t or t_max, u, v, u + v).
OPS_PER_TEST = 45
# One slab test: 6 sub, 6 mul, 10 min/max, 3 comparisons.
OPS_PER_SLAB = 25


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond, msg: str):
    if not cond:
        fail(msg)


def log(msg: str):
    print(msg, flush=True)


def cuda_ms(fn, iters: int, torch) -> float:
    """Mean milliseconds per call, by CUDA events around `iters` calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(tests: float, slabs: float, n_bytes: float):
    """(ms, what sets it): the least time for `tests` ray-triangle tests
    and `slabs` slab tests against moving `n_bytes` once."""
    t_ops = (tests * OPS_PER_TEST + slabs * OPS_PER_SLAB) / PEAK_FP32
    t_bytes = n_bytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def busy_ms(events) -> float:
    """Length of the union of the profiler events' device intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in events):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def compare_frames(a, b, what: str):
    """The CPU parity tolerance of tests/test_torch_render.py: radiance
    within 1e-4 on >= 99% of pixels, segments equal on those pixels, depth
    within rtol 1e-5 there."""
    import numpy as np
    ra, rb = a.radiance.cpu().numpy(), b.radiance.cpu().numpy()
    ok = (np.abs(ra - rb) <= 1e-4).all(axis=-1)
    frac = float(ok.mean())
    log(f"{what}: radiance within 1e-4 on {frac:.4f} of pixels")
    check(frac >= 0.99, f"{what}: only {frac:.4f} of pixels agree")
    check((a.segments.cpu().numpy()[ok] == b.segments.cpu().numpy()[ok])
          .all(), f"{what}: segments differ on agreeing pixels")
    da, db = a.depth.cpu().numpy()[ok], b.depth.cpu().numpy()[ok]
    check(np.allclose(da, db, rtol=1e-5, atol=0), f"{what}: depth differs")


def main() -> None:
    import torch

    jax_preloaded = "jax" in sys.modules
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    sys.path.insert(0, str(HERE))
    try:
        import gdpathtracing_torch
    except ImportError as e:
        fail(f"the gdpathtracing_torch package is not beside {HERE}: {e}")
    check(Path(gdpathtracing_torch.__file__).resolve().parent.parent == HERE,
          f"imported gdpathtracing_torch from {gdpathtracing_torch.__file__}"
          f", not from {HERE}")

    from gdpathtracing_torch.config import RenderConfig, Traversal
    from gdpathtracing_torch.core import rng
    from gdpathtracing_torch.ops import intersect as ti
    from gdpathtracing_torch.ops.build import KERNELS, load_libraries
    from gdpathtracing_torch.render import brdf
    from gdpathtracing_torch.render.integrator import sample_direct
    from gdpathtracing_torch.render.regen import render_radiance_regen
    from gdpathtracing_torch.render.renderer import render_radiance
    from gdpathtracing_torch.render.shading import shading_from_rows
    from gdpathtracing_torch.render.types import Ray
    from gdpathtracing_torch.scene.demo import build_demo_scene, demo_camera

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    log("card (nvidia-smi --query-gpu=name,power.limit), next line:")
    log(card)

    # -- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    libs = load_libraries(KERNELS)
    log(f"built {len(libs)} kernels in parallel in "
        f"{time.perf_counter() - t0:.2f} s")
    for lib in libs:
        log(f"  {lib.path.name}: nvcc {lib.build_seconds:.2f} s")
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"    ptxas: {line.strip()}")

    # -- 2. each kernel against its plain version ---------------------------
    cfg = RenderConfig(traversal=Traversal.PALLAS)
    scene = build_demo_scene()
    check(scene.device.type == "cuda", "the scene is not on the card")
    dev = scene.device
    cam = demo_camera(W, H)
    prep = ti.prepare_trace_inputs(scene)
    e = prep.mu.shape[1]
    nc = e // ti.BT
    scene_bytes = (3 * 4 * e + 8 * nc + 8 * ti.SUB * nc) * 4
    tab_bytes = ti.TAB_R * e * 4

    def middle_rays(n, first):
        """Primary rays of pixels [first, first + n) (the top rows see no
        geometry), their hits, shading and RNG streams."""
        pids = torch.arange(n, device=dev) + first
        seed = rng.prng_seed(pids % W,
                             torch.div(pids, W, rounding_mode="floor"), 0)
        ray, seed = cam.to(dev).generate_rays(pids, seed, cfg)
        hit = ti.trace_pallas(scene, ray, None, prep)
        return ray, hit, shading_from_rows(scene, hit, ray), seed

    report = {}

    def record(name, err, k, p, bnd, what):
        r = report.setdefault(name, dict(err=0.0, ms=[], plain_ms=[],
                                         bound_ms=[], bound_by=what))
        r["err"] = max(r["err"], err)
        r["ms"].append(k)
        r["plain_ms"].append(p)
        r["bound_ms"].append(bnd)
        log(f"  {name} on {card}: kernel {k:.4f} ms, plain {p:.4f} ms, "
            f"bound {bnd:.4f} ms ({what}), {bnd / k:.3f} of the bound")

    # Kernel 1 at the standard loop's tile through the middle of the frame:
    # primary and bounce-1 rays.
    tile = cfg.tile_rays
    primary, hit, s, seed = middle_rays(tile, (W * H // 2) // tile * tile)
    (r1, r2), seed1 = rng.pcg2d(seed)
    bounce = Ray(s.position + s.normal * cfg.ray_eps,
                 brdf.sample_brdf(s, r1, r2))
    for name, (ray, active) in {"primary": (primary, None),
                                "bounce 1": (bounce, hit.hit)}.items():
        o4t, d4t = ti.pack_rays(ray, active)
        n = o4t.shape[1]
        args = (o4t, d4t, prep.bounds, prep.mu, prep.mv, prep.mw, prep.tab)
        got = ti.closest_hit_rows(*args)
        want = ti.closest_hit_rows_plain(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        n_hit = int((want[40] < ti._MISS).sum())
        check(n_hit > n // 10, f"{name}: only {n_hit} rays hit")
        log(f"kernel 1 vs plain, {name} rays ({n}, {n_hit} hit): "
            f"max |diff| {err:g} over rows 0-47")
        check(torch.equal(got, want), f"kernel 1, {name}: rows differ from "
              f"the plain version")
        check(torch.equal(got[40].view(torch.int32),
                          want[40].view(torch.int32)),
              f"kernel 1, {name}: t is not bitwise equal")
        # Work: ray-triangle tests the rays needed (row 45) against the
        # thread-slots the kernel spent (every lane of a block sweeps each
        # chunk any lane of it needs: row 46 x 256 rays x 256 triangles).
        needed = float(want[45].sum())
        spent = float(want[46, ::ti.BN].sum()) * ti.BN * ti.BT
        k = cuda_ms(lambda: ti.closest_hit_rows(*args), KERNEL_ITERS, torch)
        p = cuda_ms(lambda: ti.closest_hit_rows_plain(*args), PLAIN_ITERS,
                    torch)
        log(f"  {needed:.4g} ray-triangle tests needed, {spent:.4g} "
            f"thread-slots swept ({needed / max(spent, 1.0):.3f} useful)")
        record("closest_hit_rows", err, k, p, *bound(
            needed, n * nc, 8 * 4 * n + scene_bytes + tab_bytes
            + ti.OUT_R * 4 * n))

    # Kernel 4 at the same tile: its bounce-1 launch, which resolves the
    # shadow queries posted from the primary hits.
    pend, _ = sample_direct(s, s.position * 0.0 + 1.0, hit.hit, seed,
                            prep.lights, cfg)
    o4t, d4t = ti.pack_rays(bounce, hit.hit)
    so4t, sd4t, stmax = ti.pack_shadow_rays(pend.shadow, pend.active,
                                             pend.tmax)
    args = (o4t, d4t, so4t, sd4t, stmax, prep.bounds, prep.sub_bounds,
            prep.mu, prep.mv, prep.mw, prep.tab)
    n = o4t.shape[1]
    rows, occ = ti.closest_hit_rows_nee(*args)
    rows_p, occ_p = ti.closest_hit_rows_nee_plain(*args)
    torch.cuda.synchronize()
    flips = int((occ != occ_p).sum())
    err = max(float((rows - rows_p).abs().max()), float(flips))
    log(f"kernel 4 vs plain, bounce-1 tile ({n} rays, "
        f"{int(pend.active.sum())} shadow queries, "
        f"{int(occ_p.sum())} occluded): max |diff| {err:g}, "
        f"{flips} occlusion mismatches")
    check(torch.equal(rows, rows_p) and flips == 0,
          "kernel 4 differs from its plain version")
    shadow = ti.occluded_plain(so4t, sd4t, stmax, prep.bounds,
                               prep.sub_bounds, prep.mu, prep.mv, prep.mw)
    needed = float(rows_p[45].sum()) + float(shadow.tests.sum())
    k = cuda_ms(lambda: ti.closest_hit_rows_nee(*args), KERNEL_ITERS, torch)
    p = cuda_ms(lambda: ti.closest_hit_rows_nee_plain(*args), PLAIN_ITERS,
                torch)
    log(f"  {needed:.4g} ray-triangle tests needed (both phases)")
    record("closest_hit_rows_nee", err, k, p, *bound(
        needed, 2 * n * nc, 17 * 4 * n + scene_bytes + tab_bytes
        + (ti.OUT_R + 1) * 4 * n))

    # Kernel 2 at the regen wavefront.
    _, hit2, s2, seed2 = middle_rays(cfg.regen_wavefront,
                                     (W * H - cfg.regen_wavefront) // 2)
    pend2, _ = sample_direct(s2, s2.position * 0.0 + 1.0, hit2.hit, seed2,
                             prep.lights, cfg)
    o4t, d4t, tlim = ti.pack_shadow_rays(pend2.shadow, pend2.active,
                                           pend2.tmax)
    args = (o4t, d4t, tlim, prep.bounds, prep.sub_bounds, prep.mu, prep.mv,
            prep.mw)
    n = o4t.shape[1]
    got = ti.occluded(*args)
    want = ti.occluded_plain(*args)
    torch.cuda.synchronize()
    flips = int((got != want.occ).sum())
    n_q = int(pend2.active.sum())
    log(f"kernel 2 vs plain, {n} shadow rays ({n_q} queries, "
        f"{int(want.occ.sum())} occluded, share "
        f"{int(want.occ.sum()) / max(n_q, 1):.3f}): {flips} mismatches")
    check(flips == 0, "kernel 2 differs from its plain version")
    check(0 < int(want.occ.sum()) < n_q, "kernel 2: a one-sided answer")
    needed = float(want.tests.sum())
    k = cuda_ms(lambda: ti.occluded(*args), KERNEL_ITERS, torch)
    p = cuda_ms(lambda: ti.occluded_plain(*args), PLAIN_ITERS, torch)
    log(f"  {needed:.4g} ray-triangle tests needed "
        f"({needed / max(n_q, 1):.1f} per query)")
    record("occluded", float(flips), k, p, *bound(
        needed, n * nc, 10 * 4 * n + scene_bytes))

    # -- 3. the main paths at 1080p -----------------------------------------
    kernels = {"closest_hit_rows": ti.closest_hit_rows,
               "occluded": ti.occluded,
               "closest_hit_rows_nee": ti.closest_hit_rows_nee}
    launches = dict.fromkeys(kernels, 0)
    n_tiles = -(-(W * H) // cfg.tile_rays)
    paths = [  # (name, config, frames)
        ("standard loop", cfg.replace(regen=False), 2),
        ("regen", cfg, 3),
        ("regen + NEE", cfg.replace(nee=True), 3),
        ("standard loop + NEE", cfg.replace(nee=True, regen=False), 3)]
    # Each wrapper's source (csrc/) and the line of the TPU kernel it
    # replaces in gdpathtracing_tpu/ops/intersect_pallas.py; the source
    # `x.cu` defines the kernel `x_kernel`.
    sources = {"closest_hit_rows": ("closest_hit_rows.cu", 520),
               "occluded": ("occlusion.cu", 1662),
               "closest_hit_rows_nee": ("closest_hit_rows_nee.cu", 613)}
    kernel_symbols = {k: Path(src).stem + "_kernel"
                      for k, (src, _) in sources.items()}
    for name, pcfg, frames in paths:
        regen = pcfg.regen is not False
        for fn in kernels.values():
            fn.launches = 0
        render_radiance_regen.iterations = 0
        torch.cuda.synchronize()
        frame_s, segs = [], []
        for f in range(frames):
            t0 = time.perf_counter()
            aovs = render_radiance(scene, cam, pcfg, f)
            torch.cuda.synchronize()
            frame_s.append(time.perf_counter() - t0)
            check(aovs.radiance.shape == (H, W, 3), f"{name}: shape")
            check(bool(torch.isfinite(aovs.radiance).all()),
                  f"{name}, frame {f}: non-finite radiance")
            seg = int(aovs.segments.sum())
            check(seg >= W * H, f"{name}, frame {f}: {seg} segments")
            segs.append(seg)
        got = {k: fn.launches for k, fn in kernels.items()}
        iters = render_radiance_regen.iterations
        check(iters > 0 if regen else iters == 0,
              f"{name}: render_radiance ran {iters} regen iterations")
        nee = pcfg.nee
        if regen:
            want = {"closest_hit_rows": iters,
                    "occluded": iters if nee else 0,
                    "closest_hit_rows_nee": 0}
        else:
            want = {"closest_hit_rows": 0 if nee else
                    frames * n_tiles * pcfg.bounces,
                    "occluded": frames * n_tiles if nee else 0,
                    "closest_hit_rows_nee": frames * n_tiles * pcfg.bounces
                    if nee else 0}
        log(f"{name}: launches {got}" + (f", {iters} regen iterations"
                                         if regen else ""))
        check(got == want, f"{name}: launches {got}, expected {want}")
        for k in kernels:
            launches[k] += got[k]
        for f, (t, seg) in enumerate(zip(frame_s, segs)):
            log(f"  frame {f}: {t * 1e3:.1f} ms, {seg} segments, "
                f"{seg / t / 1e6:.2f} Msegments/s")
        steady = statistics.median(frame_s[1:])
        log(f"1080p demo, {name}, 1 spp, 5 bounces: median of frames 1-"
            f"{frames - 1} {steady * 1e3:.1f} ms/frame, "
            f"{statistics.median(segs[1:]) / steady / 1e6:.2f} "
            f"Msegments/s; radiance mean {float(aovs.radiance.mean()):.5f};"
            f" on {card}")

        # One more frame under torch.profiler: where the device time goes.
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            render_radiance(scene, cam, pcfg, frames)
            torch.cuda.synchronize()
        on_card = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if not on_card:
            log(f"  {name}: the profiler saw no device time; busy time and "
                f"idle share not measured")
            continue
        busy = busy_ms(on_card)
        idle = 1.0 - busy / (steady * 1e3)
        log(f"  profiled frame: {len(on_card)} device kernels, busy "
            f"{busy:.2f} ms, idle share of the median frame {idle:.3f}")
        check(idle >= 0.0, f"{name}: the device was busy {busy:.2f} ms in "
              f"a {steady * 1e3:.1f} ms frame: the measurement is broken")
        by_name = {}
        for e in on_card:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
        for k, sym in kernel_symbols.items():
            t = sum(v for n, v in by_name.items() if sym in n)
            if t:
                log(f"    {k}: {t:.2f} ms ({t / busy:.3f} of busy)")
        rest = sorted(((v, n) for n, v in by_name.items() if not any(
            sym in n for sym in kernel_symbols.values())), reverse=True)
        for v, n in rest[:4]:
            log(f"    {v:8.2f} ms  {n[:100]}")
    for k, n_launch in launches.items():
        check(n_launch > 0, f"{k} was not launched on the main paths")

    # -- 4. GPU against CPU at 64x48 ----------------------------------------
    small = demo_camera(SMALL_W, SMALL_H)
    on_cpu = scene.to("cpu")
    for name, pcfg, _ in paths:
        compare_frames(render_radiance(scene, small, pcfg, SMALL_FRAME),
                       render_radiance(on_cpu, small, pcfg, SMALL_FRAME),
                       f"{SMALL_W}x{SMALL_H} {name}, cuda vs cpu")

    check(not any(m == "gdpathtracing_tpu" or m.startswith(
        "gdpathtracing_tpu.") for m in sys.modules),
        "the JAX package was imported")
    check(jax_preloaded or "jax" not in sys.modules, "jax was imported")
    log(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"gdpathtracing_torch/csrc/{sources[name][0]}",
        "replaces": "gdpathtracing_tpu/ops/intersect_pallas.py:"
                    f"{sources[name][1]}",
        "launches": launches[name],
        "max_abs_err": r["err"],
        "ms": statistics.mean(r["ms"]),
        "plain_ms": statistics.mean(r["plain_ms"]),
        "bound_ms": statistics.mean(r["bound_ms"]),
        "bound_by": r["bound_by"],
        "library_ms": None,
    } for name, r in report.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
