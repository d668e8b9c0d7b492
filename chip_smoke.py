#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (gdpathtracing_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit on failure:

1. builds the CUDA kernel of the main path from csrc/ with nvcc;
2. holds the kernel against its plain PyTorch version on the demo scene at
   the main path's shapes (primary rays of the middle 262144-ray tile of a
   1080p frame, then one
   bounce of BRDF-sampled rays from their hits), and times both;
3. renders 1920x1080 frames of the demo scene through render_radiance
   (Traversal.PALLAS, regen=False, 1 spp, 5 bounces) on the GPU and counts
   the kernel launches of that run;
4. renders 64x48 on the GPU and on the CPU and compares the two.

The last line of standard output is a JSON object with the device; the line
before it lists each kernel with its launches, error and times. Needs one
CUDA device and imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
W, H, FRAMES = 1920, 1080, 3
SMALL_W, SMALL_H, SMALL_FRAME = 64, 48, 3
KERNEL_ITERS, PLAIN_ITERS = 20, 3


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
    from gdpathtracing_torch.ops.build import load_library
    from gdpathtracing_torch.render import brdf
    from gdpathtracing_torch.render.renderer import render_radiance
    from gdpathtracing_torch.render.shading import shading_from_rows
    from gdpathtracing_torch.render.types import Ray
    from gdpathtracing_torch.scene.demo import build_demo_scene, demo_camera

    dev = torch.device("cuda", 0)
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
    lib = load_library("closest_hit_rows")
    log(f"built {lib.path.name} in {lib.build_seconds:.2f} s")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"  ptxas: {line.strip()}")

    # -- 2. kernel against its plain version --------------------------------
    cfg = RenderConfig(traversal=Traversal.PALLAS, regen=False)
    scene = build_demo_scene().to(dev)
    cam = demo_camera(W, H)
    prep = ti.prepare_trace_inputs(scene)
    # The tile through the middle of the frame (the top tile sees no
    # geometry).
    mid_tile = (W * H // 2) // cfg.tile_rays
    pids = torch.arange(cfg.tile_rays, device=dev) + mid_tile * cfg.tile_rays
    seed = rng.prng_seed(pids % W, torch.div(pids, W, rounding_mode="floor"),
                         0)
    primary, seed = cam.to(dev).generate_rays(pids, seed, cfg)
    hit = ti.trace_pallas(scene, primary, None, prep)
    s = shading_from_rows(scene, hit, primary)
    (r1, r2), seed = rng.pcg2d(seed)
    bounce = Ray(s.position + s.normal * cfg.ray_eps,
                 brdf.sample_brdf(s, r1, r2))
    ray_sets = {"primary": (primary, None), "bounce 1": (bounce, hit.hit)}

    max_err, ms, plain_ms = 0.0, [], []
    for name, (ray, active) in ray_sets.items():
        o4t, d4t = ti.pack_rays(ray, active)
        args = (o4t, d4t, prep.bounds, prep.mu, prep.mv, prep.mw, prep.tab)
        got = ti.closest_hit_rows(*args)
        want = ti.closest_hit_rows_plain(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        n_hit = int((want[40] < ti._MISS).sum())
        check(n_hit > o4t.shape[1] // 10, f"{name}: only {n_hit} rays hit")
        log(f"kernel vs plain, {name} rays ({o4t.shape[1]}, {n_hit} hit): "
            f"max |diff| {err:g} over rows 0-47")
        check(torch.equal(got, want), f"{name}: kernel rows differ from "
              f"the plain version")
        check(torch.equal(got[40].view(torch.int32),
                          want[40].view(torch.int32)),
              f"{name}: t is not bitwise equal")
        k = cuda_ms(lambda: ti.closest_hit_rows(*args), KERNEL_ITERS, torch)
        p = cuda_ms(lambda: ti.closest_hit_rows_plain(*args), PLAIN_ITERS,
                    torch)
        ms.append(k)
        plain_ms.append(p)
        log(f"  time per call on {card}: kernel {k:.4f} ms, "
            f"plain {p:.4f} ms")
        # Work: ray-triangle tests the rays needed (row 45) against the
        # thread-slots the kernel spent (every lane of a block sweeps each
        # chunk any lane of it needs: row 46 x 256 rays x 256 triangles).
        needed = float(want[45].sum())
        spent = float(want[46, ::ti.BN].sum()) * ti.BN * ti.BT
        log(f"  {needed:.4g} ray-triangle tests needed, {spent:.4g} "
            f"thread-slots swept ({needed / max(spent, 1.0):.3f} useful); "
            f"{spent / (k * 1e-3) / 1e9:.1f} G slot-tests/s on {card}")

    # -- 3. the main path at 1080p ------------------------------------------
    n_tiles = -(-(W * H) // cfg.tile_rays)
    ti.closest_hit_rows.launches = 0
    torch.cuda.synchronize()
    frame_s, segs = [], []
    for f in range(FRAMES):
        t0 = time.perf_counter()
        aovs = render_radiance(scene, cam, cfg, f)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
        check(aovs.radiance.shape == (H, W, 3), "radiance shape")
        check(bool(torch.isfinite(aovs.radiance).all()),
              f"frame {f}: non-finite radiance")
        seg = int(aovs.segments.sum())
        check(seg >= W * H, f"frame {f}: {seg} segments < {W * H} pixels")
        segs.append(seg)
    launches = ti.closest_hit_rows.launches
    check(launches == FRAMES * n_tiles * cfg.bounces,
          f"{launches} kernel launches for {FRAMES} frames, expected "
          f"{n_tiles * cfg.bounces} per frame")
    for f, (t, seg) in enumerate(zip(frame_s, segs)):
        log(f"frame {f}: {t * 1e3:.1f} ms, {seg} segments, "
            f"{seg / t / 1e6:.2f} Msegments/s on {card}")
    steady = statistics.median(frame_s[1:])
    log(f"1080p demo, PALLAS, 1 spp, 5 bounces: median of frames 1-"
        f"{FRAMES - 1} {steady * 1e3:.1f} ms/frame, "
        f"{statistics.median(segs[1:]) / steady / 1e6:.2f} Msegments/s; "
        f"{launches // FRAMES} kernel launches per frame; on {card}")
    log(f"radiance mean {float(aovs.radiance.mean()):.5f}")

    # -- 4. GPU against CPU at 64x48 ----------------------------------------
    small = demo_camera(SMALL_W, SMALL_H)
    on_gpu = render_radiance(scene, small, cfg, SMALL_FRAME)
    on_cpu = render_radiance(scene.to("cpu"), small, cfg, SMALL_FRAME)
    compare_frames(on_gpu, on_cpu, f"{SMALL_W}x{SMALL_H} cuda vs cpu")

    check(not any(m == "gdpathtracing_tpu" or m.startswith(
        "gdpathtracing_tpu.") for m in sys.modules),
        "the JAX package was imported")
    check(jax_preloaded or "jax" not in sys.modules, "jax was imported")
    log(json.dumps({"kernels": [{
        "name": "closest_hit_rows",
        "route": "cuda",
        "source": "gdpathtracing_torch/csrc/closest_hit_rows.cu",
        "replaces": "gdpathtracing_tpu/ops/intersect_pallas.py:520",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": statistics.mean(ms),
        "plain_ms": statistics.mean(plain_ms),
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
