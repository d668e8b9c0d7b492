#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (gdpathtracing_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit on failure:

1. builds the sixteen CUDA kernels (the eleven TPU kernels', the BVH
   traversal's, regen's shading, regen's two lane kernels and the primal
   BVH loop's shading) from the fourteen sources in csrc/ with nvcc, in
   parallel,
   and prints ptxas' registers, shared memory and spills;
2. holds each kernel against its plain PyTorch version at the main paths'
   shapes, bit for bit, and times both with CUDA events:
   - kernel 1 (closest hit): primary rays of the 262144-ray tile through
     the middle of a 1080p demo frame, then one bounce of BRDF-sampled
     rays from their hits, with the thread-slots its block-cooperative
     flat walk spends against one thread per ray's;
   - kernel 2 (occlusion): 393216 shadow rays (the regen wavefront) from
     the hits around the middle of the frame toward sampled light points,
     on the demo and on the grid (its 376 flat chunks), with the
     thread-slots its block-cooperative walk spends against one thread
     per ray's;
   - kernel 4 (both in one launch, on the same two block-cooperative
     walks): the middle tile's bounce-1 rays with the shadow rays of its
     primary hits, with the thread-slots of its walks against one thread
     per ray's;
   - kernel 3 (two-level closest hit, lite) on the sphere grid of the JAX
     bench (n=10, 96256 triangles), and kernel 6 (two-level closest hit
     with rows) on the n=14 grid (188416 triangles, over the reference's
     8 MiB lite threshold): each on the middle 1080p tile's primary rays,
     then one bounce from their hits, with the thread-slots their
     block-cooperative walk spends against one thread per ray's; kernel
     3 also with ``groups_kept``, the share of row 2's tests its group
     gate still runs (32 a group swept, ``walk_two_level_plain``'s group
     count), and the bound on the tests it runs; and on the grid tile,
     kernel 3 with the lite epilogue against kernel 6 (``_SC_LITE``
     off);
   - kernel 7 (one round of regen's frontier march) on the grid's middle
     tile, its lanes in the march's sort order and queued by the march's
     own candidate scan: primary rays from the spawn state, a second round
     from the first's carried best, bounce-1 rays, each with the
     thread-slots of its block-cooperative walk against one thread per
     ray's; and a round whose queue lists every superchunk, which must
     give kernel 3's winners, timed beside kernel 3 on the same rays;
   - kernel 5 (the soft-shadow top-1 blocker): the shadow rays of the
     middle tile's primary hits toward sampled light points, on the demo
     and on the grid, with soft shadows' edge_eps of phase 3b, with the
     thread-slots of its block-cooperative walk against one thread per
     ray's;
   - kernel 10 (MEGA's per-bounce megakernel) on the middle demo tile's
     packed path state, bounce 0 and bounce 1, without and with NEE, with
     the thread-slots of its block-cooperative walks against one thread
     per ray's;
     kernel 11 (FUSED's all-bounces kernel) on the middle demo tile and on
     the middle mid-grid tile, 5 bounces, with the thread-slots of its
     block-cooperative flat walk summed over the bounces against one
     thread per ray's: these two call sqrtf, sinf and
     cosf besides + - * /, and equal their plain versions bit for bit all
     the same (IEEE sqrtf; PyTorch's CUDA sin and cos are CUDA's sinf and
     cosf);
   - kernels 8 and 9 (the classic (t, idx) closest hit, gated per ray and
     per block) on the demo's middle tile, primary and bounce-1 rays, and
     on the mid grid's, with the share of rays on which they find the
     default traversal's winners, and kernel 8's thread-slots on its
     block-cooperative walk against one thread per ray's;
   - UNIT (render/intersect.py trace_unit, the plain oracle; no TPU
     kernel) against kernel 1 on the middle demo tile's primary and
     bounce-1 rays: the share of rays with kernel 1's winner (>= 0.999);
     on those, UNIT's epilogue over the kernel's own unfused K = 4 sums
     within the pinned tolerance of kernel 1's t on every ray, and UNIT's
     t (cuBLAS) within two roundings of that contraction;
   - the BVH traversal (render/traverse.py trace_bvh, no TPU kernel: the
     reference's is a plain-XLA loop) on the demo and the grid: the 262144
     camera rays around the frame's centre, one bounce from their hits,
     those camera rays with stacks of 2 (overflowing) and 96 (in device
     memory), and axis-aligned rays on box planes (NaN in the slab test),
     its bound from the plain version's counts of pops, box tests,
     object-space rays and triangle tests;
   - regen's lane kernels (csrc/regen_lanes.cu, no TPU kernel: the sort
     key, then the permute, log append and refill around the stable sort)
     on one iteration's lanes of the 1080p wavefront, on the demo and the
     bench grid, against their plain versions (regen's torch glue), timed
     with CUDA events in turns with that glue (glue, kernels, kernels,
     glue), the sort between them alone, beside their bytes bound;
   - the primal BVH loop's shading (csrc/path_shade.cu, no TPU kernel:
     the reference's is plain XLA) on the carries of the 262144-lane tile
     through the middle of a 1080p RenderConfig() demo frame, at bounce 0
     and bounce 1, against its plain version (the standard loop's torch
     body), both timed with CUDA events, beside its bytes bound;
3. drives kernels 8 and 9 through their own entry points
   (trace_pallas_classic, closest_hit_loop) over every tile of a 1080p
   demo frame's camera rays, one launch a tile each, against kernel 1's
   winners; then renders 1920x1080 frames (1 spp, 5 bounces) through
   render_radiance for each main path, with the launch count of each of
   the seventeen entry points (the sixteen kernels', regen's shading with
   two) and the regen iteration count set to 0 just before each frame and
   read just after: on the demo scene the standard loop (regen=False), the default
   regen loop, regen with NEE and the standard loop with NEE; on the grid
   regen, regen with NEE, the standard loop (which sorts rays each bounce)
   and regen with the frontier march, without and with NEE; regen on the
   mid grid (n=4), with and without the march, and on the n=14 grid, with
   and without regen_march=True (there over the 8 MiB threshold, so
   ignored); the path kernels' traversals: MEGA, MEGA + NEE and FUSED
   on the demo, FUSED on the mid grid; RenderConfig()'s BVH traversal
   (the standard loop, one trace_bvh launch a tile and bounce, two with
   NEE) on the demo, the demo with NEE and the grid; the rest of the
   primal transport on the demo: BRUTE and UNIT (plain torch, no kernel
   launch), UNIT with NEE, UNIT with regen=True (which must equal the
   UNIT frame at the same frame index: radiance and depth within 1e-6,
   segments exact), the PALLAS standard loop and regen with rr_start=2
   (the same rule between them) and RenderConfig(rr_start=2) (BVH); and
   a glass room (the demo room with a clear glass sphere) through PALLAS
   regen, the PALLAS standard loop with NEE (kernel 4) and UNIT. BRUTE
   on the grid is left out: ~10^12 ray-triangle tests a frame. Each
   regen_march=True frame comes right after its no-march counterpart at
   the same frame index and must equal it in radiance, depth and
   segments. Checks the launches against
   the regen iterations and the tiles (kernel 7 once an iteration where
   the march runs, kernel 6 where it is ignored; regen's shading once an
   iteration where a kernel shades, regen_shade_lite on the grid's and
   the mid grid's regen, regen_shade on the demo's and the n=14 grid's
   regen and in the Engine steps, and never elsewhere; regen's two lane
   kernels once an iteration where regen sorts its lanes by the Morton key
   without the march, and never elsewhere; 40 of kernel 10
   and 8 of kernel 11 a frame, and none of kernels 1-7 there; 40 or 80 of
   the BVH kernel, and 40 of the BVH loop's shading where
   path_shade_entry takes the render), and prints ms/frame,
   Msegments/s and the regen iterations. Then it
   traces one more frame of the path with torch.profiler and prints the
   device kernels launched, the device's busy time (the union of their
   intervals), the share of it in each traversal kernel, the largest other
   kernels, the device's idle share of the median frame, and each leaf
   span's host time with the device's idle time inside it (the telemetry
   module's profiler view), placed on the trace's clock by the launch
   stamps (utils/telemetry.py ``clock_knots``, which the benchmark's
   ``*_idle_ms`` metrics use), with the clock's offset from the
   profiler's own start; on the demo's BVH frame and the grid's regen
   frame (and the demo's backward step, 3b) the run fails where the
   stamps place nothing, where a stamped kernel starts before its launch
   on the placed clock, or where the clock placed by every other knot
   puts a knot left out more than LAG_BOUND_US from its kernel;
   each path also prints its peak device memory. Then Engine.step: 4 steps
   with PROGRESSIVE accumulation under a still camera and 4 with
   TEMPORAL reprojection under an orbiting one, each with the spatial
   denoiser, over the PALLAS regen frame: ms per step, the post passes'
   share of it (timed alone on the same frame), launches, and one
   profiled step;
3b. takes fwd+bwd steps of the differentiable path at 1920x1080 (1 spp,
   5 bounces), each an image MSE against a zero target and its backward
   pass: the demo's albedo gradient without and with per-bounce
   checkpoints and with NEE, the demo's instance-transform gradient with
   soft shadows and NEE (through diff/'s replace_instance_transforms), and
   the grid's albedo gradient; checks the launches of each step and the
   gradient, prints ms per step, Msegments/s (forward segments), peak
   device memory, and one more step under torch.profiler;
3c. the last modules, at 1920x1080 (1 spp, 5 bounces): regen's fused NEE
   (kernel 4 once an iteration, the shadow queries deferred one
   iteration) against its unfused NEE (kernels 1 and 2), in turns, on the
   demo and the glass room, each fused frame equal to the standard loop +
   NEE frame (segments equal, radiance within 1e-4) and at 64x48 to its
   CPU render; the first-chunk lane key (``regen_sort_key="chunk"``)
   against the default key, in turns, on the demo (8 chunk boxes) and the
   grid (47 superchunk boxes), every frame equal to the default key's;
   the command line in a subprocess (``python3 -m gdpathtracing_torch
   render demo`` at 1080p, 8 frames, then ``info demo``): exit code, PNG
   signature, JSON keys, the steady fps it prints; a JSON scene with OBJ
   meshes and a PNG texture and a GLB of the demo room, written from
   built-in geometry, loaded on the card, rendered at 1080p and held at
   64x48 against their CPU renders; the native BVH builder against the
   NumPy builder on the grid's 96004 world-space triangles as one mesh
   (bit-identical trees, both host times); the demo frame sharded over
   ``torch.cuda.device_count()`` ranks on NCCL (PALLAS standard loop,
   with and without NEE) bit-equal to the single-device frame, and the
   sharded albedo gradient within rtol 1e-5 of the single one; a NaN tile
   and a dropped tile injected into a 1080p PALLAS frame, each healed by
   ``render_with_retry`` with one retry, bit-identical to the clean frame;
4. renders 64x48 on the GPU and on the CPU for each demo path (MEGA with
   and without NEE, FUSED, BVH, BRUTE, UNIT ± NEE and the Russian
   roulette paths among them), each glass-room path, and the grid's regen
   with and without NEE and with and without the march and its BVH path,
   and compares each pair;
   the same for the differentiable demo's albedo gradient and its
   soft-shadow transform gradient on PALLAS (kernel 5) and on UNIT
   (occlusion_soft), and for the second frame of a temporal Engine under
   an orbiting camera;
5. runs the GPU-only tests (``pytest -m cuda tests/test_torch_cuda.py``),
   among them kernels 1, 3, 6 and 7 against their plain versions on
   adversarial ray sets and queues of the bench grid and at exact ties,
   kernel 11 on adversarial camera paths of the mid grid (also paths that
   all die after bounce 0, and blocks with one live path), kernel 2
   on adversarial shadow rays of the demo and the grid, kernel 5 on
   all-closed ties at margin 1.0 across lanes and chunks, sparse and
   dense needing rays and parked rays, kernel 9 on one passing gate a
   block and ties on t, kernel 8 on ties, a chunk whose tmin equals a
   ray's best t, one live ray a block, blocks that need nothing and full
   blocks, and the BVH kernel on the demo and the grid with stacks of 2,
   64 and 96, the active mask and axis-aligned rays on box planes.

The last line of standard output is a JSON object with the device; the line
before it lists each of the eleven TPU kernels' ports with its launches,
error, times and bound, and the line before that the BVH kernel's.
Needs one CUDA device and imports nothing of JAX.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
W, H = 1920, 1080
SMALL_W, SMALL_H, SMALL_FRAME = 64, 48, 3
KERNEL_ITERS, PLAIN_ITERS = 20, 2
# The two-level plain versions walk superchunks and chunks in Python:
# seconds a call on the grids.
GRID_PLAIN_ITERS = 1
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
# The BVH kernel (csrc/trace_bvh.cu), per pop: the entry's decode and the
# three comparisons that order the pushes; per inner node two slab tests
# (6 sub, 6 mul, 6 NaN tests, 10 min/max, 3 comparisons, a select); per
# BLAS entry the object-space ray (point 18, direction 15, 3 divisions);
# per triangle test Moller-Trumbore (edges 6, two crosses 18, three dots
# and their scales 21, det 5 and its tests 3, tvec 3, the validity tests
# 8, the facing test 15, inv_det 1).
OPS_PER_POP, OPS_PER_AABB, OPS_PER_OBJ_RAY, OPS_PER_MT = 8, 32, 36, 76
# One soft-shadow candidate test (csrc/soft_occlusion.cu): the six dot
# products (33), the division, u and v (4), w = 1 - u - v (2), the three
# openness tests, six selects and four minima of the margins, int_ok > 0,
# |w_d|, t > 1e-6 and t < tmax, the candidate's select and its comparison
# with the best.
OPS_PER_SOFT_TEST = 59
# The soft shadows of the differentiable paths (edge_eps).
SOFT_EPS = 0.02
# fwd+bwd steps of each differentiable path (the first is not timed).
DIFF_STEPS = 3
# Engine steps a denoising mode (the first is not timed).
ENGINE_STEPS = 4
# Float operations of the path kernels' shading per ray (kernel 10) or per
# ray and bounce (kernel 11), counted from csrc/path_common.cuh and
# mega_step.cu (transcendentals as one): shading from the winner row ~60,
# a BRDF continuation (sample, pdf, evaluation) ~330, the rest ~30; NEE
# adds two light samples (~70 each), one more shading, the light's BRDF
# evaluation and pdf and the MIS weights (~430).
OPS_SHADE_MEGA, OPS_SHADE_MEGA_NEE, OPS_SHADE_FUSED = 420, 850, 420


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond, msg: str):
    if not cond:
        fail(msg)


def log(msg: str):
    print(msg, flush=True)


def cuda_ms(fn, iters: int, torch, warm: bool = True) -> float:
    """Mean milliseconds per call, by CUDA events around `iters` calls,
    after one untimed call unless ``warm`` is false (a plain version that
    its check has just called on the same inputs)."""
    if warm:
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


def bound(tests: float, slabs: float, n_bytes: float,
          ops_per_test: int = OPS_PER_TEST, other_ops: float = 0.0):
    """(ms, what sets it): the least time for `tests` ray-triangle tests,
    `slabs` slab tests and `other_ops` more operations against moving
    `n_bytes` once."""
    t_ops = (tests * ops_per_test + slabs * OPS_PER_SLAB
             + other_ops) / PEAK_FP32
    t_bytes = n_bytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


# The profiled steps whose spans the launch stamps must place: a frame of
# the benchmark's demo.bvh and grid.interactive cells and a step of its
# demo.inverse cell. On the placed clock no stamped kernel starts before
# its launch (ROUND_US: the trace gives its times in whole ns of a
# us-based float), and the clock placed by every other knot puts each of
# the rest within LAG_BOUND_US of its kernel (the launches' lags on the
# card are 10-60 us).
CLOCK_CHECKED = ("demo, BVH (RenderConfig())", "grid, regen",
                 "demo, backward")
LAG_BOUND_US = 100.0
ROUND_US = 1.0


def profile_step(name: str, step, torch, steady_ms: float,
                 kernel_symbols: dict) -> None:
    """Run ``step`` once under the telemetry module's profiler view
    (utils/telemetry.py ``Profile``: device activity only, the program's
    spans placed on the trace's clock) and print the device kernels it
    launched, the device's busy time (the union of their intervals), the
    share of it in each traversal kernel, the largest other kernels, the
    device's idle share of the profiled and of the median step, and each
    leaf span's host time with the device's idle time inside it, the
    spans placed on the trace's clock by the launch stamps; then how the
    placed clock lies against the launches and against the profiler's own
    start. A busy time longer than the step fails the run; so do, on the
    steps of ``CLOCK_CHECKED``, stamps that place nothing, a stamped
    kernel that starts before its launch on the placed clock, and a knot
    that the clock of every other knot places more than ``LAG_BOUND_US``
    from its kernel. The offset from the profiler's start is printed, not
    held to a bound: the trace's clock has been seen to run apart from
    the host's by milliseconds within a step on the card."""
    from gdpathtracing_torch.utils.telemetry import (LEAF_SPANS, Profile,
                                                     idle_launches,
                                                     launch_pairs, to_trace)

    with Profile("cuda") as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    sm = prof.summary
    if not sm.ops:
        log(f"  {name}: the profiler saw no device time; busy time and "
            f"idle share not measured")
        return
    busy = sm.busy_s * 1e3
    log(f"  profiled: {prof_ms:.1f} ms, {sm.ops} device "
        f"kernels, busy {busy:.2f} ms; idle share "
        f"{1.0 - busy / prof_ms:.3f} of the profiled run, "
        f"{1.0 - busy / steady_ms:.3f} of the median")
    # Every kernel ran between the two clock reads around the step.
    check(busy <= prof_ms, f"{name}: the device was busy {busy:.2f} ms "
          f"in a {prof_ms:.1f} ms step: the measurement is broken")
    by_name = {n: v * 1e3 for n, v in sm.op_s.items()}
    # Whole-word match: occlusion_kernel is also a part of
    # soft_occlusion_kernel.
    pats = {k: re.compile(rf"\b{sym}\b") for k, sym in kernel_symbols.items()}
    for k, pat in pats.items():
        t = sum(v for n, v in by_name.items() if pat.search(n))
        if t:
            log(f"    {k}: {t:.2f} ms ({t / busy:.3f} of busy)")
    rest = sorted(((v, n) for n, v in by_name.items() if not any(
        pat.search(n) for pat in pats.values())), reverse=True)
    for v, n in rest[:4]:
        log(f"    {v:8.2f} ms  {n[:100]}")
    log("    spans (host ms, device idle ms inside): " + ", ".join(
        f"{n} {sm.spans[n].host_s * 1e3:.1f} / {sm.spans[n].idle_s * 1e3:.1f}"
        for n in LEAF_SPANS if n in sm.spans)
        + f"; {sm.leaf_idle_share:.3f} of the idle time inside the outer "
        f"spans is inside leaf spans")
    stamps, ks = prof.session.stamps, prof.knots
    checked = name in CLOCK_CHECKED
    if ks is None:
        log(f"    spans placed by the trace's start: none of {len(stamps)} "
            f"launch stamps pairs with a kernel started on an idle card")
        check(not checked, f"{name}: {len(stamps)} launch stamps placed "
              f"no span on the trace's clock")
        return
    # Each stamped kernel's start less its launch on the placed clock: 0
    # at a knot, its queueing or its slow launch elsewhere.
    clock = to_trace(ks)
    lag = [(e - clock(s)) / 1e3 for s, e in launch_pairs(prof.events,
                                                           stamps)]
    idle = idle_launches(prof.events, stamps)
    log(f"    placed by {len(ks)} knots of {len(idle)} launches on an idle "
        f"card ({len(stamps)} stamps): kernel start less launch "
        f"{min(lag):.3f} to {max(lag):.3f} us")
    # The clock of the even knots against the odd ones: how far a span
    # between two knots can lie from where the trace has it.
    held = to_trace(ks[::2])
    miss = [(s - o - held(s)) / 1e3 for s, o in ks[1::2]]
    if miss:
        log(f"    the odd knots on the even knots' clock: {min(miss):.3f} "
            f"to {max(miss):.3f} us from their kernels")
    # The profiler's start puts a knot's kernel its lag after its launch,
    # plus the trace clock's drift from the host's since the start.
    off = [-o / 1e3 for _, o in ks]
    log(f"    against the profiler's start: the first knot's kernel "
        f"{off[0]:.3f} us after its launch; along the step {min(off):.3f} "
        f"to {max(off):.3f} us")
    if checked:
        check(min(lag) >= -ROUND_US, f"{name}: a stamped kernel starts "
              f"{-min(lag):.3f} us before its launch on the placed clock")
        check(all(abs(m) <= LAG_BOUND_US for m in miss), f"{name}: the "
              f"even knots' clock puts an odd knot's kernel up to "
              f"{max(map(abs, miss)):.3f} us away, above {LAG_BOUND_US} us")


def bit_mismatch(got, want, torch):
    """(rays whose outputs are not all equal bit for bit, largest |diff| of
    an f32 output) of a path kernel's (f32 rows (R, N), i32 rows (R', N) or
    (N,)) against its plain version's."""
    (fa, ia), (fb, ib) = got, want
    n = fa.shape[1]
    differ = (fa.view(torch.int32) != fb.view(torch.int32)).any(dim=0) \
        | (ia.reshape(-1, n) != ib.reshape(-1, n)).any(dim=0)
    return int(differ.sum()), float((fa - fb).abs().max())


def lane_state(scene, nw: int, seed: int, torch):
    """One regen iteration's lane state after the shading, on the card:
    origins inside the scene's box, random directions, 60% of the lanes
    alive, 15% ended now, random throughput, radiance, AOVs, PCG2D words,
    path ids, bounces, steps and segments (tests/test_torch_cuda.py's)."""
    import numpy as np
    g = np.random.default_rng(seed)
    cb = scene.isect_chunk_bounds.cpu().numpy()
    lo, hi = cb[0:3].min(axis=1), cb[3:6].max(axis=1)
    o = g.uniform(lo, hi, (nw, 3)).T
    d = g.normal(size=(3, nw))
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    fs = np.concatenate([o, d, g.uniform(0.0, 2.0, (11, nw))])
    ints = np.stack([g.integers(0, 1 << 32, nw), g.integers(0, 1 << 32, nw),
                     g.permutation(nw), g.integers(0, 5, nw),
                     g.integers(0, 1 << 20, nw), g.integers(0, 5, nw)])
    u = g.uniform(size=nw)
    return (torch.from_numpy(fs.astype(np.float32)).cuda(),
            torch.from_numpy(ints).cuda(), torch.from_numpy(u < 0.6).cuda(),
            torch.from_numpy((u >= 0.6) & (u < 0.75)).cuda())


def compare_frames(a, b, what: str, seg_share: float = 1.0):
    """The CPU parity tolerance of tests/test_torch_render.py: radiance
    within 1e-4 on >= 99% of pixels, segments equal on those pixels (on
    ``seg_share`` of them), depth within rtol 1e-5 there."""
    import numpy as np
    ra, rb = a.radiance.cpu().numpy(), b.radiance.cpu().numpy()
    ok = (np.abs(ra - rb) <= 1e-4).all(axis=-1)
    frac = float(ok.mean())
    same = float((a.segments.cpu().numpy()[ok]
                  == b.segments.cpu().numpy()[ok]).mean())
    log(f"{what}: radiance within 1e-4 on {frac:.4f} of pixels, segments "
        f"equal on {same:.4f} of those")
    check(frac >= 0.99, f"{what}: only {frac:.4f} of pixels agree")
    check(same >= seg_share, f"{what}: segments differ on agreeing pixels")
    da, db = a.depth.cpu().numpy()[ok], b.depth.cpu().numpy()[ok]
    check(np.allclose(da, db, rtol=1e-5, atol=0), f"{what}: depth differs")


def glass_room(device="cuda"):
    """tests/test_golden.py's glass scene: the demo's Cornell room (its
    light, box and materials) with a clear glass sphere (transmission 1,
    ior 1.5) in it."""
    import numpy as np
    from gdpathtracing_torch.scene import demo
    from gdpathtracing_torch.scene.materials import Material
    from gdpathtracing_torch.scene.primitives import (cornell_box,
                                                      plane_mesh, uv_sphere)
    from gdpathtracing_torch.scene.scene import SceneBuilder
    b = SceneBuilder()
    light = b.add_mesh(plane_mesh(size=2.0))
    box = b.add_mesh(cornell_box(size=5.0))
    sphere = b.add_mesh(uv_sphere(radius=1.2, rings=8, segments=16))
    b.add_instance(light, demo._affine([1, 0, 0, 0, -1, 0, 0, 0, -1],
                                       (0, 2.95581, 0)),
                   materials=[demo.LIGHT_MAT])
    b.add_instance(box, demo._affine([-2.6e-08, 0, -0.6, 0, 0.6, 0, 0.6, 0,
                                      -2.6e-08], (0, 0, 0)),
                   materials=[demo.BOX_GREY, demo.BOX_RED, demo.BOX_GREEN])
    b.add_instance(sphere, np.eye(4, dtype=np.float32)[:3],
                   materials=[Material(albedo=(1.0, 0.9, 0.9),
                                       transmission=1.0, ior=1.5,
                                       roughness=0.05)])
    return b.build(device)


def orbit_camera(k: int, width: int, height: int):
    """Step k of a camera orbiting the demo room from the demo camera's
    place (a moving camera for temporal reprojection)."""
    import math
    from gdpathtracing_torch.render.camera import Camera
    a = 0.03 * k
    return Camera.looking_at((9.7694 * math.sin(a), 0.1 * k,
                              9.7694 * math.cos(a)), (0.0, 0.0, 0.0),
                             fov_deg=79.5, width=width, height=height)


def write_obj(path: Path, surfaces) -> None:
    """A Wavefront OBJ of ``surfaces`` (bvh.blas.Surface), one ``usemtl``
    group each, with positions, uvs and normals per corner."""
    lines, n = [], 0
    for k, s in enumerate(surfaces):
        lines.append(f"usemtl s{k}")
        for tri, nrm, uv in zip(s.positions, s.normals, s.uvs):
            for p, q, t in zip(tri, nrm, uv):
                lines += [f"v {p[0]:.9g} {p[1]:.9g} {p[2]:.9g}",
                          f"vt {t[0]:.9g} {t[1]:.9g}",
                          f"vn {q[0]:.9g} {q[1]:.9g} {q[2]:.9g}"]
            lines.append("f " + " ".join(f"{i}/{i}/{i}"
                                         for i in (n + 1, n + 2, n + 3)))
            n += 3
    path.write_text("\n".join(lines) + "\n")


def write_glb(path: Path, meshes, nodes) -> None:
    """A binary glTF: ``meshes`` a list of [(Surface, Material)] (one
    primitive each, non-indexed POSITION, NORMAL, TEXCOORD_0),
    ``nodes`` a list of (mesh index, (3, 4) affine)."""
    import struct
    import numpy as np
    blob, views, accessors, prims, materials = b"", [], [], [], []

    def add(arr, kind):
        nonlocal blob
        arr = np.ascontiguousarray(arr, np.float32)
        views.append({"buffer": 0, "byteOffset": len(blob),
                      "byteLength": arr.nbytes})
        accessors.append({"bufferView": len(views) - 1,
                          "componentType": 5126, "count": len(arr),
                          "type": kind})
        blob += arr.tobytes()
        return len(accessors) - 1

    for mesh in meshes:
        ps = []
        for s, m in mesh:
            materials.append({
                "pbrMetallicRoughness": {
                    "baseColorFactor": [*m.albedo, 1.0],
                    "metallicFactor": m.metallic,
                    "roughnessFactor": m.roughness},
                "emissiveFactor": [e * m.emission_energy
                                   for e in m.emission]})
            ps.append({"attributes": {
                "POSITION": add(s.positions.reshape(-1, 3), "VEC3"),
                "NORMAL": add(s.normals.reshape(-1, 3), "VEC3"),
                "TEXCOORD_0": add(s.uvs.reshape(-1, 2), "VEC2")},
                "material": len(materials) - 1})
        prims.append({"primitives": ps})
    gl_nodes = []
    for mesh, affine in nodes:
        m4 = np.eye(4, dtype=np.float64)
        m4[:3] = affine
        gl_nodes.append({"mesh": mesh, "matrix": m4.T.ravel().tolist()})
    doc = {"asset": {"version": "2.0"}, "scene": 0,
           "scenes": [{"nodes": list(range(len(gl_nodes)))}],
           "nodes": gl_nodes, "meshes": prims, "materials": materials,
           "accessors": accessors, "bufferViews": views,
           "buffers": [{"byteLength": len(blob)}]}
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    blob += b"\x00" * (-len(blob) % 4)
    path.write_bytes(struct.pack("<III", 0x46546C67, 2,
                                 12 + 8 + len(js) + 8 + len(blob))
                     + struct.pack("<II", len(js), 0x4E4F534A) + js
                     + struct.pack("<II", len(blob), 0x004E4942) + blob)


def world_triangles(scene):
    """(T, 3, 3) float32: every instance's triangles in world space."""
    import numpy as np
    tp = scene.tri_pos.cpu().numpy()
    tf = scene.inst_transform.cpu().numpy()
    return np.concatenate([
        tp[f:f + c] @ tf[i, :, :3].T + tf[i, :, 3]
        for i, (f, c) in enumerate(zip(scene.inst_tri_first,
                                       scene.inst_tri_count))]
    ).astype(np.float32)


def shard_inputs(device: str):
    """What each rank of phase 3c's sharded render renders: the demo scene
    on ``device``, the 1080p camera, the frames' configs (PALLAS, standard
    loop, ± NEE) and the gradient's config. Rank 0 and the shard workers
    all take theirs from here, so every rank renders the same frame."""
    from gdpathtracing_torch.config import RenderConfig, Traversal
    from gdpathtracing_torch.scene.demo import build_demo_scene, demo_camera
    std = RenderConfig(traversal=Traversal.PALLAS, regen=False)
    return (build_demo_scene(device=device), demo_camera(W, H),
            [std, std.replace(nee=True)], std.replace(differentiable=True))


def sharded_sequence(scene, cam, frames, grad_cfg):
    """The collective calls of one rank in phase 3c: the sharded frame of
    each config in ``frames``, then the gradient of a sharded
    differentiable render's image MSE against a zero target with respect
    to ``mat_albedo``. Returns (frames' AOVs, gradient, seconds each)."""
    import torch
    from gdpathtracing_torch.diff import image_mse, replace_albedo
    from gdpathtracing_torch.parallel import render_radiance_sharded
    out, secs = [], []
    for c in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out.append(render_radiance_sharded(scene, cam, c, 1))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    albedo = scene.mat_albedo.clone().requires_grad_(True)
    t0 = time.perf_counter()
    aovs = render_radiance_sharded(replace_albedo(scene, albedo), cam,
                                   grad_cfg, 0)
    image_mse(aovs.radiance, torch.zeros_like(aovs.radiance)).backward()
    torch.cuda.synchronize()
    secs.append(time.perf_counter() - t0)
    return out, albedo.grad, secs


def shard_worker(rank: int, world: int, port: int) -> None:
    """Rank ``rank`` > 0 of phase 3c's NCCL group, on card ``rank``."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(HERE))
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    inputs = shard_inputs(f"cuda:{rank}")
    for _ in range(2):  # as rank 0: once to warm up, once timed
        sharded_sequence(*inputs)
    dist.destroy_process_group()


def last_modules(torch, card, kernels, launches, kernel_symbols, scene, cam,
                 cfg, grid, grid_cam, glass) -> None:
    """Phase 3c: regen's fused NEE and first-chunk key, the command line,
    loaded scenes, the native builder, sharding and fault recovery."""
    import socket
    import numpy as np
    import torch.distributed as dist
    from gdpathtracing_torch.bvh import native
    from gdpathtracing_torch.bvh.blas import BLASBuilder, Surface
    from gdpathtracing_torch.cli import write_png
    from gdpathtracing_torch.ops.build import BUILD_DIR
    from gdpathtracing_torch.parallel import (inject_tile_fault,
                                              render_with_retry,
                                              tile_health)
    from gdpathtracing_torch.render.regen import render_radiance_regen
    from gdpathtracing_torch.render.renderer import render_radiance
    from gdpathtracing_torch.scene import demo
    from gdpathtracing_torch.scene.demo import demo_camera
    from gdpathtracing_torch.scene.gltfloader import load_gltf_scene
    from gdpathtracing_torch.scene.primitives import cornell_box, uv_sphere
    from gdpathtracing_torch.scene.sceneformat import load_scene_file

    def counted(fn):
        """(fn(), its launches of each kernel, its regen iterations, its
        seconds), every count set to 0 just before; the launches are
        added to the kernels line's."""
        for f in kernels.values():
            f.launches = 0
        render_radiance_regen.iterations = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = {k: f.launches for k, f in kernels.items()}
        for k, v in got.items():
            launches[k] += v
        return out, got, render_radiance_regen.iterations, secs

    def nonzero(got):
        return {k: v for k, v in got.items() if v}

    def equal_frames(a, b):
        """Every AOV of two frames equal bit for bit, on one device."""
        return all(x.dtype == y.dtype and x.device == y.device and (
            torch.equal(x.view(torch.int32), y.view(torch.int32))
            if x.dtype == torch.float32 else torch.equal(x, y))
            for x, y in zip(a, b))

    def in_turns(what, pscene, pcam, variants, want, rounds=3):
        """Render each (label, config) of ``variants`` in turns, rounds + 1
        times (the first untimed), at frame index r in round r; checks
        each frame's launches against ``want(label, iters)``; returns
        {label: [frames]}, after printing the medians and one profiled
        frame each."""
        frames = {lab: [] for lab, _ in variants}
        secs = {lab: [] for lab, _ in variants}
        for r in range(rounds + 1):
            for lab, c in variants:
                aovs, got, iters, s = counted(
                    lambda: render_radiance(pscene, pcam, c, r))
                check(bool(torch.isfinite(aovs.radiance).all())
                      and int(aovs.segments.sum()) >= W * H,
                      f"{what}, {lab}, frame {r}: not finite or too few "
                      f"segments")
                check(nonzero(got) == want(lab, iters),
                      f"{what}, {lab}: launches {nonzero(got)}, expected "
                      f"{want(lab, iters)}")
                frames[lab].append(aovs)
                if r:
                    secs[lab].append(s)
                if r == rounds:
                    log(f"{what}, {lab}: launches {nonzero(got)}, {iters} "
                        f"regen iterations a frame")
        for lab, c in variants:
            med = statistics.median(secs[lab])
            log(f"1080p {what}, {lab}, in turns: frames "
                + ", ".join(f"{s * 1e3:.1f}" for s in secs[lab])
                + f" ms, median {med * 1e3:.1f} ms; on {card}")
            profile_step(f"{what}, {lab}", lambda: render_radiance(
                pscene, pcam, c, rounds + 1), torch, med * 1e3,
                kernel_symbols)
        return frames

    # Regen's fused NEE (kernel 4 once an iteration, no kernel 2) against
    # its unfused NEE (kernels 1 and 2 once an iteration), in turns, on the
    # demo and the glass room (both flat); the fused frame must equal the
    # standard loop + NEE frame (segments equal, radiance within 1e-4).
    nee = cfg.replace(nee=True)

    def nee_launches(lab, iters):
        if lab == "fused":  # the torch glue carries the pending queries
            return {"closest_hit_rows_nee": iters}
        return {"closest_hit_rows": iters, "occluded": iters,
                "regen_lane_key": iters, "regen_lane_refill": iters}

    for what, pscene in (("demo, regen + NEE", scene),
                         ("glass, regen + NEE", glass)):
        frames = in_turns(what, pscene, cam, [
            ("unfused", nee), ("fused", nee.replace(regen_fuse_nee=True))],
            nee_launches)
        std = render_radiance(pscene, cam, nee.replace(regen=False), 3)
        got = frames["fused"][3]
        err = float((got.radiance - std.radiance).abs().max())
        same = equal_frames(got, frames["unfused"][3])
        log(f"{what}, fused, frame 3: radiance max |diff| {err:.3g} from "
            f"the standard loop + NEE frame, segments "
            f"{'equal' if torch.equal(got.segments, std.segments) else 'DIFFER'}"
            f"; {'bit-equal to' if same else 'differs from'} the unfused "
            f"frame")
        check(torch.equal(got.segments, std.segments) and err <= 1e-4,
              f"{what}: the fused frame differs from the standard loop's")
        fused = nee.replace(regen_fuse_nee=True)
        compare_frames(*(render_radiance(sc, demo_camera(SMALL_W, SMALL_H),
                                         fused, SMALL_FRAME)
                         for sc in (pscene, pscene.to("cpu"))),
                       f"{SMALL_W}x{SMALL_H} {what}, fused, cuda vs cpu")

    # The first-chunk lane key against the default (Morton) key, in turns:
    # the demo's 8 chunk boxes, the grid's 47 superchunk boxes; each frame
    # must equal the default key's.
    for what, pscene, pcam, trace, shading in (
            ("demo, regen", scene, cam, "closest_hit_rows", "regen_shade"),
            ("grid, regen", grid, grid_cam, "closest_hit_sc_lite",
             "regen_shade_lite")):
        frames = in_turns(what, pscene, pcam, [
            ("default key", cfg), ("chunk key",
                                   cfg.replace(regen_sort_key="chunk"))],
            lambda lab, iters, trace=trace, shading=shading: {
                trace: iters, shading: iters,
                **({} if lab == "chunk key" else {
                    "regen_lane_key": iters, "regen_lane_refill": iters})})
        for r, (a, b) in enumerate(zip(frames["chunk key"],
                                       frames["default key"])):
            check(equal_frames(a, b), f"{what}, frame {r}: the chunk key's "
                  f"frame differs from the default key's")
        log(f"{what}: the chunk key's frames equal the default key's")

    # The command line, as a user starts it: 8 frames of the demo at 1080p
    # (Engine, progressive, ACES) to a PNG, and `info`.
    out_png = BUILD_DIR / "cli.png"
    out_png.unlink(missing_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "gdpathtracing_torch", "render", "demo",
         "--width", str(W), "--height", str(H), "--frames", "8", "--out",
         str(out_png)], cwd=HERE, capture_output=True, text=True,
        timeout=600)
    cli_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"the CLI's render failed "
          f"(rc {proc.returncode}):\n{proc.stderr[-3000:]}")
    check(out_png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n",
          "the CLI wrote no PNG")
    fps = re.search(r"(\d+) frames in ([\d.]+)s \(([\d.]+) fps\)",
                    proc.stderr)
    first = re.search(r"first frame[^:]*: ([\d.]+)s", proc.stderr)
    check(fps is not None and first is not None,
          f"the CLI printed no timing: {proc.stderr[-1000:]}")
    log(f"CLI: python3 -m gdpathtracing_torch render demo --width {W} "
        f"--height {H} --frames 8: exit 0 in {cli_s:.1f} s, first frame "
        f"{first.group(1)} s, then {fps.group(1)} frames in "
        f"{fps.group(2)} s ({fps.group(3)} fps steady); on {card}")
    proc = subprocess.run([sys.executable, "-m", "gdpathtracing_torch",
                           "info", "demo"], cwd=HERE, capture_output=True,
                          text=True, timeout=300)
    check(proc.returncode == 0, f"the CLI's info failed: {proc.stderr}")
    info = json.loads(proc.stdout)
    check(sorted(info) == ["blas_nodes", "expanded_triangles", "instances",
                           "materials", "textures", "tlas_nodes",
                           "triangles"] and info["triangles"] == 980,
          f"the CLI's info: {info}")
    log(f"CLI: info demo: {json.dumps(info)}")

    # Loaded scenes, written here from built-in geometry: a JSON scene
    # with OBJ meshes and a PNG texture, and a GLB of the demo room's
    # geometry; each rendered at 1080p (PALLAS regen) and held at 64x48
    # against its CPU render.
    d = BUILD_DIR / "loaded_scenes"
    d.mkdir(parents=True, exist_ok=True)
    write_obj(d / "room.obj", cornell_box(size=5.0))
    write_obj(d / "ball.obj", uv_sphere(radius=1.0, rings=12, segments=24))
    checker = np.kron((np.indices((8, 8)).sum(axis=0) % 2)[..., None],
                      np.ones((16, 16, 1))) * np.array([200, 60, 40]) + 40
    write_png(d / "checker.png", checker.astype(np.uint8))
    (d / "scene.json").write_text(json.dumps({
        "meshes": {"room": {"obj": "room.obj"}, "ball": {"obj": "ball.obj"},
                   "light": {"primitive": "plane", "size": 2.0}},
        "materials": {
            "grey": {"albedo": [1, 1, 1], "roughness": 0.6},
            "red": {"albedo": [1.0, 0.16, 0.16]},
            "green": {"albedo": [0.42, 1.0, 0.13]},
            "lamp": {"emission": [1, 1, 1], "emission_energy": 10},
            "checker": {"albedo_texture": "checker.png",
                        "roughness": 0.5}},
        "instances": [
            {"mesh": "light", "materials": "lamp",
             "transform": {"position": [0, 2.95, 0],
                           "rotation_deg": [180, 0, 0]}},
            {"mesh": "room", "materials": ["grey", "red", "green"],
             "transform": {"rotation_deg": [0, 90, 0], "scale": 0.6}},
            {"mesh": "ball", "material_override": "checker",
             "transform": {"position": [0.3, -0.9, -0.5],
                           "rotation_deg": [20, 30, 0]}}],
        "camera": {"position": [0, 0, 9.77], "look_at": [0, 0, 0],
                   "fov": 79.5}}))
    light, box, mirror = demo.LIGHT_MAT, demo.BOX_GREY, demo.MIRROR_MAT
    from gdpathtracing_torch.scene.primitives import plane_mesh
    write_glb(d / "demo_room.glb", [
        [(s, light) for s in plane_mesh(size=2.0)],
        list(zip(demo.load_demo_geometry("cornell"),
                 [box, demo.BOX_RED, demo.BOX_GREEN])),
        [(s, mirror) for s in demo.load_demo_geometry("suzanne")]],
        [(k, scene.inst_transform[i].cpu().numpy())
         for i, k in enumerate((0, 1, 2, 2))])
    loaders = {
        "JSON scene (OBJ meshes, PNG texture)": lambda device, w, h:
            load_scene_file(d / "scene.json", width=w, height=h,
                            device=device),
        "GLB (the demo room)": lambda device, w, h:
            (load_gltf_scene(d / "demo_room.glb", device=device),
             demo_camera(w, h))}
    for what, load in loaders.items():
        t0 = time.perf_counter()
        lscene, lcam = load("cuda", W, H)
        load_s = time.perf_counter() - t0
        check(lscene.device.type == "cuda", f"{what}: not on the card")
        aovs, got, iters, s = counted(
            lambda: render_radiance(lscene, lcam, cfg, 1))
        want = {"closest_hit_rows": iters, "regen_lane_key": iters,
                "regen_lane_refill": iters}
        if not lscene.has_textures:  # the JSON scene's texture: torch body
            want["regen_shade"] = iters
        check(nonzero(got) == want, f"{what}: launches {nonzero(got)}, "
              f"expected {want}")
        check(bool(torch.isfinite(aovs.radiance).all())
              and int(aovs.segments.sum()) >= W * H,
              f"{what}: not finite or too few segments")
        log(f"{what}: {lscene.n_tris} triangles, {lscene.n_instances} "
            f"instances, {tuple(lscene.textures.shape)} textures, loaded "
            f"in {load_s:.2f} s; 1080p PALLAS regen {s * 1e3:.1f} ms "
            f"(first frame), {iters} regen iterations; on {card}")
        small = [load(device, SMALL_W, SMALL_H) for device in ("cuda",
                                                               "cpu")]
        compare_frames(*(render_radiance(sc, c, cfg, SMALL_FRAME)
                         for sc, c in small),
                       f"{SMALL_W}x{SMALL_H} {what}, cuda vs cpu")

    # The native BVH builder (native/bvh_builder.cpp through bvh/native.py,
    # built into build/gdpathtracing_torch/) against the NumPy builder on
    # the grid's world-space triangles as one mesh: bit-identical trees.
    soup = world_triangles(grid)
    check(native.available(), "the native BVH builder does not build")
    trees, secs = [], []
    for backend in ("native", "numpy"):
        t0 = time.perf_counter()
        b = BLASBuilder(backend=backend)
        b.build_mesh([Surface(positions=soup)])
        trees.append(b.finalize())
        secs.append(time.perf_counter() - t0)
    for k in ("node_min", "node_max", "node_left", "node_right",
              "node_first", "node_count", "tri_pos", "tri_slot"):
        check(np.array_equal(getattr(trees[0], k), getattr(trees[1], k)),
              f"the native builder's {k} differs from the NumPy builder's")
    log(f"native BVH builder, the n=10 grid's {len(soup)} world-space "
        f"triangles as one mesh: native {secs[0]:.3f} s, NumPy "
        f"{secs[1]:.3f} s on the host, {len(trees[0].node_min)} nodes, "
        f"bit-identical trees")

    # Sharding: one rank a card on NCCL; the sharded 1080p demo frame
    # (PALLAS, standard loop, ± NEE) must equal the single-device frame bit
    # for bit, and the sharded albedo gradient the single one (rtol 1e-5).
    world = torch.cuda.device_count()
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    workers = [subprocess.Popen([sys.executable, str(Path(__file__)),
                                 "--shard-worker", str(r), str(world),
                                 str(port)], cwd=HERE)
               for r in range(1, world)]
    try:
        dist.init_process_group("nccl",
                                init_method=f"tcp://localhost:{port}",
                                rank=0, world_size=world)
        sscene, scam, sframes, grad_cfg = shard_inputs("cuda")
        # Once to warm up (the group's first collectives), once timed.
        for _ in range(2):
            (sharded, g_sh, sh_s), got, _, _ = counted(
                lambda: sharded_sequence(sscene, scam, sframes, grad_cfg))
        dist.destroy_process_group()
    finally:
        for p in workers:
            p.wait(timeout=600)
    check(all(p.returncode == 0 for p in workers), "a shard worker failed")
    per_rank = -(-(W * H) // world)
    tiles = -(-per_rank // grad_cfg.tile_rays)
    want = {"closest_hit_rows": 2 * tiles * grad_cfg.bounces,
            "closest_hit_rows_nee": tiles * grad_cfg.bounces,
            "occluded": tiles}
    check(nonzero(got) == want, f"sharded: launches {nonzero(got)}, "
          f"expected {want}")
    for c, aovs in zip(sframes, sharded):
        single = render_radiance(sscene, scam, c, 1)
        check(equal_frames(aovs, single),
              f"the sharded frame (nee={c.nee}) differs from the "
              f"single-device frame")
    albedo = sscene.mat_albedo.clone().requires_grad_(True)
    from gdpathtracing_torch.diff import image_mse, replace_albedo
    one = render_radiance(replace_albedo(sscene, albedo), scam, grad_cfg, 0)
    image_mse(one.radiance, torch.zeros_like(one.radiance)).backward()
    g_err = float(((g_sh - albedo.grad).abs()
                   / albedo.grad.abs().clamp(min=1e-30)).max())
    check(torch.allclose(g_sh, albedo.grad, rtol=1e-5, atol=1e-7)
          and float(g_sh.abs().max()) > 0,
          f"the sharded albedo gradient differs from the single one "
          f"(relative {g_err:.3g})")
    log(f"sharded over {world} card(s) on NCCL: 1080p demo frames, PALLAS "
        f"standard loop, {sh_s[0] * 1e3:.1f} ms, + NEE {sh_s[1] * 1e3:.1f} "
        f"ms (second calls), bit-equal to the single-device frames; "
        f"fwd+bwd {sh_s[2] * 1e3:.1f} ms, the albedo gradient within "
        f"{g_err:.3g} (relative) of the single one; launches {want}; on "
        f"{card}")

    # Fault recovery: a NaN tile and a dropped tile injected into a 1080p
    # PALLAS frame (standard loop); render_with_retry must heal each with
    # one retry, bit-identical to the clean frame.
    std = cfg.replace(regen=False)
    clean = render_radiance(scene, cam, std, 2)
    ty, tx = H // 2 // 64, W // 2 // 64  # the tile at the frame's centre
    for kind in ("nan", "drop"):
        def faulty(s_, c_, g_, f_, kind=kind):
            return inject_tile_fault(render_radiance(s_, c_, g_, f_), ty, tx,
                                     64, kind)
        retries = []
        (healed, recovered), got, _, s = counted(lambda: render_with_retry(
            scene, cam, std, 2, faulty, tile=64,
            on_retry=lambda a, n: retries.append((a, n))))
        check(recovered == 1 and retries == [(0, 1)]
              and tile_health(healed, 64).all(),
              f"fault recovery ({kind}): {recovered} tiles, retries "
              f"{retries}")
        check(equal_frames(healed, clean),
              f"fault recovery ({kind}): the healed frame differs from the "
              f"clean one")
        log(f"fault recovery, a {kind} tile (64x64) in a 1080p PALLAS "
            f"frame: healed with 1 retry in {s * 1e3:.1f} ms (the faulty "
            f"frame included), bit-identical to the clean frame; launches "
            f"{nonzero(got)}; on {card}")


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

    from gdpathtracing_torch import Engine
    from gdpathtracing_torch.config import (DenoisingMode, RenderConfig,
                                            Traversal)
    from gdpathtracing_torch.core import rng
    from gdpathtracing_torch.diff import (image_mse, replace_albedo,
                                          replace_instance_transforms)
    from gdpathtracing_torch.ops import fused as fu
    from gdpathtracing_torch.ops import intersect as ti
    from gdpathtracing_torch.ops import lanes
    from gdpathtracing_torch.ops import megakernel as mk
    from gdpathtracing_torch.ops import shade
    from gdpathtracing_torch.ops import tiles as kt
    from gdpathtracing_torch.ops.build import KERNELS, load_libraries
    from gdpathtracing_torch.post.denoise import atrous_denoise
    from gdpathtracing_torch.post.display import display_transform
    from gdpathtracing_torch.post.progressive import progressive_update
    from gdpathtracing_torch.post.temporal import (nonlinear_depth,
                                                   temporal_update)
    from gdpathtracing_torch.render.intersect import trace_unit
    from gdpathtracing_torch.render.regen import render_radiance_regen
    from gdpathtracing_torch.render.renderer import render_radiance
    from gdpathtracing_torch.render.traverse import trace_bvh, trace_bvh_plain
    from gdpathtracing_torch.scene.demo import (build_demo_scene,
                                                build_sphere_grid,
                                                demo_camera, grid_camera)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    log("card (nvidia-smi --query-gpu=name,power.limit), next line:")
    log(card)

    t_start = time.perf_counter()

    def phase(name):
        log(f"== {name} ({time.perf_counter() - t_start:.1f} s into the run)")

    # -- 1. build -----------------------------------------------------------
    phase("1. build")
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
    phase("2. kernels against their plain versions")
    cfg = RenderConfig(traversal=Traversal.PALLAS)
    check((kt.W, kt.H) == (W, H), "ops/tiles.py cuts its tiles from another "
          "frame size")
    scene = build_demo_scene()
    check(scene.device.type == "cuda", "the scene is not on the card")
    dev = scene.device
    cam = demo_camera(W, H)
    prep = ti.prepare_trace_inputs(scene)
    e = prep.mu.shape[1]
    nc = e // ti.BT
    scene_bytes = (3 * 4 * e + 8 * nc + 8 * ti.SUB * nc) * 4
    tab_bytes = ti.TAB_R * e * 4

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
    # primary and bounce-1 rays (ops/tiles.py, also the turns tool's).
    tile = cfg.tile_rays
    mid_tile = kt.middle_tile(cfg)
    for name, args in kt.rows_tiles(scene, cam, prep, cfg).items():
        n = args[0].shape[1]
        got = ti.closest_hit_rows(*args)
        counts = {}
        want = ti.closest_hit_rows_plain(*args, counts=counts)
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
        # thread-slots the kernel's block-cooperative walk spent (a warp
        # per needing ray, or the rays' own threads where the needing
        # warps are nearly full: ti.two_level_slots), beside a thread per
        # ray's (every lane of a block sweeps each chunk any lane of it
        # needs: row 46 x 256 rays x 256 triangles).
        needed = float(want[45].sum())
        k = cuda_ms(lambda: ti.closest_hit_rows(*args), KERNEL_ITERS, torch)
        p = cuda_ms(lambda: ti.closest_hit_rows_plain(*args), PLAIN_ITERS,
                    torch, warm=False)
        log(f"  {needed:.4g} ray-triangle tests needed, "
            f"{counts['slots']:.4g} thread-slots swept "
            f"({needed / max(counts['slots'], 1.0):.3f} useful; a thread per "
            f"ray: {counts['thread_slots']:.4g}, "
            f"{needed / max(counts['thread_slots'], 1.0):.3f} useful)")
        record("closest_hit_rows", err, k, p, *bound(
            needed, n * nc, 8 * 4 * n + scene_bytes + tab_bytes
            + ti.OUT_R * 4 * n))

    # The middle tile's primary hits, their shading and one bounce: kernel
    # 4's operands.
    ray0, hit, s, seed = kt.middle_rays(scene, cam, prep, cfg, tile,
                                        mid_tile)
    bounce, _ = kt.bounce_rays(s, hit, seed, cfg)

    # UNIT (render/intersect.py trace_unit, the plain oracle; no TPU
    # kernel) against kernel 1 on the same tile's primary and bounce-1
    # rays: the share of rays with kernel 1's winner (>= 0.999). On those,
    # t: UNIT's contraction is a library product (cuBLAS on the card, a
    # BLAS on the CPU), which sums in its own order and with fused
    # multiply-adds where the kernel (-fmad=false) rounds each product in
    # a fixed order, and t = -w_o / w_d cancels terms of |m|·|o|, so two
    # roundings part by more than the pinned tolerance (rtol 1e-6 + atol
    # 5e-6) on some grazing rays. The witness (ops/tiles.py unit_t_witness): UNIT's
    # epilogue on the kernel's unfused sums meets the pinned tolerance on
    # every ray, and UNIT's t lies within the bound of two roundings of
    # the contraction (ROADMAP §3).
    for name, (r, act) in (("primary", (ray0, None)),
                           ("bounce-1", (bounce, hit.hit))):
        unit = trace_unit(scene, r, act)
        k1 = ti.trace_pallas(scene, r, act, prep)
        same = unit.eidx == k1.eidx
        both = same & k1.hit
        t_k1, t_u = k1.t[both], unit.t[both]
        t_w, t_bound = (x[both] for x in kt.unit_t_witness(
            scene, r, k1.eidx, k1.t))
        w_ok = bool(torch.isclose(t_w, t_k1, rtol=1e-6, atol=5e-6).all())
        gap = (t_u - t_k1).abs().double()
        in_bound = bool((gap <= t_bound).all())
        share = float(same.double().mean())
        t_share = float(torch.isclose(t_u, t_k1, rtol=1e-6, atol=5e-6)
                        .double().mean())
        u_ms = cuda_ms(lambda: trace_unit(scene, r, act), 3, torch)
        log(f"UNIT vs kernel 1, {name} rays ({r.o.x.shape[0]}, "
            f"{int(both.sum())} hit with kernel 1's winner): eidx equal on "
            f"{share:.6f} of rays; UNIT's t within the pinned tolerance on "
            f"{t_share:.6f} of those (max |diff| {float(gap.max()):.3g}, "
            f"at most {float((gap / t_bound).max()):.3g} of the rounding "
            f"bound); unfused witness within the pinned tolerance on all: "
            f"{w_ok} (max |diff| "
            f"{float((t_w - t_k1).abs().max()):.3g}); trace_unit "
            f"{u_ms:.2f} ms a call on {card}")
        check(share >= 0.999, f"UNIT's winners differ from kernel 1's on "
              f"the {name} rays")
        check(w_ok, f"UNIT's epilogue on unfused sums misses kernel 1's t "
              f"on the {name} rays")
        check(in_bound, f"UNIT's t lies beyond two roundings of kernel 1's "
              f"on the {name} rays")

    # Kernel 4 at the same tile: its bounce-1 launch, which resolves the
    # shadow queries posted from the primary hits.
    pend = kt.shadow_queries(s, hit, seed, prep, cfg)
    args = kt.rows_nee_operands(prep, bounce, hit.hit, pend)
    n = args[0].shape[1]
    rows, occ = ti.closest_hit_rows_nee(*args)
    counts = {}
    rows_p, occ_p = ti.closest_hit_rows_nee_plain(*args, counts=counts)
    torch.cuda.synchronize()
    flips = int((occ != occ_p).sum())
    err = max(float((rows - rows_p).abs().max()), float(flips))
    log(f"kernel 4 vs plain, bounce-1 tile ({n} rays, "
        f"{int(pend.active.sum())} shadow queries, "
        f"{int(occ_p.sum())} occluded): max |diff| {err:g}, "
        f"{flips} occlusion mismatches")
    check(torch.equal(rows, rows_p) and flips == 0,
          "kernel 4 differs from its plain version")
    needed = counts["tests"]
    k = cuda_ms(lambda: ti.closest_hit_rows_nee(*args), KERNEL_ITERS, torch)
    p = cuda_ms(lambda: ti.closest_hit_rows_nee_plain(*args), PLAIN_ITERS,
                torch, warm=False)
    # Thread-slots of both block-cooperative walks (the flat closest hit's
    # and the any-hit's), beside a thread per ray's (every lane of a block
    # on each chunk some ray of it needs, in each walk).
    log(f"  {needed:.4g} ray-triangle tests needed (both walks), "
        f"{counts['slots']:.4g} thread-slots swept "
        f"({needed / max(counts['slots'], 1.0):.3f} useful; a thread per "
        f"ray: {counts['thread_slots']:.4g}, "
        f"{needed / max(counts['thread_slots'], 1.0):.3f} useful)")
    # Slab tests: every chunk box of every bounce ray, and what the shadow
    # rays need in index order (ti.occluded_plain).
    record("closest_hit_rows_nee", err, k, p, *bound(
        needed, counts["slab_tests"],
        17 * 4 * n + scene_bytes + tab_bytes + (ti.OUT_R + 1) * 4 * n))

    def occlusion_check(label, oscene, ocam, oprep):
        """Kernel 2 on the 393216 shadow rays (the regen wavefront) from the
        hits around the middle of the frame toward sampled light points."""
        args, n_q = kt.wavefront_shadow_rays(oscene, ocam, oprep, cfg)
        n, onc = args[0].shape[1], oprep.mu.shape[1] // ti.BT
        got = ti.occluded(*args)
        counts = {}
        want = ti.occluded_plain(*args, counts=counts)
        torch.cuda.synchronize()
        flips = int((got != want.occ).sum())
        log(f"kernel 2 vs plain, {label}, {n} shadow rays ({n_q} queries, "
            f"{int(want.occ.sum())} occluded, share "
            f"{int(want.occ.sum()) / max(n_q, 1):.3f}, {onc} chunks): "
            f"{flips} mismatches")
        check(flips == 0, f"kernel 2, {label}: differs from its plain "
              f"version")
        check(0 < int(want.occ.sum()) < n_q,
              f"kernel 2, {label}: a one-sided answer")
        needed = float(want.tests.sum())
        # Thread-slots: the block-cooperative walk's (ti.any_hit_slots),
        # beside a thread per ray with every lane of the block on each
        # chunk a ray of it needs.
        spent_1 = counts["thread_slots"]
        k = cuda_ms(lambda: ti.occluded(*args), KERNEL_ITERS, torch)
        p = cuda_ms(lambda: ti.occluded_plain(*args),
                    PLAIN_ITERS if onc <= 16 else GRID_PLAIN_ITERS, torch,
                    warm=False)
        slabs = counts["slab_tests"]
        n_bytes = 10 * 4 * n + (3 * 4 * oprep.mu.shape[1] + 8 * onc
                                + 8 * ti.SUB * onc) * 4
        log(f"  {needed:.4g} ray-triangle tests and {slabs:.4g} slab tests "
            f"needed ({needed / max(n_q, 1):.1f} tests per query), "
            f"{counts['slots']:.4g} thread-slots swept "
            f"({needed / max(counts['slots'], 1.0):.3f} useful; a thread per "
            f"ray: {spent_1:.4g}, {needed / max(spent_1, 1.0):.3f} useful); "
            f"the bound with all {n * onc} ray-chunk slab tests (the "
            f"earlier count): {bound(needed, n * onc, n_bytes)[0]:.4f} ms")
        record("occluded", float(flips), k, p, *bound(needed, slabs,
                                                      n_bytes))

    # Kernel 2 at the regen wavefront, on the demo (and on the grid below).
    occlusion_check("demo", scene, cam, prep)

    # Kernels 3 and 6 on the sphere grids of the JAX bench: the middle
    # 1080p tile's primary rays, then one bounce from their hits.
    grid = build_sphere_grid(n=10, sphere_detail=16)
    grid_cam = grid_camera(W, H, n=10)
    grid_prep = ti.prepare_trace_inputs(grid)
    big = build_sphere_grid(n=14, sphere_detail=16)
    big_cam = grid_camera(W, H, n=14)
    big_prep = ti.prepare_trace_inputs(big)
    check(grid_prep.superchunks and grid_prep.m3_bytes
          <= ti._SC_RESIDENT_BYTES, "the grid does not take kernel 3")
    check(big_prep.m3_bytes > ti._SC_RESIDENT_BYTES,
          "the n=14 grid does not take kernel 6")
    # Kernel 2 on the grid's shadow rays: grid regen + NEE's query, over
    # the 376 flat chunks.
    occlusion_check("grid", grid, grid_cam, grid_prep)

    def two_level_bytes(p, n, out_rows, tab):
        """Rays in and rows out once, the triangle rows, both box sets and
        (kernel 6) the winner table once."""
        e_pad = p.mu_pad.shape[1]
        return ((8 + out_rows) * 4 * n + 3 * 4 * e_pad * 4
                + 8 * (e_pad // ti.BT + p.sc_bounds.shape[1]) * 4
                + (ti.TAB_R * e_pad * 4 if tab else 0))

    for label, gscene, gcam, gprep in (("grid", grid, grid_cam, grid_prep),
                                       ("n=14 grid", big, big_cam,
                                        big_prep)):
        lite = gprep is grid_prep
        primary, ghit, gs, gseed = kt.middle_rays(gscene, gcam, gprep, cfg,
                                                  tile, mid_tile)
        bounce, bactive = kt.bounce_rays(gs, ghit, gseed, cfg)
        for name, (ray, active) in {"primary": (primary, None),
                                    "bounce 1": (bounce, bactive)}.items():
            o4t, d4t = ti.pack_rays(ray, active)
            n = o4t.shape[1]
            geo = (o4t, d4t, gprep.sc_bounds, gprep.chunk_bounds,
                   gprep.mu_pad, gprep.mv_pad, gprep.mw_pad)
            if lite:
                kname, kfn, pfn = ("closest_hit_sc_lite",
                                   ti.closest_hit_sc_lite,
                                   ti.closest_hit_sc_lite_plain)
                args = geo[:4] + (gprep.group_bounds,) + geo[4:] \
                    + (gprep.scc,)
            else:
                kname, kfn, pfn = ("closest_hit_rows_sc",
                                   ti.closest_hit_rows_sc,
                                   ti.closest_hit_rows_sc_plain)
                args = geo + (gprep.tab, gprep.scc)
            got = kfn(*args)
            want = pfn(*args)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            t_row = 0 if lite else 40
            n_hit = int((want[t_row] < ti._MISS).sum())
            check(n_hit > n // 10, f"{label} {name}: only {n_hit} rays hit")
            log(f"{kname} vs plain, {label}, {name} rays ({n}, {n_hit} "
                f"hit): max |diff| {err:g} over rows 0-{got.shape[0] - 1}")
            check(torch.equal(got, want), f"{kname}, {label} {name}: rows "
                  f"differ from the plain version")
            check(torch.equal(got[t_row].view(torch.int32),
                              want[t_row].view(torch.int32)),
                  f"{kname}, {label} {name}: t is not bitwise equal")
            work = ti.walk_two_level_plain(
                *geo, gprep.scc,
                group_bounds=gprep.group_bounds if lite else None)
            needed = float(work.walk.steps.sum())
            slabs = float(work.slab_tests.sum())
            # Thread-slots: the kernel's block-cooperative mapping (a warp
            # per needing ray, or its own thread where the needing warps
            # are nearly full: ti.two_level_slots), beside a thread per
            # ray with every lane of the block on each staged chunk.
            spent = float(work.slots[::ti.BN].sum())
            spent_1 = float(work.chunk_sweeps[::ti.BN].sum()) * ti.BN * ti.BT
            k = cuda_ms(lambda: kfn(*args), KERNEL_ITERS, torch)
            p = cuda_ms(lambda: pfn(*args), GRID_PLAIN_ITERS, torch,
                        warm=False)
            log(f"  {needed:.4g} ray-triangle tests and {slabs:.4g} slab "
                f"tests needed, {spent:.4g} thread-slots swept "
                f"({needed / max(spent, 1.0):.3f} useful; a thread per "
                f"ray: {spent_1:.4g}, {needed / max(spent_1, 1.0):.3f} "
                f"useful)")
            n_bytes = two_level_bytes(gprep, n, 8 if lite else ti.OUT_R,
                                      not lite)
            record(kname, err, k, p, *bound(needed, slabs, n_bytes))
            if lite:
                # The group gate: the share of row 2's tests the kernel
                # still runs (32 a group swept), and the bound on the tests
                # it runs, with each swept chunk's 8 group slab tests (and
                # its 8 boxes read once).
                run = float(work.group_sweeps.sum()) * ti.GW
                gslabs = ti.GROUPS * needed / ti.BT
                gbnd, gwhat = bound(run, slabs + gslabs, n_bytes + 8 * 4
                                    * gprep.group_bounds.shape[1])
                log(f"  groups_kept {run / max(needed, 1.0):.4f}: "
                    f"{run:.4g} of the {needed:.4g} tests of row 2 run, "
                    f"with {gslabs:.4g} group slab tests; bound on the "
                    f"tests run {gbnd:.4f} ms ({gwhat}), {gbnd / k:.3f} "
                    f"of it (row 2's bound "
                    f"{bound(needed, slabs, n_bytes)[0]:.4f} ms)")
                # The lite epilogue against kernel 6's rows on this tile.
                ti._SC_LITE = False
                try:
                    rows_hit = ti.trace_pallas(gscene, ray, active, gprep)
                finally:
                    ti._SC_LITE = True
                lite_hit = ti.trace_pallas(gscene, ray, active, gprep)
                check(rows_hit.rows is not None and lite_hit.rows is None,
                      "the _SC_LITE switch did not change the kernel")
                for f in ("t", "eidx", "tri", "inst"):
                    check(torch.equal(getattr(lite_hit, f),
                                      getattr(rows_hit, f)),
                          f"grid {name}: the lite path's {f} differs from "
                          f"kernel 6's")
                on = lite_hit.hit
                duv = max(float((lite_hit.u - rows_hit.u)[on].abs().max()),
                          float((lite_hit.v - rows_hit.v)[on].abs().max()))
                log(f"  lite epilogue vs kernel 6 rows, grid {name}: t, "
                    f"eidx, tri, inst equal; max |u, v diff| {duv:g}")
                check(duv <= 1e-4, f"grid {name}: u/v differ by {duv:g}")

    # Kernel 7 (one round of regen's frontier march) on the grid's middle
    # tile, the lanes in regen's march-key order and queued by the march's
    # own candidate scan and block queues (sentinels and repeats among
    # them): primary rays from the spawn state (no winner, BIG_E), a second
    # round from the first's carried best with the cursors past the first
    # candidate, bounce-1 rays; and one round whose queue lists every
    # superchunk, which must give kernel 3's winners.
    nsc = grid_prep.sc_bounds.shape[1]
    mgeo = (grid_prep.sc_bounds, grid_prep.chunk_bounds, grid_prep.mu_pad,
            grid_prep.mv_pad, grid_prep.mw_pad, grid_prep.scc)
    primary, ghit, gs, gseed = kt.middle_rays(grid, grid_cam, grid_prep, cfg,
                                              tile, mid_tile)
    bounce, bactive = kt.bounce_rays(gs, ghit, gseed, cfg)

    def first_visits(queue, n):
        """``queue`` with each block's repeats of an entry after its first
        replaced by the sentinel nsc."""
        q = queue.view(n // ti.BN, -1)
        ql = q.shape[1]
        slot = torch.arange(ql, device=dev)
        earlier = slot[:, None] > slot[None, :]  # (this slot, an earlier)
        seen = ((q[:, :, None] == q[:, None, :]) & earlier).any(dim=2)
        return torch.where(seen & (q < nsc), nsc, q).reshape(-1)

    def march_check(what, o4t, d4t, init, queue):
        """Kernel 7 against its plain version on one round; the plain
        version's rows and the kernel's time. The bound counts the tests of
        the same round without the queue's repeats, which change no
        winner."""
        args = (o4t, d4t, init, queue) + mgeo
        n = o4t.shape[1]
        got = ti.march_step_sc(*args)
        spent = {}
        want = ti.march_step_sc_plain(*args, counts=spent)
        counts = {}
        once = ti.march_step_sc_plain(o4t, d4t, init,
                                      first_visits(queue, n), *mgeo,
                                      counts=counts)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        real = queue.view(n // ti.BN, -1) < nsc
        repeats = int(real.sum()) - int((first_visits(queue, n) < nsc).sum())
        check(torch.equal(once[:2].view(torch.int32),
                          want[:2].view(torch.int32)),
              f"kernel 7, {what}: the queue's repeats changed a winner")
        n_hit = int((want[0] < ti._MISS).sum())
        log(f"kernel 7 vs plain, grid, {what} ({n} rays, {n_hit} with a "
            f"best; queue {queue.numel()} slots: {int(real.sum())} "
            f"superchunks, {int((~real).sum())} sentinels, {repeats} "
            f"repeats): max |diff| {err:g}")
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"kernel 7, {what}: differs from its plain version")
        needed = float(once[2].sum())
        k = cuda_ms(lambda: ti.march_step_sc(*args), KERNEL_ITERS, torch)
        p = cuda_ms(lambda: ti.march_step_sc_plain(*args), GRID_PLAIN_ITERS,
                    torch, warm=False)
        log(f"  {needed:.4g} ray-triangle tests and "
            f"{counts['slab_tests']:.4g} slab tests needed (the round "
            f"swept {float(want[2].sum()):.4g} with the repeats); "
            f"{spent['slots']:.4g} thread-slots swept "
            f"({needed / max(spent['slots'], 1.0):.3f} useful; a thread per "
            f"ray: {spent['thread_slots']:.4g}, "
            f"{needed / max(spent['thread_slots'], 1.0):.3f} useful)")
        record("march_step_sc", err, k, p, *bound(
            needed, counts["slab_tests"], two_level_bytes(grid_prep, n, 8,
                                                          False)
            + 2 * 4 * n + 4 * queue.numel()))
        return want, k

    rounds = kt.march_rounds(grid_prep, primary, bounce, bactive, cfg)
    for rd in rounds:
        want, k7 = march_check(rd.what, rd.o4t, rd.d4t, rd.init, rd.queue)
        if rd is rounds[0]:
            check(int((want[0] < ti._MISS).sum()) > tile // 10,
                  "kernel 7: few primary rays found a best in the first "
                  "round")
    # The last round lists every superchunk: kernel 3's walk.
    full, o4t, d4t = want, rd.o4t, rd.d4t
    lgeo = mgeo[:2] + (grid_prep.group_bounds,) + mgeo[2:]
    lite = ti.closest_hit_sc_lite(o4t, d4t, *lgeo)
    torch.cuda.synchronize()
    hit = lite[0] < ti._MISS
    check(torch.equal(full[[0, 2, 3]], lite[[0, 2, 3]])
          and torch.equal(full[1][hit], lite[1][hit]),
          "kernel 7 with every superchunk queued differs from kernel 3")
    # The same walk: kernel 3 timed on the same rays (not recorded: kernel
    # 3's own tiles are the unsorted ones above).
    k3 = cuda_ms(lambda: ti.closest_hit_sc_lite(o4t, d4t, *lgeo),
                 KERNEL_ITERS, torch)
    log(f"  kernel 7 with every superchunk queued: kernel 3's t, eidx, "
        f"steps and entries on every ray; kernel 7 {k7:.4f} ms, kernel 3 "
        f"{k3:.4f} ms on the same rays ({k7 / k3:.3f}) on {card}")

    # Kernel 5 on the soft-shadow rays of the middle tile's primary hits,
    # on the demo (the NEE shadow rays of kernel 4's check) and on the grid,
    # over each scene's unpadded chunks (ops/tiles.py, also the turns
    # tool's).
    for label, pscene, pcam, pprep, iters in (
            ("demo", scene, cam, prep, PLAIN_ITERS),
            ("grid", grid, grid_cam, grid_prep, GRID_PLAIN_ITERS)):
        args, n_q = kt.soft_shadow_operands(pscene, pcam, pprep, cfg,
                                            SOFT_EPS)
        e5 = pprep.mu.shape[1]
        n = args[0].shape[1]
        margin, eidx = ti.soft_occluded(*args)
        want = ti.soft_occluded_plain(*args)
        torch.cuda.synchronize()
        err = float((margin - want.margin).abs().max())
        flips = int((eidx != want.eidx).sum())
        found = want.margin > -1e8
        log(f"kernel 5 vs plain, {label}: {n} shadow rays ({n_q} queries, "
            f"{int(found.sum())} with a candidate, "
            f"{int((want.margin == 1.0).sum())} at margin 1.0, "
            f"{int(((want.margin > -1e8) & (want.margin < 1.0)).sum())} "
            f"below): max |margin diff| {err:g}, {flips} eidx mismatches")
        check(torch.equal(margin.view(torch.int32),
                          want.margin.view(torch.int32)) and flips == 0,
              f"kernel 5, {label}: differs from its plain version")
        check(int(found.sum()) > 0, f"kernel 5, {label}: no candidates")
        # Work: the candidate tests the rays need against the thread-slots
        # of the block-cooperative walk (ti.two_level_slots of each
        # chunk's gates), beside a thread per ray's (every lane of a block
        # on each chunk some ray of it needs).
        needed = float(want.tests.sum())
        spent = float(want.slots[::ti.BN].sum())
        spent_1 = float(want.sweeps[::ti.BN].sum()) * ti.BN * ti.BT
        k = cuda_ms(lambda: ti.soft_occluded(*args), KERNEL_ITERS, torch)
        p = cuda_ms(lambda: ti.soft_occluded_plain(*args), iters, torch,
                    warm=False)
        log(f"  {needed:.4g} candidate tests needed "
            f"({needed / max(n_q, 1):.1f} per query), {spent:.4g} "
            f"thread-slots swept ({needed / max(spent, 1.0):.3f} useful; a "
            f"thread per ray: {spent_1:.4g}, "
            f"{needed / max(spent_1, 1.0):.3f} useful)")
        record("soft_occluded", max(err, float(flips)), k, p, *bound(
            needed, n * (e5 // ti.BT),
            17 * 4 * n + 8 * n + (12 + 3) * 4 * e5 + 8 * 4 * (e5 // ti.BT),
            OPS_PER_SOFT_TEST))

    # Kernels 10 and 11 on the camera paths of the middle 1080p tile: kernel
    # 10 at bounce 0 and, from its plain version's state, bounce 1, without
    # and with NEE; kernel 11 over 5 bounces on the demo and the mid grid.
    mid = build_sphere_grid(n=4, sphere_detail=12)
    mid_cam = grid_camera(W, H, n=4)
    mid_prep = ti.prepare_trace_inputs(mid)

    ray, pseed = kt.camera_rays(cam, cfg, tile, mid_tile, dev)
    for nee in (False, True):
        mcfg = cfg.replace(traversal=Traversal.MEGA, nee=nee)
        lt = mk._build_light_block(prep.lights if nee else None, dev)
        geo = (prep.bounds, prep.sub_bounds, prep.mu, prep.mv, prep.mw,
               prep.tab, lt)
        state = mk.pack_state(ray, pseed, cam.far)
        n = state[0].shape[1]
        for b in (0, 1):
            got = mk.mega_step(*state, *geo, b, mcfg)
            counts = {}
            want = mk.mega_step_plain(*state, *geo, b, mcfg, counts=counts)
            torch.cuda.synchronize()
            differ, err = bit_mismatch(got, want, torch)
            live = int((state[0][12] > 0).sum())
            what = f"kernel 10{', NEE' if nee else ''}, bounce {b}"
            log(f"{what} vs plain ({n} rays, {live} live, "
                f"{counts.get('shadow_rays', 0)} shadow queries): "
                f"{differ} rays not bit-equal, max |diff| {err:g}")
            check(live > n // 10, f"{what}: only {live} live rays")
            check(differ == 0, f"{what}: {differ} rays differ from the "
                  f"plain version")
            k = cuda_ms(lambda: mk.mega_step(*state, *geo, b, mcfg),
                        KERNEL_ITERS, torch)
            p = cuda_ms(lambda: mk.mega_step_plain(*state, *geo, b, mcfg),
                        PLAIN_ITERS, torch, warm=False)
            log(f"  {counts['tests']:.4g} ray-triangle tests needed "
                f"(both walks), {counts['slots']:.4g} thread-slots swept "
                f"({counts['tests'] / max(counts['slots'], 1.0):.3f} useful;"
                f" a thread per ray: {counts['thread_slots']:.4g}, "
                f"{counts['tests'] / max(counts['thread_slots'], 1.0):.3f} "
                f"useful)")
            record("mega_step", err, k, p, *bound(
                counts["tests"], (2 if nee else 1) * n * nc,
                2 * (mk.FS_R + mk.IS_R) * 4 * n + scene_bytes + tab_bytes
                + lt.numel() * 4,
                other_ops=live * (OPS_SHADE_MEGA_NEE if nee
                                  else OPS_SHADE_MEGA)))
            state = want

    fcfg = cfg.replace(traversal=Traversal.FUSED)
    for label, fscene, fcam, fprep, iters in (
            ("demo", scene, cam, prep, PLAIN_ITERS),
            ("mid grid", mid, mid_cam, mid_prep, GRID_PLAIN_ITERS)):
        args = kt.fused_operands(fscene, fcam, fprep, cfg)
        got = fu.fused_paths(*args, fcfg)
        counts = {}
        want = fu.fused_paths_plain(*args, fcfg, counts=counts)
        torch.cuda.synchronize()
        differ, err = bit_mismatch(got, want, torch)
        n, e11 = args[0].shape[1], fprep.mu.shape[1]
        segs = int(want[1].sum())
        n_hit = int((want[0][3] < ti._MISS).sum())
        log(f"kernel 11 vs plain, {label} ({n} rays, {n_hit} hit, {segs} "
            f"segments, {e11 // ti.BT} chunks): {differ} rays not "
            f"bit-equal, max |diff| {err:g}")
        check(n_hit > n // 10, f"kernel 11, {label}: only {n_hit} rays hit")
        check(differ == 0, f"kernel 11, {label}: {differ} rays differ from "
              f"the plain version")
        k = cuda_ms(lambda: fu.fused_paths(*args, fcfg), KERNEL_ITERS, torch)
        p = cuda_ms(lambda: fu.fused_paths_plain(*args, fcfg), iters, torch,
                    warm=False)
        # Thread-slots over the bounces: the block-cooperative walk's, and
        # a thread per ray's (dead paths included, as they sit in blocks).
        log(f"  {counts['tests']:.4g} ray-triangle tests needed "
            f"({counts['tests'] / segs:.1f} per segment), "
            f"{counts['slots']:.4g} thread-slots swept "
            f"({counts['tests'] / max(counts['slots'], 1.0):.3f} useful; a "
            f"thread per ray: {counts['thread_slots']:.4g}, "
            f"{counts['tests'] / max(counts['thread_slots'], 1.0):.3f} "
            f"useful)")
        record("fused_paths", err, k, p, *bound(
            counts["tests"], fcfg.bounces * n * (e11 // ti.BT),
            18 * 4 * n + (12 + ti.TABLE_W) * 4 * e11
            + 8 * 4 * (e11 // ti.BT) + args[-1].numel() * 4,
            other_ops=segs * OPS_SHADE_FUSED))

    # Kernels 8 and 9 (the classic (t, idx) closest hit over the raw chunk
    # boxes, gated per ray and per block) on the demo's middle tile, primary
    # and bounce-1 rays, and on the mid grid's (34 chunks, flat), against
    # their plain versions and against the default traversal's winners
    # (kernel 1 on the demo, kernel 3 on the mid grid).
    demo_tiles = kt.classic_tiles(scene, cam, prep, cfg)
    mid_tiles = kt.classic_tiles(mid, mid_cam, mid_prep, cfg)
    for label, cscene, cprep, (ray, active, args) in (
            ("demo, primary", scene, prep, demo_tiles["primary"]),
            ("demo, bounce 1", scene, prep, demo_tiles["bounce 1"]),
            ("mid grid, primary", mid, mid_prep, mid_tiles["primary"])):
        n, e8 = args[0].shape[1], cprep.mu.shape[1]
        iters = PLAIN_ITERS if label.startswith("demo") else GRID_PLAIN_ITERS
        out = {}
        for kname, kfn, pfn in (
                ("closest_hit_classic", ti.closest_hit_classic,
                 ti.closest_hit_classic_plain),
                ("closest_hit_loop", ti.closest_hit_loop,
                 ti.closest_hit_loop_plain)):
            t, idx = kfn(*args)
            counts = {}
            want_t, want_i = pfn(*args, counts=counts)
            torch.cuda.synchronize()
            err = float((t - want_t).abs().max())
            n_hit = int((want_t < ti._MISS).sum())
            log(f"{kname} vs plain, {label} ({n} rays, {n_hit} hit, "
                f"{e8 // ti.BT} chunks): max |diff| {err:g}")
            check(n_hit > n // 10, f"{kname}, {label}: only {n_hit} hit")
            check(torch.equal(t.view(torch.int32), want_t.view(torch.int32))
                  and torch.equal(idx, want_i),
                  f"{kname}, {label}: differs from its plain version")
            k = cuda_ms(lambda: kfn(*args), KERNEL_ITERS, torch)
            p = cuda_ms(lambda: pfn(*args), iters, torch, warm=False)
            log(f"  {counts['tests']:.4g} ray-triangle tests swept, "
                f"{counts['slots']:.4g} thread-slots "
                f"({counts['tests'] / max(counts['slots'], 1.0):.3f} useful;"
                f" a thread per ray: {counts['thread_slots']:.4g}, "
                f"{counts['tests'] / max(counts['thread_slots'], 1.0):.3f} "
                f"useful)")
            record(kname, err, k, p, *bound(
                counts["tests"], n * (e8 // ti.BT),
                8 * 4 * n + 2 * 4 * n + 3 * 4 * e8 * 4
                + 8 * 4 * (e8 // ti.BT)))
            out[kname] = (t[:tile], idx[:tile])
        ref = ti.trace_pallas(cscene, ray, active, cprep)
        (t8, i8), (t9, i9) = out["closest_hit_classic"], \
            out["closest_hit_loop"]
        same8 = float(((t8 == ref.t) & (i8 == ref.eidx)).float().mean())
        same9 = float(((t9 == t8) & (i9 == i8)).float().mean())
        log(f"  {label}: kernel 8's (t, eidx) equal the default traversal's "
            f"on {same8:.6f} of rays, kernel 9's equal kernel 8's on "
            f"{same9:.6f}")
        check(same8 >= 0.99 and same9 >= 0.99,
              f"{label}: kernels 8 and 9 disagree with the other winners")

    # The BVH traversal's kernel on its tiles (ops/tiles.py bvh_tiles) on the
    # demo and the grid, bit for bit against trace_bvh_plain.
    for label, bscene, bcam in (("demo", scene, cam),
                                ("grid", grid, grid_cam)):
        tables = sum(getattr(bscene, f).numel() * 4 for f in (
            "tri_pos", "node_min", "node_max", "node_left", "node_right",
            "node_first", "node_count", "tlas_min", "tlas_max", "tlas_left",
            "tlas_right", "tlas_inst", "inst_inv_transform", "inst_root"))
        for name, bt in kt.bvh_tiles(bscene, bcam, cfg).items():
            bargs = (bscene, bt.ray, bt.active, bt.max_stack, bt.max_iters)
            got = trace_bvh(*bargs)
            counts = {}
            want = trace_bvh_plain(*bargs, counts=counts)
            torch.cuda.synchronize()
            n = bt.ray.o.x.shape[0]
            differ = torch.zeros(n, dtype=torch.bool, device=dev)
            for f in ("t", "u", "v"):
                differ |= getattr(got, f).view(torch.int32) \
                    != getattr(want, f).view(torch.int32)
            for f in ("tri", "inst", "front", "steps"):
                differ |= getattr(got, f) != getattr(want, f)
            on = want.hit
            err = max(float((got.t - want.t)[on].abs().max()) if bool(
                on.any()) else 0.0, float(int(differ.sum())))
            log(f"trace_bvh vs plain, {label}, {name} ({n} rays, "
                f"{int(on.sum())} hit, max_stack {bt.max_stack}, max_iters "
                f"{bt.max_iters}): {int(differ.sum())} rays not bit-equal")
            check(int(on.sum()) > n // 10, f"trace_bvh, {label} {name}: only "
                  f"{int(on.sum())} rays hit")
            check(not bool(differ.any()), f"trace_bvh, {label} {name}: "
                  f"differs from its plain version")
            k = cuda_ms(lambda: trace_bvh(*bargs), KERNEL_ITERS, torch)
            p = cuda_ms(lambda: trace_bvh_plain(*bargs), 1, torch,
                        warm=False)
            log(f"  {counts['pops']:.4g} pops ({counts['pops'] / n:.1f} a "
                f"ray), {counts['inner']:.4g} inner nodes, "
                f"{counts['blas']:.4g} object-space rays, "
                f"{counts['tri_tests']:.4g} triangle tests")
            record("trace_bvh", err, k, p, *bound(
                counts["tri_tests"], 2 * counts["inner"],
                (6 * 4 + 1 + 7 * 4) * n + tables, OPS_PER_MT,
                counts["pops"] * OPS_PER_POP
                + counts["blas"] * OPS_PER_OBJ_RAY
                + 2 * counts["inner"] * (OPS_PER_AABB - OPS_PER_SLAB)))

    # Regen's lane kernels (csrc/regen_lanes.cu, no TPU kernel) on one
    # iteration's lanes of the 1080p wavefront, on the demo and the bench
    # grid, with a refill that finds a path for every dead lane: bit for bit
    # against their plain versions (regen's torch glue), then timed in
    # turns with that glue (glue, kernels, kernels, glue), the stable sort
    # between them timed alone; bound: their bytes.
    from gdpathtracing_torch.render.integrator import morton_frame
    for label, lscene, lcam in (("demo", scene, cam),
                                ("grid", grid, grid_cam)):
        nw = cfg.regen_wavefront
        fs, ints, alive, dead_now = lane_state(lscene, nw, 13, torch)
        lo, span = morton_frame(lscene)
        sp = lanes.lane_spawn(lcam.to(dev), cfg, 7)
        n_alive, n_fresh = int(alive.sum()), int(dead_now.sum())
        logs = [(torch.zeros((7, W * H + nw), device=dev),
                 torch.zeros((3, W * H + nw), dtype=torch.int64, device=dev))
                for _ in range(2)]
        counts = (n_alive, n_fresh, W * H // 2, 1000)
        key = lanes.regen_lane_key(fs, alive, dead_now, lo, span)
        perm = torch.argsort(key, stable=True)
        got = lanes.regen_lane_refill(perm, fs, ints, *logs[0], *counts, sp)
        torch.cuda.synchronize()
        want_key = lanes.regen_lane_key_plain(fs, alive, dead_now, lo, span)
        want = lanes.regen_lane_refill_plain(perm, fs, ints, *logs[1],
                                             *counts, sp)
        differ, err = bit_mismatch(got[:2], want[:2], torch)
        same = (torch.equal(key, want_key) and differ == 0
                and torch.equal(got[2], want[2])
                and torch.equal(logs[0][0].view(torch.int32),
                                logs[1][0].view(torch.int32))
                and torch.equal(logs[0][1], logs[1][1]))
        log(f"regen lanes, {label} ({nw} lanes, {n_alive} alive, {n_fresh} "
            f"ended now, all refilled): key, stacks, mask and log "
            f"{'bit-equal' if same else 'DIFFER'} (lanes differing "
            f"{differ}, max |diff| {err:.3g})")
        check(same, f"regen lanes, {label}: the kernels differ from the "
              f"torch glue")
        a = (fs, alive, dead_now, lo, span)
        b = (fs, ints, *logs[0], *counts, sp)

        def glue():
            lanes.regen_lane_refill_plain(torch.argsort(
                lanes.regen_lane_key_plain(*a), stable=True), *b)

        def kernels_():
            lanes.regen_lane_refill(torch.argsort(
                lanes.regen_lane_key(*a), stable=True), *b)

        turns = [("glue", glue), ("kernels", kernels_), ("kernels", kernels_),
                 ("glue", glue)]
        ms = {"glue": [], "kernels": []}
        for what, fn in turns:
            ms[what].append(cuda_ms(fn, KERNEL_ITERS, torch))
        k_ms = cuda_ms(lambda: lanes.regen_lane_key(*a), KERNEL_ITERS, torch)
        s_ms = cuda_ms(lambda: torch.argsort(key, stable=True), KERNEL_ITERS,
                       torch)
        r_ms = cuda_ms(lambda: lanes.regen_lane_refill(perm, *b),
                       KERNEL_ITERS, torch)
        # key: 6 f32 rows and 2 masks read, the int32 key written; refill:
        # perm, the 17 + 6 rows of each kept lane, the 10 logged rows of
        # each lane both logged and refilled, read; 17 + 6 rows and the
        # mask written, the 7 + 3 rows of each logged lane appended.
        refilled = nw - n_alive
        k_bytes = nw * (6 * 4 + 2 + 4)
        r_bytes = (nw * (8 + 116 + 1) + (nw - refilled) * 116
                   + n_fresh * 52 + n_fresh * 52)
        log(f"  {label} on {card}: torch glue (key, sort, refill) "
            + ", ".join(f"{x:.3f}" for x in ms["glue"]) + " ms; kernels "
            "and sort " + ", ".join(f"{x:.3f}" for x in ms["kernels"])
            + f" ms (in turns); regen_lane_key {k_ms:.4f} ms, bound "
            f"{k_bytes / PEAK_BYTES * 1e3:.4f} ms (bytes); stable sort "
            f"{s_ms:.4f} ms; regen_lane_refill {r_ms:.4f} ms, bound "
            f"{r_bytes / PEAK_BYTES * 1e3:.4f} ms (bytes)")

    # The primal BVH loop's shading kernel (csrc/path_shade.cu, no TPU
    # kernel) on the carries of the 262144-lane tile through the middle of
    # a 1080p RenderConfig() demo frame: bounce 0 on the camera rays, then
    # bounce 1 on what bounce 0 left; bit for bit against its plain version
    # (the standard loop's torch body), both timed; bound: the bytes of
    # the kernel's note (207 a lane; the scene rows a hit lane gathers stay
    # in L2 and are not counted). Back to back, a call costs what its
    # wrapper's checks and launch cost the host, so the kernel's own time
    # is read from the profiler.
    from gdpathtracing_torch.core.vec import Vec3
    from gdpathtracing_torch.render.integrator import bvh_carry
    from gdpathtracing_torch.render.types import Ray
    from gdpathtracing_torch.utils.telemetry import Profile
    bcfg = RenderConfig()
    nb = bcfg.tile_rays
    ray, seed = kt.camera_rays(cam, bcfg, nb, kt.middle_tile(bcfg), dev)
    carry = bvh_carry(ray, seed, cam.far)
    for bounce in (0, 1):
        fs, active = carry[0], carry[3]
        hit = trace_bvh(scene, Ray(Vec3(*fs[0:3]), Vec3(*fs[3:6])), active,
                        bcfg.max_stack)
        args = (scene, hit, *carry, bcfg, bounce)
        got = shade.path_shade_bvh(*args)
        want = shade.path_shade_bvh_plain(*args)
        torch.cuda.synchronize()

        def int_rows(out):
            return torch.cat([out[1], out[2].to(torch.int64),
                              out[3][None].to(torch.int64)])

        differ, err = bit_mismatch((got[0], int_rows(got)),
                                   (want[0], int_rows(want)), torch)
        n_live, n_hit = int(active.sum()), int((hit.hit & active).sum())
        log(f"path_shade_bvh vs plain, demo bounce {bounce} ({nb} lanes, "
            f"{n_live} active, {n_hit} hit, {int(got[3].sum())} go on): "
            f"{differ} lanes not bit-equal (max |diff| {err:.3g})")
        check(differ == 0, f"path_shade_bvh, bounce {bounce}: differs from "
              f"its plain version")
        c = cuda_ms(lambda: shade.path_shade_bvh(*args), KERNEL_ITERS, torch)
        with Profile("cuda") as prof:
            for _ in range(KERNEL_ITERS):
                shade.path_shade_bvh(*args)
            torch.cuda.synchronize()
        k = sum(v for name, v in prof.summary.op_s.items()
                if "path_shade_bvh_kernel" in name) / KERNEL_ITERS * 1e3
        check(k > 0.0, "the profiler saw no path_shade_bvh_kernel")
        p = cuda_ms(lambda: shade.path_shade_bvh_plain(*args), PLAIN_ITERS,
                    torch, warm=False)
        bnd = 207 * nb / PEAK_BYTES * 1e3
        log(f"  path_shade_bvh on {card}: kernel {k:.4f} ms on the device "
            f"(profiler), a call back to back {c:.4f} ms, plain {p:.4f} ms, "
            f"bound {bnd:.4f} ms (bytes), the kernel at {bnd / k:.3f} of the "
            f"bound")
        carry = got

    # -- 3. the main paths at 1080p -----------------------------------------
    phase("3. the primal paths at 1080p")
    kernels = {"closest_hit_rows": ti.closest_hit_rows,
               "occluded": ti.occluded,
               "closest_hit_rows_nee": ti.closest_hit_rows_nee,
               "closest_hit_sc_lite": ti.closest_hit_sc_lite,
               "closest_hit_rows_sc": ti.closest_hit_rows_sc,
               "soft_occluded": ti.soft_occluded,
               "mega_step": mk.mega_step,
               "fused_paths": fu.fused_paths,
               "march_step_sc": ti.march_step_sc,
               "closest_hit_classic": ti.closest_hit_classic,
               "closest_hit_loop": ti.closest_hit_loop,
               "trace_bvh": trace_bvh,
               "regen_shade": shade.regen_shade,
               "regen_shade_lite": shade.regen_shade_lite,
               "regen_lane_key": lanes.regen_lane_key,
               "regen_lane_refill": lanes.regen_lane_refill,
               "path_shade_bvh": shade.path_shade_bvh}
    launches = dict.fromkeys(kernels, 0)
    n_tiles = -(-(W * H) // cfg.tile_rays)
    # (scene label, scene, camera, its closest-hit kernel, [(path name,
    # config, timed frames)])
    mega, fused = Traversal.MEGA, Traversal.FUSED
    brute, unit = Traversal.BRUTE, Traversal.UNIT
    march = cfg.replace(regen_march=True)
    default = RenderConfig()  # Traversal.BVH, the standard loop
    # The glass room: the demo's Cornell room with a clear glass sphere
    # (tests/test_golden.py's glass scene), so every path through it takes
    # the dielectric lobe.
    glass, glass_cam = glass_room(), cam
    # BRUTE on the grid is left out: 96256 triangles against ~8.3 million
    # segments a frame is ~10^12 ray-triangle tests.
    runs = [
        ("demo", scene, cam, "closest_hit_rows", [
            ("standard loop", cfg.replace(regen=False), 2),
            ("regen", cfg, 2),
            ("regen + NEE", cfg.replace(nee=True), 2),
            ("standard loop + NEE", cfg.replace(nee=True, regen=False), 2),
            ("MEGA", cfg.replace(traversal=mega), 2),
            ("MEGA + NEE", cfg.replace(traversal=mega, nee=True), 2),
            ("FUSED", cfg.replace(traversal=fused), 2),
            ("BVH (RenderConfig())", default, 2),
            ("BVH + NEE", default.replace(nee=True), 2),
            ("BRUTE", RenderConfig(traversal=brute), 2),
            ("UNIT", RenderConfig(traversal=unit), 2),
            ("UNIT + NEE", RenderConfig(traversal=unit, nee=True), 2),
            ("UNIT, regen=True", RenderConfig(traversal=unit, regen=True),
             2),
            ("standard loop, rr_start=2", cfg.replace(regen=False,
                                                      rr_start=2), 2),
            ("regen, rr_start=2", cfg.replace(rr_start=2), 2),
            ("BVH, RenderConfig(rr_start=2)", RenderConfig(rr_start=2), 2)]),
        ("glass", glass, glass_cam, "closest_hit_rows", [
            ("regen", cfg, 2),
            ("standard loop + NEE", cfg.replace(nee=True, regen=False), 2),
            ("UNIT", RenderConfig(traversal=unit), 2)]),
        ("grid", grid, grid_cam, "closest_hit_sc_lite", [
            ("regen", cfg, 2),
            ("regen + NEE", cfg.replace(nee=True), 2),
            ("standard loop (sorted)", cfg.replace(regen=False), 2),
            ("regen, march", march, 2),
            ("regen + NEE, march", march.replace(nee=True), 2),
            ("BVH (RenderConfig())", default, 2)]),
        ("mid grid", mid, mid_cam, "closest_hit_sc_lite", [
            ("regen", cfg, 2),
            ("FUSED", cfg.replace(traversal=fused), 2),
            ("regen, march", march, 2)]),
        ("n=14 grid", big, big_cam, "closest_hit_rows_sc", [
            ("regen", cfg, 2),
            # over the 8 MiB threshold: the flag is ignored (kernel 6)
            ("regen, regen_march=True", march, 2)])]
    # The paths whose regen shades in a kernel, one launch an iteration:
    # regen_shade_lite on kernel 3's winners, regen_shade on kernels 1 and
    # 6's rows. Every other path shades in regen's torch body (NEE, the
    # march, glass, Russian roulette, BRUTE and UNIT) or runs no regen.
    shading = {"demo, regen": "regen_shade",
               "grid, regen": "regen_shade_lite",
               "mid grid, regen": "regen_shade_lite",
               "n=14 grid, regen": "regen_shade",
               "n=14 grid, regen, regen_march=True": "regen_shade"}
    # Each wrapper's source (csrc/) and the line of the TPU kernel it
    # replaces in gdpathtracing_tpu/ops/; the source `x.cu` defines the
    # kernel `x_kernel`, but for kernel 9, which closest_hit_classic.cu
    # defines as closest_hit_loop_kernel.
    sources = {"closest_hit_rows": ("closest_hit_rows.cu",
                                    "ops/intersect_pallas.py:520"),
               "occluded": ("occlusion.cu", "ops/intersect_pallas.py:1662"),
               "closest_hit_rows_nee": ("closest_hit_rows_nee.cu",
                                        "ops/intersect_pallas.py:613"),
               "closest_hit_sc_lite": ("closest_hit_sc_lite.cu",
                                       "ops/intersect_pallas.py:973"),
               "closest_hit_rows_sc": ("closest_hit_rows_sc.cu",
                                       "ops/intersect_pallas.py:864"),
               "soft_occluded": ("soft_occlusion.cu",
                                 "ops/intersect_pallas.py:1828"),
               "mega_step": ("mega_step.cu", "ops/megakernel.py:182"),
               "fused_paths": ("fused_paths.cu", "ops/fused_pallas.py:174"),
               "march_step_sc": ("march_step_sc.cu",
                                 "ops/intersect_pallas.py:1117"),
               "closest_hit_classic": ("closest_hit_classic.cu",
                                       "ops/intersect_pallas.py:52"),
               "closest_hit_loop": ("closest_hit_classic.cu",
                                    "ops/intersect_pallas.py:2047"),
               # not a Pallas kernel: the reference's plain-XLA loop
               "trace_bvh": ("trace_bvh.cu", "render/traverse.py:44")}
    kernel_symbols = {k: Path(src).stem + "_kernel"
                      for k, (src, _) in sources.items()}
    kernel_symbols["closest_hit_loop"] = "closest_hit_loop_kernel"

    # Kernels 8 and 9 through their own entry points, over every tile of a
    # 1080p demo frame's camera rays: trace_pallas_classic (kernel 8) and
    # closest_hit_loop (kernel 9), one launch a tile each; then kernel 1's
    # winners on the same rays, outside the count.
    tiles = []
    for k in range(n_tiles):
        pids = torch.arange(k * tile, min((k + 1) * tile, W * H), device=dev)
        tiles.append(cam.to(dev).generate_rays(pids, rng.prng_seed(
            pids % W, torch.div(pids, W, rounding_mode="floor"), 0), cfg)[0])
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    classic = [ti.trace_pallas_classic(scene, ray, None, prep)
               for ray in tiles]
    torch.cuda.synchronize()
    t_classic = time.perf_counter() - t0
    t0 = time.perf_counter()
    looped = [ti.closest_hit_loop(*ti.pack_rays(ray),
                                  scene.isect_chunk_bounds.contiguous(),
                                  prep.mu, prep.mv, prep.mw)
              for ray in tiles]
    torch.cuda.synchronize()
    t_loop = time.perf_counter() - t0
    got = {k: fn.launches for k, fn in kernels.items()}
    want = dict.fromkeys(kernels, 0)
    want["closest_hit_classic"] = want["closest_hit_loop"] = n_tiles
    log(f"demo, trace_pallas_classic and closest_hit_loop over a 1080p "
        f"frame's camera rays: launches {got}")
    check(got == want, f"classic entry points: launches {got}, expected "
          f"{want}")
    for k in kernels:
        launches[k] += got[k]
    same8 = same9 = 0
    for ray, h8, (t9, i9) in zip(tiles, classic, looped):
        h1 = ti.trace_pallas(scene, ray, None, prep)
        n = h1.t.shape[0]
        same8 += int(((h8.t == h1.t) & (h8.eidx == h1.eidx)).sum())
        same9 += int(((t9[:n] == h8.t) & (i9[:n] == h8.eidx)).sum())
    log(f"  {t_classic * 1e3:.1f} ms (trace_pallas_classic), "
        f"{t_loop * 1e3:.1f} ms (closest_hit_loop) for {W * H} rays; "
        f"kernel 8's (t, eidx) equal kernel 1's on {same8 / (W * H):.6f} "
        f"of them, kernel 9's equal kernel 8's on {same9 / (W * H):.6f}; "
        f"on {card}")
    check(same8 >= 0.99 * W * H and same9 >= 0.99 * W * H,
          "kernels 8 and 9 disagree with kernel 1 over the frame")

    paths = [(f"{label}, {name}", pscene, pcam, trace, pcfg, frames)
             for label, pscene, pcam, trace, group in runs
             for name, pcfg, frames in group]
    # A regen path's frames must equal, at the same frame index, those of
    # the standard loop rendered just before it: radiance and depth within
    # 1e-6, segments exact (tests/test_regen.py's comparison).
    same_as = {"demo, UNIT, regen=True": "demo, UNIT",
               "demo, regen, rr_start=2": "demo, standard loop, rr_start=2"}
    kept = {}
    for name, pscene, pcam, trace, pcfg, frames in paths:
        # The reference's auto policy: regen renders only PALLAS; BRUTE and
        # UNIT take it when asked.
        regen = pcfg.regen is True or (pcfg.regen is None and
                                       pcfg.traversal == Traversal.PALLAS)
        # A march path renders, in turns, its no-march counterpart at the
        # same frame index (outside the counts), and must equal it.
        march_flag = pcfg.regen_march is True
        got, iters = dict.fromkeys(kernels, 0), 0
        frame_s, segs, ref_s = [], [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_bytes = torch.cuda.memory_allocated()
        for f in range(frames):
            if march_flag:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ref = render_radiance(pscene, pcam,
                                      pcfg.replace(regen_march=None), f)
                torch.cuda.synchronize()
                ref_s.append(time.perf_counter() - t0)
            for fn in kernels.values():
                fn.launches = 0
            render_radiance_regen.iterations = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            aovs = render_radiance(pscene, pcam, pcfg, f)
            torch.cuda.synchronize()
            frame_s.append(time.perf_counter() - t0)
            for k, fn in kernels.items():
                got[k] += fn.launches
            iters += render_radiance_regen.iterations
            check(aovs.radiance.shape == (H, W, 3), f"{name}: shape")
            check(bool(torch.isfinite(aovs.radiance).all()),
                  f"{name}, frame {f}: non-finite radiance")
            seg = int(aovs.segments.sum())
            check(seg >= W * H, f"{name}, frame {f}: {seg} segments")
            segs.append(seg)
            if march_flag:
                for a in ("radiance", "depth", "segments"):
                    check(torch.equal(getattr(aovs, a), getattr(ref, a)),
                          f"{name}, frame {f}: {a} differs from the frame "
                          f"without the march")
            if name in same_as.values():
                kept.setdefault(name, []).append(aovs)
            if name in same_as:
                std = kept[same_as[name]][f]
                rad_err = float((aovs.radiance - std.radiance).abs().max())
                check(torch.allclose(aovs.radiance, std.radiance, rtol=1e-6,
                                     atol=1e-6)
                      and torch.allclose(aovs.depth, std.depth, rtol=1e-6,
                                         atol=0)
                      and torch.equal(aovs.segments, std.segments),
                      f"{name}, frame {f}: differs from {same_as[name]}")
                log(f"  frame {f}: equals {same_as[name]}'s (radiance max "
                    f"|diff| {rad_err:.3g}, depth within 1e-6, segments "
                    f"equal)")
        peak = torch.cuda.max_memory_allocated() - base_bytes
        kept.pop(same_as.get(name), None)
        check(iters > 0 if regen else iters == 0,
              f"{name}: render_radiance ran {iters} regen iterations")
        nee = pcfg.nee
        want = dict.fromkeys(kernels, 0)
        per_tile = frames * n_tiles
        if pcfg.traversal in (brute, unit):  # plain torch: no kernel
            pass
        elif pcfg.traversal == mega:  # one launch a tile and bounce
            want["mega_step"] = per_tile * pcfg.bounces
        elif pcfg.traversal == fused:  # one launch a tile
            want["fused_paths"] = per_tile
        elif pcfg.traversal == Traversal.BVH:  # one a tile and bounce, and
            #                                   one more for NEE's shadows
            want["trace_bvh"] = per_tile * pcfg.bounces * (2 if nee else 1)
            if shade.path_shade_entry(pscene, pcfg) == "bvh":
                want["path_shade_bvh"] = per_tile * pcfg.bounces
        elif regen:  # one closest hit (or march round) and, with NEE, one
            #          shadow query each
            marching = march_flag and trace == "closest_hit_sc_lite"
            want["march_step_sc" if marching else trace] = iters
            want["occluded"] = iters if nee else 0
            if name in shading:
                want[shading[name]] = iters
            if lanes.lanes_entry(pcfg, marching, False):  # the lanes' glue
                want["regen_lane_key"] = want["regen_lane_refill"] = iters
        elif nee and trace == "closest_hit_rows":  # fused NEE
            want["closest_hit_rows_nee"] = per_tile * pcfg.bounces
            want["occluded"] = per_tile
        else:  # unfused NEE on a superchunk scene
            want[trace] = per_tile * pcfg.bounces
            want["occluded"] = per_tile * pcfg.bounces if nee else 0
        log(f"{name}: launches {got}" + (f", {iters} regen iterations"
                                         if regen else ""))
        check(got == want, f"{name}: launches {got}, expected {want}")
        for k in kernels:
            launches[k] += got[k]
        for f, (t, seg) in enumerate(zip(frame_s, segs)):
            log(f"  frame {f}: {t * 1e3:.1f} ms, {seg} segments, "
                f"{seg / t / 1e6:.2f} Msegments/s"
                + (f"; {iters / frames:g} regen iterations a frame"
                   if regen else "")
                + (f"; without the march, in turns: {ref_s[f] * 1e3:.1f} "
                   f"ms, equal radiance, depth and segments"
                   if march_flag else ""))
        steady = statistics.median(frame_s[1:])
        log(f"1080p {name}, 1 spp, 5 bounces: median of frames 1-"
            f"{frames - 1} {steady * 1e3:.1f} ms/frame, "
            f"{statistics.median(segs[1:]) / steady / 1e6:.2f} "
            f"Msegments/s; radiance mean {float(aovs.radiance.mean()):.5f};"
            f" peak memory {peak / 2 ** 30:.2f} GiB above the scene; on "
            f"{card}")

        # One more frame under torch.profiler: where the device time goes.
        profile_step(name, lambda: render_radiance(pscene, pcam, pcfg,
                                                   frames),
                     torch, steady * 1e3, kernel_symbols)

    # Engine (the frame loop users drive): 4 steps of PROGRESSIVE
    # accumulation under a still camera, then 4 of TEMPORAL reprojection
    # under an orbiting one, each with the spatial denoiser, over the
    # default PALLAS regen frame; the post passes (accumulation, à-trous
    # denoiser, display transform) timed alone on the same frame.
    ecfg = cfg.replace(spatial_denoise=True)
    for mode in (DenoisingMode.PROGRESSIVE, DenoisingMode.TEMPORAL):
        name = f"demo, Engine.step, {mode.name} + denoiser"
        eng = Engine(scene, ecfg.replace(denoising=mode))
        cams = [cam if mode == DenoisingMode.PROGRESSIVE
                else orbit_camera(k, W, H) for k in range(ENGINE_STEPS + 1)]
        for fn in kernels.values():
            fn.launches = 0
        render_radiance_regen.iterations = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_bytes = torch.cuda.memory_allocated()
        step_s = []
        for c in cams[:ENGINE_STEPS]:
            t0 = time.perf_counter()
            img = eng.step(c)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            check(img.shape == (H, W, 3) and bool(torch.isfinite(img).all())
                  and float(img.min()) >= 0.0 and float(img.max()) <= 1.0,
                  f"{name}: the image is not finite in [0, 1]")
        peak = torch.cuda.max_memory_allocated() - base_bytes
        iters = render_radiance_regen.iterations
        got = {k: fn.launches for k, fn in kernels.items()}
        want = dict.fromkeys(kernels, 0)
        want["closest_hit_rows"] = want["regen_shade"] = iters
        want["regen_lane_key"] = want["regen_lane_refill"] = iters
        log(f"{name}: launches {got}, {iters} regen iterations")
        check(iters > 0 and got == want,
              f"{name}: launches {got}, expected {want}")
        check(eng.frame_index == int(eng._state.frame_count)
              == ENGINE_STEPS, f"{name}: the state did not advance")
        for k in kernels:
            launches[k] += got[k]
        # The post passes alone, on the last step's frame and state.
        aovs = render_radiance(scene, cams[0], ecfg, 0)
        state0 = eng._state

        def post():
            if mode == DenoisingMode.PROGRESSIVE:
                lin, _ = progressive_update(state0, aovs.radiance,
                                            cams[0].transform.to(dev))
            else:
                lin, _ = temporal_update(
                    state0, aovs.radiance, nonlinear_depth(
                        aovs.depth, cams[0].near, cams[0].far),
                    cams[0].to(dev).vp(), ecfg.temporal_blend,
                    ecfg.temporal_depth_eps)
            return display_transform(atrous_denoise(
                lin, aovs.normal, aovs.depth, ecfg.denoise_iterations), ecfg)

        post_ms = cuda_ms(post, 3, torch)
        steady = statistics.median(step_s[1:])
        for f, t in enumerate(step_s):
            log(f"  step {f}: {t * 1e3:.1f} ms")
        log(f"1080p {name}: median of steps 1-{ENGINE_STEPS - 1} "
            f"{steady * 1e3:.1f} ms/step; the post passes alone "
            f"{post_ms:.2f} ms ({post_ms / (steady * 1e3):.3f} of a step); "
            f"peak memory {peak / 2 ** 30:.2f} GiB above the scene; on "
            f"{card}")
        profile_step(name, lambda: eng.step(cams[ENGINE_STEPS]), torch,
                     steady * 1e3, kernel_symbols)

    # -- 3b. the differentiable path at 1080p: fwd+bwd steps ----------------
    phase("3b. the differentiable path at 1080p")
    # (path, scene, camera, parameter: "albedo" or "transforms", config,
    # launches expected per step). 8 tiles x 5 bounces: one finder launch
    # per tile and bounce is 40; with per-bounce checkpoints the backward
    # pass recomputes every bounce, finder launch included (80).
    dcfg = cfg.replace(differentiable=True)
    per = n_tiles * dcfg.bounces
    diff_paths = [
        ("demo, backward", scene, cam, "albedo", dcfg,
         {"closest_hit_rows": per}),
        ("demo, backward, bwd_checkpoint=True", scene, cam, "albedo",
         dcfg.replace(bwd_checkpoint=True), {"closest_hit_rows": 2 * per}),
        ("demo, backward + NEE", scene, cam, "albedo",
         dcfg.replace(nee=True),
         {"closest_hit_rows_nee": per, "occluded": n_tiles}),
        ("demo, soft shadows + NEE, instance transforms", scene, cam,
         "transforms", dcfg.replace(nee=True, soft_shadows=SOFT_EPS),
         {"closest_hit_rows": per, "soft_occluded": per}),
        ("grid, backward", grid, grid_cam, "albedo", dcfg,
         {"closest_hit_sc_lite": per})]
    lane_bounces = n_tiles * cfg.tile_rays * dcfg.bounces

    def diff_step(pscene, pcam, param, pcfg, frame):
        """One fwd+bwd step: (segments, gradient)."""
        base = pscene.mat_albedo if param == "albedo" \
            else pscene.inst_transform
        p = base.clone().requires_grad_(True)
        s_p = replace_albedo(pscene, p) if param == "albedo" \
            else replace_instance_transforms(pscene, p)
        aovs = render_radiance(s_p, pcam, pcfg, frame)
        image_mse(aovs.radiance, torch.zeros_like(aovs.radiance)).backward()
        return int(aovs.segments.sum()), p.grad

    for name, pscene, pcam, param, pcfg, per_step in diff_paths:
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_bytes = torch.cuda.memory_allocated()
        step_s, segs = [], []
        for f in range(DIFF_STEPS):
            t0 = time.perf_counter()
            seg, grad = diff_step(pscene, pcam, param, pcfg, f)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            segs.append(seg)
            check(bool(torch.isfinite(grad).all())
                  and float(grad.abs().max()) > 0,
                  f"{name}, step {f}: the {param} gradient is not finite "
                  f"and non-zero")
            check(seg >= W * H, f"{name}, step {f}: {seg} segments")
        peak = torch.cuda.max_memory_allocated() - base_bytes
        got = {k: fn.launches for k, fn in kernels.items()}
        want = dict.fromkeys(kernels, 0)
        for k, v in per_step.items():
            want[k] = v * DIFF_STEPS
        log(f"{name}: launches {got}")
        check(got == want, f"{name}: launches {got}, expected {want}")
        for k in kernels:
            launches[k] += got[k]
        for f, (t, seg) in enumerate(zip(step_s, segs)):
            log(f"  step {f}: {t * 1e3:.1f} ms, {seg} segments, "
                f"{seg / t / 1e6:.2f} Msegments/s")
        steady = statistics.median(step_s[1:])
        log(f"1080p {name}, 1 spp, 5 bounces, fwd+bwd: median of steps 1-"
            f"{DIFF_STEPS - 1} {steady * 1e3:.1f} ms/step, "
            f"{statistics.median(segs[1:]) / steady / 1e6:.2f} "
            f"Msegments/s; peak memory {peak / 2 ** 30:.2f} GiB above the "
            f"scene ({peak / lane_bounces:.0f} B per lane-bounce); |grad| "
            f"max {float(grad.abs().max()):.4g}; on {card}")
        profile_step(name, lambda: diff_step(pscene, pcam, param, pcfg,
                                             DIFF_STEPS),
                     torch, steady * 1e3, kernel_symbols)

    # -- 3c. the last modules ------------------------------------------------
    phase("3c. the last modules")
    last_modules(torch, card, kernels, launches, kernel_symbols, scene, cam,
                 cfg, grid, grid_cam, glass)

    for k, n_launch in launches.items():
        check(n_launch > 0, f"{k} was not launched on the main paths")

    # -- 4. GPU against CPU at 64x48 ----------------------------------------
    phase("4. GPU against CPU at 64x48")
    small = {"demo": demo_camera(SMALL_W, SMALL_H),
             "glass": demo_camera(SMALL_W, SMALL_H),
             "grid": grid_camera(SMALL_W, SMALL_H, n=10)}
    for name, pscene, _, _, pcfg, _ in paths:
        label = name.split(",")[0]
        if label not in small or (label == "grid" and pcfg.regen is False):
            continue
        compare_frames(
            render_radiance(pscene, small[label], pcfg, SMALL_FRAME),
            render_radiance(pscene.to("cpu"), small[label], pcfg,
                            SMALL_FRAME),
            f"{SMALL_W}x{SMALL_H} {name}, cuda vs cpu",
            # NEE on the grid: a shadow query whose cos_i is within
            # rounding of 0 is posted on one device only (tests/
            # test_torch_cuda.py test_superchunk_render_cuda_matches_cpu).
            seg_share=0.99 if label == "grid" and pcfg.nee else 1.0)

    # The differentiable demo's gradients, GPU against CPU: the images by
    # the render tolerance, the gradients within 5% of their largest
    # component (about 1% of pixels take another path after the card's
    # other sqrt/sin/cos rounding, and each moves these image-wide sums).
    small_cam = small["demo"]
    unit_soft = ("demo, UNIT, soft shadows + NEE, instance transforms", scene,
                 None, "transforms", RenderConfig(
                     traversal=unit, differentiable=True, nee=True,
                     soft_shadows=SOFT_EPS), None)
    for name, pscene, _, param, pcfg, _ in (diff_paths[0], diff_paths[3],
                                            unit_soft):
        out = []
        for dscene in (pscene, pscene.to("cpu")):
            base = dscene.mat_albedo if param == "albedo" \
                else dscene.inst_transform
            p = base.clone().requires_grad_(True)
            s_p = replace_albedo(dscene, p) if param == "albedo" \
                else replace_instance_transforms(dscene, p)
            aovs = render_radiance(s_p, small_cam, pcfg, SMALL_FRAME)
            (g,) = torch.autograd.grad(aovs.radiance.mean(), p)
            out.append((type(aovs)(*(x.detach() for x in aovs)), g.cpu()))
        what = f"{SMALL_W}x{SMALL_H} {name}, cuda vs cpu"
        compare_frames(out[0][0], out[1][0], what)
        ga, gb = out[0][1], out[1][1]
        rel = float((ga - gb).abs().max()) / max(float(gb.abs().max()),
                                                 1e-30)
        log(f"{what}: {param} gradient max |diff| {rel:.3g} of its largest "
            f"component")
        check(bool(torch.isfinite(ga).all()) and rel <= 0.05,
              f"{what}: the {param} gradients differ by {rel:.3g}")

    # One temporal Engine frame with the denoiser, GPU against CPU: the
    # second step of an orbit (the first leaves the history to reproject),
    # within 2e-3 on >= 95% of pixels (the denoiser spreads a pixel whose
    # path took another way over its neighbours).
    tcfg = cfg.replace(denoising=DenoisingMode.TEMPORAL, spatial_denoise=True)
    imgs = []
    for escene in (scene, scene.to("cpu")):
        eng = Engine(escene, tcfg)
        for k in range(2):
            img = eng.step(orbit_camera(k, SMALL_W, SMALL_H))
        imgs.append(img.cpu())
    ok = torch.isclose(imgs[0], imgs[1], rtol=2e-3, atol=2e-3).all(dim=-1)
    frac = float(ok.double().mean())
    log(f"{SMALL_W}x{SMALL_H} demo, Engine.step, TEMPORAL + denoiser, frame "
        f"1, cuda vs cpu: within 2e-3 on {frac:.4f} of pixels")
    check(frac >= 0.95, f"the temporal Engine frame differs: {frac:.4f}")

    # -- 5. the GPU-only tests -----------------------------------------------
    # Among them kernels 1, 3, 6 and 7 on adversarial ray sets of the bench
    # grid (one needing ray a block, a block's 256 rays on one chunk,
    # winners at either end of a chunk, parked rays, exact ties; for kernel
    # 7 also a tie against a carried best, repeated and all-sentinel
    # queues, 1 and 16 slots), kernel 11 on those sets of the mid grid's
    # camera paths (and paths that all die after bounce 0, blocks with one
    # live path), kernel 2 on adversarial shadow rays
    # (blockers at either end of a half, a limit at a blocker's own t,
    # parked rays, one live ray a block, every ray toward one chunk),
    # kernels 5, 8 and 9 on their tie and gate cases, and the BVH kernel
    # on its tiles, with the kernels this run built (the same sources, so
    # the same build directory).
    phase("5. the GPU-only tests")
    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda", "-q",
         "-p", "no:cacheprovider", "tests/test_torch_cuda.py"],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    summary = (tests.stdout.strip().splitlines() or [""])[-1]
    log(f"pytest -m cuda tests/test_torch_cuda.py: {summary}")
    check(tests.returncode == 0 and "passed" in summary
          and "skipped" not in summary,
          f"the GPU-only tests failed (rc {tests.returncode}):\n"
          f"{tests.stdout[-4000:]}{tests.stderr[-2000:]}")

    phase("done")
    check(not any(m == "gdpathtracing_tpu" or m.startswith(
        "gdpathtracing_tpu.") for m in sys.modules),
        "the JAX package was imported")
    check(jax_preloaded or "jax" not in sys.modules, "jax was imported")
    def entry(name):
        r = report[name]
        return {"name": name,
                "route": "cuda",
                "source": f"gdpathtracing_torch/csrc/{sources[name][0]}",
                "replaces": f"gdpathtracing_tpu/{sources[name][1]}",
                "launches": launches[name],
                "max_abs_err": r["err"],
                "ms": statistics.mean(r["ms"]),
                "plain_ms": statistics.mean(r["plain_ms"]),
                "bound_ms": statistics.mean(r["bound_ms"]),
                "bound_by": r["bound_by"],
                "library_ms": None}

    # The BVH kernel on its own line: it replaces no TPU kernel.
    log(json.dumps({"bvh_kernel": entry("trace_bvh")}))
    log(json.dumps({"kernels": [entry(name) for name in report
                                if name != "trace_bvh"]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--shard-worker"]:
        shard_worker(*map(int, sys.argv[2:5]))
    else:
        main()
