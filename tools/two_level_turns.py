#!/usr/bin/env python3
"""The traversal kernels of several builds, timed in turns on one GPU.

    python3 tools/two_level_turns.py --other parent=DIR [--other NAME=DIR]
                                     [--only NAME ...] [--sass] [--clocks]

Builds the kernels named by ``--only`` (C entry names; all eleven by
default) from this checkout's ``gdpathtracing_torch/csrc`` ("change") and
from each ``DIR`` (another ``csrc`` directory, for example the parent
commit's, unpacked with ``git archive`` into a directory that .gitignore
lists), with ops/build.py's flags, and prints ptxas' registers, shared
memory and spills for each. Then, on the operands of chip_smoke.py phase 2
(built by gdpathtracing_torch/ops/tiles.py for both), it launches every
build's kernel on the same tensors, checks that each output equals the
plain version bit for bit, and times the builds in turns, forward then
backward (other, change, change, other), each with CUDA events over 20
launches. The tiles:
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
  the mid grid (n=4, 34 chunks walked flat);
- kernel 5: the shadow rays of the middle tile's primary hits, on the demo
  and on the n=10 grid, over boxes grown by soft shadows' edge_eps 0.02;
- kernels 8 and 9: the demo's middle tile, primary and bounce-1 rays, and
  the mid grid's primary rays, over the raw chunk boxes.
Per tile it also prints the tests the rays need (for kernel 3 also
``groups_kept``, the share of them its group gate runs), the thread-slots
of one thread per ray and of the block-cooperative walks (``ops.intersect.
two_level_slots``, ``any_hit_slots``; kernel 8's from
``closest_hit_classic_plain(counts=)``), and the bound of chip_smoke.py
(kernels 10 and 11 without their shading operations). A kernel whose
operands grew (``ADDED``) is launched without the new one in a build
whose source predates it.

``--sass`` compares each kernel's SASS (``cuobjdump -sass``) and ptxas'
usage lines between the builds, and prints, for kernels 5, 8 and 9, the
instructions of each loop that runs ray-triangle tests, per test (a test
is one IEEE division: one MUFU.RCP), by opcode. ``--clocks`` also builds
kernel 9 with ``-DGDPT_CLOCKS`` (its clock64() split: the group votes,
the per-candidate gates, waiting for the staged rows, the candidate
barrier, starting the next copy, and the sweep, summed over the warps; and
a log of each block's SM and lifetime) and prints each part's share and
the blocks resident on an SM on kernel 9's tiles (the diagnostic build
has its own register count, so its residency is its own). The last line is one JSON
object with every time.

Needs one CUDA device and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ITERS = 20
# Each C entry point's operands (pointers, ints, floats; then the stream).
ENTRIES = {"closest_hit_rows": (8, 2, 0), "closest_hit_sc_lite": (9, 3, 0),
           "closest_hit_rows_sc": (9, 3, 0), "march_step_sc": (10, 4, 0),
           "occlusion": (9, 2, 0), "closest_hit_rows_nee": (13, 2, 0),
           "mega_step": (11, 6, 8), "fused_paths": (11, 3, 7),
           "soft_occlusion": (10, 2, 0), "closest_hit_classic": (8, 2, 0),
           "closest_hit_loop": (8, 2, 0)}
# The source of an entry that is not csrc/<entry>.cu.
SOURCES = {"closest_hit_classic": "closest_hit_classic",
           "closest_hit_loop": "closest_hit_classic"}
# Operands an entry took only from some commit on: (name in the source,
# index among the pointers). A build whose source lacks the name is
# launched without that pointer (kernel 3 before its group boxes).
ADDED = {"closest_hit_sc_lite": ("group_bounds", 4)}
PEAK_FP32 = 67e12  # float32 outside the tensor cores, H100 SXM at 700 W
OPS_PER_TEST, OPS_PER_SLAB = 45, 25  # as chip_smoke.py
OPS_PER_SOFT_TEST, SOFT_EPS = 59, 0.02  # kernel 5, as chip_smoke.py
CLOCK_PARTS = ("vote", "gate", "wait for rows", "barrier", "start copy",
               "sweep")  # closest_hit_classic.cu LoopPart
LOG_BLOCKS = 4096  # closest_hit_classic.cu kLogBlocks


def source(name: str) -> str:
    return SOURCES.get(name, name)


def kernel_name(mangled: str) -> str:
    """The longest ``<entry>_kernel`` in a mangled name (the anonymous
    namespace's hash aside)."""
    known = [f"{k}_kernel" for k in ENTRIES if f"{k}_kernel" in mangled]
    return max(known, key=len) if known else mangled.strip()


class Built:
    """One build of one source: its library and ptxas' usage lines by
    kernel."""

    def __init__(self, so: Path, usage: list[str]):
        self.so, self.usage = so, usage
        self.lib = ctypes.CDLL(str(so))


def build(label: str, csrc: Path, out_dir: Path, names,
          flags=()) -> tuple[dict, dict]:
    """nvcc the sources of the kernels ``names`` from ``csrc`` in
    parallel: (by kernel name, a function that launches it on the current
    stream with the tensors' pointers, the ints and the floats, and raises
    if the launch was refused; by source, its Built)."""
    import torch

    from gdpathtracing_torch.ops.build import NVCC_FLAGS, nvcc_path

    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sorted({source(n) for n in names}):
        so = out_dir / f"{src}-{label}.so"
        procs[src] = (so, subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, *flags, "-o", str(so),
             str(csrc / f"{src}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for src, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed on {csrc / src}.cu:\n{log}")
        usage, kern = {}, src
        for line in log.splitlines():
            if "Function properties for" in line:
                kern = kernel_name(line)
            elif "registers" in line or "spill" in line:
                usage.setdefault(kern, []).append(
                    line.split(":", 1)[-1].strip())
                print(f"  {label} {kern}: {usage[kern][-1]}")
        built[src] = Built(so, usage)
    fns = {}
    for name in names:
        n_ptrs, n_ints, n_floats = ENTRIES[name]
        drop = None
        if name in ADDED and ADDED[name][0] not in (
                csrc / f"{source(name)}.cu").read_text():
            n_ptrs, drop = n_ptrs - 1, ADDED[name][1]
        fn = getattr(built[source(name)].lib, name)
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints \
            + [ctypes.c_float] * n_floats + [ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def launch(tensors, ints, floats, fn=fn, name=name, drop=drop):
            if drop is not None:
                tensors = tensors[:drop] + tensors[drop + 1:]
            err = fn(*(t.data_ptr() for t in tensors), *ints, *floats,
                     torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"{label} {name}: cudaError {err}")

        fns[name] = launch
    return fns, built


_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;")


def sass_kernels(so: Path) -> dict[str, str]:
    """By kernel (:func:`kernel_name`), the SASS instructions of ``so``
    (``cuobjdump -sass``)."""
    from gdpathtracing_torch.ops.build import nvcc_path

    out = subprocess.run(
        [str(Path(nvcc_path()).parent / "cuobjdump"), "-sass", str(so)],
        capture_output=True, text=True, check=True).stdout
    funcs = {}
    for part in out.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        # The instructions, each "/*addr*/ text ;", with mangled names
        # (which hold the anonymous namespace's hash) cut out and branch
        # labels (".L_x_3:" before an instruction) read as its address.
        labels, pending = {}, []
        for line in body.splitlines():
            m = re.match(r"\s*(\.L_x_\d+):", line)
            if m:
                pending.append(m.group(1))
            elif _INSTR.search(line) and pending:
                for lab in pending:
                    labels[lab] = "0x" + _INSTR.search(line).group(1)
                pending = []
        lines = []
        for a, t in _INSTR.findall(body):
            t = re.sub(r"`?\((\.L_x_\d+)\)", lambda m: labels.get(
                m.group(1), m.group(1)), t)
            lines.append(re.sub(r"_ZN[0-9A-Za-z_]+", "", f"/*{a}*/ {t} ;"))
        funcs[kernel_name(name)] = "\n".join(lines)
    return funcs


def _opcode(text: str) -> str:
    words = text.split()
    return words[1] if words[0].startswith("@") else words[0]


def test_loops(sass: str) -> list[dict]:
    """The loops of a kernel's SASS that run ray-triangle tests (a
    backward branch whose range holds a MUFU.RCP: one IEEE division a
    test), innermost first: their address range, tests per iteration and
    instructions per test, by opcode (before its first dot)."""
    ins = [(int(a, 16), _opcode(t), t) for a, t in _INSTR.findall(sass)]
    loops = []
    for addr, op, text in ins:
        if op.startswith("BRA"):
            m = re.search(r"0x([0-9a-f]+)", text.split(op, 1)[1])
            if m and int(m.group(1), 16) < addr:
                loops.append((int(m.group(1), 16), addr))
    found = []
    for lo, hi in sorted(set(loops), key=lambda x: x[1] - x[0]):
        ops = [op for a, op, _ in ins if lo <= a <= hi]
        tests = sum(op.startswith("MUFU.RCP") for op in ops)
        if not tests:
            continue
        by_op = {}
        for op in ops:
            base = op.split(".")[0]
            by_op[base] = by_op.get(base, 0) + 1
        found.append(dict(range=f"0x{lo:x}-0x{hi:x}", tests=tests,
                          per_test=len(ops) / tests,
                          by_op={k: v / tests for k, v in sorted(
                              by_op.items(), key=lambda x: -x[1])}))
    return found


def sass_report(built: dict) -> dict:
    """Each kernel's SASS and ptxas usage in every build against the
    change's; the test loops of kernels 5, 8 and 9 in every build."""
    report = {}
    srcs = sorted(set.intersection(*(set(b) for b in built.values())))
    for src in srcs:
        sass = {label: sass_kernels(b[src].so) for label, b in built.items()}
        for label in built:
            if label == "change":
                continue
            for kern, text in sass["change"].items():
                same = sass[label].get(kern) == text
                same_usage = built[label][src].usage.get(kern) == \
                    built["change"][src].usage.get(kern)
                n_ins = len(_INSTR.findall(text))
                print(f"sass {kern}: {label} "
                      f"{'identical' if same else 'DIFFERS'} "
                      f"({n_ins} instructions in change, "
                      f"{len(_INSTR.findall(sass[label].get(kern, '')))} in "
                      f"{label}); ptxas usage "
                      f"{'same' if same_usage else 'differs'}")
                report[f"{kern} {label}"] = dict(identical=same,
                                                 usage_same=same_usage)
        for label, funcs in sass.items():
            for kern in ("soft_occlusion_kernel", "closest_hit_classic_kernel",
                         "closest_hit_loop_kernel"):
                if kern not in funcs:
                    continue
                loops = test_loops(funcs[kern])
                report[f"{kern} {label} loops"] = loops
                for lp in loops:
                    top = ", ".join(f"{k} {v:.2f}" for k, v in
                                    list(lp["by_op"].items())[:12])
                    print(f"loop {kern} {label} {lp['range']}: "
                          f"{lp['tests']} tests an iteration, "
                          f"{lp['per_test']:.2f} instructions a test "
                          f"({top})")
    return report


def clock_split(clocks, tens, ints, tests: float) -> dict:
    """One launch of kernel 9's diagnostic build on ``tens``: its clock64()
    cycles summed over the warps, by part, each part's share, the sweep's
    cycles a warp spends per test of a lane (its sweep cycles over the
    tests its 32 lanes ran), and from its block log the blocks resident on
    an SM: the most at once and the mean over the launch (the blocks'
    lifetimes summed over the SMs' count times the launch's span)."""
    import numpy as np
    import torch

    launch, read = clocks
    n = tens[0].shape[1]
    outs = (torch.empty(n, dtype=torch.float32, device=tens[0].device),
            torch.empty(n, dtype=torch.int32, device=tens[0].device))
    cycles = (ctypes.c_ulonglong * len(CLOCK_PARTS))()
    log = (ctypes.c_ulonglong * (LOG_BLOCKS * 3))()
    launch(tens + outs, ints, ())
    torch.cuda.synchronize()
    read(cycles, log)  # zeroes the sums
    launch(tens + outs, ints, ())
    torch.cuda.synchronize()
    if read(cycles, log) != 0:
        raise RuntimeError("closest_hit_loop_clocks failed")
    total = float(sum(cycles))
    split = {p: float(c) for p, c in zip(CLOCK_PARTS, cycles)}
    shares = {p: c / total for p, c in split.items()}
    per_test = split["sweep"] * 32 / max(tests, 1.0)
    blocks = np.ctypeslib.as_array(log).reshape(LOG_BLOCKS, 3)[
        :min(n // 256, LOG_BLOCKS)].astype(np.float64)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    span = blocks[:, 2].max() - blocks[:, 1].min()
    mean_res = float((blocks[:, 2] - blocks[:, 1]).sum() / (n_sm * span))
    most = 0
    for sm in np.unique(blocks[:, 0]):
        b = blocks[blocks[:, 0] == sm]
        ev = sorted([(t, 1) for t in b[:, 1]] + [(t, -1) for t in b[:, 2]],
                    key=lambda x: (x[0], x[1]))
        now = 0
        for _, d in ev:
            now += d
            most = max(most, now)
    print("  kernel 9 clock64() split (cycles summed over warps): "
          + ", ".join(f"{p} {shares[p]:.3f}" for p in CLOCK_PARTS)
          + f"; sweep {per_test:.2f} cycles a warp per test of a lane; "
          f"blocks resident on an SM: at most {most}, {mean_res:.2f} on "
          f"average over the launch ({span / 1e3:.1f} us, {n_sm} SMs)")
    return dict(cycles=split, shares=shares, sweep_cycles_per_test=per_test,
                blocks_resident_max=most, blocks_resident_mean=mean_res)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    metavar="NAME=DIR",
                    help="another csrc directory, timed against this one")
    ap.add_argument("--only", nargs="+", choices=sorted(ENTRIES),
                    default=sorted(ENTRIES), help="the kernels to time")
    ap.add_argument("--sass", action="store_true",
                    help="compare the builds' SASS; count kernels 5, 8 "
                    "and 9's instructions a test")
    ap.add_argument("--clocks", action="store_true",
                    help="kernel 9's clock64() split (a diagnostic build)")
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
    csrc = ROOT / "gdpathtracing_torch" / "csrc"
    builds, built = {}, {}
    for label, d in [("change", csrc)] + others:
        builds[label], built[label] = build(label, Path(d).resolve(),
                                            out_dir, args.only)
    sass = sass_report(built) if args.sass else {}
    clocks = None
    if args.clocks and "closest_hit_loop" in args.only:
        clock_fns, clock_built = build("clocks", csrc, out_dir,
                                       ["closest_hit_loop"],
                                       ("-DGDPT_CLOCKS",))
        read_clocks = clock_built["closest_hit_classic"].lib \
            .closest_hit_loop_clocks
        read_clocks.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        read_clocks.restype = ctypes.c_int
        clocks = (clock_fns["closest_hit_loop"], read_clocks)
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
        lite = name == "closest_hit_sc_lite"
        for what, (o4t, d4t) in {"primary": ti.pack_rays(primary, None),
                                 "bounce 1": ti.pack_rays(bounce, active)
                                 }.items():
            n = o4t.shape[1]
            if lite:
                tens, rows = (o4t, d4t, *geo[:2], prep.group_bounds,
                              *geo[2:]), ti.LITE_R
                want = ti.closest_hit_sc_lite_plain(*tens, prep.scc)
            else:
                tens, rows = (o4t, d4t, *geo, prep.tab), ti.OUT_R
                want = ti.closest_hit_rows_sc_plain(o4t, d4t, *geo, prep.tab,
                                                    prep.scc)
            work = ti.walk_two_level_plain(
                o4t, d4t, *geo, prep.scc,
                group_bounds=prep.group_bounds if lite else None)
            if lite:
                run = float(work.group_sweeps.sum()) * ti.GW
                print(f"  kernel 3, n={n_grid} grid, {what}: groups_kept "
                      f"{run / max(float(work.walk.steps.sum()), 1.0):.4f}"
                      f" ({run:.4g} tests run)")
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

    def soft_tiles():
        for label, scene, cam in (
                ("demo", build_demo_scene(), demo_camera(W, H)),
                ("n=10 grid", build_sphere_grid(n=10, sphere_detail=16),
                 grid_camera(W, H, n=10))):
            prep = ti.prepare_trace_inputs(scene)
            tens, _ = kt.soft_shadow_operands(scene, cam, prep, cfg,
                                              SOFT_EPS)
            n, e = tens[0].shape[1], prep.mu.shape[1]
            want = ti.soft_occluded_plain(*tens)
            tiles.append(("soft_occlusion", label, "shadow rays", tens,
                          [((n,), torch.float32), ((n,), torch.int32)],
                          (n, e), (), [want.margin, want.eidx],
                          float(want.tests.sum()), float(n * (e // ti.BT)),
                          float(want.slots[::ti.BN].sum()),
                          float(want.sweeps[::ti.BN].sum()) * ti.BN * ti.BT))

    def classic_tiles(name):
        plain = ti.closest_hit_classic_plain if name == "closest_hit_classic" \
            else ti.closest_hit_loop_plain
        for label, scene, cam in (
                ("demo", build_demo_scene(), demo_camera(W, H)),
                ("mid grid", build_sphere_grid(n=4, sphere_detail=12),
                 grid_camera(W, H, n=4))):
            prep = ti.prepare_trace_inputs(scene)
            for what, (_, _, tens) in kt.classic_tiles(scene, cam, prep,
                                                       cfg).items():
                if label == "mid grid" and what != "primary":
                    continue  # chip_smoke.py's three tiles
                n, e = tens[0].shape[1], prep.mu.shape[1]
                counts = {}
                want = plain(*tens, counts=counts)
                coop = name == "closest_hit_classic"  # kernel 8's walk
                tiles.append((name, label, what, tens,
                              [((n,), torch.float32), ((n,), torch.int32)],
                              (n, e), (), list(want), counts["tests"],
                              float(n * (e // ti.BT)),
                              counts["slots"] if coop else None,
                              counts["thread_slots"] if coop else None))

    for name in args.only:
        if name == "soft_occlusion":
            soft_tiles()
        elif name in ("closest_hit_classic", "closest_hit_loop"):
            classic_tiles(name)
        elif name in ("closest_hit_sc_lite", "march_step_sc"):
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
        per_test = OPS_PER_SOFT_TEST if name == "soft_occlusion" \
            else OPS_PER_TEST
        bound_ms = (needed * per_test + slabs * OPS_PER_SLAB) \
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
        if clocks is not None and name == "closest_hit_loop":
            row["clocks"] = clock_split(clocks, tens, ints, needed)
    print(json.dumps({"card": card, "turns": order, "tiles": results,
                      "sass": sass}))


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"done in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
