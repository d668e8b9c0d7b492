"""Regen's lane kernels (ops/lanes.py, csrc/regen_lanes.cu) on the CPU: the
configurations regen picks them for once a frame (``lanes_entry``), the
wrappers' refusals, and their plain versions driven through regen, held
iteration by iteration against regen's torch glue. The kernels themselves
run only on the card (tests/test_torch_cuda.py)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gdpathtracing_torch.config import Jitter, RenderConfig, Traversal
from gdpathtracing_torch.ops import intersect as ti
from gdpathtracing_torch.ops import lanes
from gdpathtracing_torch.render import regen
from gdpathtracing_torch.render.integrator import morton_frame
from gdpathtracing_torch.render.renderer import render_radiance
from gdpathtracing_torch.scene import demo as tdemo

torch.set_num_threads(1)
PALLAS = RenderConfig(traversal=Traversal.PALLAS)
AOVS = ("radiance", "depth", "steps", "segments", "normal")


@pytest.fixture(scope="module")
def scenes():
    return {"demo": tdemo.build_demo_scene(texture_resolution=8,
                                           sphere_detail=6, device="cpu"),
            "mid": tdemo.build_sphere_grid(n=4, sphere_detail=12,
                                           device="cpu")}


# (scene, config, whether the kernels take the lanes)
GATE = {
    "default": ("demo", PALLAS, True),
    "nee": ("demo", PALLAS.replace(nee=True), True),
    "rr_gauss": ("demo", PALLAS.replace(rr_start=2, jitter=Jitter.GAUSS),
                 True),
    "march_flag_ignored": ("demo", PALLAS.replace(regen_march=True), True),
    "mid": ("mid", PALLAS, True),
    "unit_sorted": ("demo", RenderConfig(traversal=Traversal.UNIT,
                                         regen=True, sort_rays=True), True),
    "unit": ("demo", RenderConfig(traversal=Traversal.UNIT, regen=True),
             False),
    "march": ("mid", PALLAS.replace(regen_march=True), False),
    "fused_nee": ("demo", PALLAS.replace(nee=True, regen_fuse_nee=True),
                  False),
    "chunk_key": ("demo", PALLAS.replace(regen_sort_key="chunk"), False),
    "scatter": ("demo", PALLAS.replace(regen_retire="scatter"), False),
    "unsorted": ("demo", PALLAS.replace(sort_rays=False), False),
    "uncompacted": ("demo", PALLAS.replace(compact_rays=False), False),
}


@pytest.mark.parametrize("case", list(GATE))
def test_lanes_entry(scenes, case):
    """The gate, fed as regen feeds it, takes the Morton-sorted lanes that
    retire to the log whatever shades them (NEE, Russian roulette, any
    jitter, the mid grid; the march flag is ignored on a flat scene, and
    UNIT sorts where asked); it declines the march, fused NEE, the chunk
    key, the scatter retire and unsorted or uncompacted lanes."""
    name, cfg, want = GATE[case]
    scene = scenes[name]
    prep = ti.prepare_trace_inputs(scene) \
        if cfg.traversal == Traversal.PALLAS else None
    assert lanes.lanes_entry(cfg, regen.use_march(cfg, prep),
                             regen.fuses_nee(scene, cfg, prep)) is want


# (scene, width, height, config changes, frame index, the shading entry
# regen calls and the place of ``fs`` among its arguments)
ITERATIONS = {
    # 384 paths in one 512-lane stage: no refill finds a path
    "demo": ("demo", 24, 16, {}, 3, "regen_shade", 2),
    # 384 paths through 256 lanes: the first refills run out half way
    "demo_refill": ("demo", 24, 16, {"regen_wavefront": 256}, 5,
                    "regen_shade", 2),
    "mid": ("mid", 24, 16, {"regen_wavefront": 256}, 1, "regen_shade_lite",
            3),
    # 1024 paths (2 spp) through 512 lanes, then a 256-lane drain stage
    "drain_spp2": ("demo", 32, 16, {"regen_wavefront": 512, "spp": 2},
                   2 ** 32 - 1, "regen_shade", 2),
    # the torch shading body, the Gaussian jitter, frame * spp past 2^32
    "nee_gauss": ("demo", 24, 16, {"regen_wavefront": 256, "nee": True,
                                   "jitter": Jitter.GAUSS, "spp": 2},
                  2 ** 31 + 3, "_shade_torch", 3),
}


def _frame_states(monkeypatch, scene, cam, cfg, frame, entry, at, glue):
    """The frame, and the lane stacks and active mask each regen
    iteration shades, with the lane kernels' plain versions or (``glue``)
    regen's torch glue."""
    states = []
    real = getattr(regen, entry)

    def recording(*args, **kw):
        states.append(tuple(x.clone() for x in args[at:at + 3]))
        return real(*args, **kw)

    recording.iterations = 0
    with monkeypatch.context() as m:
        m.setattr(regen, entry, recording)
        if glue:
            m.setattr(regen, "lanes_entry", lambda *a: False)
        aovs = render_radiance(scene, cam, cfg, frame)
    return aovs, states


def _same(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.parametrize("case", list(ITERATIONS))
def test_plain_lanes_equal_the_torch_glue(scenes, case, monkeypatch):
    """Regen through the lane wrappers (their plain versions here) hands
    every iteration's shading the same lane stacks and active mask as its
    torch glue, bit for bit, and renders the same frame: the demo, a
    refill that runs out of paths half way, the mid grid (kernel 3), two
    spp with a drain stage, and the torch shading body with the Gaussian
    jitter and ``frame_index * spp`` past 2^32."""
    name, w, h, change, frame, entry, at = ITERATIONS[case]
    scene = scenes[name]
    cam = (tdemo.demo_camera(w, h) if name == "demo"
           else tdemo.grid_camera(w, h, n=4))
    cfg = PALLAS.replace(**change)
    prep = ti.prepare_trace_inputs(scene)
    assert lanes.lanes_entry(cfg, regen.use_march(cfg, prep),
                             regen.fuses_nee(scene, cfg, prep))
    calls = {"key": 0, "refill": 0}

    def counting(kind, real):
        def wrapper(*args):
            calls[kind] += 1
            return real(*args)
        return wrapper

    monkeypatch.setattr(regen, "regen_lane_key",
                        counting("key", lanes.regen_lane_key))
    monkeypatch.setattr(regen, "regen_lane_refill",
                        counting("refill", lanes.regen_lane_refill))
    regen.render_radiance_regen.iterations = 0
    got, got_states = _frame_states(monkeypatch, scene, cam, cfg, frame,
                                    entry, at, glue=False)
    iters = regen.render_radiance_regen.iterations
    assert calls == {"key": iters, "refill": iters} and iters > 3
    want, want_states = _frame_states(monkeypatch, scene, cam, cfg, frame,
                                      entry, at, glue=True)
    assert calls == {"key": iters, "refill": iters}
    assert len(got_states) == len(want_states) == iters
    widths = set()
    for k, (a, b) in enumerate(zip(got_states, want_states)):
        widths.add(a[0].shape[1])
        for x, y, what in zip(a, b, ("fs", "ints", "active")):
            assert _same(x, y), f"iteration {k}: {what}"
    assert len(widths) == (2 if case == "drain_spp2" else 1)
    for k in AOVS:
        assert _same(getattr(got, k), getattr(want, k)), k


def _lane_state(scene, n=512, seed=4):
    """One iteration's lane state after the shading on the CPU, as
    tests/test_torch_cuda.py makes it on the card: 60% of the lanes
    alive, 15% ended now."""
    g = np.random.default_rng(seed)
    cb = scene.isect_chunk_bounds.numpy()
    lo, hi = cb[0:3].min(axis=1), cb[3:6].max(axis=1)
    o = g.uniform(lo, hi, (n, 3)).T
    d = g.normal(size=(3, n))
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    fs = torch.from_numpy(np.concatenate(
        [o, d, g.uniform(0.0, 2.0, (11, n))]).astype(np.float32))
    ints = torch.from_numpy(np.stack(
        [g.integers(0, 1 << 32, n), g.integers(0, 1 << 32, n),
         g.permutation(n), g.integers(0, 5, n), g.integers(0, 1 << 20, n),
         g.integers(0, 5, n)]))
    u = g.uniform(size=n)
    return fs, ints, torch.from_numpy(u < 0.6), \
        torch.from_numpy((u >= 0.6) & (u < 0.75))


def test_plain_key_is_the_glues_key(scenes):
    """On CPU tensors ``regen_lane_key`` is regen's Morton key as int32:
    live lanes below 4096, ended-now lanes 1 << 14, the rest 1 << 15; its
    stable sort is the int64 key's."""
    scene = scenes["demo"]
    fs, ints, alive, dead_now = _lane_state(scene)
    lo, span = morton_frame(scene)
    key = lanes.regen_lane_key(fs, alive, dead_now, lo, span)
    assert key.dtype == torch.int32
    assert bool((key[alive] < 4096).all())
    assert bool((key[dead_now] == 1 << 14).all())
    assert bool((key[~alive & ~dead_now] == 1 << 15).all())
    assert len(torch.unique(key[alive])) > 16
    glue = torch.argsort(key.to(torch.int64), stable=True)
    assert torch.equal(torch.argsort(key, stable=True), glue)


@pytest.mark.parametrize("fault", [
    "alive_dtype", "dead_length", "fs_rows", "fs_strided", "lo_length",
    "perm_dtype", "ints_dtype", "log_strided", "log_rows", "counts",
    "next_path", "device"])
def test_lane_wrappers_refuse(scenes, fault):
    """The wrappers raise on operands the kernels cannot read (dtype,
    shape, stride, device) and on counts out of range, before any
    launch."""
    scene = scenes["demo"]
    fs, ints, alive, dead_now = _lane_state(scene)
    lo, span = morton_frame(scene)
    n = fs.shape[1]
    perm = torch.randperm(n)
    log_f = torch.zeros((7, 2 * n))
    log_i = torch.zeros((3, 2 * n), dtype=torch.int64)
    sp = lanes.lane_spawn(tdemo.demo_camera(32, 16), PALLAS, 0)
    counts = [int(alive.sum()), int(dead_now.sum()), 0, 0]
    if fault == "alive_dtype":
        alive = alive.to(torch.uint8)
    elif fault == "dead_length":
        dead_now = dead_now[:-1]
    elif fault == "fs_rows":
        fs = fs[:16]
    elif fault == "fs_strided":
        fs = torch.cat([fs, fs], dim=1)[:, ::2]
    elif fault == "lo_length":
        lo = torch.cat([lo, lo[:1]])
    elif fault == "perm_dtype":
        perm = perm.to(torch.int32)
    elif fault == "ints_dtype":
        ints = ints.to(torch.int32)
    elif fault == "log_strided":
        log_f = torch.zeros((2 * n, 7)).T
    elif fault == "log_rows":
        log_i = log_i[:2]
    elif fault == "counts":
        counts[1] = n - counts[0] + 1
    elif fault == "next_path":
        counts[3] = 32 * 16 + 1
    elif fault == "device":
        fs, ints, alive, dead_now, perm = (
            x.to("meta") for x in (fs, ints, alive, dead_now, perm))
    with pytest.raises(ValueError):
        if fault in ("alive_dtype", "dead_length", "fs_strided",
                     "lo_length", "device"):
            lanes.regen_lane_key(fs, alive, dead_now, lo, span)
        if fault != "lo_length":
            lanes.regen_lane_refill(perm, fs, ints, log_f, log_i, *counts,
                                    sp)
