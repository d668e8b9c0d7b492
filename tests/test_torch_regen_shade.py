"""Regen's shading kernel (ops/shade.py, csrc/regen_shade.cu) on the CPU:
the entry regen picks once a frame (``shade_entry``), the two wrappers'
refusals (``regen_shade`` on winner rows, ``regen_shade_lite`` on kernel
3's winners), their plain versions, and regen's call site driven through
them and its choice between them, which the CPU makes as the card does.
The kernels themselves run only on the card (tests/test_torch_cuda.py)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gdpathtracing_torch.config import RenderConfig, Traversal
from gdpathtracing_torch.core.vec import Vec3
from gdpathtracing_torch.ops import intersect as ti
from gdpathtracing_torch.ops import shade
from gdpathtracing_torch.render import regen, shading
from gdpathtracing_torch.render.renderer import render_radiance
from gdpathtracing_torch.render.types import Ray
from gdpathtracing_torch.scene import demo as tdemo
from gdpathtracing_torch.scene import primitives as tprim
from gdpathtracing_torch.scene.materials import Material
from gdpathtracing_torch.scene.scene import Scene, SceneBuilder

torch.set_num_threads(1)
PALLAS = RenderConfig(traversal=Traversal.PALLAS)
AOVS = ("radiance", "depth", "steps", "segments", "normal")


def _sphere_room(material: Material, env: bool = False) -> Scene:
    """A sphere of ``material`` under the demo's ceiling light (with a unit
    environment map where ``env``), on the CPU."""
    b = SceneBuilder(texture_resolution=4)
    light = b.add_mesh(tprim.plane_mesh(size=2.0))
    sphere = b.add_mesh(tprim.uv_sphere(radius=1.0, rings=6, segments=12))
    b.add_instance(light, tdemo._affine([1, 0, 0, 0, -1, 0, 0, 0, -1],
                                        (0, 2.5, 0)),
                   materials=[tdemo.LIGHT_MAT])
    b.add_instance(sphere, np.eye(4, dtype=np.float32)[:3],
                   materials=[material])
    if env:
        b.set_environment(np.ones((4, 8, 3), np.float32), energy=1.0)
    return b.build("cpu")


@pytest.fixture(scope="module")
def scenes():
    tex = np.full((4, 4, 3), 0.5, np.float32)
    return {
        "demo": tdemo.build_demo_scene(texture_resolution=8, sphere_detail=6,
                                       device="cpu"),
        "mid": tdemo.build_sphere_grid(n=4, sphere_detail=12, device="cpu"),
        "sphere": _sphere_room(Material(albedo=(0.7, 0.6, 0.5))),
        "glass": _sphere_room(Material(albedo=(1, 1, 1), transmission=1.0,
                                       ior=1.5, roughness=0.05)),
        "textured": _sphere_room(Material(albedo_texture=tex)),
        "mr_textured": _sphere_room(Material(
            metallic_roughness_texture=tex)),
        "env": _sphere_room(Material(albedo=(0.7, 0.6, 0.5)), env=True)}


# (scene, config changes, the entry that shades: "lite", "rows" or None
# for the torch body)
GATE = {
    "demo": ("demo", {}, "rows"),
    "demo_march_flag": ("demo", {"regen_march": True}, "rows"),
    "sphere": ("sphere", {}, "rows"),
    "nee": ("demo", {"nee": True}, None),
    "fused_nee": ("demo", {"nee": True, "regen_fuse_nee": True}, None),
    "march": ("mid", {"regen_march": True}, None),
    "glass": ("glass", {}, None),
    "textured": ("textured", {}, None),
    "mr_textured": ("mr_textured", {}, None),
    "env": ("env", {}, None),
    "rr": ("demo", {"rr_start": 2}, None),
    "no_bounces": ("demo", {"bounces": 0}, None),
    "cpu": ("mid", {}, "lite"),
}


@pytest.mark.parametrize("case", list(GATE))
def test_shade_kernel_gate(scenes, case):
    """The gate, fed as regen feeds it, takes the flat no-NEE, no-RR demo
    (the march flag is ignored on a flat scene, so it shades there too)
    and a plain sphere room in ``regen_shade``, and the mid grid, which
    kernel 3 traces, in ``regen_shade_lite``; it declines NEE, fused NEE,
    the march, glass, textures, an environment map, Russian roulette and
    zero bounces, which the wrappers refuse. It has no device term: these
    scenes are on the CPU, where the wrappers run their plain versions."""
    name, change, want = GATE[case]
    scene, cfg = scenes[name], PALLAS.replace(**change)
    prep = ti.prepare_trace_inputs(scene)
    march = regen.use_march(cfg, prep)
    use_nee = cfg.nee and scene.n_lights > 0
    assert shade.shade_entry(scene, cfg, prep, march, use_nee) == want


def _iteration(scene, n=512, seed=0):
    """One iteration's inputs on the CPU: winner rows of random rays, lane
    stacks, a quarter of the lanes inactive."""
    g = np.random.default_rng(seed)
    o = torch.from_numpy(g.uniform(-1.5, 1.5, (3, n)).astype(np.float32))
    d = torch.nn.functional.normalize(
        torch.from_numpy(g.normal(size=(3, n)).astype(np.float32)), dim=0)
    active = torch.from_numpy(g.uniform(size=n) < 0.75)
    hit = ti.trace_pallas(scene, Ray(Vec3(*o), Vec3(*d)), active)
    fs = torch.cat([o, d, torch.ones(3, n), torch.zeros(4, n),
                    torch.full((1, n), 1000.0), torch.zeros(3, n)])
    ints = torch.from_numpy(np.stack(
        [g.integers(0, 1 << 32, n), g.integers(0, 1 << 32, n),
         np.arange(n), g.integers(0, 5, n), np.zeros(n, np.int64),
         np.zeros(n, np.int64)]))
    return hit.rows, fs, ints, active


@pytest.mark.parametrize("fault", ["glass", "rr", "fs_rows", "ints_dtype",
                                   "strided", "active_dtype"])
def test_regen_shade_refuses(scenes, fault):
    """The wrapper raises on a scene or config the kernel does not take
    and on operands it cannot read, before any launch."""
    scene = scenes["glass" if fault == "glass" else "demo"]
    rows, fs, ints, active = _iteration(scenes["demo"])
    cfg = PALLAS.replace(rr_start=2) if fault == "rr" else PALLAS
    if fault == "fs_rows":
        fs = fs[:16]
    elif fault == "ints_dtype":
        ints = ints.to(torch.int32)
    elif fault == "strided":
        rows, fs, ints, active = (rows[:, ::2], fs[:, ::2], ints[:, ::2],
                                  active[::2].clone())
    elif fault == "active_dtype":
        active = active.to(torch.uint8)
    with pytest.raises(ValueError):
        shade.regen_shade(scene, rows, fs, ints, active, cfg)


def test_regen_shade_plain_is_the_torch_body(scenes):
    """On CPU tensors the wrapper runs regen's torch body: the same stacks,
    masks and counts, the counts those of the masks."""
    scene = scenes["demo"]
    rows, fs, ints, active = _iteration(scene)
    got = shade.regen_shade(scene, rows, fs, ints, active, PALLAS)
    want = regen._shade_torch(scene, PALLAS, ti._hit_from_rows(rows, active),
                              fs, ints, active)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    fs2, ints2, alive, dead_now, counts = got
    assert fs2.shape == (17, 512) and ints2.shape == (6, 512)
    assert counts.tolist() == [int(alive.sum()), int(dead_now.sum())]
    assert not (alive & dead_now).any() and not (alive & ~active).any()
    assert torch.equal(dead_now, active & ~alive)
    assert 0 < int(alive.sum()) < int(active.sum())


def _torch_body_frame(monkeypatch, scene, cam, cfg, frame):
    """The frame with every regen iteration shaded in the torch body: the
    reference each shading entry is held to."""
    with monkeypatch.context() as m:
        m.setattr(regen, "shade_entry", lambda *a: None)
        return render_radiance(scene, cam, cfg, frame)


@pytest.mark.parametrize("retire", ["log", "scatter"])
def test_regen_through_the_wrapper_on_the_cpu(scenes, retire, monkeypatch):
    """Regen's call site on a CPU scene: every iteration goes through
    ``regen_shade`` (its plain version here), a drain stage included, and
    the frame equals the torch body's."""
    scene, cam = scenes["demo"], tdemo.demo_camera(40, 24)
    cfg = PALLAS.replace(regen_wavefront=512, regen_drain=True,
                         regen_retire=retire)
    want = _torch_body_frame(monkeypatch, scene, cam, cfg, 3)
    calls, real = [], shade.regen_shade

    def counting(scene, rows, fs, ints, active, config):
        calls.append(fs.shape[1])
        return real(scene, rows, fs, ints, active, config)

    monkeypatch.setattr(regen, "regen_shade", counting)
    regen.render_radiance_regen.iterations = 0
    got = render_radiance(scene, cam, cfg, 3)
    assert len(calls) == regen.render_radiance_regen.iterations > 2
    assert set(calls) == {512, 256}
    for k in AOVS:
        assert torch.equal(getattr(got, k), getattr(want, k)), k


def _lite_iteration(scene, n=500, seed=1):
    """One iteration's inputs on a superchunk scene kernel 3 takes: its
    raw winners (the plain version) of random rays from inside the scene's
    box, a fifth of them outside heading away (misses), lane stacks with
    bounces up to the cap, a quarter of the lanes inactive."""
    prep = ti.prepare_trace_inputs(scene)
    assert ti._sc_lite_fits(prep)
    g = np.random.default_rng(seed)
    cb = scene.isect_chunk_bounds.numpy()
    lo, hi = cb[0:3].min(axis=1), cb[3:6].max(axis=1)
    o = g.uniform(lo, hi, (n, 3)).T.astype(np.float32)
    d = g.normal(size=(3, n))
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    out = g.uniform(size=n) < 0.2
    o[:, out] = (hi + 1.0)[:, None]
    d[:, out] = np.abs(d[:, out])
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    active = torch.from_numpy(g.uniform(size=n) < 0.75)
    lite = ti.sc_lite_winners(Ray(Vec3(*o), Vec3(*d)), active, prep)
    fs = torch.cat([o, d, torch.ones(3, n), torch.zeros(4, n),
                    torch.full((1, n), 1000.0), torch.zeros(3, n)])
    ints = torch.from_numpy(np.stack(
        [g.integers(0, 1 << 32, n), g.integers(0, 1 << 32, n),
         np.arange(n), g.integers(0, 5, n), np.zeros(n, np.int64),
         np.zeros(n, np.int64)]))
    return prep, lite, fs, ints, active


def test_regen_shade_lite_plain_is_the_torch_body(scenes):
    """On CPU tensors ``regen_shade_lite`` runs ``lite_epilogue`` on
    kernel 3's winners and then regen's torch body, which is what regen
    ran on such a scene before: the same stacks, masks and counts as the
    torch body on ``trace_pallas``'s hit of the same rays (misses, hits
    and inactive lanes among them)."""
    scene = scenes["mid"]
    prep, lite, fs, ints, active = _lite_iteration(scene)
    assert lite.shape == (ti.LITE_R, 500) and lite.stride(0) == 512
    got = shade.regen_shade_lite(scene, prep, lite, fs, ints, active, PALLAS,
                                 shade.lite_tables(scene))
    hit = ti.trace_pallas(scene, Ray(Vec3(*fs[0:3]), Vec3(*fs[3:6])), active,
                          prep)
    assert hit.rows is None
    want = regen._shade_torch(scene, PALLAS, hit, fs, ints, active)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    fs2, ints2, alive, dead_now, counts = got
    won = active & (lite[0] < ti._MISS)
    assert 0 < int(won.sum()) < int(active.sum())
    assert counts.tolist() == [int(alive.sum()), int(dead_now.sum())]
    assert torch.equal(dead_now, active & ~alive) and not (alive & ~won).any()
    assert torch.equal(ints2[4], ints[4] + torch.where(active, lite[2], 0)
                       .to(torch.int64))


def test_lite_tables_are_row_major(scenes):
    """The tables are the scene's, one contiguous row a lane: the scene
    keeps ``isect_cols`` column-major, so it is the one copied."""
    scene = scenes["mid"]
    cols, shade_rows, mats = shade.lite_tables(scene)
    assert not scene.isect_cols.is_contiguous()
    for x, ref in ((cols, scene.isect_cols), (shade_rows, scene.isect_shade),
                   (mats, shading.material_table(scene))):
        assert x.is_contiguous() and torch.equal(x, ref)


@pytest.mark.parametrize("fault", [
    "glass", "rr", "no_bounces", "lite_rows", "lite_dtype", "strided",
    "active_dtype", "device", "cols_layout", "mats_width", "tables"])
def test_regen_shade_lite_refuses(scenes, fault):
    """``regen_shade_lite`` raises on a scene or config the kernel does not
    take, zero bounces, and operands it cannot read (shape, dtype, stride,
    device, the tables' layout), before any launch."""
    scene = scenes["glass" if fault == "glass" else "mid"]
    prep, lite, fs, ints, active = _lite_iteration(scenes["mid"], n=256)
    tables = shade.lite_tables(scenes["mid"])
    cfg = {"rr": PALLAS.replace(rr_start=2),
           "no_bounces": PALLAS.replace(bounces=0)}.get(fault, PALLAS)
    if fault == "lite_rows":
        lite = lite[:4]
    elif fault == "lite_dtype":
        lite = lite.double()
    elif fault == "strided":
        fs = torch.cat([fs, fs], dim=1)[:, ::2]
    elif fault == "active_dtype":
        active = active.to(torch.uint8)
    elif fault == "device":
        lite, fs, ints, active = (x.to("meta") for x in (lite, fs, ints,
                                                         active))
    elif fault == "cols_layout":
        tables = (scenes["mid"].isect_cols, *tables[1:])
    elif fault == "mats_width":
        tables = (*tables[:2], tables[2][:, :12].contiguous())
    elif fault == "tables":
        tables = tables[:2]
    with pytest.raises(ValueError):
        shade.regen_shade_lite(scene, prep, lite, fs, ints, active, cfg,
                               tables)


# (scene, config changes, kernel 3 on, the entry that shades: "lite",
# "rows" or None for the torch body)
DISPATCH = {
    "grid": ("mid", {}, True, "lite"),
    "grid_gate_off": ("mid", {"rr_start": 2}, True, None),
    "grid_not_fitting": ("mid", {}, False, "rows"),
    "demo": ("demo", {}, True, "rows"),
    "demo_no_bounces": ("demo", {"bounces": 0}, True, None),
}


@pytest.mark.parametrize("case", list(DISPATCH))
def test_regen_picks_the_lite_entry(scenes, case, monkeypatch):
    """Regen shades in ``regen_shade_lite`` where kernel 3 traces (the mid
    grid), once an iteration; in ``regen_shade`` on the winner rows of
    kernel 1 (the flat demo) and of kernel 6 (the mid grid with
    ``_SC_LITE`` off); in the torch body where the gate declines (Russian
    roulette, zero bounces). Every frame equals the torch body's (the
    plain versions here). At zero bounces every path traces one segment
    and ends."""
    name, change, lite_on, entry = DISPATCH[case]
    scene = scenes[name]
    cam = (tdemo.demo_camera(24, 16) if name == "demo"
           else tdemo.grid_camera(24, 16, n=4))
    cfg = PALLAS.replace(regen_wavefront=256, **change)
    monkeypatch.setattr(ti, "_SC_LITE", lite_on)
    want = _torch_body_frame(monkeypatch, scene, cam, cfg, 2)
    calls = {"lite": 0, "rows": 0}

    def counting(kind, real):
        def wrapper(*args):
            calls[kind] += 1
            return real(*args)
        return wrapper

    monkeypatch.setattr(regen, "regen_shade_lite",
                        counting("lite", shade.regen_shade_lite))
    monkeypatch.setattr(regen, "regen_shade",
                        counting("rows", shade.regen_shade))
    regen.render_radiance_regen.iterations = 0
    torch0 = regen._shade_torch.iterations
    got = render_radiance(scene, cam, cfg, 2)
    iters = regen.render_radiance_regen.iterations
    if cfg.bounces == 0:  # one segment a path: 384 paths, 256 lanes
        assert iters == 2 and bool((got.segments == 1).all())
    else:
        assert iters > 2
    assert calls == {k: iters if k == entry else 0 for k in calls}
    assert regen._shade_torch.iterations - torch0 == \
        (iters if entry is None else 0)
    for k in AOVS:
        assert torch.equal(getattr(got, k), getattr(want, k)), k
