"""The primal BVH loop's shading kernel (ops/shade.py ``path_shade_bvh``,
csrc/path_shade.cu) on the CPU: the entry ``path_trace`` asks
(``path_shade_entry``), the wrapper's refusals, and the loop of its own
that the entry takes, driven through the wrapper's plain version and held
bit for bit against the standard loop's torch body. The kernel itself runs
only on the card (tests/test_torch_cuda.py)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gdpathtracing_torch.config import RenderConfig, Traversal
from gdpathtracing_torch.core.vec import Vec3
from gdpathtracing_torch.ops import shade
from gdpathtracing_torch.render import integrator
from gdpathtracing_torch.render import traverse
from gdpathtracing_torch.render.renderer import render_radiance
from gdpathtracing_torch.render.types import Ray
from gdpathtracing_torch.scene import demo as tdemo
from gdpathtracing_torch.scene import primitives as tprim
from gdpathtracing_torch.scene.materials import Material
from gdpathtracing_torch.scene.scene import Scene, SceneBuilder

torch.set_num_threads(1)
AOVS = ("radiance", "depth", "steps", "segments", "normal")


def _sphere_room(material: Material, light: bool = True) -> Scene:
    """A sphere of ``material`` (under the demo's ceiling light where
    ``light``), on the CPU."""
    b = SceneBuilder(texture_resolution=4)
    sphere = b.add_mesh(tprim.uv_sphere(radius=1.0, rings=6, segments=12))
    if light:
        plane = b.add_mesh(tprim.plane_mesh(size=2.0))
        b.add_instance(plane, tdemo._affine([1, 0, 0, 0, -1, 0, 0, 0, -1],
                                            (0, 2.5, 0)),
                       materials=[tdemo.LIGHT_MAT])
    b.add_instance(sphere, np.eye(4, dtype=np.float32)[:3],
                   materials=[material])
    return b.build("cpu")


@pytest.fixture(scope="module")
def scenes():
    return {
        "demo": tdemo.build_demo_scene(texture_resolution=8, sphere_detail=6,
                                       device="cpu"),
        "mid": tdemo.build_sphere_grid(n=4, sphere_detail=12, device="cpu"),
        "dark": _sphere_room(Material(albedo=(0.7, 0.6, 0.5)), light=False),
        "glass": _sphere_room(Material(albedo=(1, 1, 1), transmission=1.0,
                                       ior=1.5, roughness=0.05)),
        "textured": _sphere_room(Material(
            albedo_texture=np.full((4, 4, 3), 0.5, np.float32)))}


# (scene, RenderConfig changes, the entry: "bvh" or None for the torch body)
GATE = {
    "bvh": ("demo", {}, "bvh"),
    "bvh_grid": ("mid", {}, "bvh"),
    "nee_without_lights": ("dark", {"nee": True}, "bvh"),
    "sort_rays_false": ("demo", {"sort_rays": False}, "bvh"),
    "differentiable": ("demo", {"differentiable": True}, None),
    "nee": ("demo", {"nee": True}, None),
    "soft_primary": ("demo", {"soft_primary": 0.01}, None),
    "sort_rays": ("demo", {"sort_rays": True}, None),
    "rr": ("demo", {"rr_start": 2}, None),
    "no_bounces": ("demo", {"bounces": 0}, None),
    "glass": ("glass", {}, None),
    "textured": ("textured", {}, None),
    "pallas": ("demo", {"traversal": Traversal.PALLAS}, None),
    "brute": ("demo", {"traversal": Traversal.BRUTE}, None),
    "unit": ("demo", {"traversal": Traversal.UNIT}, None),
}


@pytest.mark.parametrize("case", list(GATE))
def test_path_shade_entry_gate(scenes, case):
    """The gate takes a primal BVH render with no NEE (off, or a scene
    without emitters), no soft primary and no ray sort on a scene the
    kernel takes, and declines the differentiable render, NEE, the soft
    primary, ``sort_rays=True``, Russian roulette, zero bounces, glass,
    textures and every other traversal. It has no device term: these
    scenes are on the CPU."""
    name, change, want = GATE[case]
    assert shade.path_shade_entry(scenes[name],
                                  RenderConfig().replace(**change)) == want


def _torch_body(monkeypatch, scene, cam, cfg, frame):
    """The frame with every bounce in the standard loop's torch body."""
    with monkeypatch.context() as m:
        m.setattr(integrator, "path_shade_entry", lambda *a: None)
        return render_radiance(scene, cam, cfg, frame)


# (scene, RenderConfig changes, frame index)
RENDERS = {
    "demo": ("demo", {}, 0),
    "demo_one_bounce": ("demo", {"bounces": 1}, 3),
    "demo_two_spp": ("demo", {"spp": 2}, 3),
    "demo_one_bounce_two_spp": ("demo", {"bounces": 1, "spp": 2}, 0),
    "demo_three_tiles": ("demo", {"tile_rays": 256}, 1),
    "mid": ("mid", {}, 2),
}


@pytest.mark.parametrize("case", list(RENDERS))
def test_bvh_loop_equals_the_torch_body(scenes, case, monkeypatch):
    """``render_radiance`` under ``RenderConfig()`` takes the loop of its
    own, one ``path_shade_bvh`` a tile, sample and bounce (its plain
    version here), and every AOV equals, bit for bit and in dtype, the
    same render through the torch body: the demo at 32x18 (one and five
    bounces, one and two samples, two frame indices, three tiles of 256
    rays) and the mid grid at 16x12."""
    name, change, frame = RENDERS[case]
    scene = scenes[name]
    cam = (tdemo.demo_camera(32, 18) if name == "demo"
           else tdemo.grid_camera(16, 12, n=4))
    cfg = RenderConfig().replace(**change)
    assert shade.path_shade_entry(scene, cfg) == "bvh"
    want = _torch_body(monkeypatch, scene, cam, cfg, frame)
    calls, real = [], shade.path_shade_bvh

    def counting(scene, hit, fs, seeds, counts, active, config, bounce):
        calls.append((fs.shape[1], bounce))
        return real(scene, hit, fs, seeds, counts, active, config, bounce)

    monkeypatch.setattr(integrator, "path_shade_bvh", counting)
    got = render_radiance(scene, cam, cfg, frame)
    n_pix = cam.width * cam.height
    tiles = [min(cfg.tile_rays, n_pix - k)
             for k in range(0, n_pix, cfg.tile_rays)]
    assert calls == [(n, i) for n in tiles for _ in range(cfg.spp)
                     for i in range(cfg.bounces)]
    for k in AOVS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and torch.equal(a, b), k
    assert int(got.segments.max()) == cfg.bounces * cfg.spp
    assert bool((got.depth < cam.far).any())


def test_launch_counter_stays_on_the_cpu(scenes):
    """On the CPU the wrapper runs its plain version and counts no launch;
    the traversal is handed every lane of every bounce."""
    cam = tdemo.demo_camera(16, 16)
    before, lanes = shade.path_shade_bvh.launches, traverse.trace_bvh.lanes
    render_radiance(scenes["demo"], cam, RenderConfig(bounces=3), 0)
    assert shade.path_shade_bvh.launches == before
    assert traverse.trace_bvh.lanes - lanes == 3 * 16 * 16


def _carry(scene, n=300, seed=0):
    """The hit and carry of one bounce: the loop's start on random rays
    from inside the demo room, traced by the plain BVH walk."""
    g = np.random.default_rng(seed)
    o = torch.from_numpy(g.uniform(-1.0, 1.0, (3, n)).astype(np.float32))
    d = torch.nn.functional.normalize(
        torch.from_numpy(g.normal(size=(3, n)).astype(np.float32)), dim=0)
    ray = Ray(Vec3(*o), Vec3(*d))
    seeds = (torch.from_numpy(g.integers(0, 1 << 32, n)),
             torch.from_numpy(g.integers(0, 1 << 32, n)))
    fs, seeds, counts, active = integrator.bvh_carry(ray, seeds, 1000.0)
    active[::4] = False
    hit = traverse.trace_bvh(scene, ray, active)
    return hit, fs, seeds, counts, active


def test_path_shade_bvh_one_bounce(scenes):
    """One bounce through the wrapper on the CPU: fresh stacks of the
    carry's shapes; steps and segments counted on active lanes; paths go
    on only where they hit; ended paths keep their ray and read prev pdf
    -1; the first-hit depth is written where a lane hit."""
    scene = scenes["demo"]
    hit, fs, seeds, counts, active = _carry(scene)
    got = shade.path_shade_bvh(scene, hit, fs, seeds, counts, active,
                               RenderConfig(), 0)
    fs2, seeds2, counts2, alive = got
    assert (fs2.shape, seeds2.shape, counts2.shape, alive.shape) == \
        (fs.shape, seeds.shape, counts.shape, active.shape)
    assert all(x.data_ptr() != y.data_ptr()
               for x, y in zip(got, (fs, seeds, counts, active)))
    won = hit.hit & active
    assert 0 < int(alive.sum()) < int(won.sum())
    assert not bool((alive & ~won).any())
    assert torch.equal(counts2[0], torch.where(active, hit.steps, 0))
    assert torch.equal(counts2[1], active.to(torch.int32))
    ended = ~alive
    assert torch.equal(fs2[0:9, ended], fs[0:9, ended])
    assert bool((fs2[12, ended] == -1.0).all())
    assert bool((fs2[13, won] < 1000.0).all())
    assert bool((fs2[13, ~won] == 1000.0).all())
    assert not torch.equal(seeds2, seeds)


@pytest.mark.parametrize("fault", [
    "pallas", "nee", "bounce", "fs_rows", "seeds_dtype", "counts_strided",
    "active_dtype", "hit_front", "hit_rows", "device", "empty"])
def test_path_shade_bvh_refuses(scenes, fault):
    """The wrapper raises, before any launch, on a render the gate
    declines, a bounce past the cap, and operands it cannot read (shape,
    dtype, stride, the hit's fields, a hit with winner rows, the device,
    no lanes)."""
    scene = scenes["demo"]
    hit, fs, seeds, counts, active = _carry(scene, n=64)
    cfg, bounce = RenderConfig(), 0
    if fault == "pallas":
        cfg = cfg.replace(traversal=Traversal.PALLAS)
    elif fault == "nee":
        cfg = cfg.replace(nee=True)
    elif fault == "bounce":
        bounce = cfg.bounces
    elif fault == "fs_rows":
        fs = fs[:16]
    elif fault == "seeds_dtype":
        seeds = seeds.to(torch.int32)
    elif fault == "counts_strided":
        counts = torch.cat([counts, counts], dim=1)[:, ::2]
    elif fault == "active_dtype":
        active = active.to(torch.uint8)
    elif fault == "hit_front":
        hit = hit._replace(front=hit.front.to(torch.int32))
    elif fault == "hit_rows":
        hit = hit._replace(rows=torch.zeros(48, 64))
    elif fault == "device":
        hit = hit._replace(**{f: getattr(hit, f).to("meta") for f in
                              ("t", "u", "v", "tri", "inst", "front",
                               "steps")})
        fs, seeds, counts, active = (x.to("meta") for x in
                                     (fs, seeds, counts, active))
    elif fault == "empty":
        hit = hit._replace(**{f: getattr(hit, f)[:0] for f in
                              ("t", "u", "v", "tri", "inst", "front",
                               "steps")})
        fs, seeds, counts, active = (fs[:, :0], seeds[:, :0], counts[:, :0],
                                     active[:0])
    with pytest.raises(ValueError):
        shade.path_shade_bvh(scene, hit, fs, seeds, counts, active, cfg,
                             bounce)
