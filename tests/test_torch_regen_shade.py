"""Regen's shading kernel (ops/shade.py, csrc/regen_shade.cu) on the CPU:
the gate that picks it over the torch body, the wrapper's refusals, and
regen's call site driven through the wrapper's plain version. The kernel
itself runs only on the card (tests/test_torch_cuda.py)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gdpathtracing_torch.config import RenderConfig, Traversal
from gdpathtracing_torch.core.vec import Vec3
from gdpathtracing_torch.ops import intersect as ti
from gdpathtracing_torch.ops import shade
from gdpathtracing_torch.render import regen
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


# (scene, config changes, scene reported on the card, the kernel shades)
GATE = {
    "demo": ("demo", {}, True, True),
    "demo_march_flag": ("demo", {"regen_march": True}, True, True),
    "sphere": ("sphere", {}, True, True),
    "nee": ("demo", {"nee": True}, True, False),
    "fused_nee": ("demo", {"nee": True, "regen_fuse_nee": True}, True,
                  False),
    "march": ("mid", {"regen_march": True}, True, False),
    "glass": ("glass", {}, True, False),
    "textured": ("textured", {}, True, False),
    "mr_textured": ("mr_textured", {}, True, False),
    "env": ("env", {}, True, False),
    "rr": ("demo", {"rr_start": 2}, True, False),
    "cpu": ("demo", {}, False, False),
}


@pytest.mark.parametrize("case", list(GATE))
def test_shade_kernel_gate(scenes, case, monkeypatch):
    """The gate, fed as regen feeds it, takes the flat no-NEE, no-RR demo
    (the march flag is ignored on a flat scene, so it shades there too) and
    a plain sphere room, and declines NEE, fused NEE, the march, glass,
    textures, an environment map, Russian roulette and a CPU scene. A scene
    "on the card" reports a CUDA device; nothing else of it changes."""
    name, change, on_card, want = GATE[case]
    scene, cfg = scenes[name], PALLAS.replace(**change)
    march = regen.use_march(cfg, ti.prepare_trace_inputs(scene))
    use_nee = cfg.nee and scene.n_lights > 0
    if on_card:
        monkeypatch.setattr(Scene, "device",
                            property(lambda s: torch.device("cuda")))
    assert shade.shade_kernel_supported(scene, cfg, march, use_nee) is want


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


@pytest.mark.parametrize("retire", ["log", "scatter"])
def test_regen_through_the_wrapper_on_the_cpu(scenes, retire, monkeypatch):
    """Regen's call site with the gate forced on for a CPU scene: every
    iteration goes through ``regen_shade`` (its plain version here), a
    drain stage included, and the frame equals the torch body's."""
    scene, cam = scenes["demo"], tdemo.demo_camera(40, 24)
    cfg = PALLAS.replace(regen_wavefront=512, regen_drain=True,
                         regen_retire=retire)
    want = render_radiance(scene, cam, cfg, 3)
    calls, real = [], shade.regen_shade

    def counting(scene, rows, fs, ints, active, config):
        calls.append(fs.shape[1])
        return real(scene, rows, fs, ints, active, config)

    monkeypatch.setattr(regen, "shade_kernel_supported", lambda *a: True)
    monkeypatch.setattr(regen, "regen_shade", counting)
    regen.render_radiance_regen.iterations = 0
    got = render_radiance(scene, cam, cfg, 3)
    assert len(calls) == regen.render_radiance_regen.iterations > 2
    assert set(calls) == {512, 256}
    for k in AOVS:
        assert torch.equal(getattr(got, k), getattr(want, k)), k
