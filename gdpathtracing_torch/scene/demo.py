"""The demo scene — port of gdpathtracing_tpu/scene/demo.py.

The geometry asset is the port's own copy of the JAX package's
``scene/data/demo_geometry.npz`` (tests/test_torch_scene.py holds the two
byte-equal).

Rebuild of the reference's Cornell demo.
Mirrors project/demo/demo.tscn:69-93: an emissive ceiling plane light, the
3-surface Cornell cube with per-surface grey/red/green overrides, and two
instances of one shared Suzanne mesh (one diffuse + faintly emissive, one
metallic mirror). Transforms and material parameters are transcribed from
the .tscn (basis rows + origin); the cornell/suzanne geometry ships as a
packed npz asset converted from the reference's OBJ files
(examples/convert_demo_assets.py ← project/demo/geometry/{cornell,
suzanne}.obj, wired at demo.tscn:85-93). ``geometry="sphere"`` substitutes
a cheap UV sphere + procedural box (the round-1 stand-in) — used by tests
that need a small triangle count.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from gdpathtracing_torch.bvh.blas import Surface
from gdpathtracing_torch.render.camera import Camera
from gdpathtracing_torch.scene.materials import Material
from gdpathtracing_torch.scene.primitives import (cornell_box, plane_mesh,
                                                  uv_sphere)
from gdpathtracing_torch.scene.scene import Scene, SceneBuilder

_GEOMETRY_NPZ = Path(__file__).resolve().parent / "data" / "demo_geometry.npz"


def load_demo_geometry(name: str):
    """Per-surface triangle arrays of a demo mesh ("cornell"/"suzanne")
    from the packed asset → list[Surface]."""
    with np.load(_GEOMETRY_NPZ) as z:
        n = int(z[f"{name}_n_surfaces"])
        out = []
        for k in range(n):
            def opt(field):
                key = f"{name}_{k}_{field}"
                return z[key] if key in z.files else None
            out.append(Surface(positions=z[f"{name}_{k}_positions"],
                               normals=opt("normals"), uvs=opt("uvs")))
    return out


def _affine(rows9, origin) -> np.ndarray:
    """Godot tscn Transform3D(9 basis numbers row-major, origin) → (3,4)."""
    m = np.zeros((3, 4), dtype=np.float32)
    m[:, :3] = np.asarray(rows9, dtype=np.float32).reshape(3, 3)
    m[:, 3] = origin
    return m


# demo.tscn materials (load_steps sub_resources)
LIGHT_MAT = Material(albedo=(1, 1, 1),
                     emission=(0.832472, 0.8072, 0.719802),
                     emission_energy=10.0, roughness=1.0)          # tscn:23-27
BOX_GREY = Material(albedo=(1, 1, 1), roughness=0.6)               # tscn:28-30
BOX_RED = Material(albedo=(1.0, 0.16, 0.16), roughness=1.0)        # tscn:31-33
BOX_GREEN = Material(albedo=(0.42, 1.0, 0.13), roughness=1.0)      # tscn:34-36
SUZANNE_MAT = Material(albedo=(0.8, 0.8, 0.8),
                       emission=(0.360742, 0.135649, 0.818479),
                       emission_energy=0.4, roughness=1.0)         # tscn:37-41
MIRROR_MAT = Material(albedo=(1, 1, 1), metallic=1.0,
                      roughness=0.16)                              # tscn:43-45


def build_demo_scene(texture_resolution: int = 1024,
                     sphere_detail: int = 16,
                     geometry: str = "reference", device="cuda") -> Scene:
    """``geometry="reference"`` (default): the real cornell.obj /
    suzanne.obj demo geometry (demo.tscn:69-93). ``"sphere"``: cheap
    procedural stand-ins (UV sphere of `sphere_detail`, procedural box) —
    for tests that want a small triangle count. Built on ``device``."""
    b = SceneBuilder(texture_resolution=texture_resolution)

    light_mesh = b.add_mesh(plane_mesh(size=2.0))
    if geometry == "reference":
        box_mesh = b.add_mesh(load_demo_geometry("cornell"))
        sphere_mesh = b.add_mesh(load_demo_geometry("suzanne"))
    else:
        box_mesh = b.add_mesh(cornell_box(size=5.0))
        sphere_mesh = b.add_mesh(uv_sphere(radius=1.0, rings=sphere_detail,
                                           segments=2 * sphere_detail))

    # Light: plane flipped to face down at y=2.956 (demo.tscn:73-76).
    b.add_instance(
        light_mesh,
        _affine([1, 0, 0, 0, -1, 1.50996e-07, 0, -1.50996e-07, -1],
                (0, 2.95581, 0)),
        materials=[LIGHT_MAT])

    # Cornell cube, rotated 90° about Y and scaled 0.6 (demo.tscn:78-83).
    b.add_instance(
        box_mesh,
        _affine([-2.62268e-08, 0, -0.6, 0, 0.6, 0, 0.6, 0, -2.62268e-08],
                (0, 0, 0)),
        materials=[BOX_GREY, BOX_RED, BOX_GREEN])

    # Two instances of the shared mesh (demo.tscn:85-93) — one BLAS,
    # two BLASInstances, exercising the TLAS.
    b.add_instance(
        sphere_mesh,
        _affine([0.982635, -0.208021, 0.656626,
                 0.0853118, 1.17191, 0.243597,
                 -0.68348, -0.152791, 0.974428],
                (-1.16402, -1.55573, -0.923088)),
        materials=[SUZANNE_MAT])
    b.add_instance(
        sphere_mesh,
        _affine([0.934979, 0.0872355, -0.747128,
                 0.0853118, 1.17191, 0.243597,
                 0.74735, -0.242915, 0.906899],
                (1.27032, -0.951083, -0.923088)),
        materials=[MIRROR_MAT])

    return b.build(device)


def demo_camera(width: int, height: int, fov_deg: float = 79.5) -> Camera:
    """Camera at (0, 0, 9.7694), identity basis, looking down -Z
    (demo.tscn:49-53)."""
    transform = np.array([[1, 0, 0, 0],
                          [0, 1, 0, 0],
                          [0, 0, 1, 9.7694]], dtype=np.float32)
    return Camera.from_affine(transform, fov_deg=fov_deg,
                              width=width, height=height)


def build_sphere_grid(n: int = 10, sphere_detail: int = 16,
                      spacing: float = 2.5, device="cuda",
                      instance_albedo: bool = False) -> Scene:
    """Stress scene: an n×n grid of instanced spheres (one shared mesh →
    n² BLAS instances, n²·tris expanded triangles) over a floor, an
    emissive ceiling light, alternating diffuse/metal materials. Used by
    bench.py --scene grid to measure scaling beyond the ~1.5k-tri demo.

    ``instance_albedo`` gives every sphere an albedo row of its own, the
    inverse problem of recovering each object's colour: the k-th sphere
    (row-major) keeps its material's roughness and metallic and scales
    its albedo by 0.5 + 0.5·k/(n²−1)."""
    b = SceneBuilder()
    sphere = b.add_mesh(
        uv_sphere(radius=1.0, rings=sphere_detail, segments=2 * sphere_detail))
    floor = b.add_mesh(plane_mesh(size=2.0))
    light_mesh = b.add_mesh(plane_mesh(size=2.0))

    half = (n - 1) * spacing * 0.5
    b.add_instance(
        floor,
        _affine([n * spacing, 0, 0, 0, 1, 0, 0, 0, n * spacing],
                (0, -1.0, 0)),
        materials=[Material(albedo=(0.8, 0.8, 0.8), roughness=0.7)])
    b.add_instance(
        light_mesh,
        _affine([n * spacing, 0, 0, 0, -1, 0, 0, 0, -n * spacing],
                (0, 4.0 + n, 0)),
        materials=[LIGHT_MAT])
    mats = [Material(albedo=(0.9, 0.3, 0.2), roughness=0.4),
            Material(albedo=(0.2, 0.5, 0.9), roughness=0.2, metallic=1.0),
            Material(albedo=(0.3, 0.9, 0.4), roughness=0.8),
            Material(albedo=(0.9, 0.9, 0.9), roughness=0.05, metallic=1.0)]
    for i in range(n):
        for j in range(n):
            mat = mats[(i + j) % len(mats)]
            if instance_albedo:
                f = 0.5 + 0.5 * (i * n + j) / max(n * n - 1, 1)
                mat = dataclasses.replace(
                    mat, albedo=tuple(c * f for c in mat.albedo))
            b.add_instance(
                sphere,
                _affine([1, 0, 0, 0, 1, 0, 0, 0, 1],
                        (i * spacing - half, 0.0, j * spacing - half)),
                materials=[mat])
    return b.build(device)


def grid_camera(width: int, height: int, n: int = 10,
                spacing: float = 2.5) -> Camera:
    ext = n * spacing
    return Camera.looking_at((0.6 * ext, 0.45 * ext, 0.8 * ext),
                             (0, 0, 0), fov_deg=50.0,
                             width=width, height=height)


def build_cornell_simple(light_energy: float = 10.0,
                         device="cuda") -> Scene:
    """Minimal diffuse Cornell scene for tests (BASELINE config 1): the box
    plus the plane light, no spheres."""
    b = SceneBuilder()
    light_mesh = b.add_mesh(plane_mesh(size=2.0))
    box_mesh = b.add_mesh(cornell_box(size=5.0))
    light = Material(albedo=(1, 1, 1), emission=(1, 1, 1),
                     emission_energy=light_energy, roughness=1.0)
    b.add_instance(
        light_mesh,
        _affine([1, 0, 0, 0, -1, 0, 0, 0, -1], (0, 2.95581, 0)),
        materials=[light])
    b.add_instance(
        box_mesh,
        _affine([-2.62268e-08, 0, -0.6, 0, 0.6, 0, 0.6, 0, -2.62268e-08],
                (0, 0, 0)),
        materials=[BOX_GREY, BOX_RED, BOX_GREEN])
    return b.build(device)
