"""The sphere grid with one albedo per sphere, as the configuration states
it: an n x n grid of one UV sphere mesh (instanced n² times) over a floor,
under an emissive ceiling plane. Sphere k (row-major) takes the roughness
and metallic of the four alternating materials (two diffuse, two metal)
and its albedo times 0.5 + 0.5·k/(n²−1), so each sphere is a row of the
albedo table of its own.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.meshes import plane, uv_sphere
from benchmark.reference.scene import Description, material

N = 10
DETAIL = 16
SPACING = 2.5

LIGHT = material(albedo=(1, 1, 1), emission=(0.832472, 0.8072, 0.719802),
                 emission_energy=10.0, roughness=1.0)
FLOOR = material(albedo=(0.8, 0.8, 0.8), roughness=0.7)
SPHERES = [material(albedo=(0.9, 0.3, 0.2), roughness=0.4),
           material(albedo=(0.2, 0.5, 0.9), roughness=0.2, metallic=1.0),
           material(albedo=(0.3, 0.9, 0.4), roughness=0.8),
           material(albedo=(0.9, 0.9, 0.9), roughness=0.05, metallic=1.0)]


def affine(rows9, origin) -> np.ndarray:
    m = np.zeros((3, 4), dtype=np.float32)
    m[:, :3] = np.asarray(rows9, dtype=np.float32).reshape(3, 3)
    m[:, 3] = origin
    return m


def description() -> Description:
    d = Description()
    sphere = d.add_mesh(uv_sphere(1.0, DETAIL, 2 * DETAIL))
    floor = d.add_mesh(plane(2.0))
    light = d.add_mesh(plane(2.0))
    half = (N - 1) * SPACING * 0.5
    d.add_instance(floor, affine([N * SPACING, 0, 0, 0, 1, 0, 0, 0,
                                  N * SPACING], (0, -1.0, 0)), [FLOOR])
    d.add_instance(light, affine([N * SPACING, 0, 0, 0, -1, 0, 0, 0,
                                  -N * SPACING], (0, 4.0 + N, 0)), [LIGHT])
    for i in range(N):
        for j in range(N):
            m = SPHERES[(i + j) % len(SPHERES)]
            f = 0.5 + 0.5 * (i * N + j) / max(N * N - 1, 1)
            m = dict(m, albedo=tuple(c * f for c in m["albedo"]))
            d.add_instance(sphere, affine([1, 0, 0, 0, 1, 0, 0, 0, 1],
                                          (i * SPACING - half, 0.0,
                                           j * SPACING - half)), [m])
    return d


def camera() -> tuple[np.ndarray, float]:
    """Looking at the grid's centre from (0.6, 0.45, 0.8) times its
    extent, 50° vertical FOV."""
    ext = N * SPACING
    eye = np.asarray((0.6 * ext, 0.45 * ext, 0.8 * ext), dtype=np.float32)
    fwd = np.asarray((0, 0, 0), dtype=np.float32) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray((0.0, 1.0, 0.0), dtype=np.float32))
    right /= np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    m = np.zeros((3, 4), dtype=np.float32)
    m[:, 0], m[:, 1], m[:, 2], m[:, 3] = right, true_up, -fwd, eye
    return m, 50.0
