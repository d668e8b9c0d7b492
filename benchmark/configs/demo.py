"""The demo room as the configuration states it: the upstream demo's
Cornell room with its ceiling light and two instances of Suzanne, one
diffuse and faintly emissive, one a metallic mirror (project/demo/
demo.tscn:49-93; transforms as basis rows and origin, materials as its
sub-resources). The room and Suzanne are the upstream OBJ files, packed
in ``demo_geometry.npz`` beside this file.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from benchmark.reference.meshes import packed, plane
from benchmark.reference.scene import Description, material

ASSET = Path(__file__).resolve().parent / "demo_geometry.npz"

LIGHT = material(albedo=(1, 1, 1), emission=(0.832472, 0.8072, 0.719802),
                 emission_energy=10.0, roughness=1.0)
GREY = material(albedo=(1, 1, 1), roughness=0.6)
RED = material(albedo=(1.0, 0.16, 0.16), roughness=1.0)
GREEN = material(albedo=(0.42, 1.0, 0.13), roughness=1.0)
SUZANNE = material(albedo=(0.8, 0.8, 0.8),
                   emission=(0.360742, 0.135649, 0.818479),
                   emission_energy=0.4, roughness=1.0)
MIRROR = material(albedo=(1, 1, 1), metallic=1.0, roughness=0.16)


def affine(rows9, origin) -> np.ndarray:
    """A Godot Transform3D (basis rows, origin) as a (3, 4) affine."""
    m = np.zeros((3, 4), dtype=np.float32)
    m[:, :3] = np.asarray(rows9, dtype=np.float32).reshape(3, 3)
    m[:, 3] = origin
    return m


def description() -> Description:
    d = Description()
    light = d.add_mesh(plane(2.0))
    room = d.add_mesh(packed(ASSET, "cornell"))
    suzanne = d.add_mesh(packed(ASSET, "suzanne"))
    d.add_instance(light, affine([1, 0, 0, 0, -1, 1.50996e-07,
                                  0, -1.50996e-07, -1], (0, 2.95581, 0)),
                   [LIGHT])
    d.add_instance(room, affine([-2.62268e-08, 0, -0.6, 0, 0.6, 0,
                                 0.6, 0, -2.62268e-08], (0, 0, 0)),
                   [GREY, RED, GREEN])
    d.add_instance(suzanne, affine([0.982635, -0.208021, 0.656626,
                                    0.0853118, 1.17191, 0.243597,
                                    -0.68348, -0.152791, 0.974428],
                                   (-1.16402, -1.55573, -0.923088)),
                   [SUZANNE])
    d.add_instance(suzanne, affine([0.934979, 0.0872355, -0.747128,
                                    0.0853118, 1.17191, 0.243597,
                                    0.74735, -0.242915, 0.906899],
                                   (1.27032, -0.951083, -0.923088)),
                   [MIRROR])
    return d


def camera() -> tuple[np.ndarray, float]:
    """(world-from-camera affine, vertical FOV in degrees): at (0, 0,
    9.7694) looking down -Z (demo.tscn:49-53)."""
    return np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 9.7694]],
                    dtype=np.float32), 79.5
