"""Meshes of the reference's scenes: a plane, a UV sphere, and the demo's
packed geometry (the room and Suzanne, converted from the upstream OBJ
files). Each is a list of (positions (F, 3, 3), normals (F, 3, 3))
surfaces, counter-clockwise seen from the normal side.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def plane(size: float = 2.0):
    """A size x size plane facing +Y, two triangles."""
    h = size * 0.5
    verts = np.array([[-h, 0, -h], [-h, 0, h], [h, 0, h], [h, 0, -h]],
                     dtype=np.float32)
    pos = np.stack([verts[[0, 1, 2]], verts[[0, 2, 3]]])
    nrm = np.tile(np.array([0, 1, 0], dtype=np.float32), (2, 3, 1))
    return [(pos, nrm)]


def uv_sphere(radius: float = 1.0, rings: int = 16, segments: int = 32):
    """A UV sphere with smooth outward normals."""
    pos, nrm = [], []

    def point(r_i: int, s_i: int):
        theta = np.pi * r_i / rings
        phi = 2 * np.pi * s_i / segments
        n = np.array([np.sin(theta) * np.cos(phi), np.cos(theta),
                      np.sin(theta) * np.sin(phi)], dtype=np.float32)
        return radius * n, n

    for r_i in range(rings):
        for s_i in range(segments):
            p00, p01 = point(r_i, s_i), point(r_i, s_i + 1)
            p10, p11 = point(r_i + 1, s_i), point(r_i + 1, s_i + 1)
            tris = []
            if r_i > 0:
                tris.append((p00, p10, p01))
            if r_i < rings - 1:
                tris.append((p01, p10, p11))
            for tri in tris:
                p = np.stack([t[0] for t in tri])
                n = np.stack([t[1] for t in tri])
                geom = np.cross(p[1] - p[0], p[2] - p[0])
                if np.dot(geom, n.mean(axis=0)) < 0:
                    p, n = p[[0, 2, 1]], n[[0, 2, 1]]
                pos.append(p)
                nrm.append(n)
    return [(np.stack(pos), np.stack(nrm))]


def packed(path: Path, name: str):
    """The surfaces of mesh ``name`` in a packed ``.npz`` asset."""
    with np.load(path) as z:
        return [(z[f"{name}_{k}_positions"], z[f"{name}_{k}_normals"])
                for k in range(int(z[f"{name}_n_surfaces"]))]
