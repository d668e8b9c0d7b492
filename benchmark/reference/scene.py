"""The reference's scene: a description of meshes, materials and instances,
and the tables the reference traces and shades with, worked out from it.

A description is what a configuration states (``benchmark/configs/<name>.py``):
meshes as lists of surfaces (object-space triangles with vertex normals),
materials in table order, and instances (a mesh, a (3, 4) world-from-object
affine, a material per surface). :class:`Description` assembles one the way
a scene builder resolves materials: slot 0 is the default material, the
others are added once each, in order of first use.

The tables expand every instance into world space: per triangle the affine
map of world space onto its unit-triangle space (Woop), from which a ray's
t, u and v follow, its world-space vertex normals and its world bounds.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

DEFAULT_MATERIAL = dict(albedo=(0.5, 0.5, 0.5), emission=(0.0, 0.0, 0.0),
                        emission_energy=0.0, metallic=0.0, roughness=0.5)


def material(albedo=(1.0, 1.0, 1.0), emission=(0.0, 0.0, 0.0),
             emission_energy=0.0, metallic=0.0, roughness=1.0) -> dict:
    return dict(albedo=tuple(albedo), emission=tuple(emission),
                emission_energy=emission_energy, metallic=metallic,
                roughness=roughness)


class Description:
    """Meshes, materials and instances of a scene."""

    def __init__(self):
        self.meshes: list[list[dict]] = []
        self.materials: list[dict] = [DEFAULT_MATERIAL]
        self.instances: list[tuple[int, np.ndarray, list[int]]] = []

    def add_mesh(self, surfaces) -> int:
        """``surfaces``: (positions (F, 3, 3), normals (F, 3, 3)) pairs."""
        self.meshes.append([dict(positions=np.asarray(p, np.float32),
                                 normals=np.asarray(n, np.float32))
                            for p, n in surfaces])
        return len(self.meshes) - 1

    def _material_id(self, mat) -> int:
        if mat is None:
            return 0
        if mat not in self.materials:
            self.materials.append(mat)
        return self.materials.index(mat)

    def add_instance(self, mesh: int, transform, materials) -> None:
        n_surf = len(self.meshes[mesh])
        mats = list(materials) + [None] * (n_surf - len(materials))
        self.instances.append((mesh, np.asarray(transform, np.float32),
                               [self._material_id(m) for m in mats]))

    def albedo(self) -> np.ndarray:
        """(M, 3) float32 albedo table."""
        return np.array([m["albedo"] for m in self.materials], np.float32)


class Tables(NamedTuple):
    cols: torch.Tensor      # (E, 12) f32 unit-space rows [u | v | w]
    normals: torch.Tensor   # (E, 9) f32 world vertex normals n0 n1 n2
    mat: torch.Tensor       # (E,) int64 material id
    lo: torch.Tensor        # (E, 3) f32 world bounds
    hi: torch.Tensor
    mat_rows: torch.Tensor  # (M, 6) f32 [emission3, energy, metallic,
    #                         roughness]
    albedo: torch.Tensor    # (M, 3) f32


def _unit_space(world: np.ndarray) -> np.ndarray:
    """(c, 3, 3) world triangles -> (c, 3, 4) affine maps of world space
    onto each triangle's (u, v, w) space; zero for a degenerate one."""
    w0 = world[:, 0]
    e1 = world[:, 1] - w0
    e2 = world[:, 2] - w0
    n = np.cross(e1, e2)
    m = np.stack([e1, e2, n], axis=-1)
    det = np.linalg.det(m)
    ok = np.abs(det) > 1e-18
    m_safe = np.where(ok[:, None, None], m, np.eye(3, dtype=np.float32))
    minv = np.linalg.inv(m_safe).astype(np.float32)
    minv = np.where(ok[:, None, None], minv, 0.0).astype(np.float32)
    c = -np.einsum("cij,cj->ci", minv, w0).astype(np.float32)
    return np.concatenate([minv, c[:, :, None]], axis=2)


def compile_tables(desc: Description, device) -> Tables:
    """The reference's tables of ``desc`` on ``device``."""
    cols, worlds, tfs, nrms, mats = [], [], [], [], []
    n_slots = max(len(m) for _, _, m in desc.instances)
    for mesh, tf, mat_ids in desc.instances:
        surfaces = desc.meshes[mesh]
        pos = np.concatenate([s["positions"] for s in surfaces])
        slot = np.concatenate([np.full(len(s["positions"]), k)
                               for k, s in enumerate(surfaces)])
        world = pos @ tf[:, :3].T + tf[:, 3]
        cols.append(_unit_space(world))
        worlds.append(world)
        tfs.append(np.broadcast_to(tf, (len(pos), 3, 4)))
        nrms.append(np.concatenate([s["normals"] for s in surfaces]))
        ids = np.array(mat_ids + [0] * (n_slots - len(mat_ids)))
        mats.append(ids[np.minimum(slot, n_slots - 1)])
    world = np.concatenate(worlds)
    tf = np.ascontiguousarray(np.concatenate(tfs))
    # The shading normals: each vertex normal through the instance's
    # linear part, normalised at the hit.
    world_n = np.einsum("eab,evb->eva", tf[:, :, :3], np.concatenate(nrms))
    e = len(world)
    mt = desc.materials
    mat_rows = np.array([[*m["emission"], m["emission_energy"], m["metallic"],
                          m["roughness"]] for m in mt], np.float32)

    def dev(x, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)

    return Tables(cols=dev(np.concatenate(cols).reshape(e, 12)),
                  normals=dev(world_n.reshape(e, 9)),
                  mat=dev(np.concatenate(mats), torch.int64),
                  lo=dev(world.min(axis=1)), hi=dev(world.max(axis=1)),
                  mat_rows=dev(mat_rows), albedo=dev(desc.albedo()))
