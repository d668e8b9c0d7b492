"""Emissive-triangle light table — port of ``build_light_table`` of
gdpathtracing_tpu/render/lights.py.

The closest-hit kernel's winner table carries each emitter's pick-pdf term
and geometric normal (ops/intersect.py ``build_trace_table`` rows 30-33), so
the table is built even on the ported slice, which has no NEE yet. Light
sampling itself (``sample_light``, MIS pickup) comes with NEE (ROADMAP
queue 1, item 7).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gdpathtracing_torch.core.math3d import affine_apply_point
from gdpathtracing_torch.core.vec import Vec3
from gdpathtracing_torch.scene.scene import Scene

_EPS = 1e-8


class LightTable(NamedTuple):
    v0: Vec3          # (L,) world-space triangle vertices
    v1: Vec3
    v2: Vec3
    normal: Vec3      # (L,) unit geometric normal
    area: torch.Tensor
    emission: Vec3    # (L,) radiance (rgb * energy)
    pick_prob: torch.Tensor  # (L,)
    cdf: torch.Tensor        # (L,)


def build_light_table(scene: Scene) -> "LightTable | None":
    """World-space emitter table, or None when the scene has no lights."""
    if scene.n_lights == 0:
        return None
    inst = scene.light_inst.long()
    tri = scene.light_tri.long()
    tf = scene.inst_transform[inst]             # (L, 3, 4)
    pos = scene.tri_pos[tri]                    # (L, 3, 3)

    def vert(k):
        return affine_apply_point(
            tf, Vec3(pos[:, k, 0], pos[:, k, 1], pos[:, k, 2]))

    v0, v1, v2 = vert(0), vert(1), vert(2)
    n = (v1 - v0).cross(v2 - v0)
    nl = n.length()
    area = 0.5 * nl
    normal = n * (1.0 / torch.clamp(nl, min=_EPS))

    slot = torch.clamp(scene.tri_slot[tri],
                       max=scene.inst_materials.shape[1] - 1).long()
    mat = scene.inst_materials[inst, slot].long()
    energy = torch.clamp(scene.mat_emission_energy[mat], min=0.0)
    emission = Vec3(scene.mat_emission[mat, 0] * energy,
                    scene.mat_emission[mat, 1] * energy,
                    scene.mat_emission[mat, 2] * energy)

    power = area * emission.luminance()
    total = torch.clamp(torch.sum(power), min=_EPS)
    pick = power / total
    cdf = torch.cumsum(pick, dim=0)
    return LightTable(v0, v1, v2, normal, area, emission, pick, cdf)
