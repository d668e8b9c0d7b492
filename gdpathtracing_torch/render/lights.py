"""Emissive-triangle light sampling for next-event estimation (NEE) — port
of ``build_light_table``, ``sample_light`` and ``light_pdf_from_rows`` of
gdpathtracing_tpu/render/lights.py.

The table is built once per scene (ops/intersect.py ``prepare_trace_inputs``
keeps it); the closest-hit kernel's winner table carries each emitter's
pick-pdf term and geometric normal (``build_trace_table`` rows 30-33), which
``light_pdf_from_rows`` reads for the MIS weight of a BRDF-sampled emitter
hit. Emitters are double-sided. After the superchunk lite kernel, which
writes no rows, ``light_pdf_of_hit`` finds the emitter by (inst, tri).

A differentiable render builds the table from the live scene instead, as
the reference does in every render (render/integrator.py): then
``sample_light`` and ``light_pdf_of_hit``, which the differentiable
traversal always takes, carry emission and emitter-geometry gradients.
Their per-lane fetches are ``index_select`` (see render/shading.py
``get_shading_data_fast``): every lane that hit no emitter reads row 0.
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
    # (L, 17) rows [v0(3), e1(3), e2(3), n(3), emission(3), area,
    # pick_prob]: sample_light fetches the picked emitter with one gather.
    rows: torch.Tensor


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
    e1, e2 = v1 - v0, v2 - v0
    rows = torch.stack([
        v0.x, v0.y, v0.z, e1.x, e1.y, e1.z, e2.x, e2.y, e2.z,
        normal.x, normal.y, normal.z,
        emission.x, emission.y, emission.z, area, pick], dim=1)
    return LightTable(v0, v1, v2, normal, area, emission, pick, cdf, rows)


class LightSample(NamedTuple):
    point: Vec3
    normal: Vec3
    emission: Vec3
    pdf_solid: torch.Tensor  # solid-angle pdf of the sampled direction
    wi: Vec3                 # unit direction shading point -> light
    dist: torch.Tensor


def sample_light(table: LightTable, position: Vec3, r_pick, r1, r2
                 ) -> LightSample:
    """Pick an emitter in proportion to its power, sample a uniform point
    on it and convert the area pdf to solid angle at ``position``.

    The pick is ``clamp(searchsorted(cdf, r, right=False), 0, L-1)``: the
    number of cdf entries below ``r``, so a tie ``cdf[j] == r`` picks ``j``
    and a round-off ``cdf[-1] < r`` picks the last emitter. JAX's one-hot
    product for few emitters selects the same row."""
    return sample_light_rows(table.rows, table.cdf, position, r_pick, r1,
                             r2)


def sample_light_rows(rows: torch.Tensor, cdf: torch.Tensor, position: Vec3,
                      r_pick, r1, r2) -> LightSample:
    """:func:`sample_light` on the table's (L, 17) ``rows`` and its
    ``cdf`` (the path kernels' light block, ops/megakernel.py)."""
    n_lights = cdf.shape[0]
    pick = torch.clamp(torch.searchsorted(cdf.contiguous(),
                                          r_pick.contiguous(), right=False),
                       0, n_lights - 1)
    r = rows.index_select(0, pick)  # (N, 17)
    v0 = Vec3(r[:, 0], r[:, 1], r[:, 2])
    e1 = Vec3(r[:, 3], r[:, 4], r[:, 5])
    e2 = Vec3(r[:, 6], r[:, 7], r[:, 8])
    normal = Vec3(r[:, 9], r[:, 10], r[:, 11])
    emission = Vec3(r[:, 12], r[:, 13], r[:, 14])
    area = r[:, 15]
    pick_prob = r[:, 16]

    su = torch.sqrt(r1)
    b1 = r2 * su                 # v1 weight; v2 gets su(1-r2), v0 1-su
    b2 = su * (1.0 - r2)
    point = v0 + e1 * b1 + e2 * b2

    delta = point - position
    dist2 = torch.clamp(delta.length_sq(), min=_EPS)
    dist = torch.sqrt(dist2)
    wi = delta * (1.0 / dist)
    cos_l = torch.abs(normal.dot(-wi))  # double-sided emitter
    pdf_solid = dist2 / torch.clamp(cos_l * area, min=_EPS) * pick_prob
    pdf_solid = torch.where(cos_l > 1e-6, pdf_solid, torch.inf)  # grazing
    return LightSample(point, normal, emission, pdf_solid, wi, dist)


def light_pdf_from_rows(hit_rows: torch.Tensor, ray_dir: Vec3, t
                        ) -> torch.Tensor:
    """Solid-angle pdf that NEE would have given the direction that just
    hit, from the winner's emitter term (pick_prob/area, 0 when not a
    light) and geometric normal in rows 30-33 of the closest-hit rows."""
    inv_term = hit_rows[30]
    cos_l = torch.abs(hit_rows[31] * ray_dir.x + hit_rows[32] * ray_dir.y
                      + hit_rows[33] * ray_dir.z)
    dist2 = torch.clamp(t * t, min=_EPS)
    pdf = dist2 * inv_term / torch.clamp(cos_l, min=1e-6)
    return torch.where((inv_term > 0.0) & (cos_l > 1e-6), pdf, 0.0)


def light_pdf_of_hit(table: LightTable, scene: Scene, hit_inst, hit_tri,
                     ray_dir: Vec3, t) -> torch.Tensor:
    """The pdf of :func:`light_pdf_from_rows` for a hit known only by
    (inst, tri): matched against the (L,) emitters, the first match taken
    (as ``jnp.argmax`` takes it); 0 when the hit is not an emitter.

    Allocates an (N, L) match mask, as the reference does: small for the
    bench scenes (L = 2 on the sphere grids), but a scene of many emitters
    would want a per-triangle light index instead."""
    eq = (scene.light_inst[None, :] == hit_inst[:, None]) & \
        (scene.light_tri[None, :] == hit_tri[:, None])      # (N, L)
    is_light = eq.any(dim=1)
    k = torch.argmax(eq.to(torch.uint8), dim=1)
    normal = Vec3(*(x.index_select(0, k) for x in table.normal))
    cos_l = torch.abs(normal.dot(-ray_dir))
    dist2 = torch.clamp(t * t, min=_EPS)
    pdf = dist2 / torch.clamp(cos_l * table.area.index_select(0, k),
                              min=_EPS) * table.pick_prob.index_select(0, k)
    return torch.where(is_light & (cos_l > 1e-6), pdf, 0.0)
