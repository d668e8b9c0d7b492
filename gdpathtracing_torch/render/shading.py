"""Hit → shading data.

Port of ``get_shading_data``, ``get_shading_data_fast``,
``shading_from_rows`` and ``sample_texture_array`` of
gdpathtracing_tpu/render/shading.py. After a rows kernel everything a hit
needs (normals, uvs, material values) arrives pre-selected in ``hit.rows``
(ops/intersect.py ``build_trace_table`` layout) and only textured scenes
gather; after the superchunk lite kernel (``rows`` is None) shading
gathers one packed triangle row and one material row per hit; after the
BVH traversal (``fast=False``: no expanded-triangle index) it gathers by
triangle and instance, as the reference's own gather path does.
"""

from __future__ import annotations

import torch

from gdpathtracing_torch.core.math3d import affine_apply_dir
from gdpathtracing_torch.core.vec import Vec3, where as vwhere
from gdpathtracing_torch.render.types import HitInfo, Ray, ShadingInfo
from gdpathtracing_torch.scene.scene import Scene

MIN_ROUGHNESS = 0.006


def sample_texture_array(textures: torch.Tensor, tex_idx: torch.Tensor,
                         u: torch.Tensor, v: torch.Tensor) -> Vec3:
    """Bilinear sample of (X, R, R, 3) with repeat wrapping; tex_idx < 0
    returns white."""
    res = textures.shape[1]
    fu = torch.remainder(u, 1.0) * res - 0.5
    fv = torch.remainder(v, 1.0) * res - 0.5
    x0 = torch.floor(fu).to(torch.int64)
    y0 = torch.floor(fv).to(torch.int64)
    fx = fu - x0
    fy = fv - y0
    x0w = x0 % res
    y0w = y0 % res
    x1w = (x0 + 1) % res
    y1w = (y0 + 1) % res
    t = torch.clamp(tex_idx, min=0).to(torch.int64)

    def fetch(yy, xx):
        c = textures[t, yy, xx]  # (N, 3)
        return Vec3(c[..., 0], c[..., 1], c[..., 2])

    c00 = fetch(y0w, x0w)
    c01 = fetch(y0w, x1w)
    c10 = fetch(y1w, x0w)
    c11 = fetch(y1w, x1w)
    top = c00 + (c01 - c00) * fx
    bot = c10 + (c11 - c10) * fx
    color = top + (bot - top) * fy
    untextured = tex_idx < 0
    one = Vec3.full(1.0, like=color)
    return vwhere(untextured, one, color)


def material_table(scene: Scene) -> torch.Tensor:
    """(M, 13) f32 material rows [albedo3, emission3, energy, metallic,
    roughness, tex, transmission, ior, mr_tex]."""
    return torch.cat([
        scene.mat_albedo, scene.mat_emission,
        scene.mat_emission_energy[:, None], scene.mat_metallic[:, None],
        scene.mat_roughness[:, None],
        scene.mat_tex.to(torch.float32)[:, None],
        scene.mat_transmission[:, None], scene.mat_ior[:, None],
        scene.mat_mr_tex.to(torch.float32)[:, None]], dim=1)


def get_shading_data_fast(scene: Scene, hit: HitInfo, ray: Ray
                          ) -> ShadingInfo:
    """Shading from the expanded-triangle index: one (N, 16) gather of
    ``isect_shade`` and one of the (M, 13) material table. The reference
    selects the material row with a one-hot matmul at HIGHEST precision
    for small M, which is exact, because a gather's backward is slow on
    its device; an ``index_select`` is the same select, keeps TF32 out, and
    its backward (an atomic ``index_add_``) copes with millions of lanes
    reading a handful of rows, where advanced indexing's sorted
    ``index_put_`` serialises them (PERF.md §6)."""
    row = scene.isect_shade.index_select(
        0, torch.clamp(hit.eidx, min=0))  # (N, 16)
    u, v = hit.u, hit.v
    w = 1.0 - u - v
    normal = Vec3(
        row[:, 0] * w + row[:, 3] * u + row[:, 6] * v,
        row[:, 1] * w + row[:, 4] * u + row[:, 7] * v,
        row[:, 2] * w + row[:, 5] * u + row[:, 8] * v,
    ).normalize(eps=1e-20)
    normal = vwhere(hit.front, normal, -normal)
    uv_u = row[:, 9] * w + row[:, 11] * u + row[:, 13] * v
    uv_v = row[:, 10] * w + row[:, 12] * u + row[:, 14] * v
    m = material_table(scene).index_select(
        0, row[:, 15].to(torch.int64))  # (N, 13)

    albedo = Vec3(m[:, 0], m[:, 1], m[:, 2])
    if scene.has_textures:
        albedo = albedo * sample_texture_array(
            scene.textures, m[:, 9].to(torch.int32), uv_u, uv_v)
    energy = torch.clamp(m[:, 6], min=0.0)
    emission = Vec3(m[:, 3] * energy, m[:, 4] * energy, m[:, 5] * energy)
    metallic = m[:, 7]
    roughness = m[:, 8]
    if scene.has_mr_textures:
        mr_idx = m[:, 12].to(torch.int32)
        mr = sample_texture_array(scene.textures, mr_idx, uv_u, uv_v)
        roughness = torch.where(mr_idx >= 0, roughness * mr.y, roughness)
        metallic = torch.where(mr_idx >= 0, metallic * mr.z, metallic)
    return _finish(ray, hit.t, normal, albedo, emission, metallic, roughness,
                   m[:, 10], m[:, 11])


def _finish(ray, t, normal, albedo, emission, metallic, roughness,
            transmission, ior) -> ShadingInfo:
    position = ray.at(t)
    out_dir = -ray.d
    fresnel_0 = Vec3.full(0.02, like=albedo) + \
        (albedo - Vec3.full(0.02, like=albedo)) * metallic
    diffuse_albedo = albedo - albedo * metallic
    roughness = torch.clamp(roughness, min=MIN_ROUGHNESS)
    return ShadingInfo(
        position=position, normal=normal, out_dir=out_dir,
        lambert_out=normal.dot(out_dir), emission=emission,
        diffuse_albedo=diffuse_albedo, fresnel_0=fresnel_0,
        roughness=roughness, transmission=transmission, ior=ior,
        albedo=albedo)


def get_shading_data(scene: Scene, hit: HitInfo, ray: Ray,
                     fast: bool = True) -> ShadingInfo:
    """Shading of a hit: from the winner rows where a kernel wrote them;
    else, with ``fast`` (a PALLAS hit, which carries its expanded-triangle
    index), by the gathers of :func:`get_shading_data_fast`; else (a BVH
    hit) by triangle and instance. ``fast`` is the reference's switch,
    which its integrator sets for PALLAS; the reference defaults it to
    False, the port to True, since every caller but the BVH loop shades a
    PALLAS hit."""
    if hit.rows is not None:
        return shading_from_rows(scene, hit, ray)
    if fast:
        return get_shading_data_fast(scene, hit, ray)
    tri = hit.tri.long()
    inst = hit.inst.long()
    # The surface's material through its instance's material table (one
    # mesh, many materials).
    slot = torch.clamp(scene.tri_slot[tri].long(),
                       max=scene.inst_materials.shape[1] - 1)
    mat = scene.inst_materials[inst, slot].long()
    tf = scene.inst_transform[inst]  # (N, 3, 4)

    u, v = hit.u, hit.v
    w = 1.0 - u - v
    nrm = scene.tri_normal[tri]  # (N, 3, 3)
    n_obj = Vec3(
        nrm[..., 0, 0] * w + nrm[..., 1, 0] * u + nrm[..., 2, 0] * v,
        nrm[..., 0, 1] * w + nrm[..., 1, 1] * u + nrm[..., 2, 1] * v,
        nrm[..., 0, 2] * w + nrm[..., 1, 2] * u + nrm[..., 2, 2] * v,
    )
    uvs = scene.tri_uv[tri]  # (N, 3, 2)
    uv_u = uvs[..., 0, 0] * w + uvs[..., 1, 0] * u + uvs[..., 2, 0] * v
    uv_v = uvs[..., 0, 1] * w + uvs[..., 1, 1] * u + uvs[..., 2, 1] * v
    normal = affine_apply_dir(tf, n_obj).normalize(eps=1e-20)
    normal = vwhere(hit.front, normal, -normal)

    albedo = Vec3.from_array(scene.mat_albedo[mat])
    if scene.has_textures:
        albedo = albedo * sample_texture_array(scene.textures,
                                               scene.mat_tex[mat], uv_u, uv_v)
    energy = torch.clamp(scene.mat_emission_energy[mat], min=0.0)
    em = scene.mat_emission[mat]
    emission = Vec3(em[:, 0] * energy, em[:, 1] * energy, em[:, 2] * energy)
    metallic = scene.mat_metallic[mat]
    roughness = scene.mat_roughness[mat]
    if scene.has_mr_textures:
        mr_idx = scene.mat_mr_tex[mat]
        mr = sample_texture_array(scene.textures, mr_idx, uv_u, uv_v)
        roughness = torch.where(mr_idx >= 0, roughness * mr.y, roughness)
        metallic = torch.where(mr_idx >= 0, metallic * mr.z, metallic)
    return _finish(ray, hit.t, normal, albedo, emission, metallic, roughness,
                   scene.mat_transmission[mat], scene.mat_ior[mat])


def shading_from_rows(scene: Scene, hit: HitInfo, ray: Ray) -> ShadingInfo:
    """Gather-free shading fetch from the (48, N) winner rows."""
    r = hit.rows
    u, v = hit.u, hit.v
    w = 1.0 - u - v
    normal = Vec3(
        r[0] * w + r[3] * u + r[6] * v,
        r[1] * w + r[4] * u + r[7] * v,
        r[2] * w + r[5] * u + r[8] * v,
    ).normalize(eps=1e-20)
    normal = vwhere(hit.front, normal, -normal)
    uv_u = r[9] * w + r[11] * u + r[13] * v
    uv_v = r[10] * w + r[12] * u + r[14] * v

    albedo = Vec3(r[17], r[18], r[19])
    if scene.has_textures:
        tex_idx = r[26].to(torch.int32)
        albedo = albedo * sample_texture_array(scene.textures, tex_idx,
                                               uv_u, uv_v)
    energy = torch.clamp(r[23], min=0.0)
    emission = Vec3(r[20] * energy, r[21] * energy, r[22] * energy)
    metallic = r[24]
    roughness = r[25]
    if scene.has_mr_textures:
        mr_idx = r[29].to(torch.int32)
        mr = sample_texture_array(scene.textures, mr_idx, uv_u, uv_v)
        roughness = torch.where(mr_idx >= 0, roughness * mr.y, roughness)
        metallic = torch.where(mr_idx >= 0, metallic * mr.z, metallic)
    return _finish(ray, hit.t, normal, albedo, emission, metallic, roughness,
                   r[27], r[28])
