"""Physically-based BRDF: Burley-style diffuse + GGX specular, with
cosine-hemisphere / GGX-VNDF importance sampling and one-sample-MIS lobe
mixing.

Port of gdpathtracing_tpu/render/brdf.py: same expressions in the same
evaluation order, on torch tensors.

Re-expression of the reference BRDF library (brdfs.glsl), vectorized over
the ray wavefront. Matches its model exactly except one fix: the specular
NDF denominator squares n·h (standard GGX) — the reference evaluates
``half_dot_normal * (a2 - 1) + 1`` unsquared (brdfs.glsl:27), which
disagrees with its own VNDF pdf (brdfs.glsl:64) and biases the specular
lobe; a quirk fixed, not copied.

All denominators carry tiny epsilons: under ``torch.where``-based masking the
unselected branch is still computed, and NaNs would poison gradients.
"""

from __future__ import annotations

import torch

from gdpathtracing_torch.core.vec import Vec3, reflect
from gdpathtracing_torch.render.types import ShadingInfo

PI = 3.141592653589793
_EPS = 1e-8


def _maximum(a, b):
    """jnp.maximum of a tensor and a tensor or Python scalar (either side);
    NaN propagates as in JAX."""
    if not isinstance(a, torch.Tensor):
        a, b = b, a
    if isinstance(b, torch.Tensor):
        return torch.maximum(a, b)
    return torch.clamp(a, min=b)


def _minimum(a, b):
    if not isinstance(a, torch.Tensor):
        a, b = b, a
    if isinstance(b, torch.Tensor):
        return torch.minimum(a, b)
    return torch.clamp(a, max=b)


def _safe_div(a, b):
    return a / torch.where(torch.abs(b) < _EPS, torch.where(b < 0, -_EPS, _EPS), b)


def fresnel_schlick(f0: Vec3, f90: Vec3, cos_theta) -> Vec3:
    """brdfs.glsl:3-8."""
    fac = torch.clamp(1.0 - cos_theta, 0.0, 1.0)
    fac5 = (fac * fac) * (fac * fac) * fac
    return f0 + (f90 - f0) * fac5


def eval_brdf(s: ShadingInfo, light_dir: Vec3) -> Vec3:
    """Full BRDF value (brdfs.glsl:10-38): Burley diffuse with double
    Schlick retro term + height-correlated Smith GGX specular."""
    ndotl = s.normal.dot(light_dir)
    ndotv = s.lambert_out
    valid = _minimum(ndotl, ndotv) >= 0.0

    half = (light_dir + s.out_dir).normalize(eps=_EPS)
    hdotv = half.dot(s.out_dir)

    f90 = (hdotv * hdotv) * (2.0 * s.roughness) + 0.5
    one = Vec3.full(1.0)
    fd = fresnel_schlick(one, Vec3(f90, f90, f90), ndotv).x * \
        fresnel_schlick(one, Vec3(f90, f90, f90), ndotl).x
    brdf = s.diffuse_albedo * fd

    hdotn = half.dot(s.normal)
    a2 = s.roughness * s.roughness
    denom = hdotn * hdotn * (a2 - 1.0) + 1.0   # n·h squared: GGX fix
    distribution = a2 / _maximum(denom * denom, _EPS)

    masking = ndotl * torch.sqrt(_maximum(
        (ndotv - a2 * ndotv) * ndotv + a2, 0.0))
    shadowing = ndotv * torch.sqrt(_maximum(
        (ndotl - a2 * ndotl) * ndotl + a2, 0.0))
    geometry = 0.5 / _maximum(masking + shadowing, _EPS)

    fs = fresnel_schlick(s.fresnel_0, one, _maximum(0.0, hdotv))
    brdf = brdf + fs * (distribution * geometry)
    brdf = brdf * (1.0 / PI)
    return Vec3(torch.where(valid, brdf.x, 0.0),
                torch.where(valid, brdf.y, 0.0),
                torch.where(valid, brdf.z, 0.0))


def shading_frame(normal: Vec3):
    """Duff et al. branchless orthonormal basis (brdfs.glsl:83-93).
    Returns (tangent, bitangent) so that (t, b, normal) is the
    tangent-to-world frame."""
    sign = torch.where(normal.z > 0.0, 1.0, -1.0)
    a = -1.0 / (sign + normal.z)
    b = normal.x * normal.y * a
    t = Vec3(1.0 + sign * normal.x * normal.x * a, sign * b,
             -sign * normal.x)
    bt = Vec3(b, sign + normal.y * normal.y * a, -normal.y)
    return t, bt


def _to_world(t: Vec3, b: Vec3, n: Vec3, local: Vec3) -> Vec3:
    return t * local.x + b * local.y + n * local.z


def _to_local(t: Vec3, b: Vec3, n: Vec3, world: Vec3) -> Vec3:
    return Vec3(t.dot(world), b.dot(world), n.dot(world))


def sample_hemisphere_cosine(r1, r2) -> Vec3:
    """Projected-solid-angle (cosine) hemisphere sample in local frame
    (brdfs.glsl:95-101)."""
    phi = 2.0 * PI * r1
    radius = torch.sqrt(r2)
    z = torch.sqrt(_maximum(1.0 - radius * radius, 0.0))
    return Vec3(radius * torch.cos(phi), radius * torch.sin(phi), z)


def hemisphere_cosine_pdf(z):
    return _maximum(0.0, z) * (1.0 / PI)


def sample_ggx_vndf(view_local: Vec3, roughness, r1, r2) -> Vec3:
    """Spherical-cap GGX VNDF half-vector sample (brdfs.glsl:40-54)."""
    v = Vec3(view_local.x * roughness, view_local.y * roughness,
             view_local.z).normalize(eps=_EPS)
    phi = 2.0 * PI * r1
    z = 1.0 - r2 * (1.0 + v.z)
    sin_t = torch.sqrt(_maximum(0.0, 1.0 - z * z))
    h = Vec3(sin_t * torch.cos(phi), sin_t * torch.sin(phi), z) + v
    return Vec3(h.x * roughness, h.y * roughness, h.z).normalize(eps=_EPS)


def ggx_vndf_pdf(ndotv, hdotn, hdotv, roughness):
    """VNDF density of the half vector (brdfs.glsl:56-67)."""
    a2 = roughness * roughness
    inv_a2 = 1.0 - a2
    denom = ndotv + torch.sqrt(_maximum(a2 + inv_a2 * ndotv * ndotv, 0.0))
    d_vis = _maximum(0.0, hdotv) * (2.0 / PI) / _maximum(denom, _EPS)
    m2 = 1.0 - inv_a2 * hdotn * hdotn
    pdf = d_vis * a2 / _maximum(m2 * m2, _EPS)
    return torch.where(hdotn < 0.0, 0.0, pdf)


def ggx_dir_pdf(ndotv, view_dir: Vec3, light_dir: Vec3, normal: Vec3,
                roughness):
    """Density of the reflected direction (brdfs.glsl:74-81)."""
    half = (light_dir + view_dir).normalize(eps=_EPS)
    hdotv = half.dot(view_dir)
    hdotn = half.dot(normal)
    return ggx_vndf_pdf(ndotv, hdotn, hdotv, roughness) / \
        _maximum(4.0 * hdotv, _EPS)


def fresnel_dielectric(cos_i, eta):
    """Exact unpolarized dielectric Fresnel reflectance. `eta` = n_i/n_t
    (ratio of the incident medium's IOR over the transmitted one);
    cos_i ≥ 0. Returns 1.0 under total internal reflection."""
    cos_i = torch.clamp(cos_i, 0.0, 1.0)
    sin2_t = eta * eta * _maximum(1.0 - cos_i * cos_i, 0.0)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(_maximum(1.0 - sin2_t, 0.0))
    rs = (eta * cos_i - cos_t) / _maximum(eta * cos_i + cos_t, _EPS)
    rp = (cos_i - eta * cos_t) / _maximum(cos_i + eta * cos_t, _EPS)
    f = 0.5 * (rs * rs + rp * rp)
    return torch.where(tir, 1.0, torch.clamp(f, 0.0, 1.0))


def refract(d: Vec3, n: Vec3, eta) -> tuple[Vec3, torch.Tensor]:
    """GLSL-style refract of incident direction `d` (pointing into the
    surface) about normal `n` (facing the incident side). Returns
    (direction, tir_mask); direction is garbage where tir is True."""
    cos_i = -d.dot(n)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    tir = k < 0.0
    t = d * eta + n * (eta * cos_i - torch.sqrt(_maximum(k, 0.0)))
    return t.normalize(eps=_EPS), tir


def diffuse_probability(s: ShadingInfo):
    """Lobe-pick probability (brdfs.glsl:107-110)."""
    return _minimum(0.5, s.diffuse_albedo.luminance())


def sample_brdf(s: ShadingInfo, r1, r2) -> Vec3:
    """Stochastic lobe pick + importance sample (brdfs.glsl:112-128).
    Computes both lobes and selects (SIMD-style; on the VPU this is cheaper
    than divergence)."""
    t, b = shading_frame(s.normal)
    p_diff = diffuse_probability(s)
    pick_diffuse = r1 < p_diff

    r1_d = _safe_div(r1, p_diff)
    r1_s = _safe_div(r1 - p_diff, 1.0 - p_diff)

    d_local = sample_hemisphere_cosine(r1_d, r2)
    diffuse_dir = _to_world(t, b, s.normal, d_local)

    view_local = _to_local(t, b, s.normal, s.out_dir)
    half_local = sample_ggx_vndf(view_local, s.roughness, r1_s, r2)
    spec_local = -reflect(view_local, half_local)
    spec_dir = _to_world(t, b, s.normal, spec_local)

    return Vec3(torch.where(pick_diffuse, diffuse_dir.x, spec_dir.x),
                torch.where(pick_diffuse, diffuse_dir.y, spec_dir.y),
                torch.where(pick_diffuse, diffuse_dir.z, spec_dir.z))


def brdf_pdf(s: ShadingInfo, sampled_dir: Vec3):
    """One-sample-MIS combined density (brdfs.glsl:130-138):
    lerp(spec_pdf, diff_pdf, p_diffuse)."""
    p_diff = diffuse_probability(s)
    spec = ggx_dir_pdf(s.lambert_out, s.out_dir, sampled_dir, s.normal,
                       s.roughness)
    diff = hemisphere_cosine_pdf(s.normal.dot(sampled_dir))
    return spec + (diff - spec) * p_diff
