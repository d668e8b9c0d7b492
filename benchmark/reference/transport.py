"""Light transport of the plain reference: 3-vectors, the PCG2D stream,
the camera's primary rays, the BRDF, shading from a hit, the sky and the
display transform.

Plain PyTorch, written out term by term in the evaluation order that the
renderer's semantics fix (the upstream GLSL, as the JAX package and its
port transcribe it), so that two correct renderers of the same path draw
the same random numbers and round alike. Nothing here is imported from
the program under test.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

PI = 3.141592653589793
_EPS = 1e-8
_TWO_PI = 6.2831853
MIN_ROUGHNESS = 0.006
MISS_T = 1e9

# ---------------------------------------------------------------------------
# 3-vectors of (N,) tensors
# ---------------------------------------------------------------------------


class Vec3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @classmethod
    def full(cls, v, like: "Vec3 | None" = None) -> "Vec3":
        if like is not None:
            v = torch.full_like(like.x, float(v))
        else:
            v = torch.as_tensor(v, dtype=torch.float32)
        return cls(v, v, v)

    def _coerce(self, o):
        return o if isinstance(o, Vec3) else Vec3(o, o, o)

    def __add__(self, o) -> "Vec3":
        o = self._coerce(o)
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    __radd__ = __add__

    def __sub__(self, o) -> "Vec3":
        o = self._coerce(o)
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __mul__(self, o) -> "Vec3":
        o = self._coerce(o)
        return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)

    __rmul__ = __mul__

    def __neg__(self) -> "Vec3":
        return Vec3(-self.x, -self.y, -self.z)

    def dot(self, o: "Vec3") -> torch.Tensor:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def length(self) -> torch.Tensor:
        return torch.sqrt(self.dot(self))

    def normalize(self, eps: float = 0.0) -> "Vec3":
        if eps > 0.0:
            inv = torch.where(self.dot(self) > eps, 1.0 / self.length(), 0.0)
        else:
            inv = 1.0 / self.length()
        return self * inv

    def luminance(self) -> torch.Tensor:
        return 0.2126 * self.x + 0.7152 * self.y + 0.0722 * self.z

    def stack(self) -> torch.Tensor:
        return torch.stack([self.x, self.y, self.z], dim=-1)

    def map(self, fn) -> "Vec3":
        return Vec3(fn(self.x), fn(self.y), fn(self.z))


def vwhere(mask, a: Vec3, b: Vec3) -> Vec3:
    return Vec3(torch.where(mask, a.x, b.x), torch.where(mask, a.y, b.y),
                torch.where(mask, a.z, b.z))


def lerp(a: Vec3, b: Vec3, t) -> Vec3:
    return a + (b - a) * t


def reflect(d: Vec3, n: Vec3) -> Vec3:
    return d - n * (2.0 * d.dot(n))


# ---------------------------------------------------------------------------
# PCG2D: 32-bit words carried in int64 and masked after every step
# ---------------------------------------------------------------------------

_MASK = 0xFFFFFFFF
_A = 1664525
_C = 1013904223
_GOLDEN = 0x9E3779B9
_INV32 = 2.32830643654e-10


def _mul32(a: torch.Tensor, k: int) -> torch.Tensor:
    lo = a * (k & 0xFFFF)
    hi = ((a * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def pcg2d(seed):
    sx, sy = seed
    sx = (sx * _A + _C) & _MASK
    sy = (sy * _A + _C) & _MASK
    sx = (sx + sy * _A) & _MASK
    sy = (sy + sx * _A) & _MASK
    sx = sx ^ (sx >> 16)
    sy = sy ^ (sy >> 16)
    sx = (sx + sy * _A) & _MASK
    sy = (sy + sx * _A) & _MASK
    sx = sx ^ (sx >> 16)
    sy = sy ^ (sy >> 16)
    return (sx.to(torch.float32) * _INV32,
            sy.to(torch.float32) * _INV32), (sx, sy)


def prng_seed(px: torch.Tensor, py: torch.Tensor, frame: int):
    frame = int(frame) & _MASK
    sx = (_mul32(px.to(torch.int64) & _MASK, _GOLDEN) + frame) & _MASK
    sy = (_mul32(py.to(torch.int64) & _MASK, _GOLDEN) + frame) & _MASK
    sx = sx ^ (sx >> 16)
    sy = sy ^ (sy >> 16)
    return _mul32(sx, _GOLDEN), _mul32(sy, _GOLDEN)


# ---------------------------------------------------------------------------
# Camera: a pinhole looking down -Z of its (3, 4) world-from-camera affine
# ---------------------------------------------------------------------------


class Camera(NamedTuple):
    transform: torch.Tensor  # (3, 4) f32
    fov_deg: torch.Tensor    # () f32
    width: int
    height: int


def primary_rays(cam: Camera, pids: torch.Tensor, frame: int):
    """Jittered (uniform) primary rays of flat row-major pixel ids, and
    the PCG2D stream after the jitter draw: (o, d, seed)."""
    px_i = pids % cam.width
    py_i = torch.div(pids, cam.width, rounding_mode="floor")
    seed = prng_seed(px_i, py_i, frame)
    px = px_i.to(torch.float32)
    py = py_i.to(torch.float32)
    (r1, r2), seed = pcg2d(seed)
    jx, jy = r1 - 0.5, r2 - 0.5
    # Division by device tensors: a division by a Python scalar may become
    # a product with its reciprocal, which rounds differently.
    wh = torch.tensor([float(cam.width), float(cam.height)], device=px.device)
    sx = (px + 0.5 + jx) / wh[0] * 2.0 - 1.0
    sy = (py + 0.5 + jy) / wh[1] * 2.0 - 1.0
    half_tan = torch.tan((cam.fov_deg * (math.pi / 180.0) * 0.5)
                         .double()).float()
    aspect = cam.width / cam.height
    cx = sx * (half_tan * aspect)
    cy = -sy * half_tan
    cz = -torch.ones_like(sx)
    m = cam.transform
    d = Vec3(m[0, 0] * cx + m[0, 1] * cy + m[0, 2] * cz,
             m[1, 0] * cx + m[1, 1] * cy + m[1, 2] * cz,
             m[2, 0] * cx + m[2, 1] * cy + m[2, 2] * cz).normalize()
    o = Vec3(m[0, 3] + d.x * 0.0, m[1, 3] + d.y * 0.0, m[2, 3] + d.z * 0.0)
    return o, d, seed


# ---------------------------------------------------------------------------
# BRDF: Burley diffuse + height-correlated Smith GGX, cosine / VNDF sampling
# ---------------------------------------------------------------------------


class Shading(NamedTuple):
    position: Vec3
    normal: Vec3
    out_dir: Vec3
    lambert_out: torch.Tensor
    emission: Vec3
    diffuse_albedo: Vec3
    fresnel_0: Vec3
    roughness: torch.Tensor


def _maximum(a, b):
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
    return a / torch.where(torch.abs(b) < _EPS,
                           torch.where(b < 0, -_EPS, _EPS), b)


def fresnel_schlick(f0: Vec3, f90: Vec3, cos_theta) -> Vec3:
    fac = torch.clamp(1.0 - cos_theta, 0.0, 1.0)
    fac5 = (fac * fac) * (fac * fac) * fac
    return f0 + (f90 - f0) * fac5


def eval_brdf(s: Shading, light_dir: Vec3) -> Vec3:
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
    denom = hdotn * hdotn * (a2 - 1.0) + 1.0
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


def _frame(normal: Vec3):
    sign = torch.where(normal.z > 0.0, 1.0, -1.0)
    a = -1.0 / (sign + normal.z)
    b = normal.x * normal.y * a
    t = Vec3(1.0 + sign * normal.x * normal.x * a, sign * b,
             -sign * normal.x)
    bt = Vec3(b, sign + normal.y * normal.y * a, -normal.y)
    return t, bt


def _to_world(t: Vec3, b: Vec3, n: Vec3, local: Vec3) -> Vec3:
    return t * local.x + b * local.y + n * local.z


def _ggx_vndf(view_local: Vec3, roughness, r1, r2) -> Vec3:
    v = Vec3(view_local.x * roughness, view_local.y * roughness,
             view_local.z).normalize(eps=_EPS)
    phi = 2.0 * PI * r1
    z = 1.0 - r2 * (1.0 + v.z)
    sin_t = torch.sqrt(_maximum(0.0, 1.0 - z * z))
    h = Vec3(sin_t * torch.cos(phi), sin_t * torch.sin(phi), z) + v
    return Vec3(h.x * roughness, h.y * roughness, h.z).normalize(eps=_EPS)


def _p_diffuse(s: Shading):
    return _minimum(0.5, s.diffuse_albedo.luminance())


def sample_brdf(s: Shading, r1, r2) -> Vec3:
    t, b = _frame(s.normal)
    p_diff = _p_diffuse(s)
    pick_diffuse = r1 < p_diff
    r1_d = _safe_div(r1, p_diff)
    r1_s = _safe_div(r1 - p_diff, 1.0 - p_diff)
    phi = 2.0 * PI * r1_d
    radius = torch.sqrt(r2)
    z = torch.sqrt(_maximum(1.0 - radius * radius, 0.0))
    d_local = Vec3(radius * torch.cos(phi), radius * torch.sin(phi), z)
    diffuse_dir = _to_world(t, b, s.normal, d_local)
    view_local = Vec3(t.dot(s.out_dir), b.dot(s.out_dir),
                      s.normal.dot(s.out_dir))
    half_local = _ggx_vndf(view_local, s.roughness, r1_s, r2)
    spec_local = -reflect(view_local, half_local)
    spec_dir = _to_world(t, b, s.normal, spec_local)
    return vwhere(pick_diffuse, diffuse_dir, spec_dir)


def brdf_pdf(s: Shading, sampled_dir: Vec3):
    p_diff = _p_diffuse(s)
    half = (sampled_dir + s.out_dir).normalize(eps=_EPS)
    hdotv = half.dot(s.out_dir)
    hdotn = half.dot(s.normal)
    a2 = s.roughness * s.roughness
    inv_a2 = 1.0 - a2
    ndotv = s.lambert_out
    denom = ndotv + torch.sqrt(_maximum(a2 + inv_a2 * ndotv * ndotv, 0.0))
    d_vis = _maximum(0.0, hdotv) * (2.0 / PI) / _maximum(denom, _EPS)
    m2 = 1.0 - inv_a2 * hdotn * hdotn
    vndf = torch.where(hdotn < 0.0, 0.0, d_vis * a2 / _maximum(m2 * m2, _EPS))
    spec = vndf / _maximum(4.0 * hdotv, _EPS)
    diff = _maximum(0.0, s.normal.dot(sampled_dir)) * (1.0 / PI)
    return spec + (diff - spec) * p_diff


# ---------------------------------------------------------------------------
# Shading of a closest hit, the sky, the display transform
# ---------------------------------------------------------------------------


def shade(normals: torch.Tensor, mat_rows: torch.Tensor, albedo: torch.Tensor,
          o: Vec3, d: Vec3, t, u, v, front) -> Shading:
    """Shading of hits: ``normals`` (N, 9) the winners' world vertex
    normals, ``mat_rows`` (N, 6) [emission3, energy, metallic, roughness]
    of their materials, ``albedo`` (N, 3) their albedo (the tensor the
    inverse cell differentiates), ``t``, ``u``, ``v``, ``front`` the hit
    records."""
    w = 1.0 - u - v
    n = normals
    normal = Vec3(n[:, 0] * w + n[:, 3] * u + n[:, 6] * v,
                  n[:, 1] * w + n[:, 4] * u + n[:, 7] * v,
                  n[:, 2] * w + n[:, 5] * u + n[:, 8] * v).normalize(eps=1e-20)
    normal = vwhere(front, normal, -normal)
    alb = Vec3(albedo[:, 0], albedo[:, 1], albedo[:, 2])
    energy = torch.clamp(mat_rows[:, 3], min=0.0)
    emission = Vec3(mat_rows[:, 0] * energy, mat_rows[:, 1] * energy,
                    mat_rows[:, 2] * energy)
    metallic = mat_rows[:, 4]
    position = o + d * t
    out_dir = -d
    fresnel_0 = Vec3.full(0.02, like=alb) + \
        (alb - Vec3.full(0.02, like=alb)) * metallic
    diffuse_albedo = alb - alb * metallic
    roughness = torch.clamp(mat_rows[:, 5], min=MIN_ROUGHNESS)
    return Shading(position, normal, out_dir, normal.dot(out_dir), emission,
                   diffuse_albedo, fresnel_0, roughness)


SKY_HORIZON = (0.95, 0.95, 0.95)
SKY_ZENITH = (0.9, 0.94, 1.0)


def sky(d: Vec3) -> Vec3:
    t = 0.5 * (d.y + 1.0)
    return lerp(Vec3(*SKY_HORIZON), Vec3(*SKY_ZENITH), t)


def aces(x: torch.Tensor) -> torch.Tensor:
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def display(accum: torch.Tensor, count: int) -> torch.Tensor:
    """Progressive average of ``count`` frames through exposure 1 and the
    ACES tonemap: what a still camera's viewer shows."""
    c = torch.tensor(count, dtype=torch.int32, device=accum.device)
    return aces((accum / c.to(torch.float32)) * 1.0)
