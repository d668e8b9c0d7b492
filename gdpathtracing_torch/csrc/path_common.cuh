// Device code shared by the path kernels (mega_step.cu, kernel 10, and
// fused_paths.cu, kernel 11) and regen's shading (regen_shade.cu, whose
// plain version is render/regen.py's torch body): the PCG2D stream, the
// analytic sky, the shading record and the BRDF (evaluation, sampling,
// pdf), each written in the term order of the port's PyTorch modules
// (core/rng.py, render/sky.py, render/shading.py, render/brdf.py,
// render/lights.py), so that the plain versions in ops/megakernel.py,
// ops/fused.py and render/regen.py, which call those modules, round the
// same way.
//
// What "the same order" means here. The PyTorch modules are evaluated one
// elementwise op at a time, so every product and sum is rounded on its own
// (hence -fmad=false). A Python float enters an op as the float32 nearest
// to its double value: constants are written `(float)<double expression>`,
// as Python folds them. `c / x` with a Python float c is
// `x.reciprocal() * c` in PyTorch, so it is written `(1.0f / x) * c`.
// `torch.clamp`, `torch.maximum` and `torch.minimum` carry a NaN through
// (fmaxf/fminf would drop it): clamp_lo / clamp_hi / max_nan / min_nan.
// sqrtf, division and the float conversion of the PCG words are IEEE
// (no fast math); sinf and cosf are the CUDA math library's.
//
// The dielectric-transmission branch of the BRDF is not here: every
// kernel that includes this runs only on scenes without transmission
// (mega_supported, fused_supported, shade_entry).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace gdpt {

constexpr double kPi = 3.141592653589793;
constexpr float kMinRoughness = (float)0.006;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
  return V3{x, y, z};
}
__device__ __forceinline__ V3 operator+(V3 a, V3 b) {
  return V3{a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 operator-(V3 a, V3 b) {
  return V3{a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 operator*(V3 a, V3 b) {
  return V3{a.x * b.x, a.y * b.y, a.z * b.z};
}
__device__ __forceinline__ V3 operator*(V3 a, float s) {
  return V3{a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ V3 operator-(V3 a) { return V3{-a.x, -a.y, -a.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 select(bool m, V3 a, V3 b) {
  return m ? a : b;
}

// torch.maximum / torch.minimum / torch.clamp: a NaN operand gives NaN.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}
__device__ __forceinline__ float clamp_lo(float a, float lo) {
  return max_nan(a, lo);
}
__device__ __forceinline__ float clamp_hi(float a, float hi) {
  return min_nan(a, hi);
}
__device__ __forceinline__ float clamp01(float a, float lo, float hi) {
  return min_nan(max_nan(a, lo), hi);
}

// Vec3.normalize(eps) (core/vec.py): 0 where |v|^2 <= eps.
__device__ __forceinline__ V3 normalize_eps(V3 v, float eps) {
  const float lsq = dot(v, v);
  const float inv = lsq > eps ? 1.0f / sqrtf(lsq) : 0.0f;
  return v * inv;
}

// ---------------------------------------------------------------------------
// PCG2D (core/rng.py pcg2d): uint32 words; u, v in [0, 1).
// ---------------------------------------------------------------------------
__device__ __forceinline__ void pcg2d(unsigned& sx, unsigned& sy, float& u,
                                      float& v) {
  const unsigned a = 1664525u, c = 1013904223u;
  sx = sx * a + c;
  sy = sy * a + c;
  sx = sx + sy * a;
  sy = sy + sx * a;
  sx = sx ^ (sx >> 16);
  sy = sy ^ (sy >> 16);
  sx = sx + sy * a;
  sy = sy + sx * a;
  sx = sx ^ (sx >> 16);
  sy = sy ^ (sy >> 16);
  const float inv32 = (float)2.32830643654e-10;
  u = __uint2float_rn(sx) * inv32;
  v = __uint2float_rn(sy) * inv32;
}

// ---------------------------------------------------------------------------
// The analytic sky (render/sky.py sample_sky without an environment map):
// horizon + (zenith - horizon) * t, the difference taken in double as
// Python takes it, both passed in as floats.
// ---------------------------------------------------------------------------
struct Sky {
  float hx, hy, hz;  // horizon
  float dx, dy, dz;  // zenith - horizon
};

__device__ __forceinline__ V3 sample_sky(float dir_y, const Sky& s) {
  const float t = 0.5f * (dir_y + 1.0f);
  return V3{s.hx + s.dx * t, s.hy + s.dy * t, s.hz + s.dz * t};
}

// ---------------------------------------------------------------------------
// The shading record (render/types.py ShadingInfo; render/shading.py
// _finish), without transmission and ior.
// ---------------------------------------------------------------------------
struct Shade {
  V3 pos, n, out, emission, diffuse, f0;
  float lambert_out, rough;
};

// shading._finish: position o + d * t, out_dir -d, the Fresnel f0, the
// diffuse albedo, roughness clamped to MIN_ROUGHNESS.
__device__ __forceinline__ Shade finish_shade(V3 o, V3 d, float t, V3 normal,
                                              V3 albedo, V3 emission,
                                              float metallic, float rough) {
  Shade s;
  s.pos = o + d * t;
  s.out = -d;
  s.n = normal;
  s.emission = emission;
  const float f = (float)0.02;
  s.f0 = V3{f + (albedo.x - f) * metallic, f + (albedo.y - f) * metallic,
            f + (albedo.z - f) * metallic};
  s.diffuse = albedo - albedo * metallic;
  s.rough = clamp_lo(rough, kMinRoughness);
  s.lambert_out = dot(normal, s.out);
  return s;
}

// shading.shading_from_rows on one ray's winner row (the (40, E) table
// layout of ops/intersect.py build_trace_table, `col` reading row r):
// the interpolated normal flipped to the ray's side, albedo, emission,
// metallic and roughness. u and v are the clipped barycentrics.
template <typename Col>
__device__ __forceinline__ Shade shade_rows(const Col& col, float u, float v,
                                            bool front, V3 o, V3 d, float t) {
  const float w = 1.0f - u - v;
  V3 normal = normalize_eps(
      V3{col(0) * w + col(3) * u + col(6) * v,
         col(1) * w + col(4) * u + col(7) * v,
         col(2) * w + col(5) * u + col(8) * v},
      (float)1e-20);
  normal = front ? normal : -normal;
  const V3 albedo{col(17), col(18), col(19)};
  const float energy = clamp_lo(col(23), 0.0f);
  const V3 emission{col(20) * energy, col(21) * energy, col(22) * energy};
  return finish_shade(o, d, t, normal, albedo, emission, col(24), col(25));
}

// ---------------------------------------------------------------------------
// The BRDF (render/brdf.py): Burley diffuse + GGX specular.
// ---------------------------------------------------------------------------
constexpr float kBrdfEps = (float)1e-8;

__device__ __forceinline__ float safe_div(float a, float b) {
  return a / (fabsf(b) < kBrdfEps ? (b < 0.0f ? -kBrdfEps : kBrdfEps) : b);
}

// fresnel_schlick's factor (1 - cos)^5, clamped.
__device__ __forceinline__ float schlick5(float cos_theta) {
  const float fac = clamp01(1.0f - cos_theta, 0.0f, 1.0f);
  return (fac * fac) * (fac * fac) * fac;
}

__device__ __forceinline__ V3 eval_brdf(const Shade& s, V3 l) {
  const float ndotl = dot(s.n, l);
  const float ndotv = s.lambert_out;
  const bool valid = min_nan(ndotl, ndotv) >= 0.0f;

  const V3 half = normalize_eps(l + s.out, kBrdfEps);
  const float hdotv = dot(half, s.out);

  const float f90 = (hdotv * hdotv) * (2.0f * s.rough) + 0.5f;
  // fresnel_schlick(1, f90, c).x = 1 + (f90 - 1) * (1 - c)^5
  const float fd = (1.0f + (f90 - 1.0f) * schlick5(ndotv)) *
                   (1.0f + (f90 - 1.0f) * schlick5(ndotl));
  V3 brdf = s.diffuse * fd;

  const float hdotn = dot(half, s.n);
  const float a2 = s.rough * s.rough;
  const float denom = hdotn * hdotn * (a2 - 1.0f) + 1.0f;
  const float distribution = a2 / clamp_lo(denom * denom, kBrdfEps);

  const float masking =
      ndotl * sqrtf(clamp_lo((ndotv - a2 * ndotv) * ndotv + a2, 0.0f));
  const float shadowing =
      ndotv * sqrtf(clamp_lo((ndotl - a2 * ndotl) * ndotl + a2, 0.0f));
  const float geometry =
      (1.0f / clamp_lo(masking + shadowing, kBrdfEps)) * 0.5f;

  const float fac5 = schlick5(clamp_lo(hdotv, 0.0f));
  const V3 fs{s.f0.x + (1.0f - s.f0.x) * fac5,
              s.f0.y + (1.0f - s.f0.y) * fac5,
              s.f0.z + (1.0f - s.f0.z) * fac5};
  brdf = brdf + fs * (distribution * geometry);
  brdf = brdf * (float)(1.0 / kPi);
  return valid ? brdf : V3{0.0f, 0.0f, 0.0f};
}

// shading_frame (Duff et al.): tangent t and bitangent b of normal n.
__device__ __forceinline__ void shading_frame(V3 n, V3& t, V3& b) {
  const float sign = n.z > 0.0f ? 1.0f : -1.0f;
  const float a = (1.0f / (sign + n.z)) * -1.0f;
  const float bb = n.x * n.y * a;
  t = V3{1.0f + sign * n.x * n.x * a, sign * bb, -sign * n.x};
  b = V3{bb, sign + n.y * n.y * a, -n.y};
}

__device__ __forceinline__ V3 to_world(V3 t, V3 b, V3 n, V3 l) {
  return V3{t.x * l.x + b.x * l.y + n.x * l.z,
            t.y * l.x + b.y * l.y + n.y * l.z,
            t.z * l.x + b.z * l.y + n.z * l.z};
}

__device__ __forceinline__ float ggx_vndf_pdf(float ndotv, float hdotn,
                                              float hdotv, float rough) {
  const float a2 = rough * rough;
  const float inv_a2 = 1.0f - a2;
  const float denom =
      ndotv + sqrtf(clamp_lo(a2 + inv_a2 * ndotv * ndotv, 0.0f));
  const float d_vis = clamp_lo(hdotv, 0.0f) * (float)(2.0 / kPi) /
                      clamp_lo(denom, kBrdfEps);
  const float m2 = 1.0f - inv_a2 * hdotn * hdotn;
  const float pdf = d_vis * a2 / clamp_lo(m2 * m2, kBrdfEps);
  return hdotn < 0.0f ? 0.0f : pdf;
}

__device__ __forceinline__ float ggx_dir_pdf(float ndotv, V3 view, V3 light,
                                             V3 normal, float rough) {
  const V3 half = normalize_eps(light + view, kBrdfEps);
  const float hdotv = dot(half, view);
  const float hdotn = dot(half, normal);
  return ggx_vndf_pdf(ndotv, hdotn, hdotv, rough) /
         clamp_lo(4.0f * hdotv, kBrdfEps);
}

// diffuse_probability: min(0.5, luminance(diffuse albedo)).
__device__ __forceinline__ float diffuse_probability(const Shade& s) {
  const float lum = s.diffuse.x * (float)0.2126 +
                    s.diffuse.y * (float)0.7152 +
                    s.diffuse.z * (float)0.0722;
  return clamp_hi(lum, 0.5f);
}

__device__ __forceinline__ V3 sample_brdf(const Shade& s, float r1,
                                          float r2) {
  V3 t, b;
  shading_frame(s.n, t, b);
  const float p_diff = diffuse_probability(s);
  const bool pick_diffuse = r1 < p_diff;
  const float r1_d = safe_div(r1, p_diff);
  const float r1_s = safe_div(r1 - p_diff, 1.0f - p_diff);
  const float two_pi = (float)(2.0 * kPi);

  // sample_hemisphere_cosine(r1_d, r2)
  const float phi_d = two_pi * r1_d;
  const float radius = sqrtf(r2);
  const float z = sqrtf(clamp_lo(1.0f - radius * radius, 0.0f));
  const V3 d_local{radius * cosf(phi_d), radius * sinf(phi_d), z};
  const V3 diffuse_dir = to_world(t, b, s.n, d_local);

  // view_local, sample_ggx_vndf(view_local, rough, r1_s, r2)
  const V3 vl{dot(t, s.out), dot(b, s.out), dot(s.n, s.out)};
  const V3 v =
      normalize_eps(V3{vl.x * s.rough, vl.y * s.rough, vl.z}, kBrdfEps);
  const float phi_s = two_pi * r1_s;
  const float zz = 1.0f - r2 * (1.0f + v.z);
  const float sin_t = sqrtf(clamp_lo(1.0f - zz * zz, 0.0f));
  const V3 h = V3{sin_t * cosf(phi_s), sin_t * sinf(phi_s), zz} + v;
  const V3 hl = normalize_eps(V3{h.x * s.rough, h.y * s.rough, h.z},
                              kBrdfEps);
  // -reflect(vl, hl) = -(vl - hl * (2 * dot(vl, hl)))
  const V3 spec_local = -(vl - hl * (2.0f * dot(vl, hl)));
  const V3 spec_dir = to_world(t, b, s.n, spec_local);
  return pick_diffuse ? diffuse_dir : spec_dir;
}

__device__ __forceinline__ float brdf_pdf(const Shade& s, V3 dir) {
  const float p_diff = diffuse_probability(s);
  const float spec = ggx_dir_pdf(s.lambert_out, s.out, dir, s.n, s.rough);
  const float diff = clamp_lo(dot(s.n, dir), 0.0f) * (float)(1.0 / kPi);
  return spec + (diff - spec) * p_diff;
}

// One BRDF-sampled continuation (render/integrator.py, the path kernels'
// epilogue): the sampled direction, its pdf, cos at the new direction and
// the BRDF value.
struct BrdfSample {
  V3 dir, f;
  float pdf, lambert_in;
};

__device__ __forceinline__ BrdfSample continue_path(const Shade& s, float r1,
                                                    float r2) {
  BrdfSample b;
  b.dir = sample_brdf(s, r1, r2);
  b.pdf = brdf_pdf(s, b.dir);
  b.lambert_in = dot(s.n, b.dir);
  b.f = eval_brdf(s, b.dir);
  return b;
}

}  // namespace gdpt
