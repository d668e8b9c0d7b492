// The primal standard loop's shading of one bounce on BVH hits, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the reference runs this step as plain XLA inside
// its bounce loop (gdpathtracing_tpu/render/integrator.py, `body` after
// `trace_bvh`), where XLA fuses it; the port ran it as ~600 PyTorch
// elementwise and gather ops a tile-bounce body, each a launch over every
// lane of the tile, live or dead, which kept the card idle while the host
// issued them. Contract (ops/shade.py path_shade_bvh, whose plain version
// path_shade_bvh_plain is those PyTorch statements): one bounce `bounce`
// of n lanes whose rays render/traverse.py trace_bvh just traced,
//
//   in   hit      t (n,) f32 (1e9 where missed or inactive), u, v (n,)
//                 f32, tri, inst, steps (n,) i32, front (n,) u8: the
//                 HitInfo trace_bvh returns
//        scene    tri_normal (T, 3, 3) f32, tri_slot (T,) i32,
//                 inst_materials (I, S) i32, inst_transform (I, 3, 4)
//                 f32, mat_albedo (M, 3), mat_emission (M, 3),
//                 mat_emission_energy, mat_metallic, mat_roughness (M,)
//                 f32
//        fs       (17, n) f32  0:3 o | 3:6 d | 6:9 throughput | 9:12
//                              radiance | 12 prev pdf | 13 depth | 14:17
//                              first-hit normal (regen's layout)
//        seeds    (2, n) i64   the PCG2D words, in [0, 2^32)
//        counts   (2, n) i32   steps, segments
//        active   (n,) u8      the lanes whose path goes on
//   out  fs, seeds, counts, active: the carry after the bounce, in fresh
//        buffers of the same shapes
//
// Per lane, in the order of the PyTorch body (render/integrator.py before
// this kernel; ops/shade.py path_shade_bvh_plain): hit = t < 1e9 and
// active; steps += active ? hit steps : 0, segments += active; on a hit
// the shading record of render/shading.py get_shading_data(fast=False):
// the material inst_materials[inst, min(tri_slot[tri], S - 1)], the
// object-space normal nrm0 * w + nrm1 * u + nrm2 * v (w = 1 - u - v)
// through the instance's linear part in core/math3d.py affine_apply_dir's
// order, normalised (eps 1e-20) and flipped by `front`, albedo, emission
// × clamped energy, metallic and roughness (path_common.cuh finish_shade);
// emission = hit ? the surface's : the analytic sky's; radiance +=
// throughput * emission where active; on bounce 0 the first-hit depth and
// normal where hit; one PCG2D draw on every lane, as the body draws it;
// the BRDF sample, pdf and value, survival and the ray_eps offset; the
// survive-selects of origin, direction, throughput and prev pdf (-1 where
// the path ends); active = survive. A lane that does not hit keeps its
// ray and throughput and ends, so its shading record, which the body
// computes and discards, is not computed here. Scope (ops/shade.py
// path_shade_entry): BVH hits, primal, no NEE, soft primary, reordering,
// transmission, textures, environment map or Russian roulette, and at
// least one bounce.
//
// What bounds it on the H100: device memory. A lane reads 25 bytes of its
// hit, 64 of the fs rows it needs (not the prev pdf), 16 of seeds, 8 of
// counts and 1 of its mask, and writes 68 + 16 + 8 + 1: 207 bytes, ~54 MB
// a 262144-lane tile, ~16 us at 3.35 TB/s. A hit lane also gathers ~116
// bytes of scene rows (a triangle's normals and slot, the instance's
// material index and transform, the material's columns), which for the
// demo's 1948 triangles (~80 KB of tables) stay in L1 and L2. The
// arithmetic (shading ~60 operations, a BRDF continuation ~330, PCG2D,
// sky) is ~0.5 us a tile at 67 TFLOP/s. The design: a thread per lane,
// 256 a block, every carry row read once and written once, coalesced
// (lane fastest), the gathers only on lanes that hit.

#include "path_common.cuh"

namespace {

using namespace gdpt;

constexpr int kBlock = 256;
constexpr float kMissT = 1e9f;

// trace_bvh's HitInfo, one (n,) array a field.
struct Hits {
  const float *t, *u, *v;
  const int *tri, *inst, *steps;
  const unsigned char* front;
};

struct Tables {
  const float* tri_normal;      // (T, 3, 3)
  const int* tri_slot;          // (T,)
  const int* inst_materials;    // (I, S)
  const float* inst_transform;  // (I, 3, 4)
  const float *albedo, *emission, *energy, *metallic, *roughness;
  int n_tris, n_inst, n_slots, n_mats;
};

struct Carry {
  const float* fs;
  const long long* seeds;
  const int* counts;
  const unsigned char* active;
};

struct CarryOut {
  float* fs;
  long long* seeds;
  int* counts;
  unsigned char* active;
};

struct Params {
  int n, bounce;
  float ray_eps;
  Sky sky;
};

__device__ __forceinline__ int clamp_index(int i, int size) {
  return min(max(i, 0), size - 1);
}

// render/shading.py get_shading_data(fast=False) on one hit: the gathers by
// triangle and instance (every index clamped into its table, which a
// triangle and instance that trace_bvh returned already are).
__device__ __forceinline__ Shade shade_hit(const Tables& tb, int tri,
                                           int inst, float u, float v,
                                           bool front, V3 o, V3 d, float t) {
  tri = clamp_index(tri, tb.n_tris);
  inst = clamp_index(inst, tb.n_inst);
  const int slot = clamp_index(tb.tri_slot[tri], tb.n_slots);
  const int mat = clamp_index(
      tb.inst_materials[(size_t)inst * tb.n_slots + slot], tb.n_mats);
  const float* nr = tb.tri_normal + (size_t)tri * 9;
  const float w = 1.0f - u - v;
  const V3 n_obj{nr[0] * w + nr[3] * u + nr[6] * v,
                 nr[1] * w + nr[4] * u + nr[7] * v,
                 nr[2] * w + nr[5] * u + nr[8] * v};
  // core/math3d.py affine_apply_dir: (m00 x + m01 y) + m02 z.
  const float* m = tb.inst_transform + (size_t)inst * 12;
  V3 normal = normalize_eps(
      V3{m[0] * n_obj.x + m[1] * n_obj.y + m[2] * n_obj.z,
         m[4] * n_obj.x + m[5] * n_obj.y + m[6] * n_obj.z,
         m[8] * n_obj.x + m[9] * n_obj.y + m[10] * n_obj.z},
      (float)1e-20);
  normal = front ? normal : -normal;
  const float* al = tb.albedo + (size_t)mat * 3;
  const float* em = tb.emission + (size_t)mat * 3;
  const float energy = clamp_lo(tb.energy[mat], 0.0f);
  return finish_shade(o, d, t, normal, V3{al[0], al[1], al[2]},
                      V3{em[0] * energy, em[1] * energy, em[2] * energy},
                      tb.metallic[mat], tb.roughness[mat]);
}

__global__ void __launch_bounds__(kBlock)
path_shade_bvh_kernel(const Hits h, const Tables tb, const Carry in,
                      const CarryOut out, const Params p) {
  const int lane = blockIdx.x * kBlock + threadIdx.x;
  if (lane >= p.n) return;
  const size_t n = (size_t)p.n;
  const float* f = in.fs + lane;
  const bool act = in.active[lane] != 0;
  const float t = h.t[lane];
  const bool hit = t < kMissT && act;

  const V3 o{f[0], f[n], f[2 * n]}, d{f[3 * n], f[4 * n], f[5 * n]};
  const V3 tp{f[6 * n], f[7 * n], f[8 * n]};
  V3 rad{f[9 * n], f[10 * n], f[11 * n]};
  float depth = f[13 * n];
  V3 n0{f[14 * n], f[15 * n], f[16 * n]};

  // integrator.continue_path's draw, taken on every lane.
  unsigned sx = (unsigned)in.seeds[lane], sy = (unsigned)in.seeds[n + lane];
  float r1, r2;
  pcg2d(sx, sy, r1, r2);

  V3 emission = sample_sky(d.y, p.sky);
  bool survive = false;
  V3 o2 = o, d2 = d, tp2 = tp;
  float pdf2 = -1.f;
  if (hit) {
    const Shade s = shade_hit(tb, h.tri[lane], h.inst[lane], h.u[lane],
                              h.v[lane], h.front[lane] != 0, o, d, t);
    emission = s.emission;
    if (p.bounce == 0) {  // first-hit AOVs
      const V3 rel = s.pos - o;
      depth = sqrtf(dot(rel, rel));
      n0 = s.n;
    }
    // integrator.continue_path without transmission and Russian roulette.
    const BrdfSample b = continue_path(s, r1, r2);
    const float scale = b.pdf > (float)1e-12
                            ? b.lambert_in / clamp_lo(b.pdf, (float)1e-12)
                            : 0.f;
    survive = b.lambert_in > 0.f && b.pdf > (float)1e-12;
    if (survive) {
      o2 = s.pos + s.n * p.ray_eps;
      d2 = b.dir;
      tp2 = tp * (b.f * scale);
      pdf2 = b.pdf;
    }
  }
  rad = act ? rad + tp * emission : rad;

  float* g = out.fs + lane;
  g[0] = o2.x;
  g[n] = o2.y;
  g[2 * n] = o2.z;
  g[3 * n] = d2.x;
  g[4 * n] = d2.y;
  g[5 * n] = d2.z;
  g[6 * n] = tp2.x;
  g[7 * n] = tp2.y;
  g[8 * n] = tp2.z;
  g[9 * n] = rad.x;
  g[10 * n] = rad.y;
  g[11 * n] = rad.z;
  g[12 * n] = pdf2;
  g[13 * n] = depth;
  g[14 * n] = n0.x;
  g[15 * n] = n0.y;
  g[16 * n] = n0.z;
  out.seeds[lane] = (long long)sx;
  out.seeds[n + lane] = (long long)sy;
  out.counts[lane] = in.counts[lane] + (act ? h.steps[lane] : 0);
  out.counts[n + lane] = in.counts[n + lane] + (act ? 1 : 0);
  out.active[lane] = survive ? 1 : 0;
}

}  // namespace

// Launches on `stream`; does not synchronise. Returns the first CUDA error
// (0 = launched).
extern "C" int path_shade_bvh(
    const void* hit_t, const void* hit_u, const void* hit_v,
    const void* hit_tri, const void* hit_inst, const void* hit_front,
    const void* hit_steps, const void* tri_normal, const void* tri_slot,
    const void* inst_materials, const void* inst_transform,
    const void* mat_albedo, const void* mat_emission, const void* mat_energy,
    const void* mat_metallic, const void* mat_roughness, const void* fs,
    const void* seeds, const void* counts, const void* active, void* fs_out,
    void* seeds_out, void* counts_out, void* active_out, int n, int n_tris,
    int n_inst, int n_slots, int n_mats, int bounce, float ray_eps,
    float sky_hx, float sky_hy, float sky_hz, float sky_dx, float sky_dy,
    float sky_dz, void* stream) {
  if (n <= 0 || n_tris <= 0 || n_inst <= 0 || n_slots <= 0 || n_mats <= 0 ||
      bounce < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const Hits h{(const float*)hit_t,     (const float*)hit_u,
               (const float*)hit_v,     (const int*)hit_tri,
               (const int*)hit_inst,    (const int*)hit_steps,
               (const unsigned char*)hit_front};
  const Tables tb{(const float*)tri_normal,    (const int*)tri_slot,
                  (const int*)inst_materials,  (const float*)inst_transform,
                  (const float*)mat_albedo,    (const float*)mat_emission,
                  (const float*)mat_energy,    (const float*)mat_metallic,
                  (const float*)mat_roughness, n_tris,
                  n_inst,                      n_slots,
                  n_mats};
  const Carry in{(const float*)fs, (const long long*)seeds,
                 (const int*)counts, (const unsigned char*)active};
  const CarryOut out{(float*)fs_out, (long long*)seeds_out, (int*)counts_out,
                     (unsigned char*)active_out};
  const Params p{n, bounce, ray_eps,
                 Sky{sky_hx, sky_hy, sky_hz, sky_dx, sky_dy, sky_dz}};
  const cudaStream_t st = (cudaStream_t)stream;
  path_shade_bvh_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0, st>>>(
      h, tb, in, out, p);
  return (int)cudaGetLastError();
}
