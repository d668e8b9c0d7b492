// The standard loop's shading of one bounce, for Hopper (sm_90a): the
// primal loop's on BVH hits (path_shade_bvh, first below), and the
// differentiable loop's on PALLAS hits with its backward (path_shade_diff
// and path_shade_diff_bwd, after it).
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

// ---------------------------------------------------------------------------
// The differentiable standard loop's bounce (ops/shade.py path_shade_diff,
// path_shade_diff_bwd; the autograd.Function PathShadeDiff applies them).
//
// Replaces no TPU kernel: the reference differentiates this step as plain
// XLA inside its bounce loop; the port ran it as ~600 PyTorch ops a
// tile-bounce body and ~100 more in its backward graph, the largest of
// them the atomic index_add_ of the material gather's backward, millions
// of lanes into a handful of rows. Contract of the forward (plain version
// path_shade_diff_plain, the body's statements): one bounce `bounce` of n
// lanes whose hit the finder found and ops/intersect.py's _diff_epilogue
// recomputed,
//
//   in   hit      t (n,) f32 (1e9 where missed or inactive), u, v (n,) f32
//                 (clipped), front (n,) u8, eidx, steps (n,) i32
//        tables   shade (E, 16) f32 Scene.isect_shade, mats (M, 13) f32
//                 render/shading.py material_table (detached)
//        carry    origin, direction, throughput, radiance: one (n,) f32
//                 array a component; active (n,) u8; the PCG2D words (n,)
//                 i64 each; depth (n,) f32; steps, segments (n,) i32;
//                 first-hit normal, one (n,) f32 array a component
//   out  fs       (11, n) f32  0:3 origin | 3:6 direction | 6 prev pdf |
//                              7 depth | 8:11 first-hit normal (7:11 only
//                              at bounce 0; later the wrapper returns the
//                              carry's own)
//        tp, rad  one (n,) f32 array a component
//        seeds    (2, n) i64, counts (2, n) i32 (steps, segments),
//        active   (n,) u8 (survive)
//        saved    (9, n) f32, mat (n,) i32, where `save`: 0:3 the emission
//                 added (0 where inactive) | 3:6 the throughput's factor
//                 (1 where the path ended) | 6:9 k * throughput (0 where
//                 the path ended), and the material row of the hit
//
// Per lane the body's statements with the shading record of
// render/shading.py get_shading_data_fast (shade[max(eidx, 0)], mats of
// its column 15, path_common.cuh shade_rows), in the term order of
// path_shade_bvh_kernel above, so the primal outputs equal the body's bit
// for bit. k = scale * d f_c / d albedo_c: render/brdf.py's diffuse_albedo
// (albedo - albedo * metallic) and fresnel_0 (0.02 + (albedo - 0.02) *
// metallic) are affine in the albedo and the sampled direction and pdf are
// detached, so the derivative is one scalar for the three channels,
// valid * ((1 - metallic) * fd + metallic * (1 - fac5) * D * G) / pi.
//
// The backward (path_shade_diff_bwd, plain version path_shade_diff_bwd_plain)
// reads the saved rows and the gradients of the new radiance and
// throughput, and writes
//
//   g_tp_in  (3, n) f32  added emission * g_rad + g_tp * factor
//   g_albedo (M, 3) f32  sum over lanes of g_tp * (k * throughput), by
//                        the lane's material row
//
// (the radiance's gradient passes through unchanged, with no kernel work).
// A block sums its lanes' rows in shared memory (M <= 1024 rows of 3
// floats): a warp whose contributing lanes share one row reduces by
// shuffles and adds once, else each lane adds; then one atomicAdd into
// the (M, 3) gradient per non-zero entry per block, which the entry point
// zeroes on the same stream. The sum's order varies from run to run.
//
// What bounds them on the H100: device memory. The forward reads 21 bytes
// of its hit and 89 of the carry (73 after bounce 0, where depth and
// normal are not touched), writes 93 (77) and 40 saved: ~211-243 bytes a
// lane, ~55-64 MB a 262144-lane tile, 17-19 us at 3.35 TB/s; a hit lane
// also gathers a 64-byte shading row and a 52-byte material row, which
// for the demo's and the grid's tables (0.1 and ~6 MB) stay in L2. The
// backward reads 40 saved and 24 of gradients and writes 12: 76 bytes a
// lane, ~20 MB a tile, ~6 us. The design: a thread per lane, 256 a block,
// every row read and written once, coalesced, the gathers only on lanes
// that hit.
// ---------------------------------------------------------------------------

constexpr int kMaxMats = 1024;

struct DiffHits {
  const float *t, *u, *v;
  const unsigned char* front;
  const int *eidx, *steps;
};

struct DiffTables {
  const float* shade;  // (E, 16)
  const float* mats;   // (M, 13)
  int n_rows, n_mats;
};

// The body's carry, one (n,) array a component.
struct DiffCarry {
  const float *ox, *oy, *oz, *dx, *dy, *dz;
  const float *tx, *ty, *tz, *rx, *ry, *rz;
  const unsigned char* active;
  const long long *seed0, *seed1;
  const float* depth;
  const int *steps, *segments;
  const float *nx, *ny, *nz;
};

struct DiffOut {
  float* fs;  // (11, n)
  float *tx, *ty, *tz, *rx, *ry, *rz;
  long long* seeds;       // (2, n)
  int* counts;            // (2, n)
  unsigned char* active;  // (n,)
  float* saved;           // (9, n)
  int* mat;               // (n,)
};

struct DiffParams {
  int n, bounce, save;
  float ray_eps;
  Sky sky;
};

// d f_c / d albedo_c of path_common.cuh eval_brdf at `l`, the same for the
// three channels (render/brdf.py eval_brdf's terms; ops/shade.py
// albedo_slope is its plain version).
__device__ __forceinline__ float albedo_slope(const Shade& s, V3 l,
                                              float metallic) {
  const float ndotl = dot(s.n, l);
  const float ndotv = s.lambert_out;
  if (!(min_nan(ndotl, ndotv) >= 0.0f)) return 0.0f;
  const V3 half = normalize_eps(l + s.out, kBrdfEps);
  const float hdotv = dot(half, s.out);
  const float f90 = (hdotv * hdotv) * (2.0f * s.rough) + 0.5f;
  const float fd = (1.0f + (f90 - 1.0f) * schlick5(ndotv)) *
                   (1.0f + (f90 - 1.0f) * schlick5(ndotl));
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
  return ((1.0f - metallic) * fd +
          metallic * (1.0f - fac5) * (distribution * geometry)) *
         (float)(1.0 / kPi);
}

__global__ void __launch_bounds__(kBlock)
path_shade_diff_kernel(const DiffHits h, const DiffTables tb,
                       const DiffCarry in, const DiffOut out,
                       const DiffParams p) {
  const int lane = blockIdx.x * kBlock + threadIdx.x;
  if (lane >= p.n) return;
  const size_t n = (size_t)p.n;
  const bool act = in.active[lane] != 0;
  const float t = h.t[lane];
  const bool hit = t < kMissT && act;

  const V3 o{in.ox[lane], in.oy[lane], in.oz[lane]};
  const V3 d{in.dx[lane], in.dy[lane], in.dz[lane]};
  const V3 tp{in.tx[lane], in.ty[lane], in.tz[lane]};
  V3 rad{in.rx[lane], in.ry[lane], in.rz[lane]};
  float depth = 0.f;
  V3 n0{0.f, 0.f, 0.f};
  if (p.bounce == 0) {
    depth = in.depth[lane];
    n0 = V3{in.nx[lane], in.ny[lane], in.nz[lane]};
  }

  // integrator.continue_path's draw, taken on every lane.
  unsigned sx = (unsigned)in.seed0[lane], sy = (unsigned)in.seed1[lane];
  float r1, r2;
  pcg2d(sx, sy, r1, r2);

  V3 emission = sample_sky(d.y, p.sky);
  bool survive = false;
  V3 o2 = o, d2 = d, tp2 = tp, mult{1.f, 1.f, 1.f};
  float pdf2 = -1.f, k = 0.f;
  int mat = 0;
  if (hit) {
    // render/shading.py get_shading_data_fast: the shading row of the
    // winner and the material row its column 15 names.
    const float* sh = tb.shade + (size_t)clamp_index(h.eidx[lane], tb.n_rows)
                                     * 16;
    mat = clamp_index((int)(long long)sh[15], tb.n_mats);
    const float* m = tb.mats + (size_t)mat * 13;
    const auto col = [&](int r) { return r < 17 ? sh[r] : m[r - 17]; };
    const Shade s = shade_rows(col, h.u[lane], h.v[lane], h.front[lane] != 0,
                               o, d, t);
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
      mult = b.f * scale;
      tp2 = tp * mult;
      pdf2 = b.pdf;
      if (p.save) k = albedo_slope(s, b.dir, m[7]) * scale;
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
  g[6 * n] = pdf2;
  if (p.bounce == 0) {
    g[7 * n] = depth;
    g[8 * n] = n0.x;
    g[9 * n] = n0.y;
    g[10 * n] = n0.z;
  }
  out.tx[lane] = tp2.x;
  out.ty[lane] = tp2.y;
  out.tz[lane] = tp2.z;
  out.rx[lane] = rad.x;
  out.ry[lane] = rad.y;
  out.rz[lane] = rad.z;
  out.seeds[lane] = (long long)sx;
  out.seeds[n + lane] = (long long)sy;
  out.counts[lane] = in.steps[lane] + (act ? h.steps[lane] : 0);
  out.counts[n + lane] = in.segments[lane] + (act ? 1 : 0);
  out.active[lane] = survive ? 1 : 0;
  if (p.save) {
    float* sv = out.saved + lane;
    sv[0] = act ? emission.x : 0.f;
    sv[n] = act ? emission.y : 0.f;
    sv[2 * n] = act ? emission.z : 0.f;
    sv[3 * n] = mult.x;
    sv[4 * n] = mult.y;
    sv[5 * n] = mult.z;
    sv[6 * n] = k * tp.x;
    sv[7 * n] = k * tp.y;
    sv[8 * n] = k * tp.z;
    out.mat[lane] = mat;
  }
}

__global__ void __launch_bounds__(kBlock)
path_shade_diff_bwd_kernel(const float* __restrict__ saved,
                           const int* __restrict__ mat,
                           const float* __restrict__ grx,
                           const float* __restrict__ gry,
                           const float* __restrict__ grz,
                           const float* __restrict__ gtx,
                           const float* __restrict__ gty,
                           const float* __restrict__ gtz,
                           float* __restrict__ g_tp_in,
                           float* __restrict__ g_albedo, const int n_lanes,
                           const int n_mats) {
  extern __shared__ float acc[];  // (n_mats, 3)
  for (int i = threadIdx.x; i < 3 * n_mats; i += kBlock) acc[i] = 0.f;
  __syncthreads();
  const int lane = blockIdx.x * kBlock + threadIdx.x;
  const size_t n = (size_t)n_lanes;
  float c0 = 0.f, c1 = 0.f, c2 = 0.f;
  int row = -1;  // the material row this lane adds to, -1 for none
  if (lane < n_lanes) {
    const float* sv = saved + lane;
    const float gr0 = grx[lane], gr1 = gry[lane], gr2 = grz[lane];
    const float gt0 = gtx[lane], gt1 = gty[lane], gt2 = gtz[lane];
    g_tp_in[lane] = sv[0] * gr0 + gt0 * sv[3 * n];
    g_tp_in[n + lane] = sv[n] * gr1 + gt1 * sv[4 * n];
    g_tp_in[2 * n + lane] = sv[2 * n] * gr2 + gt2 * sv[5 * n];
    const float w0 = sv[6 * n], w1 = sv[7 * n], w2 = sv[8 * n];
    if (w0 != 0.f || w1 != 0.f || w2 != 0.f) {
      row = clamp_index(mat[lane], n_mats);
      c0 = gt0 * w0;
      c1 = gt1 * w1;
      c2 = gt2 * w2;
    }
  }
  // A warp whose adding lanes share one row reduces by shuffles.
  const unsigned full = 0xffffffffu;
  const int top = __reduce_max_sync(full, row);
  if (__all_sync(full, row < 0 || row == top)) {
    for (int off = 16; off > 0; off >>= 1) {
      c0 += __shfl_down_sync(full, c0, off);
      c1 += __shfl_down_sync(full, c1, off);
      c2 += __shfl_down_sync(full, c2, off);
    }
    if ((threadIdx.x & 31) == 0 && top >= 0) {
      atomicAdd(acc + 3 * top, c0);
      atomicAdd(acc + 3 * top + 1, c1);
      atomicAdd(acc + 3 * top + 2, c2);
    }
  } else if (row >= 0) {
    atomicAdd(acc + 3 * row, c0);
    atomicAdd(acc + 3 * row + 1, c1);
    atomicAdd(acc + 3 * row + 2, c2);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * n_mats; i += kBlock) {
    if (acc[i] != 0.f) atomicAdd(g_albedo + i, acc[i]);
  }
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

// The differentiable loop's bounce: see path_shade_diff_kernel. `save` 0
// writes neither `saved` nor `mat` (a render that needs no gradient).
// Launches on `stream`; does not synchronise. Returns the first CUDA error
// (0 = launched).
extern "C" int path_shade_diff(
    const void* hit_t, const void* hit_u, const void* hit_v,
    const void* hit_front, const void* hit_eidx, const void* hit_steps,
    const void* shade, const void* mats, const void* ox, const void* oy,
    const void* oz, const void* dx, const void* dy, const void* dz,
    const void* tx, const void* ty, const void* tz, const void* rx,
    const void* ry, const void* rz, const void* active, const void* seed0,
    const void* seed1, const void* depth, const void* steps,
    const void* segments, const void* nx, const void* ny, const void* nz,
    void* fs_out, void* tx_out, void* ty_out, void* tz_out, void* rx_out,
    void* ry_out, void* rz_out, void* seeds_out, void* counts_out,
    void* active_out, void* saved, void* mat, int n, int n_rows, int n_mats,
    int bounce, int save, float ray_eps, float sky_hx, float sky_hy,
    float sky_hz, float sky_dx, float sky_dy, float sky_dz, void* stream) {
  if (n <= 0 || n_rows <= 0 || n_mats <= 0 || bounce < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const DiffHits h{(const float*)hit_t, (const float*)hit_u,
                   (const float*)hit_v, (const unsigned char*)hit_front,
                   (const int*)hit_eidx, (const int*)hit_steps};
  const DiffTables tb{(const float*)shade, (const float*)mats, n_rows,
                      n_mats};
  const DiffCarry in{(const float*)ox,          (const float*)oy,
                     (const float*)oz,          (const float*)dx,
                     (const float*)dy,          (const float*)dz,
                     (const float*)tx,          (const float*)ty,
                     (const float*)tz,          (const float*)rx,
                     (const float*)ry,          (const float*)rz,
                     (const unsigned char*)active,
                     (const long long*)seed0,   (const long long*)seed1,
                     (const float*)depth,       (const int*)steps,
                     (const int*)segments,      (const float*)nx,
                     (const float*)ny,          (const float*)nz};
  const DiffOut out{(float*)fs_out,        (float*)tx_out,
                    (float*)ty_out,        (float*)tz_out,
                    (float*)rx_out,        (float*)ry_out,
                    (float*)rz_out,        (long long*)seeds_out,
                    (int*)counts_out,      (unsigned char*)active_out,
                    (float*)saved,         (int*)mat};
  const DiffParams p{n, bounce, save ? 1 : 0, ray_eps,
                     Sky{sky_hx, sky_hy, sky_hz, sky_dx, sky_dy, sky_dz}};
  const cudaStream_t st = (cudaStream_t)stream;
  path_shade_diff_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0, st>>>(
      h, tb, in, out, p);
  return (int)cudaGetLastError();
}

// Its backward: see path_shade_diff_bwd_kernel. Zeroes `g_albedo` and
// launches on `stream`; does not synchronise. Returns the first CUDA error
// (0 = launched).
extern "C" int path_shade_diff_bwd(const void* saved, const void* mat,
                                   const void* grx, const void* gry,
                                   const void* grz, const void* gtx,
                                   const void* gty, const void* gtz,
                                   void* g_tp_in, void* g_albedo, int n,
                                   int n_mats, void* stream) {
  if (n <= 0 || n_mats <= 0 || n_mats > kMaxMats) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const int err = (int)cudaMemsetAsync(
      g_albedo, 0, (size_t)n_mats * 3 * sizeof(float), st);
  if (err) return err;
  path_shade_diff_bwd_kernel<<<(n + kBlock - 1) / kBlock, kBlock,
                               (size_t)n_mats * 3 * sizeof(float), st>>>(
      (const float*)saved, (const int*)mat, (const float*)grx,
      (const float*)gry, (const float*)grz, (const float*)gtx,
      (const float*)gty, (const float*)gtz, (float*)g_tp_in,
      (float*)g_albedo, n, n_mats);
  return (int)cudaGetLastError();
}
