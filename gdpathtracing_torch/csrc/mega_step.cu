// Per-bounce path-tracing megakernel for Hopper (sm_90a): kernel 10.
//
// Replaces the TPU kernel `_make_mega_kernel`
// (gdpathtracing_tpu/ops/megakernel.py:182, wrapper `_mega_step` :479,
// driven by `path_trace_mega` :560). Contract (ops/megakernel.py
// mega_step): one whole bounce of a packed wavefront,
//
//   in   fs       (24, N) f32  0:3 o | 3:6 d | 6:9 throughput |
//                              9:12 radiance | 12 active | 13 depth |
//                              14 prev pdf | 15:18 first normal | pad
//        is       (8, N) i32   0 seed_x | 1 seed_y (uint32 bit patterns) |
//                              2 steps | 3 segments | pad
//        bounds, sub_bounds, mu/mv/mw, tab  as kernels 1 and 2
//        lt       (L, 18) f32  LightTable.rows (17 values) | cdf
//   out  fs, is   the state after the bounce
//
// and, for each ray, in this order (the reference's phases):
//   A   the closest hit (kernel 1's walk, trace_common.cuh walk_flat_coop)
//       of the live rays; dead rays are parked outside the scene and cast
//       no vote;
//   A'  with NEE: shading from the winner's table row, one emitter sample
//       (two PCG2D draws) and the shadow ray toward it;
//   B   with NEE: its any-hit (kernel 2's walk, walk_any_coop);
//   B'  the emission (sky on a miss) with the MIS weight, the visible
//       direct light, the first-hit AOVs, one BRDF sample (one draw), and
//       with rr_start > 0 Russian roulette (one more draw, every bounce),
//       then the new state. A' is computed again in B' from the same seed,
//       as the reference does, so nothing but the winner and the occlusion
//       bit lives across the walks.
// A block whose rays are all dead passes its state through unchanged
// (megakernel.py:457-472); its threads leave together, before any walk.
//
// Every output is per ray and neither walk depends on the block, so the
// frame does not depend on how the wrapper orders the rays between
// bounces (compact_rays).
//
// What bounds it on the H100: arithmetic, as for kernels 1 and 2 (~45
// operations per ray-triangle test, 25 per slab test, plus ~600 of
// shading, light sampling and BRDF per ray); device memory moves only the
// state (32 rows in and out), the winner rows and the chunk rows. The
// design: one thread per ray for the state and the epilogues, and 256-ray
// blocks, the state read and written once per bounce (the whole point of
// the TPU kernel, which kept it resident in VMEM); the walks are kernels
// 1 and 2's block-cooperative ones, which list each chunk's needing rays
// and sweep them a warp per ray, the rows double-buffered by cp.async: a
// thread per ray left the lanes of dead or non-needing rays idle while
// their warps swept (after the first bounce most of a block). The two
// walks' shared blocks overlay each other (NeeShared, 37 952 B): each
// thread takes its winner into registers before the barrier after which
// the any-hit walk writes its block. Shading stays out of the walk loops,
// so the epilogues' registers are live only between them, and o and d
// are loaded again after each walk (load_row3). Launch bounds (256, 3):
// 80 registers, no spills, 3 blocks of 38 KB an SM; holding o and d across
// the walks spilled 12 B there (and ran within 3.5% of it), (256, 2) takes
// 93 registers and 2-9% more time, (256, 4) 64 with 92 B of spill stores
// and 3-16% more (in turns on the H100, tools/two_level_turns.py).
#include "path_common.cuh"
#include "trace_common.cuh"

namespace {

using namespace gdpt;

constexpr int kLtR = 18;  // light block row: LightTable.rows (17) | cdf
constexpr float kPark = 1e9f;
constexpr float kParkD = (float)0.5773503;
// Shadow queries stop short of the light: (0, dist * (1 - 1e-3)).
constexpr float kShadowScale = (float)(1.0 - 1e-3);

struct Params {
  int n, e, n_lights, bounce, nee, rr_start;
  float ray_eps, rr_min_p;
  Sky sky;
};

struct LightSample {
  V3 emission, wi;
  float pdf_solid, dist;
};

// lights.sample_light on the light block: the emitter is
// clamp(#{cdf < r_pick}, 0, L - 1), found by a lower-bound search of the
// ascending cdf; a uniform point on it; the area pdf turned into a
// solid-angle pdf at `pos` (inf at grazing angles).
__device__ __forceinline__ LightSample sample_light(const float* __restrict__ lt,
                                                   int n_lights, V3 pos,
                                                   float r_pick, float r1,
                                                   float r2) {
  int lo = 0, hi = n_lights;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (lt[(size_t)mid * kLtR + 17] < r_pick) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const float* r = lt + (size_t)min(lo, n_lights - 1) * kLtR;
  const V3 v0{r[0], r[1], r[2]}, e1{r[3], r[4], r[5]}, e2{r[6], r[7], r[8]};
  const V3 normal{r[9], r[10], r[11]};
  const float area = r[15], pick = r[16];

  LightSample ls;
  ls.emission = V3{r[12], r[13], r[14]};
  const float su = sqrtf(r1);
  const float b1 = r2 * su;
  const float b2 = su * (1.0f - r2);
  const V3 point = v0 + e1 * b1 + e2 * b2;
  const V3 delta = point - pos;
  const float dist2 = clamp_lo(dot(delta, delta), (float)1e-8);
  ls.dist = sqrtf(dist2);
  ls.wi = delta * (1.0f / ls.dist);
  const float cos_l = fabsf(dot(normal, -ls.wi));
  const float pdf = dist2 / clamp_lo(cos_l * area, (float)1e-8) * pick;
  ls.pdf_solid = cos_l > (float)1e-6 ? pdf : INFINITY;
  return ls;
}

// The emitter sample of a hit (epilogues A' and B'): two PCG2D draws from
// (sx, sy), which advance.
__device__ __forceinline__ LightSample draw_light(const float* __restrict__ lt,
                                                  int n_lights, V3 pos,
                                                  unsigned& sx,
                                                  unsigned& sy) {
  float lr1, lr2, lr3, unused;
  pcg2d(sx, sy, lr1, lr2);
  pcg2d(sx, sy, lr3, unused);
  return sample_light(lt, n_lights, pos, lr3, lr1, lr2);
}

// Rows r .. r + 2 of the state at this ray, loaded where they are used
// rather than held across the walks: a volatile load is never merged with
// an earlier one, so o and d take no register during the walks, which
// leaves launch bounds (256, 3) without spills (the state is read-only
// here, so the non-coherent path is safe).
__device__ __forceinline__ V3 load_row3(const float* __restrict__ f,
                                        size_t n, int r) {
  float x[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    asm volatile("ld.global.nc.f32 %0, [%1];"
                 : "=f"(x[k])
                 : "l"(f + (size_t)(r + k) * n));
  }
  return V3{x[0], x[1], x[2]};
}

__global__ void __launch_bounds__(kBN, 3)
mega_step_kernel(const float* __restrict__ fs, const int* __restrict__ is,
                 const float* __restrict__ bounds,
                 const float* __restrict__ sub_bounds,
                 const float* __restrict__ mu, const float* __restrict__ mv,
                 const float* __restrict__ mw, const float* __restrict__ tab,
                 const float* __restrict__ lt, float* __restrict__ fs_out,
                 int* __restrict__ is_out, const Params p) {
  __shared__ NeeShared sh;

  const size_t n = (size_t)p.n, e = (size_t)p.e;
  const int nc = p.e / kBT;
  const int tid = threadIdx.x;
  const size_t ray = (size_t)blockIdx.x * kBN + tid;
  const float* f = fs + ray;
  const int* iv = is + ray;

  const bool act = f[12 * n] > 0.f;
  if (!__syncthreads_or(act)) {
    for (int r = 0; r < 24; ++r) fs_out[r * n + ray] = f[r * n];
    for (int r = 0; r < 8; ++r) is_out[r * n + ray] = iv[r * n];
    return;
  }
  // ---- A: closest hit; dead rays parked so that every slab test fails.
  Ray ra;
  {
    const V3 o = load_row3(f, n, 0), d = load_row3(f, n, 3);
    ra.ox = act ? o.x : kPark;
    ra.oy = act ? o.y : kPark;
    ra.oz = act ? o.z : kPark;
    ra.ow = 1.f;
    ra.dx = act ? d.x : kParkD;
    ra.dy = act ? d.y : kParkD;
    ra.dz = act ? d.z : kParkD;
    ra.dw = 0.f;
    ra.rdx = rcp_guarded(ra.dx);
    ra.rdy = rcp_guarded(ra.dy);
    ra.rdz = rcp_guarded(ra.dz);
  }
  CoopCursor cur{0, 0};
  WalkCounts cnt{0.f, 0.f, 0.f};
  walk_flat_coop(sh.closest, ra, act, bounds, nc, mu, mv, mw, e, tid, cur,
                 cnt);
  const Best best = two_level_best(sh.closest, tid);
  const float steps = cnt.steps;

  const bool found = best.t < kMiss;
  const bool hit = found && act;
  const float t = best.t;
  const float u = clamp01(best.u, 0.f, 1.f);
  const float v = clamp01(best.v, 0.f, 1.f);
  const bool front = best.wd < 0.f;
  // The winner's table row (0 on a miss), as kernel 1 writes it.
  const auto col = [&](int r) { return found ? tab[r * e + best.e] : 0.f; };
  const unsigned seed_x = (unsigned)iv[0], seed_y = (unsigned)iv[n];

  bool occ = false;
  if (p.nee) {
    // ---- A': the shadow ray of this hit's emitter sample.
    Ray rb;
    float lim;
    {
      const V3 o = load_row3(f, n, 0), d = load_row3(f, n, 3);
      const Shade s = shade_rows(col, u, v, front, o, d, t);
      unsigned sx = seed_x, sy = seed_y;
      const LightSample ls = draw_light(lt, p.n_lights, s.pos, sx, sy);
      const float cos_i = dot(s.n, ls.wi);
      const bool sh_act = hit && cos_i > 0.f && isfinite(ls.pdf_solid);
      const V3 so = s.pos + s.n * p.ray_eps;
      rb.ox = sh_act ? so.x : kPark;
      rb.oy = sh_act ? so.y : kPark;
      rb.oz = sh_act ? so.z : kPark;
      rb.ow = 1.f;
      rb.dx = sh_act ? ls.wi.x : kParkD;
      rb.dy = sh_act ? ls.wi.y : kParkD;
      rb.dz = sh_act ? ls.wi.z : kParkD;
      rb.dw = 0.f;
      rb.rdx = rcp_guarded(rb.dx);
      rb.rdy = rcp_guarded(rb.dy);
      rb.rdz = rcp_guarded(rb.dz);
      lim = sh_act ? ls.dist * kShadowScale : 0.f;
    }
    // ---- B: its any-hit, once every winner is read out of `closest`.
    __syncthreads();
    occ = walk_any_coop(sh.any, rb, lim, bounds, sub_bounds, nc, mu, mv, mw,
                        e, tid);
  }

  // ---- B': shade, light, sample, write the state.
  const V3 o = load_row3(f, n, 0), d = load_row3(f, n, 3);
  const Shade s = shade_rows(col, u, v, front, o, d, t);
  const V3 tp{f[6 * n], f[7 * n], f[8 * n]};
  V3 rad{f[9 * n], f[10 * n], f[11 * n]};
  const float prev_pdf = f[14 * n];
  unsigned sx = seed_x, sy = seed_y;

  V3 emission = hit ? s.emission : sample_sky(d.y, p.sky);
  int segs_add = act ? 1 : 0;
  if (p.nee) {
    // lights.light_pdf_from_rows: the pdf NEE would have given this
    // direction, from the winner's emitter term and normal (rows 30-33).
    const float inv_term = col(30);
    const float cos_l = fabsf(col(31) * d.x + col(32) * d.y + col(33) * d.z);
    const float dist2 = clamp_lo(t * t, (float)1e-8);
    const float pl0 = dist2 * inv_term / clamp_lo(cos_l, (float)1e-6);
    const float pl = (inv_term > 0.f && cos_l > (float)1e-6) ? pl0 : 0.f;
    const float pb = clamp_lo(prev_pdf, 0.f);
    const float w_mis =
        (prev_pdf > 0.f && hit && pl > 0.f)
            ? (pb * pb) / clamp_lo(pb * pb + pl * pl, (float)1e-20)
            : 1.f;
    emission = emission * w_mis;
  }
  rad = act ? rad + tp * emission : rad;

  if (p.nee) {
    const LightSample ls = draw_light(lt, p.n_lights, s.pos, sx, sy);
    const float cos_i = dot(s.n, ls.wi);
    const bool sh_act = hit && cos_i > 0.f && isfinite(ls.pdf_solid);
    const float visibility = 1.f - (occ ? 1.f : 0.f);
    segs_add += sh_act ? 1 : 0;
    const V3 f_l = eval_brdf(s, ls.wi);
    const float pb_l = brdf_pdf(s, ls.wi);
    const float pdf = ls.pdf_solid;
    const float w_l = (pdf * pdf) / clamp_lo(pdf * pdf + pb_l * pb_l,
                                             (float)1e-20);
    const float scale_l =
        ((sh_act && pdf > (float)1e-12 && isfinite(pdf))
             ? cos_i * w_l / clamp_lo(pdf, (float)1e-12)
             : 0.f) *
        visibility;
    const V3 direct = tp * f_l * ls.emission * scale_l;
    rad = act ? rad + direct : rad;
  }

  const bool first = p.bounce == 0 && hit;
  const V3 rel = s.pos - o;
  const float depth = first ? sqrtf(dot(rel, rel)) : f[13 * n];
  const V3 n0 = first ? s.n : V3{f[15 * n], f[16 * n], f[17 * n]};

  float r1, r2;
  pcg2d(sx, sy, r1, r2);
  const BrdfSample b = continue_path(s, r1, r2);
  const float scale = b.pdf > (float)1e-12
                          ? b.lambert_in / clamp_lo(b.pdf, (float)1e-12)
                          : 0.f;
  V3 mult = b.f * scale;
  bool survive = hit && b.lambert_in > 0.f && b.pdf > (float)1e-12;
  if (p.rr_start > 0) {
    // Russian roulette: the draw is taken on every bounce, the kill from
    // bounce rr_start on.
    float r5, unused;
    pcg2d(sx, sy, r5, unused);
    const float lum = max_nan(tp.x * mult.x,
                              max_nan(tp.y * mult.y, tp.z * mult.z));
    const float pr = clamp01(lum, p.rr_min_p, 1.f);
    const bool do_rr = p.bounce >= p.rr_start;
    survive = survive && (do_rr ? r5 < pr : true);
    mult = mult * (do_rr ? 1.f / pr : 1.f);
  }
  const V3 new_o = s.pos + s.n * p.ray_eps;
  const V3 o2 = survive ? new_o : o;
  const V3 d2 = survive ? b.dir : d;
  const V3 tp2 = survive ? tp * mult : tp;

  float* g = fs_out + ray;
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
  g[12 * n] = survive ? 1.f : 0.f;
  g[13 * n] = depth;
  g[14 * n] = survive ? b.pdf : -1.f;
  g[15 * n] = n0.x;
  g[16 * n] = n0.y;
  g[17 * n] = n0.z;
  for (int r = 18; r < 24; ++r) g[r * n] = f[r * n];
  int* h = is_out + ray;
  h[0] = (int)sx;
  h[n] = (int)sy;
  h[2 * n] = iv[2 * n] + (act ? (int)steps : 0);
  h[3 * n] = iv[3 * n] + segs_add;
  for (int r = 4; r < 8; ++r) h[r * n] = iv[r * n];
}

}  // namespace

// Launches on `stream`; does not synchronise. Returns cudaGetLastError()
// (0 = launched).
extern "C" int mega_step(const void* fs, const void* is, const void* bounds,
                         const void* sub_bounds, const void* mu,
                         const void* mv, const void* mw, const void* tab,
                         const void* lt, void* fs_out, void* is_out, int n,
                         int e, int n_lights, int bounce, int nee,
                         int rr_start, float ray_eps, float rr_min_p,
                         float sky_hx, float sky_hy, float sky_hz,
                         float sky_dx, float sky_dy, float sky_dz,
                         void* stream) {
  if (n <= 0 || e <= 0 || n % kBN != 0 || e % kBT != 0 ||
      (nee && n_lights <= 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const Params p{n,        e,        n_lights, bounce,
                 nee,      rr_start, ray_eps,  rr_min_p,
                 Sky{sky_hx, sky_hy, sky_hz, sky_dx, sky_dy, sky_dz}};
  mega_step_kernel<<<n / kBN, kBN, 0, (cudaStream_t)stream>>>(
      (const float*)fs, (const int*)is, (const float*)bounds,
      (const float*)sub_bounds, (const float*)mu, (const float*)mv,
      (const float*)mw, (const float*)tab, (const float*)lt, (float*)fs_out,
      (int*)is_out, p);
  return (int)cudaGetLastError();
}
