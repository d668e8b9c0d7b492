// All-bounces path-tracing kernel for Hopper (sm_90a): kernel 11.
//
// Replaces the TPU kernel `_make_kernel` + `_sweep` + `_gather_rows`
// (gdpathtracing_tpu/ops/fused_pallas.py:174, :79 and :151; wrapper
// `_run` :348, driven by `path_trace_fused` :382). Contract
// (ops/fused.py fused_paths): every bounce of every path in one launch,
//
//   in   o4, d4   (4, N) f32   camera rays as (o, 1) and (d, 0)
//        seeds    (2, N) i32   PCG2D words (uint32 bit patterns)
//        bounds   (8, nc)      inflated chunk AABBs (flat: up to 64
//                              chunks, no superchunk level)
//        mu/mv/mw (4, E)       unit-triangle-space rows
//        table    (E, 32) f32  isect_cols (12) | isect_shade (16) | pad
//        mats     (M, 16) f32  albedo3 | emission3 | energy | metallic |
//                              roughness | tex | transmission | ior |
//                              mr_tex | pad
//   out  out      (7, N) f32   radiance rgb | depth (1e9 on a miss) |
//                              first-hit normal
//        segs     (N,) i32     path segments traced
//
// Each bounce of a ray: the closest hit (kernel 1's walk, trace_common.cuh
// walk_flat_coop, over the flat chunks); the winner's (E, 32) row (a load,
// where the TPU used a one-hot product); u and v from its isect_cols at the
// winner's t, not clipped, front = w_d < 0; the material by mat_id,
// transmission 0 and ior 1.5; the emission or, on a miss, the sky; on
// bounce 0 depth = t and the normal; below the last bounce one BRDF sample.
// Dead rays park at 1e9 with direction 0.5773503, where every slab test
// fails. These are the reference's FUSED rules, kept as it has them; they
// differ from MEGA's and PALLAS's (clipped u, v; depth |position - o|).
//
// What bounds it on the H100: arithmetic (~45 operations per ray-triangle
// test, 25 per slab test, ~400 of shading and BRDF per ray and bounce);
// device memory moves only the rays in, 8 words out, and the chunk and
// winner rows. The design: the whole bounce loop in one launch (one a tile
// instead of one per bounce), 256-ray blocks, a thread per path for the
// path state (in registers) and the shading, and each bounce's closest hit
// on kernel 1's block-cooperative flat walk (walk_flat_coop): from bounce 1
// on a block's rays point everywhere and the dead ones need nothing, so a
// thread per ray would sweep with most lanes idle; the cooperative walk
// lists each chunk's needing rays and sweeps them a warp per ray (or by
// their own threads where the needing warps are nearly full), the rows
// double-buffered by cp.async. Each bounce stores the ray's o and d in
// shared memory and reads its winner back from there; a dead path casts
// no vote and is never listed, but takes part in every barrier, and a
// block whose paths are all dead costs one vote per 32 chunks a bounce.
// Launch bounds (256, 3): ptxas fits the path state and the walk in 77
// registers without spilling, and 3 blocks of 38 KB fit an SM; under
// (256, 2) it takes 85 and runs 6-8% slower, and without the walk's 7/8
// thread path 8% slower (in turns on the H100, tools/two_level_turns.py).

#include "path_common.cuh"
#include "trace_common.cuh"

namespace {

using namespace gdpt;

constexpr int kTableW = 32;
constexpr int kMatW = 16;
constexpr float kPark = 1e9f;
constexpr float kParkD = (float)0.5773503;

struct Params {
  int n, e, bounces;
  float ray_eps;
  Sky sky;
};

__global__ void __launch_bounds__(kBN, 3)
fused_paths_kernel(const float* __restrict__ o4, const float* __restrict__ d4,
                   const int* __restrict__ seeds,
                   const float* __restrict__ bounds,
                   const float* __restrict__ mu, const float* __restrict__ mv,
                   const float* __restrict__ mw,
                   const float* __restrict__ table,
                   const float* __restrict__ mats, float* __restrict__ out,
                   int* __restrict__ segs_out, const Params p) {
  __shared__ TwoLevelShared sh;

  const size_t n = (size_t)p.n, e = (size_t)p.e;
  const int nc = p.e / kBT;
  const int tid = threadIdx.x;
  const size_t ray = (size_t)blockIdx.x * kBN + tid;

  V3 o{o4[ray], o4[n + ray], o4[2 * n + ray]};
  V3 d{d4[ray], d4[n + ray], d4[2 * n + ray]};
  unsigned sx = (unsigned)seeds[ray], sy = (unsigned)seeds[n + ray];
  V3 tp{1.f, 1.f, 1.f}, rad{0.f, 0.f, 0.f}, n0{0.f, 0.f, 0.f};
  bool active = true;
  float depth = kMiss;
  int segs = 0;
  CoopCursor cur{0, 0};  // kept across the bounces (walk_flat_coop)
  WalkCounts cnt{0.f, 0.f, 0.f};

  for (int bounce = 0; bounce < p.bounces; ++bounce) {
    Ray r;
    r.ox = o.x;
    r.oy = o.y;
    r.oz = o.z;
    r.ow = 1.f;
    r.dx = d.x;
    r.dy = d.y;
    r.dz = d.z;
    r.dw = 0.f;
    r.rdx = rcp_guarded(r.dx);
    r.rdy = rcp_guarded(r.dy);
    r.rdz = rcp_guarded(r.dz);
    walk_flat_coop(sh, r, active, bounds, nc, mu, mv, mw, e, tid, cur, cnt);
    const Best best = two_level_best(sh, tid);
    const float t = best.t;
    const bool hit = t < kMiss && active;
    segs += active ? 1 : 0;

    // The winner's row, 0 where the ray found nothing.
    const float* row = table + (size_t)best.e * kTableW;
    const auto R = [&](int c) { return hit ? row[c] : 0.f; };
    const float u = dot4(R(0), R(1), R(2), R(3), o.x, o.y, o.z, 1.f) +
                    t * dot4(R(0), R(1), R(2), R(3), d.x, d.y, d.z, 0.f);
    const float v = dot4(R(4), R(5), R(6), R(7), o.x, o.y, o.z, 1.f) +
                    t * dot4(R(4), R(5), R(6), R(7), d.x, d.y, d.z, 0.f);
    const float w_d = dot4(R(8), R(9), R(10), R(11), d.x, d.y, d.z, 0.f);
    const bool front = w_d < 0.f;
    const float w_bc = 1.f - u - v;
    V3 normal = normalize_eps(
        V3{R(12) * w_bc + R(15) * u + R(18) * v,
           R(13) * w_bc + R(16) * u + R(19) * v,
           R(14) * w_bc + R(17) * u + R(20) * v},
        (float)1e-20);
    normal = front ? normal : -normal;

    const float* m = mats + (size_t)(int)R(27) * kMatW;
    const V3 albedo{m[0], m[1], m[2]};
    const float energy = clamp_lo(m[6], 0.f);
    const V3 emission{m[3] * energy, m[4] * energy, m[5] * energy};
    const Shade s =
        finish_shade(o, d, t, normal, albedo, emission, m[7],
                     clamp_lo(m[8], kMinRoughness));

    const V3 emit = hit ? s.emission : sample_sky(d.y, p.sky);
    rad = active ? rad + tp * emit : rad;
    if (bounce == 0) {
      depth = hit ? t : depth;
      n0 = hit ? normal : n0;
    }

    if (bounce < p.bounces - 1) {
      float r1, r2;
      pcg2d(sx, sy, r1, r2);
      const BrdfSample b = continue_path(s, r1, r2);
      const float scale = b.pdf > (float)1e-12
                              ? b.lambert_in / clamp_lo(b.pdf, (float)1e-12)
                              : 0.f;
      const bool survive = hit && b.lambert_in > 0.f && b.pdf > (float)1e-12;
      o = survive ? s.pos + normal * p.ray_eps : o;
      d = survive ? b.dir : d;
      tp = survive ? V3{tp.x * b.f.x * scale, tp.y * b.f.y * scale,
                        tp.z * b.f.z * scale}
                   : tp;
      active = survive;
      o = active ? o : V3{kPark, kPark, kPark};
      d = active ? d : V3{kParkD, kParkD, kParkD};
    }
  }

  out[ray] = rad.x;
  out[n + ray] = rad.y;
  out[2 * n + ray] = rad.z;
  out[3 * n + ray] = depth;
  out[4 * n + ray] = n0.x;
  out[5 * n + ray] = n0.y;
  out[6 * n + ray] = n0.z;
  segs_out[ray] = segs;
}

}  // namespace

// Launches on `stream`; does not synchronise. Returns cudaGetLastError()
// (0 = launched).
extern "C" int fused_paths(const void* o4, const void* d4, const void* seeds,
                           const void* bounds, const void* mu, const void* mv,
                           const void* mw, const void* table,
                           const void* mats, void* out, void* segs, int n,
                           int e, int bounces, float ray_eps, float sky_hx,
                           float sky_hy, float sky_hz, float sky_dx,
                           float sky_dy, float sky_dz, void* stream) {
  if (n <= 0 || e <= 0 || n % kBN != 0 || e % kBT != 0 || bounces < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const Params p{n, e, bounces, ray_eps,
                 Sky{sky_hx, sky_hy, sky_hz, sky_dx, sky_dy, sky_dz}};
  fused_paths_kernel<<<n / kBN, kBN, 0, (cudaStream_t)stream>>>(
      (const float*)o4, (const float*)d4, (const int*)seeds,
      (const float*)bounds, (const float*)mu, (const float*)mv,
      (const float*)mw, (const float*)table, (const float*)mats, (float*)out,
      (int*)segs, p);
  return (int)cudaGetLastError();
}
