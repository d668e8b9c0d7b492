// Soft-shadow top-1 blocker kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `_soft_occlusion_kernel`
// (gdpathtracing_tpu/ops/intersect_pallas.py:1828, wrapper `_soft_occlusion`
// :1899, `soft_occluded_pallas` :1939). Contract (ops/intersect.py
// soft_occluded):
//
//   in   o4, d4    (4, N)   shadow rays as (o, 1) and (d, 0); N % 256 == 0
//        tmax      (N,)     the query is (1e-6, tmax); 0 for parked rays
//        bounds    (8, nc)  chunk AABBs grown by edge_eps x their diagonal
//                           (ops/intersect.py soft_bounds)
//        mu/mv/mw  (4, E)   unit-triangle-space rows, E = 256 * nc
//        eo        (3, E)   edge openness per triangle: rows u, v, w, 1 =
//                           an open (silhouette) edge, 0 = a shared one
//   out  margin    (N,) f32 the winner's open-edge margin, -1e9 = none
//        eidx      (N,) i32 the winner's expanded-triangle index, 0 = none
//
// A triangle is a candidate of a ray when its chunk passes the ray's own
// slab test (tmax >= tmin, tmax > 0, tmin < the query's tmax), |w_d| >
// 1e-12, the ray crosses its plane at 1e-6 < t < tmax, and the crossing is
// inside every closed edge (their least barycentric coordinate > 0). Its
// margin is the least barycentric coordinate over its open edges (1 when
// every edge is closed), so a near miss past a silhouette edge scores < 0.
// The winner is the largest margin and, among equal margins above -1e8,
// the lowest eidx: a lexicographic maximum, so it depends neither on the
// visit order nor on which rays share a block. Interior hits on closed
// triangles all score exactly 1.0, so that tie rule decides often.
//
// What bounds it on the H100: arithmetic, as for kernels 1 and 2 (six
// 4-term dot products, one IEEE division and the margin's selects per
// ray-triangle test). A maximum cannot resolve early, so there is no exit
// once a blocker is found, unlike kernel 2: every chunk whose soft-inflated
// box a ray enters is swept to the end. The design is kernel 2's, simple
// first: one thread per ray, 256-ray blocks, chunks in index order;
// `__syncthreads_or` skips a chunk no ray of the block needs, otherwise the
// block stages the chunk's mu/mv/mw (12 KB, `stage_chunk`) and its openness
// flags (3 KB) in shared memory, and every ray that needs the chunk sweeps
// its 256 triangles; the winner stays in registers. Built with
// -fmad=false, it equals the plain version (ops/intersect.py
// soft_occluded_plain) bit for bit.

#include "trace_common.cuh"

namespace {

using namespace gdpt;

constexpr float kNoBlocker = -1e9f;

__global__ void __launch_bounds__(kBN)
soft_occlusion_kernel(const float* __restrict__ o4,
                      const float* __restrict__ d4,
                      const float* __restrict__ tmax,
                      const float* __restrict__ bounds,
                      const float* __restrict__ mu,
                      const float* __restrict__ mv,
                      const float* __restrict__ mw,
                      const float* __restrict__ eo,
                      float* __restrict__ margin_out,
                      int* __restrict__ eidx_out, int n, int e) {
  __shared__ ChunkRows s_m;
  __shared__ float s_eo[3][kBT];

  const int nc = e / kBT;
  const int tid = threadIdx.x;
  const size_t ray = (size_t)blockIdx.x * kBN + tid;
  const Ray r = load_ray(o4, d4, (size_t)n, ray);
  const float lim = tmax[ray];
  float best_m = kNoBlocker;
  int best_e = 0;

  for (int c = 0; c < nc; ++c) {
    float tmin, tmx;
    slab(r, bounds, nc, c, tmin, tmx);
    const bool may = (tmx >= tmin) && (tmx > 0.f) && (tmin < lim);
    // Also the barrier that ends every read of the previous chunk's rows.
    if (!__syncthreads_or(may)) continue;
    stage_chunk(s_m, mu, mv, mw, (size_t)e, c, tid);
    const size_t col = (size_t)c * kBT + tid;
#pragma unroll
    for (int k = 0; k < 3; ++k) s_eo[k][tid] = eo[k * (size_t)e + col];
    __syncthreads();
    if (!may) continue;
#pragma unroll 4
    for (int j = 0; j < kBT; ++j) {
      const Uvt h = intersect(s_m, r, j);
      const float w = 1.f - h.u - h.v;
      const bool ou = s_eo[0][j] > 0.f;
      const bool ov = s_eo[1][j] > 0.f;
      const bool ow = s_eo[2][j] > 0.f;
      const float m_open =
          fminf(fminf(ou ? h.u : 1.f, ov ? h.v : 1.f), ow ? w : 1.f);
      const bool int_ok =
          fminf(fminf(ou ? 1.f : h.u, ov ? 1.f : h.v), ow ? 1.f : w) > 0.f;
      const bool in_t = h.wd_ok && h.t > 1e-6f && h.t < lim && int_ok;
      const float m = in_t ? m_open : kNoBlocker;
      const int ej = c * kBT + j;
      if (m > best_m || (m == best_m && m > -1e8f && ej < best_e)) {
        best_m = m;
        best_e = ej;
      }
    }
  }
  margin_out[ray] = best_m;
  eidx_out[ray] = best_e;
}

}  // namespace

// Launches on `stream`; does not synchronise. Returns cudaGetLastError()
// (0 = launched).
extern "C" int soft_occlusion(const void* o4, const void* d4,
                              const void* tmax, const void* bounds,
                              const void* mu, const void* mv, const void* mw,
                              const void* eo, void* margin, void* eidx, int n,
                              int e, void* stream) {
  if (n <= 0 || e <= 0 || n % kBN != 0 || e % kBT != 0) {
    return (int)cudaErrorInvalidValue;
  }
  soft_occlusion_kernel<<<n / kBN, kBN, 0, (cudaStream_t)stream>>>(
      (const float*)o4, (const float*)d4, (const float*)tmax,
      (const float*)bounds, (const float*)mu, (const float*)mv,
      (const float*)mw, (const float*)eo, (float*)margin, (int*)eidx, n, e);
  return (int)cudaGetLastError();
}
