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
// What bounds it on the H100: arithmetic (six 4-term dot products, one
// IEEE division and the margin's selects per ray-triangle test). A maximum
// cannot resolve early, so every chunk whose soft-inflated box a ray
// enters is swept to the end. The design is the block-cooperative walk of
// the other traversal kernels (trace_common.cuh), with an arg-max:
//   - the chunks in index order, in groups of 32: each ray keeps the bits
//     of the group's chunks its gate passes, and a vote word per warp
//     names the candidates (coop_vote, coop_candidates). The gate reads no
//     best, so a ray's bits are exactly the chunks it needs;
//   - per candidate the block lists the k rays that need it (coop_ballot,
//     coop_list); warp w sweeps entries w, w + 8, ... a ray at a time
//     (soft_sweep_warp: lane l tests triangles l, l + 32, ..., l + 224,
//     five xor shuffles find the warp's largest (margin, then lowest
//     index), the lane that holds it merges it into the ray's best); where
//     the needing warps are more than 7/8 full (8k > 7 * 32 * those
//     warps), each needing ray's own thread sweeps all 256 triangles
//     (soft_sweep_thread). Both call soft_margin, and max and min are
//     order-free, so the two give the same bits;
//   - the rows (12 KB) and the openness flags (3 KB) of a chunk arrive by
//     cp.async into one of two buffers, the next candidate's while the
//     current one is swept;
//   - one barrier a candidate: as no gate reads a best, the ballot's
//     barrier also ends the last candidate's sweeps, merges and reads of
//     the buffer the next copy overwrites;
//   - launch bounds (256, 2): 96 registers, no spills. Under (256, 3) it
//     spills (80 registers) and measured the same in turns on the H100;
//     under (256, 4) it spills more and ran 5-24% slower (PERF.md §6).
// Built with -fmad=false, it equals the plain version (ops/intersect.py
// soft_occluded_plain) bit for bit.

#include "trace_common.cuh"

namespace {

using namespace gdpt;

constexpr float kNoBlocker = -1e9f;

// What the block shares (42 048 B of static shared memory): the staged
// rows and openness flags, double buffered; every ray's o, d, query tmax
// and best so far; two slots of per-warp vote words (CoopCursor).
struct SoftShared {
  ChunkRows rows[2];
  float eo[2][3][kBT];
  float4 o[kBN], d[kBN];
  float lim[kBN];
  float bm[kBN];
  int be[kBN];
  unsigned vote[2][kWarps];
};

typedef float EdgeFlags[3][kBT];

// Starts the copy of chunk c's rows and openness flags into buffer `buf`:
// each thread its column, without waiting.
__device__ __forceinline__ void stage_soft(
    SoftShared& sh, int buf, int c, const float* __restrict__ mu,
    const float* __restrict__ mv, const float* __restrict__ mw,
    const float* __restrict__ eo, size_t e, int tid) {
  stage_chunk_async(sh.rows[buf], mu, mv, mw, e, c, tid);
  const size_t col = (size_t)c * kBT + tid;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    cp_async4(&sh.eo[buf][k][tid], eo + k * e + col);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// The margin of triangle j of the staged chunk for ray `r` with query
// (1e-6, lim): the least barycentric coordinate over its open edges where
// the ray crosses its plane in the query inside every closed edge, else
// -1e9.
__device__ __forceinline__ float soft_margin(const ChunkRows& rows,
                                             const EdgeFlags& eo,
                                             const Ray& r, float lim, int j) {
  const Uvt h = intersect(rows, r, j);
  const float w = 1.f - h.u - h.v;
  const bool ou = eo[0][j] > 0.f;
  const bool ov = eo[1][j] > 0.f;
  const bool ow = eo[2][j] > 0.f;
  const float m_open =
      fminf(fminf(ou ? h.u : 1.f, ov ? h.v : 1.f), ow ? w : 1.f);
  const bool int_ok =
      fminf(fminf(ou ? 1.f : h.u, ov ? 1.f : h.v), ow ? 1.f : w) > 0.f;
  const bool in_t = h.wd_ok && h.t > 1e-6f && h.t < lim && int_ok;
  return in_t ? m_open : kNoBlocker;
}

// The ray's winner so far takes (m, e) where m is larger, or equal, above
// -1e8, with a lower e.
__device__ __forceinline__ bool soft_better(float m, int e, float best_m,
                                            int best_e) {
  return m > best_m || (m == best_m && m > -1e8f && e < best_e);
}

// The staged chunk whose first triangle is `base`, swept for this
// thread's own ray `r`, all 256 triangles in order.
__device__ __forceinline__ void soft_sweep_thread(SoftShared& sh,
                                                  const ChunkRows& rows,
                                                  const EdgeFlags& eo,
                                                  const Ray& r, float lim,
                                                  int base, int tid) {
  float best_m = sh.bm[tid];
  int best_e = sh.be[tid];
#pragma unroll 4
  for (int j = 0; j < kBT; ++j) {
    const float m = soft_margin(rows, eo, r, lim, j);
    if (soft_better(m, base + j, best_m, best_e)) {
      best_m = m;
      best_e = base + j;
    }
  }
  sh.bm[tid] = best_m;
  sh.be[tid] = best_e;
}

// The staged chunk whose first triangle is `base`, swept for ray `ray` by
// one warp: lane l tests triangles l, l + 32, ..., l + 224 and keeps its
// largest margin (the first of equal ones: the lowest index); five xor
// shuffles find the warp's largest (margin, then lowest index), the
// lexicographic maximum of the chunk, which the lane that found it merges.
__device__ __forceinline__ void soft_sweep_warp(SoftShared& sh,
                                                const ChunkRows& rows,
                                                const EdgeFlags& eo, int ray,
                                                int base, int lane) {
  const float4 o = sh.o[ray], d = sh.d[ray];
  const Ray r{o.x, o.y, o.z, o.w, d.x, d.y, d.z, d.w, 0.f, 0.f, 0.f};
  const float lim = sh.lim[ray];
  float m = kNoBlocker;
  int j = kBT;
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) {
    const float mq = soft_margin(rows, eo, r, lim, lane + 32 * q);
    if (mq > m) {
      m = mq;
      j = lane + 32 * q;
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const float om = __shfl_xor_sync(kFull, m, s);
    const int oj = __shfl_xor_sync(kFull, j, s);
    if (om > m || (om == m && oj < j)) {
      m = om;
      j = oj;
    }
  }
  // Every lane holds the warp's (m, j) now; lane j % 32 found it.
  if (lane == (j & 31) && soft_better(m, base + j, sh.bm[ray], sh.be[ray])) {
    sh.bm[ray] = m;
    sh.be[ray] = base + j;
  }
}

__global__ void __launch_bounds__(kBN, 2)
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
  __shared__ SoftShared sh;

  const int nc = e / kBT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t ray = (size_t)blockIdx.x * kBN + tid;
  const Ray r = load_ray(o4, d4, (size_t)n, ray);
  const float lim = tmax[ray];
  sh.o[tid] = make_float4(r.ox, r.oy, r.oz, r.ow);
  sh.d[tid] = make_float4(r.dx, r.dy, r.dz, r.dw);
  sh.lim[tid] = lim;
  sh.bm[tid] = kNoBlocker;
  sh.be[tid] = 0;
  CoopCursor cur{0, 0};
  for (int c0 = 0; c0 < nc; c0 += 32) {
    const int gn = min(32, nc - c0);
    unsigned bits = 0;  // this ray's gates over the group
    for (int j = 0; j < gn; ++j) {
      float tmin, tmx;
      slab(r, bounds, nc, c0 + j, tmin, tmx);
      if ((tmx >= tmin) && (tmx > 0.f) && (tmin < lim)) bits |= 1u << j;
    }
    coop_vote(sh.vote, cur, bits, lane, warp);
    __syncthreads();
    unsigned cand = coop_candidates(sh.vote, cur);
    if (cand == 0) continue;
    stage_soft(sh, cur.buf, c0 + __ffs(cand) - 1, mu, mv, mw, eo, (size_t)e,
               tid);
    while (cand != 0) {
      const int j = __ffs(cand) - 1;
      const int base = (c0 + j) * kBT;
      cand &= cand - 1;
      const bool needs = (bits >> j) & 1u;
      coop_ballot(sh.vote, cur, needs, lane, warp);
      // The ballots and the chunk's rows and flags; every sweep and merge
      // of the last candidate has ended.
      __syncthreads();
      int k, nw;
      const unsigned* need = coop_list(sh.vote, cur, k, nw);
      const int now = cur.buf;
      cur.buf ^= 1;
      if (cand != 0) {
        stage_soft(sh, cur.buf, c0 + __ffs(cand) - 1, mu, mv, mw, eo,
                   (size_t)e, tid);
      }
      if (8 * k > 7 * 32 * nw) {
        if (needs) {
          soft_sweep_thread(sh, sh.rows[now], sh.eo[now], r, lim, base, tid);
        }
      } else {
        for (int i = warp; i < k; i += kWarps) {
          soft_sweep_warp(sh, sh.rows[now], sh.eo[now],
                          needing_ray(need, i, lane), base, lane);
        }
      }
    }
  }
  __syncthreads();  // every merge
  margin_out[ray] = sh.bm[tid];
  eidx_out[ray] = sh.be[tid];
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
