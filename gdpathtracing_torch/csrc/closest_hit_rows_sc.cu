// Two-level closest-hit rows kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel_rows_sc` + `_sweep_update`
// (gdpathtracing_tpu/ops/intersect_pallas.py:864 and :291, wrapper
// `_closest_hit_rows_sc` :918). Contract (ops/intersect.py
// closest_hit_rows_sc):
//
//   in   o4, d4       (4, N)       rays as (o, 1) and (d, 0); N % 256 == 0
//        sc_bounds    (8, nsc)     inflated superchunk AABBs
//        bounds       (8, nc)      inflated chunk AABBs, nc = nsc * scc
//        mu/mv/mw     (4, E)       unit-triangle-space rows, E = 256 * nc
//        tab          (40, E)      per-triangle winner table
//        scc                       chunks per superchunk
//   out               (48, N)      rows 0-39 the winner's table row (0 on
//                                  a miss), 40 t (1e9 on a miss), 41 u,
//                                  42 v, 43 w_d, 44 eidx, 45 triangles
//                                  swept by this ray, 46 superchunks its
//                                  block entered, 47 chunks its block
//                                  swept (not kernel 1's meaning of 46-47).
//
// The walk and the winner are kernel 3's (closest_hit_sc_lite.cu,
// trace_common.cuh walk_two_level); this kernel also keeps the winner's
// u, v and w_d and writes its 40 table rows once per ray at the end, so
// shading needs no gather. The TPU package takes it for superchunk scenes
// whose triangle rows exceed its VMEM budget (ops/intersect.py
// `_SC_RESIDENT_BYTES`).
//
// What bounds it on the H100: arithmetic, as kernel 3; bytes add the 40
// table rows of each winner and 48 floats a ray out (the n=14 grid's 8.63
// MiB of rows stay in the 50 MB L2). As in kernel 3, one thread per ray
// would spend most thread-slots on lanes whose ray does not need the
// staged chunk (on n=14 grid bounce rays, 92%). The design is kernel 3's
// block-cooperative walk: a warp per needing ray (a thread per ray where
// the needing warps are nearly full) and the rows double-buffered by
// cp.async; the winner's u, v and w_d stay in the lane that found it,
// which merges them into the ray's best. Launch bounds (256, 2): ptxas
// then allocates 80 registers, and 3 blocks of 256 still fit an SM (80 x
// 256 x 3 <= 65536 registers, 3 x 38 KB of shared memory); asked for 3
// blocks it allocates 72 and the kernel runs 1-2% slower (in turns on the
// H100, tools/two_level_turns.py).

#include "trace_common.cuh"

namespace {

using namespace gdpt;

__global__ void __launch_bounds__(kBN, 2)
closest_hit_rows_sc_kernel(const float* __restrict__ o4,
                           const float* __restrict__ d4,
                           const float* __restrict__ sc_bounds,
                           const float* __restrict__ bounds,
                           const float* __restrict__ mu,
                           const float* __restrict__ mv,
                           const float* __restrict__ mw,
                           const float* __restrict__ tab,
                           float* __restrict__ out, int n, int e, int scc) {
  __shared__ TwoLevelShared sh;

  const int nsc = e / (kBT * scc);
  const int tid = threadIdx.x;
  const size_t ray = (size_t)blockIdx.x * kBN + tid;
  const Ray r = load_ray(o4, d4, (size_t)n, ray);

  WalkCounts cnt{0.f, 0.f, 0.f};
  walk_two_level(sh, r, sc_bounds, nsc, bounds, scc, mu, mv, mw, (size_t)e,
                 tid, cnt);
  write_rows(out, tab, (size_t)n, (size_t)e, ray, two_level_best(sh, tid),
             cnt.steps, cnt.sc_entries, cnt.chunk_sweeps);
}

}  // namespace

// Launches on `stream`; does not synchronise. Returns cudaGetLastError()
// (0 = launched).
extern "C" int closest_hit_rows_sc(const void* o4, const void* d4,
                                   const void* sc_bounds, const void* bounds,
                                   const void* mu, const void* mv,
                                   const void* mw, const void* tab,
                                   void* out, int n, int e, int scc,
                                   void* stream) {
  if (n <= 0 || e <= 0 || scc <= 0 || n % kBN != 0 ||
      e % (kBT * scc) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  closest_hit_rows_sc_kernel<<<n / kBN, kBN, 0, (cudaStream_t)stream>>>(
      (const float*)o4, (const float*)d4, (const float*)sc_bounds,
      (const float*)bounds, (const float*)mu, (const float*)mv,
      (const float*)mw, (const float*)tab, (float*)out, n, e, scc);
  return (int)cudaGetLastError();
}
