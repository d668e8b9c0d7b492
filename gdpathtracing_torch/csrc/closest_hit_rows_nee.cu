// Fused closest-hit rows + occlusion kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel_rows_nee`
// (gdpathtracing_tpu/ops/intersect_pallas.py:613, wrapper
// `_closest_hit_rows_nee` :712, `trace_occlude_pallas` :773). Contract
// (ops/intersect.py closest_hit_rows_nee):
//
//   in   o4, d4      (4, N)      bounce rays (phase A), N % 256 == 0
//        so4, sd4    (4, N)      the previous bounce's shadow rays (phase B)
//        stmax       (N,)        shadow query (0, stmax); 0 when parked
//        bounds      (8, nc)     inflated chunk AABBs
//        sub_bounds  (8, 2 nc)   inflated sub-chunk AABBs
//        mu/mv/mw    (4, E)      unit-triangle-space rows
//        tab         (40, E)     winner table
//   out  rows        (48, N)     kernel 1's rows for the bounce rays, with
//                                46 the chunks the block swept for phase A
//                                and 47 those it swept for phase B
//        occ         (N,) i32    kernel 2's answer for the shadow rays
//
// Ray i of the block is bounce ray i and shadow ray i. The block runs
// kernel 1's walk on the bounce rays and then kernel 2's on the shadow
// rays, both block-cooperative (trace_common.cuh walk_flat_coop, then
// walk_any_coop): both answers, and rows 45 and 46, are those of kernels 1
// and 2 run apart, bit for bit. Row 47 counts the chunks on which some
// still unresolved shadow ray of the block passes its chunk gate
// (walk_any_coop's counting variant), as the thread-per-ray form of this
// kernel counted its shadow sweeps.
//
// What bounds it on the H100: arithmetic, as for kernels 1 and 2 (the
// ray-triangle tests of both walks); bytes are the two ray sets in and the
// rows and flags out. The design: a thread per ray would sweep each chunk
// some ray of the block needs with every lane, and leave idle the lanes
// whose ray does not need it (0.30 of the thread-slots useful on a demo
// bounce-1 tile, kernel 1 before its redesign). The cooperative walks list
// each chunk's needing rays and sweep them a warp per ray, the rows
// double-buffered by cp.async. What the single launch keeps is the launch
// itself: the two walks no longer share the chunk loads, but the demo's 8
// chunks (96 KB of rows) stay in L2. A merged walk (one vote and two
// ballots per candidate) would share them, at the price of a third walk
// in trace_common.cuh to keep bit-equal to the other two, one whose
// barriers wait on both ray sets at once; the two walks in sequence reuse
// what kernels 1 and 2 already run. Their shared blocks overlay each
// other (NeeShared, 37 952 B): each thread reads its winner out of the
// closest walk's block before the barrier after which the any-hit walk
// writes its own. Launch bounds (256, 3): 79 registers, no spills, 3
// blocks an SM; (256, 2) takes 82 and 11% more time, (256, 4) 64 with 8 B
// of spill stores and 9% more (in turns on the H100,
// tools/two_level_turns.py).

#include "trace_common.cuh"

namespace {

using namespace gdpt;

__global__ void __launch_bounds__(kBN, 3)
closest_hit_rows_nee_kernel(
    const float* __restrict__ o4, const float* __restrict__ d4,
    const float* __restrict__ so4, const float* __restrict__ sd4,
    const float* __restrict__ stmax, const float* __restrict__ bounds,
    const float* __restrict__ sub_bounds, const float* __restrict__ mu,
    const float* __restrict__ mv, const float* __restrict__ mw,
    const float* __restrict__ tab, float* __restrict__ out,
    int* __restrict__ occ_out, int n, int e) {
  __shared__ NeeShared sh;

  const int nc = e / kBT;
  const int tid = threadIdx.x;
  const size_t ray = (size_t)blockIdx.x * kBN + tid;

  // Phase A: the bounce rays' closest hit.
  CoopCursor cur{0, 0};
  WalkCounts cnt{0.f, 0.f, 0.f};
  walk_flat_coop(sh.closest, load_ray(o4, d4, (size_t)n, ray), true, bounds,
                 nc, mu, mv, mw, (size_t)e, tid, cur, cnt);
  const Best best = two_level_best(sh.closest, tid);
  __syncthreads();  // every winner read: the any-hit walk may write `any`

  // Phase B: the shadow rays' any-hit; parked rays carry stmax = 0.
  float sweeps_b = 0.f;
  const bool occ = walk_any_coop<true>(
      sh.any, load_ray(so4, sd4, (size_t)n, ray), stmax[ray], bounds,
      sub_bounds, nc, mu, mv, mw, (size_t)e, tid, &sweeps_b);
  write_rows(out, tab, (size_t)n, (size_t)e, ray, best, cnt.steps,
             cnt.chunk_sweeps, sweeps_b);
  occ_out[ray] = occ ? 1 : 0;
}

}  // namespace

// Launches on `stream`; does not synchronise. Returns cudaGetLastError()
// (0 = launched).
extern "C" int closest_hit_rows_nee(const void* o4, const void* d4,
                                    const void* so4, const void* sd4,
                                    const void* stmax, const void* bounds,
                                    const void* sub_bounds, const void* mu,
                                    const void* mv, const void* mw,
                                    const void* tab, void* out, void* occ,
                                    int n, int e, void* stream) {
  if (n <= 0 || e <= 0 || n % kBN != 0 || e % kBT != 0) {
    return (int)cudaErrorInvalidValue;
  }
  closest_hit_rows_nee_kernel<<<n / kBN, kBN, 0, (cudaStream_t)stream>>>(
      (const float*)o4, (const float*)d4, (const float*)so4,
      (const float*)sd4, (const float*)stmax, (const float*)bounds,
      (const float*)sub_bounds, (const float*)mu, (const float*)mv,
      (const float*)mw, (const float*)tab, (float*)out, (int*)occ, n, e);
  return (int)cudaGetLastError();
}
