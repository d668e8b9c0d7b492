// Closest-hit rows kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel_rows` + `_sweep_update`
// (gdpathtracing_tpu/ops/intersect_pallas.py:520 and :291, wrapper
// `_closest_hit_rows` :560). Contract (ops/intersect.py closest_hit_rows):
//
//   in   o4, d4  (4, N)   rays as (o, 1) and (d, 0); N % 256 == 0
//        bounds  (8, nc)  inflated chunk AABBs [min3 | max3 | pad2]
//        mu/mv/mw (4, E)  unit-triangle-space rows, E = 256 * nc
//        tab     (40, E)  per-triangle winner table (build_trace_table)
//   out          (48, N)  rows 0-39 winner's table row (0 on a miss),
//                         40 t (1e9 on a miss), 41 u, 42 v, 43 w_d,
//                         44 eidx, 45 triangles swept by this ray,
//                         46 chunks swept by this ray's block, 47 zero.
//
// Winner: the lowest (t, eidx) pair over every triangle whose chunk passes
// the ray's OWN slab test against the inflated box (tmax >= tmin,
// tmax > 0, tmin <= current best t). That gate makes the result
// independent of chunk visit order and of which rays share a block.
//
// What bounds it on the H100: arithmetic. Each swept (ray, triangle) pair
// costs six 4-term dot products, one IEEE division and the edge tests
// (~45 operations), and each ray sweeps the 256 triangles of every chunk
// whose slab test it passes; device-memory traffic is only the rays in,
// the 12 KB chunk rows per swept chunk and the 48 output rows.
// The design: the block-cooperative flat walk (trace_common.cuh
// walk_flat_coop), one block per 256 rays. A thread per ray would leave
// every lane whose ray does not need a staged chunk idle while the others
// sweep it (30% of the thread-slots useful on a demo tile's bounce-1
// rays). Instead the block votes on the chunks in groups of 32, lists for
// each candidate chunk the rays that need it, and sweeps it a warp per
// listed ray (a lane per 8 triangles, a shuffle reduction to the lowest
// (t, eidx)), or by the rays' own threads where the needing warps are
// nearly full; the rows arrive by cp.async into a double buffer. Each
// ray's best lives in shared memory during the walk; the 40-row table
// gather happens once per ray at the end. Launch bounds (256, 3): 72
// registers and 38 KB of shared memory, 3 blocks an SM; (256, 2) gives
// the same 72, (256, 4) 64 and 5-7% more time, and warp sweeps alone
// without the thread path 12-13% more (in turns on the H100,
// tools/two_level_turns.py).

#include "trace_common.cuh"

namespace {

using namespace gdpt;

__global__ void __launch_bounds__(kBN, 3)
closest_hit_rows_kernel(const float* __restrict__ o4,
                        const float* __restrict__ d4,
                        const float* __restrict__ bounds,
                        const float* __restrict__ mu,
                        const float* __restrict__ mv,
                        const float* __restrict__ mw,
                        const float* __restrict__ tab,
                        float* __restrict__ out, int n, int e) {
  __shared__ TwoLevelShared sh;

  const int nc = e / kBT;
  const int tid = threadIdx.x;
  const size_t ray = (size_t)blockIdx.x * kBN + tid;
  const Ray r = load_ray(o4, d4, (size_t)n, ray);

  CoopCursor cur{0, 0};
  WalkCounts cnt{0.f, 0.f, 0.f};
  walk_flat_coop(sh, r, true, bounds, nc, mu, mv, mw, (size_t)e, tid, cur,
                 cnt);
  write_rows(out, tab, (size_t)n, (size_t)e, ray, two_level_best(sh, tid),
             cnt.steps, cnt.chunk_sweeps, 0.f);
}

}  // namespace

// Launches on `stream`; does not synchronise. Returns cudaGetLastError()
// (0 = launched).
extern "C" int closest_hit_rows(const void* o4, const void* d4,
                                const void* bounds, const void* mu,
                                const void* mv, const void* mw,
                                const void* tab, void* out, int n, int e,
                                void* stream) {
  if (n <= 0 || e <= 0 || n % kBN != 0 || e % kBT != 0) {
    return (int)cudaErrorInvalidValue;
  }
  closest_hit_rows_kernel<<<n / kBN, kBN, 0, (cudaStream_t)stream>>>(
      (const float*)o4, (const float*)d4, (const float*)bounds,
      (const float*)mu, (const float*)mv, (const float*)mw,
      (const float*)tab, (float*)out, n, e);
  return (int)cudaGetLastError();
}
