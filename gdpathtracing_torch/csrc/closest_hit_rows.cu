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
// (~55 flops), and every ray of a block whose slab test passed sweeps all
// 256 triangles of the chunk; device-memory traffic is only the rays in,
// the 12 KB chunk rows per swept chunk and the 48 output rows.
// The design: one thread per ray and one block per 256 rays. The block walks
// the chunks in index order; `__syncthreads_or` skips a chunk no ray of the
// block needs, otherwise the block stages the chunk's mu/mv/mw (3 x 4 x 256
// f32 = 12 KB) in shared memory, where every thread reads the same
// triangle at once (a broadcast, no bank conflicts). The best hit stays in
// registers; the 40-row table gather happens once per ray at the end.
// The device code lives in trace_common.cuh, shared with kernels 2 and 4.

#include "trace_common.cuh"

namespace {

using namespace gdpt;

__global__ void __launch_bounds__(kBN)
closest_hit_rows_kernel(const float* __restrict__ o4,
                        const float* __restrict__ d4,
                        const float* __restrict__ bounds,
                        const float* __restrict__ mu,
                        const float* __restrict__ mv,
                        const float* __restrict__ mw,
                        const float* __restrict__ tab,
                        float* __restrict__ out, int n, int e) {
  __shared__ ChunkRows s_m;

  const int nc = e / kBT;
  const int tid = threadIdx.x;
  const size_t ray = (size_t)blockIdx.x * kBN + tid;
  const Ray r = load_ray(o4, d4, (size_t)n, ray);

  Best best = no_hit();
  float steps = 0.f, sweeps = 0.f;
  walk_flat_closest(s_m, r, bounds, nc, mu, mv, mw, (size_t)e, tid, best,
                    steps, sweeps);
  write_rows(out, tab, (size_t)n, (size_t)e, ray, best, steps, sweeps, 0.f);
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
