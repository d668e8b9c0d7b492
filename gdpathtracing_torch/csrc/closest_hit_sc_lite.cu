// Two-level closest-hit kernel, (t, eidx) only, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel_sc_lite` + `_lite_sc_sweep`
// (gdpathtracing_tpu/ops/intersect_pallas.py:973 and :1022, wrapper
// `_closest_hit_sc_lite` :1065). Contract (ops/intersect.py
// closest_hit_sc_lite):
//
//   in   o4, d4       (4, N)       rays as (o, 1) and (d, 0); N % 256 == 0
//        sc_bounds    (8, nsc)     inflated superchunk AABBs, each around
//                                  the real chunks of scc consecutive ones
//        bounds       (8, nc)      inflated chunk AABBs, nc = nsc * scc;
//                                  pad chunks are point boxes at 1e30
//        mu/mv/mw     (4, E)       unit-triangle-space rows, E = 256 * nc
//        scc                       chunks per superchunk
//   out               (8, N)       0 t (1e9 on a miss), 1 eidx (exact in
//                                  f32), 2 triangles swept by this ray,
//                                  3 superchunks its block entered,
//                                  4-7 zero.
//
// Winner: the lowest (t, eidx) pair over the triangles whose superchunk
// and chunk both pass the ray's OWN slab test (tmax >= tmin, tmax > 0,
// tmin <= current best t), so the answer depends on neither visit order
// nor block (trace_common.cuh walk_two_level).
//
// What bounds it on the H100: arithmetic. Each needed (ray, triangle) test
// is six 4-term dot products, one IEEE division and the edge tests; each
// ray also slab-tests every superchunk and the chunks of those it enters.
// Device memory carries the rays in, the 12 KB rows of each chunk a block
// stages, and 8 floats a ray out.
// The design, kept simple: one thread per ray, 256-ray blocks, superchunks
// and their chunks in index order. `__syncthreads_or` skips a superchunk
// no ray of the block enters, then a chunk no ray of it needs; a needed
// chunk is staged in shared memory (every thread reads the same triangle
// at once, a broadcast) and swept with the closest-hit sweep of kernel 1.
// What the TPU kernel needed only on the TPU is left out: the per-block
// near-to-far superchunk queue, its sentinel decode, the static unroll and
// the VMEM-resident triangle rows.

#include "trace_common.cuh"

namespace {

using namespace gdpt;

constexpr int kLiteR = 8;  // output rows

__global__ void __launch_bounds__(kBN)
closest_hit_sc_lite_kernel(const float* __restrict__ o4,
                           const float* __restrict__ d4,
                           const float* __restrict__ sc_bounds,
                           const float* __restrict__ bounds,
                           const float* __restrict__ mu,
                           const float* __restrict__ mv,
                           const float* __restrict__ mw,
                           float* __restrict__ out, int n, int e, int scc) {
  __shared__ ChunkRows s_m;

  const int nsc = e / (kBT * scc);
  const int tid = threadIdx.x;
  const size_t ray = (size_t)blockIdx.x * kBN + tid;
  const Ray r = load_ray(o4, d4, (size_t)n, ray);

  Best best = no_hit();
  WalkCounts cnt{0.f, 0.f, 0.f};
  walk_two_level(s_m, r, sc_bounds, nsc, bounds, scc, mu, mv, mw, (size_t)e,
                 tid, best, cnt);

  const size_t nn = (size_t)n;
  out[ray] = best.t;
  out[nn + ray] = (float)best.e;
  out[2 * nn + ray] = cnt.steps;
  out[3 * nn + ray] = cnt.sc_entries;
  for (int k = 4; k < kLiteR; ++k) out[k * nn + ray] = 0.f;
}

}  // namespace

// Launches on `stream`; does not synchronise. Returns cudaGetLastError()
// (0 = launched).
extern "C" int closest_hit_sc_lite(const void* o4, const void* d4,
                                   const void* sc_bounds, const void* bounds,
                                   const void* mu, const void* mv,
                                   const void* mw, void* out, int n, int e,
                                   int scc, void* stream) {
  if (n <= 0 || e <= 0 || scc <= 0 || n % kBN != 0 ||
      e % (kBT * scc) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  closest_hit_sc_lite_kernel<<<n / kBN, kBN, 0, (cudaStream_t)stream>>>(
      (const float*)o4, (const float*)d4, (const float*)sc_bounds,
      (const float*)bounds, (const float*)mu, (const float*)mv,
      (const float*)mw, (float*)out, n, e, scc);
  return (int)cudaGetLastError();
}
