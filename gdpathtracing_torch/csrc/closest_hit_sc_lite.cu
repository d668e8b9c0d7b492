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
// stages (the grid's 4.41 MiB stay in the 50 MB L2), and 8 floats a ray
// out. What keeps a walk with one thread per ray far from that bound is
// the mapping: a warp with one needing lane runs all 256 triangles while
// its other lanes idle (on grid bounce rays a tenth of the thread-slots
// do a needed test), and each staged chunk is a synchronous copy between
// two barriers.
// The design: the block-cooperative walk of trace_common.cuh
// (walk_two_level). The visit order, the gates and the counts are those
// of one thread per ray; for each chunk the block lists the rays that
// need it, and a warp sweeps each listed ray, a lane per 8 of the 256
// triangles, with a shuffle reduction to the lowest (t, eidx); where the
// needing warps are nearly full the ray's own thread sweeps instead. The
// rows arrive by cp.async into a double buffer, the next candidate chunk
// while the current one is swept. A lane's 8 tests are unrolled, which
// takes more than 64 registers: 3 blocks of 256 an SM, 38 KB of shared
// memory each.
// What the TPU kernel needed only on the TPU is left out: the per-block
// near-to-far superchunk queue, its sentinel decode, the static unroll and
// the VMEM-resident triangle rows.

#include "trace_common.cuh"

namespace {

using namespace gdpt;

constexpr int kLiteR = 8;  // output rows

__global__ void __launch_bounds__(kBN, 3)
closest_hit_sc_lite_kernel(const float* __restrict__ o4,
                           const float* __restrict__ d4,
                           const float* __restrict__ sc_bounds,
                           const float* __restrict__ bounds,
                           const float* __restrict__ mu,
                           const float* __restrict__ mv,
                           const float* __restrict__ mw,
                           float* __restrict__ out, int n, int e, int scc) {
  __shared__ TwoLevelShared sh;

  const int nsc = e / (kBT * scc);
  const int tid = threadIdx.x;
  const size_t ray = (size_t)blockIdx.x * kBN + tid;
  const Ray r = load_ray(o4, d4, (size_t)n, ray);

  WalkCounts cnt{0.f, 0.f, 0.f};
  walk_two_level(sh, r, sc_bounds, nsc, bounds, scc, mu, mv, mw, (size_t)e,
                 tid, cnt);
  const Best best = two_level_best(sh, tid);

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
