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
//        group_bounds (8, 8 nc)    inflated AABBs of each chunk's eight
//                                  32-triangle groups (column 8c + q:
//                                  triangles 256c + 32q .. + 31); a group
//                                  with no real triangle is a point box
//                                  at 1e30
//        mu/mv/mw     (4, E)       unit-triangle-space rows, E = 256 * nc
//        scc                       chunks per superchunk
//   out               (8, N)       0 t (1e9 on a miss), 1 eidx (exact in
//                                  f32), 2 triangles of the chunks whose
//                                  gates this ray passes (256 a chunk),
//                                  3 superchunks its block entered,
//                                  4-7 zero.
//
// Winner: the lowest (t, eidx) pair over the triangles whose superchunk
// and chunk both pass the ray's OWN slab test (tmax >= tmin, tmax > 0,
// tmin <= current best t), so the answer depends on neither visit order
// nor block (trace_common.cuh walk_two_level). Row 2 counts those chunk
// gates, as the plain version and the TPU kernel do, and not the tests the
// kernel runs: inside a chunk whose gate passes, the ray sweeps only the
// groups whose own box passes the same test (the group gate). The group
// gate is exact: the boxes are inflated (ops/intersect.py
// _inflate_bounds), so a triangle whose hit the sweep would find lies in
// its group's box and the ray's slab test of that box passes with tmin at
// most the hit's t; a group it fails holds no triangle that wins or ties.
// The plain version ignores group_bounds, so kernel == plain on real rays
// is the check of that argument.
//
// What bounds it on the H100: arithmetic. Each (ray, triangle) test it
// runs is six 4-term dot products, one IEEE division and the edge tests
// (32 a group swept); each ray also slab-tests every superchunk, the
// chunks of those it enters and the 8 groups of each chunk whose gate it
// passes (chip_smoke.py counts these from the plain walk's group count,
// ops/intersect.py walk_two_level_plain). On the grid the groups keep
// ~1/6 of the 256-triangle chunk sweeps' tests. Device memory carries the
// rays in, the 12 KB rows of each chunk a block stages (the grid's 4.41
// MiB stay in the 50 MB L2), 8 group boxes a chunk gate, and 8 floats a
// ray out. What keeps a walk with one thread per ray far from that bound is
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
// while the current one is swept. A lane's 8 tests, one a group, are
// unrolled, and the warp skips a group its ray's mask leaves out (the
// same for all its lanes). That takes more than 64 registers: 3 blocks of
// 256 an SM, 38 KB of shared memory each, and 256 B of group masks.
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
                           const float* __restrict__ group_bounds,
                           const float* __restrict__ mu,
                           const float* __restrict__ mv,
                           const float* __restrict__ mw,
                           float* __restrict__ out, int n, int e, int scc) {
  __shared__ TwoLevelShared sh;
  __shared__ unsigned char groups[kBN];  // each ray's group mask

  const int nsc = e / (kBT * scc);
  const int tid = threadIdx.x;
  const size_t ray = (size_t)blockIdx.x * kBN + tid;
  const Ray r = load_ray(o4, d4, (size_t)n, ray);

  WalkCounts cnt{0.f, 0.f, 0.f};
  walk_two_level<true>(sh, r, sc_bounds, nsc, bounds, scc, mu, mv, mw,
                       (size_t)e, tid, cnt, group_bounds, groups);
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
                                   const void* group_bounds, const void* mu,
                                   const void* mv, const void* mw, void* out,
                                   int n, int e, int scc, void* stream) {
  if (n <= 0 || e <= 0 || scc <= 0 || n % kBN != 0 ||
      e % (kBT * scc) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  closest_hit_sc_lite_kernel<<<n / kBN, kBN, 0, (cudaStream_t)stream>>>(
      (const float*)o4, (const float*)d4, (const float*)sc_bounds,
      (const float*)bounds, (const float*)group_bounds, (const float*)mu,
      (const float*)mv, (const float*)mw, (float*)out, n, e, scc);
  return (int)cudaGetLastError();
}
