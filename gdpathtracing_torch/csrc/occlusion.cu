// Occlusion (any-hit) kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `_occlusion_kernel`
// (gdpathtracing_tpu/ops/intersect_pallas.py:1662, wrapper `_occlusion`
// :1737, `occluded_pallas` :1774). Contract (ops/intersect.py occluded):
//
//   in   o4, d4      (4, N)      shadow rays as (o, 1) and (d, 0);
//                                N % 256 == 0
//        tlim        (N,)        the query is (0, tlim); 0 for parked rays
//        bounds      (8, nc)     inflated chunk AABBs
//        sub_bounds  (8, 2 nc)   inflated AABBs of each chunk's two
//                                128-triangle halves
//        mu/mv/mw    (4, E)      unit-triangle-space rows, E = 256 * nc
//   out  occ         (N,) i32    1 where a triangle is hit in (0, tlim)
//
// The answer is an OR over every triangle the ray's own (conservative)
// gates let it test, so it does not depend on visit order or on which
// rays share a block: it equals the TPU kernel's up to float ties.
//
// What bounds it on the H100: arithmetic, as for kernel 1 (six 4-term dot
// products and one IEEE division per ray-triangle test, ~55 flops); the
// bytes are the rays in, one int out and 12 KB of chunk rows per swept
// chunk. A ray tests a chunk only when its slab test against the chunk box
// passes with tmin < tlim, then each half only when the half's own box
// passes, and it stops at its first blocking half. What kept a walk with
// one thread per ray far from that bound is the mapping: a staged chunk
// is swept by the few threads whose ray needs it while their warps' other
// lanes idle, and each chunk is a synchronous copy between barriers.
// The design: the block-cooperative any-hit walk of trace_common.cuh
// (walk_any_coop), chunks in index order. The block votes on groups of 32
// chunks, lists for each candidate the rays that need one of its halves,
// and a warp tests each listed ray, a lane per 4 of a half's 128
// triangles, `__any_sync` ending the query at the first half that blocks;
// the rows arrive by cp.async into a double buffer, the next candidate's
// while the current one is swept, and the block stops once no ray of it is
// unresolved. 35 KB of shared memory a block, at most 64 registers: 4
// blocks an SM (3 measured no faster).

#include "trace_common.cuh"

namespace {

using namespace gdpt;

__global__ void __launch_bounds__(kBN, 4)
occlusion_kernel(const float* __restrict__ o4, const float* __restrict__ d4,
                 const float* __restrict__ tlim,
                 const float* __restrict__ bounds,
                 const float* __restrict__ sub_bounds,
                 const float* __restrict__ mu, const float* __restrict__ mv,
                 const float* __restrict__ mw, int* __restrict__ occ_out,
                 int n, int e) {
  __shared__ AnyHitShared sh;

  const int nc = e / kBT;
  const int tid = threadIdx.x;
  const size_t ray = (size_t)blockIdx.x * kBN + tid;
  const Ray r = load_ray(o4, d4, (size_t)n, ray);
  const float lim = tlim[ray];
  const bool occ = walk_any_coop(sh, r, lim, bounds, sub_bounds, nc, mu, mv,
                                 mw, (size_t)e, tid);
  occ_out[ray] = occ ? 1 : 0;
}

}  // namespace

// Launches on `stream`; does not synchronise. Returns cudaGetLastError()
// (0 = launched).
extern "C" int occlusion(const void* o4, const void* d4, const void* tlim,
                         const void* bounds, const void* sub_bounds,
                         const void* mu, const void* mv, const void* mw,
                         void* occ, int n, int e, void* stream) {
  if (n <= 0 || e <= 0 || n % kBN != 0 || e % kBT != 0) {
    return (int)cudaErrorInvalidValue;
  }
  occlusion_kernel<<<n / kBN, kBN, 0, (cudaStream_t)stream>>>(
      (const float*)o4, (const float*)d4, (const float*)tlim,
      (const float*)bounds, (const float*)sub_bounds, (const float*)mu,
      (const float*)mv, (const float*)mw, (int*)occ, n, e);
  return (int)cudaGetLastError();
}
