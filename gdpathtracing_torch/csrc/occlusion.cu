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
// chunk. What the design does about it is to test fewer triangles: a ray
// tests a chunk only when its slab test against the chunk box passes with
// tmin < tlim, then each half only when the half's own box passes, and it
// stops at its first blocking triangle. The block walks the chunks in
// index order, one thread per ray; `__syncthreads_or` skips a chunk no ray
// of the block needs and ends the walk once every ray of the block is
// occluded or has nothing left to test (tlim <= 0). A needed chunk's
// mu/mv/mw (12 KB) is staged in shared memory as in kernel 1.

#include "trace_common.cuh"

namespace {

using namespace gdpt;

__global__ void __launch_bounds__(kBN)
occlusion_kernel(const float* __restrict__ o4, const float* __restrict__ d4,
                 const float* __restrict__ tlim,
                 const float* __restrict__ bounds,
                 const float* __restrict__ sub_bounds,
                 const float* __restrict__ mu, const float* __restrict__ mv,
                 const float* __restrict__ mw, int* __restrict__ occ_out,
                 int n, int e) {
  __shared__ ChunkRows s_m;

  const int nc = e / kBT;
  const int tid = threadIdx.x;
  const size_t ray = (size_t)blockIdx.x * kBN + tid;
  const Ray r = load_ray(o4, d4, (size_t)n, ray);
  const float lim = tlim[ray];
  const bool occ = walk_flat_any(s_m, r, lim, bounds, sub_bounds, nc, mu, mv,
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
