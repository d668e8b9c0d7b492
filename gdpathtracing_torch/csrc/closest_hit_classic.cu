// The classic flat closest-hit kernels, (t, idx) only, for Hopper (sm_90a):
// two entry points over one walk.
//
// closest_hit_classic replaces the TPU kernel `_kernel` (gdpathtracing_tpu/
// ops/intersect_pallas.py:52, wrapper `_closest_hit` :122), the kernel
// behind `trace_pallas_classic`; closest_hit_loop replaces `_kernel_loop`
// (intersect_pallas.py:2047, wrapper `_closest_hit_loop` :2061), which
// sweeps the chunks with FUSED's in-kernel loop `_sweep` (fused_pallas.py:
// 79). Contract of both (ops/intersect.py closest_hit_classic and
// closest_hit_loop):
//
//   in   o4, d4       (4, N)       rays as (o, 1) and (d, 0); N % 256 == 0
//        bounds       (8, nc)      the RAW chunk AABBs (isect_chunk_bounds,
//                                  not inflated)
//        mu/mv/mw     (4, E)       unit-triangle-space rows, E = 256 * nc
//   out  t            (N,) f32     1e9 on a miss
//        idx          (N,) int32   the winner's expanded-triangle index,
//                                  0 on a miss
//
// Chunks in index order; a ray's gate on chunk c is its slab test against
// the raw box with a STRICT tmin < its best t (tmax >= tmin, tmax > 0).
// The two kernels differ only in who sweeps a chunk, as their TPU
// counterparts do:
//   - closest_hit_classic: the rays whose own gate passes (the block skips
//     the chunk when none does);
//   - closest_hit_loop: every ray of the 256-ray block, once any ray's
//     gate passes, whether or not its own did. Its answer can depend on
//     how rays are packed into blocks.
// Within a chunk the lowest t wins, ties to the lowest index; across
// chunks a strictly lower t replaces the best, so an earlier chunk keeps
// a tie (argmin per chunk, then a strict <). t is taken with 4-term dot
// products summed left to right (trace_common.cuh intersect), which is
// the TPU loop kernel's broadcast form; the TPU kernel 8 used a K=4
// matmul, which may sum in another order.
//
// What bounds it on the H100: arithmetic. Each (ray, triangle) test of a
// swept chunk is six 4-term dot products, one IEEE division and the edge
// tests, plus one slab test per ray and chunk. Device memory carries the
// rays in, the 12 KB rows of each chunk a block stages, and 8 bytes a ray
// out.
// The design, kept simple: one thread per ray, 256-ray blocks, chunks in
// index order; `__syncthreads_or` skips a chunk no ray of the block needs,
// a needed chunk is staged in shared memory (every thread reads the same
// triangle at once, a broadcast) and swept by one thread per ray.

#include "trace_common.cuh"

namespace {

using namespace gdpt;

template <bool kBlockGate>
__device__ __forceinline__ void classic_walk(
    const float* __restrict__ o4, const float* __restrict__ d4,
    const float* __restrict__ bounds, const float* __restrict__ mu,
    const float* __restrict__ mv, const float* __restrict__ mw,
    float* __restrict__ t_out, int* __restrict__ idx_out, int n, int e) {
  __shared__ ChunkRows s_m;

  const int nc = e / kBT;
  const int tid = threadIdx.x;
  const size_t ray = (size_t)blockIdx.x * kBN + tid;
  const Ray r = load_ray(o4, d4, (size_t)n, ray);

  float best_t = kMiss;
  int best_i = 0;
  for (int c = 0; c < nc; ++c) {
    float tmin, tmax;
    slab(r, bounds, nc, c, tmin, tmax);
    const bool may = (tmax >= tmin) && (tmax > 0.f) && (tmin < best_t);
    // Also the barrier that ends every read of the previous chunk's rows.
    if (!__syncthreads_or(may)) continue;
    stage_chunk(s_m, mu, mv, mw, (size_t)e, c, tid);
    __syncthreads();
    if (!kBlockGate && !may) continue;
    float tk = kMiss;
    int k = 0;
#pragma unroll 4
    for (int j = 0; j < kBT; ++j) {
      const Uvt h = intersect(s_m, r, j);
      const bool valid = h.wd_ok && (h.t > 0.f) && (h.u >= 0.f) &&
                         (h.v >= 0.f) && (h.u + h.v <= 1.f);
      if (valid && h.t < tk) {
        tk = h.t;
        k = j;
      }
    }
    if (tk < best_t) {
      best_t = tk;
      best_i = c * kBT + k;
    }
  }
  t_out[ray] = best_t;
  idx_out[ray] = best_i;
}

__global__ void __launch_bounds__(kBN)
closest_hit_classic_kernel(const float* __restrict__ o4,
                           const float* __restrict__ d4,
                           const float* __restrict__ bounds,
                           const float* __restrict__ mu,
                           const float* __restrict__ mv,
                           const float* __restrict__ mw,
                           float* __restrict__ t_out,
                           int* __restrict__ idx_out, int n, int e) {
  classic_walk<false>(o4, d4, bounds, mu, mv, mw, t_out, idx_out, n, e);
}

__global__ void __launch_bounds__(kBN)
closest_hit_loop_kernel(const float* __restrict__ o4,
                        const float* __restrict__ d4,
                        const float* __restrict__ bounds,
                        const float* __restrict__ mu,
                        const float* __restrict__ mv,
                        const float* __restrict__ mw,
                        float* __restrict__ t_out, int* __restrict__ idx_out,
                        int n, int e) {
  classic_walk<true>(o4, d4, bounds, mu, mv, mw, t_out, idx_out, n, e);
}

bool bad_shape(int n, int e) {
  return n <= 0 || e <= 0 || n % kBN != 0 || e % kBT != 0;
}

}  // namespace

// Both launch on `stream` and do not synchronise. Each returns
// cudaGetLastError() (0 = launched).
extern "C" int closest_hit_classic(const void* o4, const void* d4,
                                   const void* bounds, const void* mu,
                                   const void* mv, const void* mw,
                                   void* t_out, void* idx_out, int n, int e,
                                   void* stream) {
  if (bad_shape(n, e)) return (int)cudaErrorInvalidValue;
  closest_hit_classic_kernel<<<n / kBN, kBN, 0, (cudaStream_t)stream>>>(
      (const float*)o4, (const float*)d4, (const float*)bounds,
      (const float*)mu, (const float*)mv, (const float*)mw, (float*)t_out,
      (int*)idx_out, n, e);
  return (int)cudaGetLastError();
}

extern "C" int closest_hit_loop(const void* o4, const void* d4,
                                const void* bounds, const void* mu,
                                const void* mv, const void* mw, void* t_out,
                                void* idx_out, int n, int e, void* stream) {
  if (bad_shape(n, e)) return (int)cudaErrorInvalidValue;
  closest_hit_loop_kernel<<<n / kBN, kBN, 0, (cudaStream_t)stream>>>(
      (const float*)o4, (const float*)d4, (const float*)bounds,
      (const float*)mu, (const float*)mv, (const float*)mw, (float*)t_out,
      (int*)idx_out, n, e);
  return (int)cudaGetLastError();
}
