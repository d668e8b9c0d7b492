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
// Thread i carries bounce ray i through kernel 1's loop body and shadow
// ray i through kernel 2's, over one walk of the chunks: a block stages a
// chunk (12 KB of shared memory) when any of its rays needs it for either
// phase, so the two phases share the chunk loads and the launch. Both
// answers are those of kernels 1 and 2 run apart, bit for bit.
//
// What bounds it on the H100: arithmetic, as for kernels 1 and 2 (the
// ray-triangle tests of both phases); bytes are the two ray sets in and
// the rows and flags out. The design keeps each phase's per-ray gates, so
// it tests exactly what kernels 1 and 2 would; what it saves is one launch
// and the chunk loads the phases share.

#include "trace_common.cuh"

namespace {

using namespace gdpt;

__global__ void __launch_bounds__(kBN)
closest_hit_rows_nee_kernel(
    const float* __restrict__ o4, const float* __restrict__ d4,
    const float* __restrict__ so4, const float* __restrict__ sd4,
    const float* __restrict__ stmax, const float* __restrict__ bounds,
    const float* __restrict__ sub_bounds, const float* __restrict__ mu,
    const float* __restrict__ mv, const float* __restrict__ mw,
    const float* __restrict__ tab, float* __restrict__ out,
    int* __restrict__ occ_out, int n, int e) {
  __shared__ ChunkRows s_m;

  const int nc = e / kBT;
  const int tid = threadIdx.x;
  const size_t ray = (size_t)blockIdx.x * kBN + tid;
  const Ray a = load_ray(o4, d4, (size_t)n, ray);
  const Ray b = load_ray(so4, sd4, (size_t)n, ray);
  const float lim = stmax[ray];

  Best best = no_hit();
  float steps = 0.f, sweeps_a = 0.f, sweeps_b = 0.f;
  bool occ = false;

  for (int c = 0; c < nc; ++c) {
    float tmin, tmax;
    slab(a, bounds, nc, c, tmin, tmax);
    const bool may_a = (tmax >= tmin) && (tmax > 0.f) && (tmin <= best.t);
    slab(b, bounds, nc, c, tmin, tmax);
    const bool may_b =
        !occ && (tmax >= tmin) && (tmax > 0.f) && (tmin < lim);

    // The first is also the barrier that ends every read of the previous
    // chunk's rows.
    const bool any_a = __syncthreads_or(may_a);
    const bool any_b = __syncthreads_or(may_b);
    if (!any_a && !any_b) continue;
    stage_chunk(s_m, mu, mv, mw, (size_t)e, c, tid);
    __syncthreads();
    if (any_a) sweeps_a += 1.f;
    if (any_b) sweeps_b += 1.f;
    if (may_a) {
      steps += (float)kBT;
      sweep_closest(s_m, a, c * kBT, best);
    }
    if (may_b) occ = occlude_chunk(s_m, b, lim, sub_bounds, kSub * nc, c);
  }
  write_rows(out, tab, (size_t)n, (size_t)e, ray, best, steps, sweeps_a,
             sweeps_b);
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
