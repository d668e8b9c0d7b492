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
//
// Numerics: build with -fmad=false and without --use_fast_math. Every
// product and sum is then rounded on its own, in the same order as the
// plain PyTorch version (intersect.py closest_hit_rows_plain), and the
// division is IEEE, so the two agree bit for bit on t and eidx.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kBN = 256;     // rays per block (one thread per ray)
constexpr int kBT = 256;     // triangles per chunk
constexpr int kTabR = 40;    // table rows
constexpr float kMiss = 1e9f;
constexpr float kWdEps = 1e-12f;

__device__ __forceinline__ float rcp_guarded(float d) {
  return 1.0f / (fabsf(d) < 1e-30f ? 1e-30f : d);
}

__device__ __forceinline__ float dot4(float a0, float a1, float a2, float a3,
                                      float b0, float b1, float b2,
                                      float b3) {
  return a0 * b0 + a1 * b1 + a2 * b2 + a3 * b3;
}

__global__ void __launch_bounds__(kBN)
closest_hit_rows_kernel(const float* __restrict__ o4,
                        const float* __restrict__ d4,
                        const float* __restrict__ bounds,
                        const float* __restrict__ mu,
                        const float* __restrict__ mv,
                        const float* __restrict__ mw,
                        const float* __restrict__ tab,
                        float* __restrict__ out, int n, int e) {
  // Rows 0-3 mu, 4-7 mv, 8-11 mw of the chunk being swept.
  __shared__ float s_m[12][kBT];

  const int nc = e / kBT;
  const int tid = threadIdx.x;
  const size_t ray = (size_t)blockIdx.x * kBN + tid;
  const size_t sn = (size_t)n;

  const float ox = o4[ray], oy = o4[sn + ray], oz = o4[2 * sn + ray],
              ow = o4[3 * sn + ray];
  const float dx = d4[ray], dy = d4[sn + ray], dz = d4[2 * sn + ray],
              dw = d4[3 * sn + ray];
  const float rdx = rcp_guarded(dx), rdy = rcp_guarded(dy),
              rdz = rcp_guarded(dz);

  float best_t = kMiss, best_u = 0.f, best_v = 0.f, best_wd = 0.f;
  int best_e = 0;
  float steps = 0.f, sweeps = 0.f;

  for (int c = 0; c < nc; ++c) {
    const float tx1 = (bounds[c] - ox) * rdx;
    const float tx2 = (bounds[3 * nc + c] - ox) * rdx;
    const float ty1 = (bounds[nc + c] - oy) * rdy;
    const float ty2 = (bounds[4 * nc + c] - oy) * rdy;
    const float tz1 = (bounds[2 * nc + c] - oz) * rdz;
    const float tz2 = (bounds[5 * nc + c] - oz) * rdz;
    const float tmin = fmaxf(fmaxf(fminf(tx1, tx2), fminf(ty1, ty2)),
                             fminf(tz1, tz2));
    const float tmax = fminf(fminf(fmaxf(tx1, tx2), fmaxf(ty1, ty2)),
                             fmaxf(tz1, tz2));
    const bool may = (tmax >= tmin) && (tmax > 0.f) && (tmin <= best_t);

    // Also the barrier that ends every read of the previous chunk's rows.
    if (!__syncthreads_or(may)) continue;

    const size_t col = (size_t)c * kBT + tid;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      s_m[k][tid] = mu[k * (size_t)e + col];
      s_m[4 + k][tid] = mv[k * (size_t)e + col];
      s_m[8 + k][tid] = mw[k * (size_t)e + col];
    }
    __syncthreads();
    sweeps += 1.f;
    if (!may) continue;
    steps += (float)kBT;

    const int base = c * kBT;
#pragma unroll 4
    for (int j = 0; j < kBT; ++j) {
      const float wd = dot4(dx, dy, dz, dw, s_m[8][j], s_m[9][j], s_m[10][j],
                            s_m[11][j]);
      const float wo = dot4(ox, oy, oz, ow, s_m[8][j], s_m[9][j], s_m[10][j],
                            s_m[11][j]);
      const bool wd_ok = fabsf(wd) > kWdEps;
      const float t = -wo / (wd_ok ? wd : 1.0f);
      const float uo = dot4(ox, oy, oz, ow, s_m[0][j], s_m[1][j], s_m[2][j],
                            s_m[3][j]);
      const float ud = dot4(dx, dy, dz, dw, s_m[0][j], s_m[1][j], s_m[2][j],
                            s_m[3][j]);
      const float vo = dot4(ox, oy, oz, ow, s_m[4][j], s_m[5][j], s_m[6][j],
                            s_m[7][j]);
      const float vd = dot4(dx, dy, dz, dw, s_m[4][j], s_m[5][j], s_m[6][j],
                            s_m[7][j]);
      const float u = uo + t * ud;
      const float v = vo + t * vd;
      const bool valid = wd_ok && (t > 0.f) && (u >= 0.f) && (v >= 0.f) &&
                         (u + v <= 1.f);
      const int eidx = base + j;
      if (valid && (t < best_t ||
                    (t == best_t && t < kMiss && eidx < best_e))) {
        best_t = t;
        best_e = eidx;
        best_u = u;
        best_v = v;
        best_wd = wd;
      }
    }
  }

  const bool hit = best_t < kMiss;
  for (int r = 0; r < kTabR; ++r) {
    out[r * sn + ray] = hit ? tab[r * (size_t)e + best_e] : 0.f;
  }
  out[40 * sn + ray] = best_t;
  out[41 * sn + ray] = best_u;
  out[42 * sn + ray] = best_v;
  out[43 * sn + ray] = best_wd;
  out[44 * sn + ray] = (float)best_e;
  out[45 * sn + ray] = steps;
  out[46 * sn + ray] = sweeps;
  out[47 * sn + ray] = 0.f;
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
