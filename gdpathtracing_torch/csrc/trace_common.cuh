// Device code shared by the traversal kernels (closest_hit_rows.cu,
// occlusion.cu, closest_hit_rows_nee.cu, closest_hit_sc_lite.cu,
// closest_hit_rows_sc.cu, soft_occlusion.cu, march_step_sc.cu,
// closest_hit_classic.cu, and the walks of the path kernels mega_step.cu
// and fused_paths.cu): one thread per ray, 256-ray blocks, chunks of 256
// triangles staged in shared memory.
//
// Layouts (ops/intersect.py):
//   rays     o4, d4  (4, N)  (o, 1) and (d, 0), N % 256 == 0
//   boxes    (8, nb)         [min3 | max3 | pad2], inflated by ~100 ulp
//   mu/mv/mw (4, E)          unit-triangle-space rows, E = 256 * nc
//   superchunks              nsc = nc / scc boxes, each around scc
//                            consecutive chunks (the two-level kernels)
//
// Numerics: built with -fmad=false and without --use_fast_math, so every
// product and sum is rounded on its own, in the order written here, and
// division is IEEE. The plain PyTorch versions (ops/intersect.py) use the
// same order, and the two agree bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace gdpt {

constexpr int kBN = 256;         // rays per block (one thread per ray)
constexpr int kBT = 256;         // triangles per chunk
constexpr int kSub = 2;          // sub-chunks per chunk (shadow rays)
constexpr int kSW = kBT / kSub;  // triangles per sub-chunk
constexpr int kTabR = 40;        // winner-table rows
constexpr float kMiss = 1e9f;
constexpr float kWdEps = 1e-12f;

// Rows 0-3 mu, 4-7 mv, 8-11 mw of the chunk being swept: 12 KB.
typedef float ChunkRows[12][kBT];

__device__ __forceinline__ float rcp_guarded(float d) {
  return 1.0f / (fabsf(d) < 1e-30f ? 1e-30f : d);
}

__device__ __forceinline__ float dot4(float a0, float a1, float a2, float a3,
                                      float b0, float b1, float b2,
                                      float b3) {
  return a0 * b0 + a1 * b1 + a2 * b2 + a3 * b3;
}

struct Ray {
  float ox, oy, oz, ow, dx, dy, dz, dw, rdx, rdy, rdz;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o4,
                                        const float* __restrict__ d4,
                                        size_t n, size_t i) {
  Ray r;
  r.ox = o4[i];
  r.oy = o4[n + i];
  r.oz = o4[2 * n + i];
  r.ow = o4[3 * n + i];
  r.dx = d4[i];
  r.dy = d4[n + i];
  r.dz = d4[2 * n + i];
  r.dw = d4[3 * n + i];
  r.rdx = rcp_guarded(r.dx);
  r.rdy = rcp_guarded(r.dy);
  r.rdz = rcp_guarded(r.dz);
  return r;
}

// Slab test of `r` against box `k` of an (8, nb) box array.
__device__ __forceinline__ void slab(const Ray& r,
                                     const float* __restrict__ box, int nb,
                                     int k, float& tmin, float& tmax) {
  const float tx1 = (box[k] - r.ox) * r.rdx;
  const float tx2 = (box[3 * nb + k] - r.ox) * r.rdx;
  const float ty1 = (box[nb + k] - r.oy) * r.rdy;
  const float ty2 = (box[4 * nb + k] - r.oy) * r.rdy;
  const float tz1 = (box[2 * nb + k] - r.oz) * r.rdz;
  const float tz2 = (box[5 * nb + k] - r.oz) * r.rdz;
  tmin = fmaxf(fmaxf(fminf(tx1, tx2), fminf(ty1, ty2)), fminf(tz1, tz2));
  tmax = fminf(fminf(fmaxf(tx1, tx2), fmaxf(ty1, ty2)), fmaxf(tz1, tz2));
}

// Every thread of the block copies its column of chunk c. The caller
// brackets it with barriers.
__device__ __forceinline__ void stage_chunk(ChunkRows& s_m,
                                            const float* __restrict__ mu,
                                            const float* __restrict__ mv,
                                            const float* __restrict__ mw,
                                            size_t e, int c, int tid) {
  const size_t col = (size_t)c * kBT + tid;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    s_m[k][tid] = mu[k * e + col];
    s_m[4 + k][tid] = mv[k * e + col];
    s_m[8 + k][tid] = mw[k * e + col];
  }
}

// Triangle j of the staged chunk against `r`: t (w_d = 1 where
// |w_d| <= 1e-12, never a hit), u, v and w_d.
struct Uvt {
  float t, u, v, wd;
  bool wd_ok;
};

__device__ __forceinline__ Uvt intersect(const ChunkRows& s_m, const Ray& r,
                                         int j) {
  Uvt h;
  h.wd = dot4(r.dx, r.dy, r.dz, r.dw, s_m[8][j], s_m[9][j], s_m[10][j],
              s_m[11][j]);
  const float wo = dot4(r.ox, r.oy, r.oz, r.ow, s_m[8][j], s_m[9][j],
                        s_m[10][j], s_m[11][j]);
  h.wd_ok = fabsf(h.wd) > kWdEps;
  h.t = -wo / (h.wd_ok ? h.wd : 1.0f);
  const float uo = dot4(r.ox, r.oy, r.oz, r.ow, s_m[0][j], s_m[1][j],
                        s_m[2][j], s_m[3][j]);
  const float ud = dot4(r.dx, r.dy, r.dz, r.dw, s_m[0][j], s_m[1][j],
                        s_m[2][j], s_m[3][j]);
  const float vo = dot4(r.ox, r.oy, r.oz, r.ow, s_m[4][j], s_m[5][j],
                        s_m[6][j], s_m[7][j]);
  const float vd = dot4(r.dx, r.dy, r.dz, r.dw, s_m[4][j], s_m[5][j],
                        s_m[6][j], s_m[7][j]);
  h.u = uo + h.t * ud;
  h.v = vo + h.t * vd;
  return h;
}

// Closest hit so far: the lowest (t, eidx) pair.
struct Best {
  float t, u, v, wd;
  int e;
};

__device__ __forceinline__ Best no_hit() { return Best{kMiss, 0.f, 0.f, 0.f, 0}; }

// Closest-hit sweep of the staged chunk whose first triangle is `base`.
__device__ __forceinline__ void sweep_closest(const ChunkRows& s_m,
                                              const Ray& r, int base,
                                              Best& best) {
#pragma unroll 4
  for (int j = 0; j < kBT; ++j) {
    const Uvt h = intersect(s_m, r, j);
    const bool valid = h.wd_ok && (h.t > 0.f) && (h.u >= 0.f) &&
                       (h.v >= 0.f) && (h.u + h.v <= 1.f);
    const int eidx = base + j;
    if (valid && (h.t < best.t ||
                  (h.t == best.t && h.t < kMiss && eidx < best.e))) {
      best = Best{h.t, h.u, h.v, h.wd, eidx};
    }
  }
}

// Flat closest-hit walk (kernels 1, 10 and 11) over the nc chunks in
// index order. A ray sweeps chunk c when its own slab test against the
// inflated box passes (tmax >= tmin, tmax > 0, tmin <= its best t so far);
// the block skips a chunk none of its rays needs, otherwise it stages the
// chunk and every ray that needs it sweeps it. `steps` counts the
// triangles the ray swept, `sweeps` the chunks its block staged. The
// winner depends on neither the visit order nor the block.
__device__ __forceinline__ void walk_flat_closest(
    ChunkRows& s_m, const Ray& r, const float* __restrict__ bounds, int nc,
    const float* __restrict__ mu, const float* __restrict__ mv,
    const float* __restrict__ mw, size_t e, int tid, Best& best,
    float& steps, float& sweeps) {
  for (int c = 0; c < nc; ++c) {
    float tmin, tmax;
    slab(r, bounds, nc, c, tmin, tmax);
    const bool may = (tmax >= tmin) && (tmax > 0.f) && (tmin <= best.t);
    // Also the barrier that ends every read of the previous chunk's rows.
    if (!__syncthreads_or(may)) continue;
    stage_chunk(s_m, mu, mv, mw, e, c, tid);
    __syncthreads();
    sweeps += 1.f;
    if (!may) continue;
    steps += (float)kBT;
    sweep_closest(s_m, r, c * kBT, best);
  }
}

// What the two-level walk counts: triangles this ray swept, superchunks
// its block entered, chunks its block swept.
struct WalkCounts {
  float steps, sc_entries, chunk_sweeps;
};

// Superchunk `s` of the two-level closest-hit walk (kernels 3, 6 and 7):
// s holds the `scc` consecutive chunks s*scc .. s*scc + scc - 1. A ray
// sweeps chunk c when its own slab tests against the inflated box of s
// and of c itself both pass (tmax >= tmin, tmax > 0, tmin <= its best t
// so far). The block skips the superchunk when none of its rays enters
// it, and a chunk none of them needs; otherwise it stages the chunk and
// every ray that needs it sweeps it. Every thread of the block calls it
// with the same s.
__device__ __forceinline__ void walk_superchunk(
    ChunkRows& s_m, const Ray& r, int s, const float* __restrict__ sc_bounds,
    int nsc, const float* __restrict__ chunk_bounds, int scc,
    const float* __restrict__ mu, const float* __restrict__ mv,
    const float* __restrict__ mw, size_t e, int tid, Best& best,
    WalkCounts& cnt) {
  const int nc = nsc * scc;
  float tmin, tmax;
  slab(r, sc_bounds, nsc, s, tmin, tmax);
  const bool sc_may = (tmax >= tmin) && (tmax > 0.f) && (tmin <= best.t);
  // Also the barrier that ends every read of the previous chunk's rows.
  if (!__syncthreads_or(sc_may)) return;
  cnt.sc_entries += 1.f;
  for (int c = s * scc; c < (s + 1) * scc; ++c) {
    slab(r, chunk_bounds, nc, c, tmin, tmax);
    const bool may = sc_may && (tmax >= tmin) && (tmax > 0.f) &&
                     (tmin <= best.t);
    if (!__syncthreads_or(may)) continue;
    stage_chunk(s_m, mu, mv, mw, e, c, tid);
    __syncthreads();
    cnt.chunk_sweeps += 1.f;
    if (!may) continue;
    cnt.steps += (float)kBT;
    sweep_closest(s_m, r, c * kBT, best);
  }
}

// Two-level closest-hit walk (closest_hit_sc_lite.cu, closest_hit_rows_sc.cu)
// over the nsc superchunks in index order (walk_superchunk each). The
// winner depends on neither the visit order nor the block.
__device__ __forceinline__ void walk_two_level(
    ChunkRows& s_m, const Ray& r, const float* __restrict__ sc_bounds,
    int nsc, const float* __restrict__ chunk_bounds, int scc,
    const float* __restrict__ mu, const float* __restrict__ mv,
    const float* __restrict__ mw, size_t e, int tid, Best& best,
    WalkCounts& cnt) {
  for (int s = 0; s < nsc; ++s) {
    walk_superchunk(s_m, r, s, sc_bounds, nsc, chunk_bounds, scc, mu, mv,
                    mw, e, tid, best, cnt);
  }
}

// Any-hit of shadow ray `r` against the staged chunk c: each 128-triangle
// half whose own (inflated) box the ray enters before `tlim` is swept,
// and the first blocking triangle ends the query. A triangle blocks when
// |w_d| > 1e-12, 0 < t < tlim, u, v >= 0 and u + v <= 1.
__device__ __forceinline__ bool occlude_chunk(
    const ChunkRows& s_m, const Ray& r, float tlim,
    const float* __restrict__ sub_bounds, int nsub, int c) {
  for (int s = 0; s < kSub; ++s) {
    float tmin, tmax;
    slab(r, sub_bounds, nsub, c * kSub + s, tmin, tmax);
    if (!(tmax >= tmin && tmax > 0.f && tmin < tlim)) continue;
#pragma unroll 4
    for (int j = s * kSW; j < (s + 1) * kSW; ++j) {
      const Uvt h = intersect(s_m, r, j);
      if (h.wd_ok && h.t > 0.f && h.t < tlim && h.u >= 0.f && h.v >= 0.f &&
          h.u + h.v <= 1.f) {
        return true;
      }
    }
  }
  return false;
}

// Flat any-hit walk (kernels 2 and 10) of shadow ray `r` in (0, lim)
// over the nc chunks in index order: a ray tests chunk c when its slab
// test against the inflated box passes with tmin < lim (then each half
// by its own box, occlude_chunk), and stops at its first blocker; the
// block skips a chunk none of its rays needs and ends the walk once none
// is unresolved (lim <= 0 marks a parked ray).
__device__ __forceinline__ bool walk_flat_any(
    ChunkRows& s_m, const Ray& r, float lim, const float* __restrict__ bounds,
    const float* __restrict__ sub_bounds, int nc,
    const float* __restrict__ mu, const float* __restrict__ mv,
    const float* __restrict__ mw, size_t e, int tid) {
  bool occ = false;
  for (int c = 0; c < nc; ++c) {
    float tmin, tmax;
    slab(r, bounds, nc, c, tmin, tmax);
    const bool may = !occ && (tmax >= tmin) && (tmax > 0.f) && (tmin < lim);
    // Also the barrier that ends every read of the previous chunk's rows.
    if (!__syncthreads_or(may)) continue;
    stage_chunk(s_m, mu, mv, mw, e, c, tid);
    __syncthreads();
    if (may) occ = occlude_chunk(s_m, r, lim, sub_bounds, kSub * nc, c);
    // Also the barrier that ends every read of this chunk's rows.
    if (!__syncthreads_or(!occ && lim > 0.f)) break;
  }
  return occ;
}

// Rows 0-39 the winner's table row (0 on a miss), 40 t, 41 u, 42 v,
// 43 w_d, 44 eidx, 45-47 the counters.
__device__ __forceinline__ void write_rows(float* __restrict__ out,
                                           const float* __restrict__ tab,
                                           size_t n, size_t e, size_t ray,
                                           const Best& best, float steps,
                                           float sweeps, float sweeps_b) {
  const bool hit = best.t < kMiss;
  for (int r = 0; r < kTabR; ++r) {
    out[r * n + ray] = hit ? tab[r * e + best.e] : 0.f;
  }
  out[40 * n + ray] = best.t;
  out[41 * n + ray] = best.u;
  out[42 * n + ray] = best.v;
  out[43 * n + ray] = best.wd;
  out[44 * n + ray] = (float)best.e;
  out[45 * n + ray] = steps;
  out[46 * n + ray] = sweeps;
  out[47 * n + ray] = sweeps_b;
}

}  // namespace gdpt
