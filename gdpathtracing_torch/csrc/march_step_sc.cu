// One round of regen's frontier march, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel_sc_march` (gdpathtracing_tpu/ops/
// intersect_pallas.py:1117, wrapper `_march_step_sc` :1151). Contract
// (ops/intersect.py march_step_sc):
//
//   in   o4, d4       (4, N)       rays as (o, 1) and (d, 0); N % 256 == 0
//        init         (2, N)       the carried best: 0 t (1e9: none),
//                                  1 eidx as an f32 value (2^24 - 1: none)
//        queue        (N/256 * QL) int32, block b's superchunks at
//                                  [b*QL, b*QL + QL); a value outside
//                                  [0, nsc) is a sentinel: no sweep
//        sc_bounds    (8, nsc)     inflated superchunk AABBs
//        bounds       (8, nc)      inflated chunk AABBs, nc = nsc * scc
//        mu/mv/mw     (4, E)       unit-triangle-space rows, E = 256 * nc
//        scc, ql                   chunks per superchunk, queue slots
//   out               (8, N)       0 t, 1 eidx (exact in f32), 2 triangles
//                                  this ray swept, 3 superchunks its block
//                                  entered, 4-7 zero.
//
// Winner: the lowest (t, eidx) pair over the carried best and the
// triangles of the queued superchunks whose superchunk and chunk both pass
// the ray's OWN slab test (kernel 3's gates over one superchunk,
// trace_common.cuh walk_superchunk_coop). The march visits superchunks
// near to far, not in index order, so a carried best can hold a larger
// eidx at the same t than a triangle swept now: the merge's tie clause
// (equal t, lower eidx) keeps the winner the one the one-shot walk finds.
// Sweeps are idempotent, so a duplicate queue entry changes nothing but
// row 2.
//
// What bounds it on the H100: arithmetic, as kernel 3: each needed
// (ray, triangle) test is six 4-term dot products, one IEEE division and
// the edge tests, plus a slab test per queued superchunk and per chunk of
// each one the ray enters. Device memory carries the rays, the carried
// best and the queue in, the 12 KB rows of each chunk a block stages, and
// 8 floats a ray out.
// The design: kernel 3's block-cooperative walk, entry by entry. A block
// seeds each ray's best in shared memory from `init`, then walks its own
// QL queue entries in queue order; an entry is the same for every thread
// of the block, so a sentinel is skipped without divergence, and each real
// entry is one walk_superchunk_coop: the superchunk vote, its candidate
// chunks from the per-warp votes, for each a ballot list of the rays that
// need it swept a warp per ray (or by the rays' own threads where the
// needing warps are nearly full), the rows double-buffered by cp.async.
// A lane's 8 tests are unrolled as in kernel 3: 3 blocks of 256 an SM,
// 38 KB of shared memory each.

#include "trace_common.cuh"

namespace {

using namespace gdpt;

constexpr int kLiteR = 8;  // output rows

__global__ void __launch_bounds__(kBN, 3)
march_step_sc_kernel(const float* __restrict__ o4,
                     const float* __restrict__ d4,
                     const float* __restrict__ init,
                     const int* __restrict__ queue,
                     const float* __restrict__ sc_bounds,
                     const float* __restrict__ bounds,
                     const float* __restrict__ mu,
                     const float* __restrict__ mv,
                     const float* __restrict__ mw,
                     float* __restrict__ out, int n, int e, int scc,
                     int ql) {
  __shared__ TwoLevelShared sh;

  const int nsc = e / (kBT * scc);
  const int tid = threadIdx.x;
  const size_t nn = (size_t)n;
  const size_t ray = (size_t)blockIdx.x * kBN + tid;
  const Ray r = load_ray(o4, d4, nn, ray);

  two_level_start(sh, r, tid, init[ray], (int)init[nn + ray]);
  WalkCounts cnt{0.f, 0.f, 0.f};
  CoopCursor cur{0, 0};
  const int* q = queue + (size_t)blockIdx.x * ql;
  const int lane = tid & 31, warp = tid >> 5;
  const int nc = nsc * scc;
  for (int j = 0; j < ql; ++j) {
    const int s = q[j];
    if (s < 0 || s >= nsc) continue;  // a sentinel: the same on every thread
    walk_superchunk_coop(sh, r, s, sc_bounds, nsc, bounds, scc, mu, mv, mw,
                         (size_t)e, tid, lane, warp, nc, cur, cnt);
  }

  out[ray] = sh.bt[tid];
  out[nn + ray] = (float)sh.be[tid];
  out[2 * nn + ray] = cnt.steps;
  out[3 * nn + ray] = cnt.sc_entries;
  for (int k = 4; k < kLiteR; ++k) out[k * nn + ray] = 0.f;
}

}  // namespace

// Launches on `stream`; does not synchronise. Returns cudaGetLastError()
// (0 = launched).
extern "C" int march_step_sc(const void* o4, const void* d4, const void* init,
                             const void* queue, const void* sc_bounds,
                             const void* bounds, const void* mu,
                             const void* mv, const void* mw, void* out, int n,
                             int e, int scc, int ql, void* stream) {
  if (n <= 0 || e <= 0 || scc <= 0 || ql <= 0 || n % kBN != 0 ||
      e % (kBT * scc) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  march_step_sc_kernel<<<n / kBN, kBN, 0, (cudaStream_t)stream>>>(
      (const float*)o4, (const float*)d4, (const float*)init,
      (const int*)queue, (const float*)sc_bounds, (const float*)bounds,
      (const float*)mu, (const float*)mv, (const float*)mw, (float*)out, n, e,
      scc, ql);
  return (int)cudaGetLastError();
}
