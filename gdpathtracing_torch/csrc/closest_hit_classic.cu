// The classic flat closest-hit kernels, (t, idx) only, for Hopper (sm_90a):
// two entry points, each with its own walk.
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
// The designs:
//   - closest_hit_classic (kernel 8): its rule leaves every ray whose gate
//     fails idle on a chunk that others sweep (a thread per ray kept 0.06-
//     0.15 of its bound on the H100, PERF.md §6), so it runs the
//     block-cooperative flat walk of kernels 1, 4, 10 and 11
//     (trace_common.cuh walk_flat_coop) with kernel 8's strict gate: the
//     chunks in groups of 32, a vote per group on the raw-box test without
//     the best-t cut names the block's candidates; each candidate's rows
//     arrive by cp.async into one of two 16-byte-aligned buffers while the
//     one before is swept; a ballot lists the rays whose own gate passes,
//     and a warp sweeps each listed ray (a lane per 8 triangles, a shuffle
//     reduction to the lowest (t, index)), or the rays' own threads sweep
//     where the needing warps are more than 7/8 full. The bests live in
//     shared memory; each ray writes its own at the end;
//   - closest_hit_loop (kernel 9): its rule already keeps every lane of a
//     swept chunk busy, so its walk (loop_walk) spends what it can save on
//     the staging and the barriers: the chunks in groups of 32, a vote per
//     group on the raw-box test without the best-t cut names the block's
//     candidates (coop_vote, coop_candidates); each candidate's rows
//     arrive by cp.async into one of two buffers while the one before is
//     swept, and one `__syncthreads_or` a candidate both takes the block
//     gate (with the cut: the contract's answer) and ends the reads of the
//     buffer the next copy overwrites. The staged rows are 16-byte
//     aligned, so the sweep reads a row's words of four triangles with one
//     LDS.128. Measured in turns on the H100 (PERF.md §6): the staging
//     alone 1-7% faster than synchronous staging, with the aligned rows
//     13-25%; two rays a thread (128 threads, each staged triangle read
//     once for two tests) was 5-6% slower on the demo's tiles and 6%
//     faster on the mid grid's, so a thread carries one ray.

#include "trace_common.cuh"

namespace {

using namespace gdpt;

// Kernel 8: the flat cooperative walk with the strict gate over the raw
// boxes; launch bounds (256, 3) as kernel 1, whose walk it is.
__global__ void __launch_bounds__(kBN, 3)
closest_hit_classic_kernel(const float* __restrict__ o4,
                           const float* __restrict__ d4,
                           const float* __restrict__ bounds,
                           const float* __restrict__ mu,
                           const float* __restrict__ mv,
                           const float* __restrict__ mw,
                           float* __restrict__ t_out,
                           int* __restrict__ idx_out, int n, int e) {
  __shared__ TwoLevelShared sh;

  const int tid = threadIdx.x;
  const size_t ray = (size_t)blockIdx.x * kBN + tid;
  const Ray r = load_ray(o4, d4, (size_t)n, ray);
  CoopCursor cur{0, 0};
  WalkCounts cnt{0.f, 0.f, 0.f};
  walk_flat_coop<true>(sh, r, true, bounds, e / kBT, mu, mv, mw, (size_t)e,
                       tid, cur, cnt);
  // Every merge into this ray's best ended at a barrier (walk_flat_coop).
  t_out[ray] = sh.bt[tid];
  idx_out[ray] = sh.be[tid];
}

// The parts of kernel 9's walk, each ending at a mark of LoopClocks.
enum LoopPart { kVote, kGate, kWait, kBarrier, kStage, kSweep, kParts };

#ifdef GDPT_CLOCKS
// Diagnostic build (tools/two_level_turns.py --clocks; never chip_smoke's
// or the package's): lane 0 of every warp of kernel 9 sums the clock64()
// cycles between its marks into the part that ends at each mark, and adds
// them to g_loop_clocks when it ends; thread 0 of each of the first
// kLogBlocks blocks logs its SM and the global timer (ns) when the block
// starts and when all its warps have ended, in g_loop_blocks.
constexpr int kLogBlocks = 4096;
__device__ unsigned long long g_loop_clocks[kParts];
__device__ unsigned long long g_loop_blocks[kLogBlocks][3];

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

struct LoopClocks {
  unsigned long long part[kParts];
  long long t0;
  __device__ __forceinline__ void start() {
    if (threadIdx.x == 0 && blockIdx.x < kLogBlocks) {
      unsigned sm;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
      g_loop_blocks[blockIdx.x][0] = sm;
      g_loop_blocks[blockIdx.x][1] = global_ns();
    }
    for (int p = 0; p < kParts; ++p) part[p] = 0;
    t0 = clock64();
  }
  __device__ __forceinline__ void mark(int p) {
    const long long t = clock64();
    part[p] += (unsigned long long)(t - t0);
    t0 = t;
  }
  __device__ __forceinline__ void flush(int lane) {
    if (lane == 0) {
      for (int p = 0; p < kParts; ++p) {
        atomicAdd(&g_loop_clocks[p], part[p]);
      }
    }
    __syncthreads();
    if (threadIdx.x == 0 && blockIdx.x < kLogBlocks) {
      g_loop_blocks[blockIdx.x][2] = global_ns();
    }
  }
};
#else
struct LoopClocks {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void flush(int) {}
};
#endif

// Kernel 9: chunks in index order; the block sweeps chunk c for every one
// of its rays when some ray's gate passes (its slab test against the raw
// box with tmax >= tmin, tmax > 0 and tmin < its best t); each ray's best
// takes the chunk's lowest t (ties to the lower index) where it is lower.
// Only a chunk some ray enters under the test without the cut (a
// candidate of its group's vote) can pass the gate, so the others are
// skipped at the vote.
__device__ __forceinline__ void loop_walk(
    const float* __restrict__ o4, const float* __restrict__ d4,
    const float* __restrict__ bounds, const float* __restrict__ mu,
    const float* __restrict__ mv, const float* __restrict__ mw,
    float* __restrict__ t_out, int* __restrict__ idx_out, int n, int e) {
  // 16-byte aligned, so the sweep reads four triangles' words of a row
  // with one LDS.128 (3 shared loads a test, not 12).
  __shared__ __align__(16) ChunkRows rows[2];
  __shared__ unsigned vote[2][kWarps];

  const int nc = e / kBT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t ray = (size_t)blockIdx.x * kBN + tid;
  const Ray r = load_ray(o4, d4, (size_t)n, ray);
  float best_t = kMiss;
  int best_i = 0;
  LoopClocks clk;
  clk.start();
  CoopCursor cur{0, 0};
  for (int c0 = 0; c0 < nc; c0 += 32) {
    const int gn = min(32, nc - c0);
    unsigned bits = 0;  // this ray's raw-box tests over the group
    for (int j = 0; j < gn; ++j) {
      float tmin, tmax;
      slab(r, bounds, nc, c0 + j, tmin, tmax);
      if ((tmax >= tmin) && (tmax > 0.f)) bits |= 1u << j;
    }
    coop_vote(vote, cur, bits, lane, warp);
    __syncthreads();
    unsigned cand = coop_candidates(vote, cur);
    clk.mark(kVote);
    if (cand == 0) continue;
    coop_first(rows, cur, cand, c0, mu, mv, mw, (size_t)e, tid);
    while (cand != 0) {
      const int j = __ffs(cand) - 1;
      const int c = c0 + j;
      cand &= cand - 1;
      bool may = false;
      if ((bits >> j) & 1u) {
        float tmin, tmax;
        slab(r, bounds, nc, c, tmin, tmax);
        may = tmin < best_t;
      }
      clk.mark(kGate);
      cp_async_wait_all();
      clk.mark(kWait);
      // The block gate; chunk c's rows; every read of the other buffer
      // (the last candidate's) has ended.
      const bool pass = __syncthreads_or(may);
      clk.mark(kBarrier);
      const ChunkRows& now = coop_rows(rows, cur, cand, c0, mu, mv, mw,
                                       (size_t)e, tid);
      clk.mark(kStage);
      if (!pass) continue;
      float tk = kMiss;
      int k = 0;
#pragma unroll 4
      for (int jj = 0; jj < kBT; ++jj) {
        const Uvt h = intersect(now, r, jj);
        const bool valid = h.wd_ok && (h.t > 0.f) && (h.u >= 0.f) &&
                           (h.v >= 0.f) && (h.u + h.v <= 1.f);
        if (valid && h.t < tk) {
          tk = h.t;
          k = jj;
        }
      }
      if (tk < best_t) {
        best_t = tk;
        best_i = c * kBT + k;
      }
      clk.mark(kSweep);
    }
  }
  clk.flush(lane);
  t_out[ray] = best_t;
  idx_out[ray] = best_i;
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
  loop_walk(o4, d4, bounds, mu, mv, mw, t_out, idx_out, n, e);
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

#ifdef GDPT_CLOCKS
// The diagnostic build's cycle sums (LoopPart order) into `cycles`, zeroed
// after the read, and its block log (kLogBlocks rows of SM, start ns, end
// ns) into `blocks`. Synchronous.
extern "C" int closest_hit_loop_clocks(void* cycles, void* blocks) {
  cudaMemcpyFromSymbol(cycles, g_loop_clocks, sizeof g_loop_clocks);
  cudaMemcpyFromSymbol(blocks, g_loop_blocks, sizeof g_loop_blocks);
  const unsigned long long zero[kParts] = {};
  cudaMemcpyToSymbol(g_loop_clocks, zero, sizeof zero);
  return (int)cudaGetLastError();
}
#endif
