// Device code shared by the traversal kernels (closest_hit_rows.cu,
// occlusion.cu, closest_hit_rows_nee.cu, closest_hit_sc_lite.cu,
// closest_hit_rows_sc.cu, soft_occlusion.cu, march_step_sc.cu,
// closest_hit_classic.cu, and the walks of the path kernels mega_step.cu
// and fused_paths.cu): 256-ray blocks, chunks of 256 triangles staged in
// shared memory. Kernel 9 sweeps each chunk its block's gate passes for
// every ray of the block, on the cooperative votes and cp.async staging;
// the others walk block-cooperatively, a warp per ray that needs a chunk:
// the flat closest hit of kernels 1, 4, 8, 10 and 11 (walk_flat_coop;
// kernel 8 with its strict gate), the two-level closest hit of kernels 3,
// 6 and 7 (walk_superchunk_coop), both over coop_group_closest, the
// any-hit of kernels 2, 4 and 10 (walk_any_coop), and the soft-shadow
// arg-max of kernel 5 (soft_occlusion.cu, on the same votes and ballot
// lists).
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

// Closest-hit sweep of triangles lo .. hi - 1 of the staged chunk whose
// first triangle is `base`.
__device__ __forceinline__ void sweep_closest_span(const ChunkRows& s_m,
                                                   const Ray& r, int base,
                                                   int lo, int hi,
                                                   Best& best) {
#pragma unroll 4
  for (int j = lo; j < hi; ++j) {
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

// Closest-hit sweep of the staged chunk whose first triangle is `base`.
__device__ __forceinline__ void sweep_closest(const ChunkRows& s_m,
                                              const Ray& r, int base,
                                              Best& best) {
  sweep_closest_span(s_m, r, base, 0, kBT, best);
}

// What the two-level walk counts: triangles this ray swept, superchunks
// its block entered, chunks its block swept.
struct WalkCounts {
  float steps, sc_entries, chunk_sweeps;
};

// ---------------------------------------------------------------------------
// The block-cooperative two-level walk (kernels 3, 6 and 7)
// ---------------------------------------------------------------------------

constexpr int kWarps = kBN / 32;       // warps per block
constexpr int kPerLane = kBT / 32;     // triangles a lane tests for one ray
constexpr unsigned kFull = 0xffffffffu;
// Kernel 3's group gate: a chunk's triangles 32q .. 32q + 31 are group q,
// step q of a warp sweep (lane l tests triangle l + 32q), with its own
// inflated box (ops/intersect.py TracePrep.group_bounds, column 8c + q).
constexpr int kGroups = kPerLane;      // groups per chunk

// Asynchronous 4-byte copy from device to shared memory (cp.async; no
// register holds the value, and any float pointer is aligned for it).
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

// Waits for this thread's cp.async copies; a barrier then makes every
// thread's copies visible to the block.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Starts the copy of chunk c's 12 rows into `dst`: each thread of the
// block its column, without waiting.
__device__ __forceinline__ void stage_chunk_async(
    ChunkRows& dst, const float* __restrict__ mu,
    const float* __restrict__ mv, const float* __restrict__ mw, size_t e,
    int c, int tid) {
  const size_t col = (size_t)c * kBT + tid;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    cp_async4(&dst[k][tid], mu + k * e + col);
    cp_async4(&dst[4 + k][tid], mv + k * e + col);
    cp_async4(&dst[8 + k][tid], mw + k * e + col);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// What the block shares during the walk (38 KB): the staged rows, double
// buffered; every ray's o and d and its best so far; and two slots of
// per-warp vote words (a vote writes slot v & 1, so the next vote never
// overwrites a slot a slow thread still reads: the two are a barrier
// apart).
struct TwoLevelShared {
  ChunkRows rows[2];
  float4 o[kBN], d[kBN];
  float bt[kBN], bu[kBN], bv[kBN], bwd[kBN];
  int be[kBN];
  unsigned vote[2][kWarps];
};

// Closest hit of ray `ray` (o, d in `sh`) against the staged chunk `rows`
// whose first triangle is `base`, by one warp: lane l tests triangles l,
// l + 32, ..., l + 224 and keeps its lowest (t, j); five xor shuffles find
// the warp's lowest; the lane that holds it merges it into the ray's best.
// A candidate counts when it is valid and t < 1e9, ties on t go to the
// lower index, and the merge takes t < best t or an equal t with a lower
// eidx: the minimum of a total order, the winner sweep_closest finds in
// any grouping, so t, eidx, u, v and w_d come out bit-equal. With
// kGroupGate (kernel 3) the warp runs step q only where bit q of the
// ray's `groups` is set (the same for every lane: no divergence).
template <bool kGroupGate = false>
__device__ __forceinline__ void sweep_closest_warp(TwoLevelShared& sh,
                                                   const ChunkRows& rows,
                                                   int ray, int base,
                                                   int lane,
                                                   unsigned groups = 0u) {
  const float4 o = sh.o[ray], d = sh.d[ray];
  const Ray r{o.x, o.y, o.z, o.w, d.x, d.y, d.z, d.w, 0.f, 0.f, 0.f};
  float bt = kMiss, bu = 0.f, bv = 0.f, bwd = 0.f;
  int bj = kBT;
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) {
    if (kGroupGate && !((groups >> q) & 1u)) continue;
    const int j = lane + 32 * q;
    const Uvt h = intersect(rows, r, j);
    const bool valid = h.wd_ok && (h.t > 0.f) && (h.u >= 0.f) &&
                       (h.v >= 0.f) && (h.u + h.v <= 1.f);
    if (valid && h.t < bt) {  // j rises: an equal t keeps the lower j
      bt = h.t;
      bu = h.u;
      bv = h.v;
      bwd = h.wd;
      bj = j;
    }
  }
  float t = bt;
  int j = bj;
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    const float ot = __shfl_xor_sync(kFull, t, m);
    const int oj = __shfl_xor_sync(kFull, j, m);
    if (ot < t || (ot == t && oj < j)) {
      t = ot;
      j = oj;
    }
  }
  // Every lane holds the warp's lowest (t, j) now; lane j % 32 found it.
  if (t < kMiss && lane == (j & 31)) {
    const int e = base + j;
    if (t < sh.bt[ray] || (t == sh.bt[ray] && e < sh.be[ray])) {
      sh.bt[ray] = t;
      sh.bu[ray] = bu;
      sh.bv[ray] = bv;
      sh.bwd[ray] = bwd;
      sh.be[ray] = e;
    }
  }
}

// The ray of entry i of a chunk's list of needing rays: the i-th set bit
// over the block's eight warp ballots `need`, in ray order. Every lane of
// the warp calls it with the same i and gets the same ray.
__device__ __forceinline__ int needing_ray(const unsigned* need, int i,
                                           int lane) {
  int w = 0;
  for (int c = __popc(need[0]); i >= c; c = __popc(need[++w])) i -= c;
  const unsigned m = need[w];
  const bool mine =
      ((m >> lane) & 1u) && __popc(m & ((1u << lane) - 1u)) == i;
  return w * 32 + __ffs(__ballot_sync(kFull, mine)) - 1;
}

// The staging and the votes both block-cooperative walks share (the
// two-level closest hit, walk_superchunk_coop, and the any-hit,
// walk_any_coop). A walk's shared memory holds the staged rows, double
// buffered, and two slots of per-warp vote words: a vote writes slot v & 1,
// so the next vote never overwrites a slot a slow thread still reads (the
// two are a barrier apart). Every thread of the block makes the same calls
// in the same order; for each group of up to 32 chunks
//   coop_vote(the ray's gate bits over the group)  <barrier>
//   cand = coop_candidates(); coop_first(cand)
// and for each candidate chunk, the lowest bit of cand first,
//   coop_ballot(whether the ray needs it)  <barrier>
//   need = coop_list(k, nw); rows = coop_rows(cand without it)
// then the sweeps of the k listed rays, and a barrier. The cursor carries
// the votes taken and the buffer the next chunk's rows go to.
struct CoopCursor {
  int v, buf;
};

// This warp's word of a group vote: the OR of its lanes' gate bits.
__device__ __forceinline__ void coop_vote(unsigned (&vote)[2][kWarps],
                                          const CoopCursor& cur,
                                          unsigned bits, int lane, int warp) {
  bits = __reduce_or_sync(kFull, bits);
  if (lane == 0) vote[cur.v & 1][warp] = bits;
}

// After the barrier: the group's candidate chunks, a bit each (the OR of
// the block's eight words).
__device__ __forceinline__ unsigned coop_candidates(
    const unsigned (&vote)[2][kWarps], CoopCursor& cur) {
  unsigned cand = 0;
  for (int w = 0; w < kWarps; ++w) cand |= vote[cur.v & 1][w];
  ++cur.v;
  return cand;
}

// Starts the copy of the group's first candidate, chunk c0 + (the lowest
// bit of cand), into the cursor's buffer.
__device__ __forceinline__ void coop_first(
    ChunkRows (&rows)[2], const CoopCursor& cur, unsigned cand, int c0,
    const float* __restrict__ mu, const float* __restrict__ mv,
    const float* __restrict__ mw, size_t e, int tid) {
  stage_chunk_async(rows[cur.buf], mu, mv, mw, e, c0 + __ffs(cand) - 1, tid);
}

// This warp's ballot of the rays that need the current candidate; then
// waits for this thread's copies of its rows (the barrier after it makes
// both the ballots and the rows the block's).
__device__ __forceinline__ void coop_ballot(unsigned (&vote)[2][kWarps],
                                            const CoopCursor& cur,
                                            bool needs, int lane, int warp) {
  const unsigned ballot = __ballot_sync(kFull, needs);
  if (lane == 0) vote[cur.v & 1][warp] = ballot;
  cp_async_wait_all();
}

// After the barrier: the eight ballots of the candidate (the list of its
// needing rays, needing_ray), with k the rays listed and nw the warps that
// hold one.
__device__ __forceinline__ const unsigned* coop_list(
    const unsigned (&vote)[2][kWarps], CoopCursor& cur, int& k, int& nw) {
  const unsigned* need = vote[cur.v & 1];
  ++cur.v;
  k = 0;
  nw = 0;
  for (int w = 0; w < kWarps; ++w) {
    k += __popc(need[w]);
    nw += need[w] != 0u;
  }
  return need;
}

// The current candidate's staged rows; starts the copy of the next one
// (chunk c0 + the lowest bit of `rest`, the candidates after it, if any)
// into the other buffer, which the last sweep read.
__device__ __forceinline__ const ChunkRows& coop_rows(
    ChunkRows (&rows)[2], CoopCursor& cur, unsigned rest, int c0,
    const float* __restrict__ mu, const float* __restrict__ mv,
    const float* __restrict__ mw, size_t e, int tid) {
  const ChunkRows& now = rows[cur.buf];
  cur.buf ^= 1;
  if (rest != 0) {
    stage_chunk_async(rows[cur.buf], mu, mv, mw, e, c0 + __ffs(rest) - 1,
                      tid);
  }
  return now;
}

// One group of up to 32 chunks, c0 .. c0 + gn - 1, of a block-cooperative
// closest-hit walk: the loop body both walks share (walk_superchunk_coop
// for the chunks of a superchunk, walk_flat_coop for the flat chunks). A
// ray needs chunk c when `live` holds (its superchunk's test passed; the
// flat walk: the ray is not parked) and its own slab test against c's
// box passes (tmax >= tmin, tmax > 0, tmin <= its best t so far; with
// kStrictGate, kernel 8's contract over the raw boxes, tmin < its best t).
// Who sweeps a staged chunk:
//   - the block lists the k rays that need the chunk (a ballot per warp;
//     entry i is the i-th needing ray in ray order);
//   - warp w sweeps entries w, w + 8, ... a ray at a time
//     (sweep_closest_warp), so a lane tests a triangle for a ray that
//     needs it; but where the warps with a needing ray are more than 7/8
//     full (8k > 7 * 32 * those warps), the ray's own thread sweeps all
//     256 triangles (sweep_closest), which then spends fewer instructions
//     than k warp sweeps and their reductions. The two give the same bits;
//   - the rows arrive by cp.async into one of two buffers: the group's
//     first candidate is requested after the vote, and each next candidate
//     while the current chunk is swept. A candidate is a chunk that some
//     live ray of the block enters under the test without the best-t cut
//     (its needing rays are a subset of those), so a chunk no ray can need
//     costs nothing but the vote, and a candidate the cut removes costs one
//     read of its rows from L2.
// With kGroupGate (kernel 3 alone), a ray whose chunk gate passes also
// slab-tests the chunk's 8 group boxes (`group_bounds`, (8, 8 nc), column
// 8c + q) in its own thread, with the same test and the same best t, and
// keeps the mask of those that pass in `groups[tid]` (shared); the block
// lists the rays with a non-zero mask, and a sweep runs only the masked
// groups of its ray. The gate is exact: a triangle whose hit the sweep
// would find lies in its group's inflated box, so the ray passes that
// box's slab test with tmin <= the hit's t; a group whose tmin is above
// the best t holds no triangle that wins or ties. `steps` still counts
// 256 for each chunk whose gate the ray passes (the contract's row 2),
// not the tests run; `chunk_sweeps` counts the chunks on which some ray
// of the block sweeps a group.
// Every thread of the block calls it with the same group and its own ray
// `r`, whose o, d and best so far are in `sh` (two_level_start); the best
// is merged there. `steps` counts the triangles the ray swept,
// `chunk_sweeps` the chunks its block swept. A group whose vote finds no
// candidate ends without a barrier after it: its only shared reads are
// the vote words, which the next vote does not overwrite (CoopCursor).
template <bool kStrictGate = false, bool kGroupGate = false>
__device__ __forceinline__ void coop_group_closest(
    TwoLevelShared& sh, const Ray& r, bool live, int c0, int gn,
    const float* __restrict__ chunk_bounds, int nc,
    const float* __restrict__ mu, const float* __restrict__ mv,
    const float* __restrict__ mw, size_t e, int tid, int lane, int warp,
    CoopCursor& cur, WalkCounts& cnt,
    const float* __restrict__ group_bounds = nullptr,
    unsigned char* groups = nullptr) {
  float tmin, tmax;
  unsigned bits = 0;
  if (live) {
    for (int j = 0; j < gn; ++j) {
      slab(r, chunk_bounds, nc, c0 + j, tmin, tmax);
      if ((tmax >= tmin) && (tmax > 0.f)) bits |= 1u << j;
    }
  }
  coop_vote(sh.vote, cur, bits, lane, warp);
  __syncthreads();
  unsigned cand = coop_candidates(sh.vote, cur);
  if (cand == 0) return;
  coop_first(sh.rows, cur, cand, c0, mu, mv, mw, e, tid);
  while (cand != 0) {
    const int c = c0 + __ffs(cand) - 1;
    cand &= cand - 1;
    bool may = false;
    if (live) {
      slab(r, chunk_bounds, nc, c, tmin, tmax);
      may = (tmax >= tmin) && (tmax > 0.f) &&
            (kStrictGate ? tmin < sh.bt[tid] : tmin <= sh.bt[tid]);
    }
    unsigned gm = 0u;  // kGroupGate: the groups whose gate passes
    if constexpr (kGroupGate) {
      if (may) {
        for (int q = 0; q < kGroups; ++q) {
          slab(r, group_bounds, kGroups * nc, kGroups * c + q, tmin, tmax);
          if ((tmax >= tmin) && (tmax > 0.f) && (tmin <= sh.bt[tid])) {
            gm |= 1u << q;
          }
        }
        cnt.steps += (float)kBT;
      }
      groups[tid] = (unsigned char)gm;
    }
    const bool needs = kGroupGate ? gm != 0u : may;
    coop_ballot(sh.vote, cur, needs, lane, warp);
    __syncthreads();  // the ballots (and masks), and chunk c's rows
    int k, nw;
    const unsigned* need = coop_list(sh.vote, cur, k, nw);
    const ChunkRows& rows = coop_rows(sh.rows, cur, cand, c0, mu, mv, mw, e,
                                      tid);
    if (k == 0) continue;
    cnt.chunk_sweeps += 1.f;
    if (!kGroupGate && may) cnt.steps += (float)kBT;
    if (8 * k > 7 * 32 * nw) {
      if (needs) {
        Best b{sh.bt[tid], sh.bu[tid], sh.bv[tid], sh.bwd[tid], sh.be[tid]};
        if constexpr (kGroupGate) {
          for (int q = 0; q < kGroups; ++q) {
            if ((gm >> q) & 1u) {
              sweep_closest_span(rows, r, c * kBT, 32 * q, 32 * q + 32, b);
            }
          }
        } else {
          sweep_closest(rows, r, c * kBT, b);
        }
        sh.bt[tid] = b.t;
        sh.bu[tid] = b.u;
        sh.bv[tid] = b.v;
        sh.bwd[tid] = b.wd;
        sh.be[tid] = b.e;
      }
    } else {
      for (int i = warp; i < k; i += kWarps) {
        const int ray = needing_ray(need, i, lane);
        sweep_closest_warp<kGroupGate>(sh, rows, ray, c * kBT, lane,
                                       kGroupGate ? groups[ray] : 0u);
      }
    }
    __syncthreads();  // the merged bests; rows, ballots and masks are free
  }
}

// Superchunk `s` of the two-level closest-hit walk, block-cooperative
// (kernels 3 and 6 for every s in index order, walk_two_level; kernel 7
// for each entry of its block's queue). A ray needs chunk c of s when its
// own slab tests against the inflated boxes of s and c both pass (tmax >=
// tmin, tmax > 0, tmin <= its best t so far); the block enters s when one
// of its rays passes s's test, and then walks the chunks of s in groups of
// 32 (coop_group_closest, which says who sweeps a chunk and how the rows
// arrive).
// Every thread of the block calls it with the same s and its own ray `r`,
// whose o, d and best so far are in `sh` (two_level_start); the best is
// merged there. `lane`, `warp` and `nc` (nsc * scc) are the caller's,
// taken once for the walk, and so is the cursor `cur` (CoopCursor), which
// it advances. `steps` counts the triangles the ray swept,
// `sc_entries` the superchunks its block entered, `chunk_sweeps` the chunks
// it swept. A sweep is idempotent: visiting s again sweeps only the chunks
// whose gate still passes, and changes no best.
// kGroupGate (kernel 3 alone): the group gate of coop_group_closest, over
// `group_bounds` with the masks in the shared `groups`.
template <bool kGroupGate = false>
__device__ __forceinline__ void walk_superchunk_coop(
    TwoLevelShared& sh, const Ray& r, int s,
    const float* __restrict__ sc_bounds, int nsc,
    const float* __restrict__ chunk_bounds, int scc,
    const float* __restrict__ mu, const float* __restrict__ mv,
    const float* __restrict__ mw, size_t e, int tid, int lane, int warp,
    int nc, CoopCursor& cur, WalkCounts& cnt,
    const float* __restrict__ group_bounds = nullptr,
    unsigned char* groups = nullptr) {
  float tmin, tmax;
  slab(r, sc_bounds, nsc, s, tmin, tmax);
  const bool sc_may = (tmax >= tmin) && (tmax > 0.f) && (tmin <= sh.bt[tid]);
  // Also the barrier after which every best of the last sweep is seen.
  if (!__syncthreads_or(sc_may)) return;
  cnt.sc_entries += 1.f;
  for (int c0 = s * scc; c0 < (s + 1) * scc; c0 += 32) {
    coop_group_closest<false, kGroupGate>(
        sh, r, sc_may, c0, min(32, (s + 1) * scc - c0), chunk_bounds, nc,
        mu, mv, mw, e, tid, lane, warp, cur, cnt, group_bounds, groups);
  }
}

// Stores the ray's o and d in `sh`, and (t0, e0) as its best so far: no
// hit (1e9, 0), or a march round's carried best.
__device__ __forceinline__ void two_level_start(TwoLevelShared& sh,
                                                const Ray& r, int tid,
                                                float t0, int e0) {
  sh.o[tid] = make_float4(r.ox, r.oy, r.oz, r.ow);
  sh.d[tid] = make_float4(r.dx, r.dy, r.dz, r.dw);
  sh.bt[tid] = t0;
  sh.bu[tid] = sh.bv[tid] = sh.bwd[tid] = 0.f;
  sh.be[tid] = e0;
}

// Two-level closest-hit walk of kernels 3 and 6: every superchunk in index
// order (walk_superchunk_coop) from no hit. Every thread calls it with its
// own ray `r`; the winner is read from `sh` after it returns. Kernel 3
// sets kGroupGate and passes its group boxes and a shared mask a ray.
template <bool kGroupGate = false>
__device__ __forceinline__ void walk_two_level(
    TwoLevelShared& sh, const Ray& r, const float* __restrict__ sc_bounds,
    int nsc, const float* __restrict__ chunk_bounds, int scc,
    const float* __restrict__ mu, const float* __restrict__ mv,
    const float* __restrict__ mw, size_t e, int tid, WalkCounts& cnt,
    const float* __restrict__ group_bounds = nullptr,
    unsigned char* groups = nullptr) {
  const int lane = tid & 31, warp = tid >> 5;
  const int nc = nsc * scc;
  two_level_start(sh, r, tid, kMiss, 0);
  CoopCursor cur{0, 0};
  for (int s = 0; s < nsc; ++s) {
    walk_superchunk_coop<kGroupGate>(sh, r, s, sc_bounds, nsc, chunk_bounds,
                                     scc, mu, mv, mw, e, tid, lane, warp, nc,
                                     cur, cnt, group_bounds, groups);
  }
}

// The ray's winner after walk_two_level.
__device__ __forceinline__ Best two_level_best(const TwoLevelShared& sh,
                                               int tid) {
  return Best{sh.bt[tid], sh.bu[tid], sh.bv[tid], sh.bwd[tid], sh.be[tid]};
}

// Flat closest-hit walk of kernels 1, 4, 8, 10 and 11, block-cooperative:
// the nc chunks in index order, in groups of 32 (coop_group_closest), from
// no hit.
// A ray needs chunk c when it is `live` and its own slab test against c's
// box (inflated; kernel 8's raw) passes before its best t so far (each
// gate sees the best after the same earlier chunks as a walk of the chunks
// one by one would), so the winner, `steps` (256 per chunk the ray needs)
// and `chunk_sweeps` (the chunks some ray of the block needs) depend on
// neither the grouping nor the block. A ray that is not live (a parked
// path of kernels 10 and 11, whose every gate fails) casts no vote bit and
// is never listed; it still takes part in every barrier.
// kStrictGate (kernel 8) cuts with tmin < best t instead of <=. Kernel 8
// takes the chunk's arg-min (lowest t, then lowest index) and replaces the
// best only where it is strictly lower, so an earlier chunk keeps a tie;
// the merge here takes the lowest (t, eidx), and since the chunks come in
// index order every eidx of chunk c is above the best's, so an equal t
// never replaces it either: the same winner.
// Every thread calls it with its own ray `r`; it stores r and no hit in
// `sh` first (two_level_start), and the winner is read from `sh` after it
// returns (two_level_best). The cursor `cur` is the caller's, so that
// kernel 11 keeps the vote parity across its bounces: the first vote of a
// bounce then never overwrites the vote words a slow thread still reads
// from the last group of the bounce before. Every read of another ray's
// o, d and best ends at the barrier after its sweep, so the next bounce's
// two_level_start overwrites nothing still being read.
template <bool kStrictGate = false>
__device__ __forceinline__ void walk_flat_coop(
    TwoLevelShared& sh, const Ray& r, bool live,
    const float* __restrict__ bounds, int nc, const float* __restrict__ mu,
    const float* __restrict__ mv, const float* __restrict__ mw, size_t e,
    int tid, CoopCursor& cur, WalkCounts& cnt) {
  const int lane = tid & 31, warp = tid >> 5;
  two_level_start(sh, r, tid, kMiss, 0);
  for (int c0 = 0; c0 < nc; c0 += 32) {
    coop_group_closest<kStrictGate>(sh, r, live, c0, min(32, nc - c0),
                                    bounds, nc, mu, mv, mw, e, tid, lane,
                                    warp, cur, cnt);
  }
}

// ---------------------------------------------------------------------------
// The block-cooperative any-hit walk (kernels 2, 4 and 10)
// ---------------------------------------------------------------------------

// What the block shares during the any-hit walk (35 KB): the staged rows,
// double buffered; every ray's o, d and limit, the halves of the staged
// chunk it needs, whether it is occluded; and two slots of per-warp vote
// words, as in TwoLevelShared.
struct AnyHitShared {
  ChunkRows rows[2];
  float4 o[kBN], d[kBN];
  float lim[kBN];
  int halves[kBN];  // bit s: the ray sweeps half s of the staged chunk
  int occ[kBN];
  unsigned vote[2][kWarps];
};

// The shared memory of a kernel that runs the closest-hit walk and then
// the any-hit walk (kernels 4 and 10): the two walks' blocks overlaid,
// since stacked (37 952 + 35 904 B) they pass the 48 KB of static shared
// memory. The handover: every thread reads its winner out of `closest`
// (two_level_best) into registers, then a __syncthreads(), and only then
// does the any-hit walk write `any`. No copy is in flight when
// walk_flat_coop returns (each candidate's ballot waits for its rows, and
// the last candidate starts none), and the barrier also ends the reads of
// a last group that had no candidate, which ends without one.
union NeeShared {
  TwoLevelShared closest;
  AnyHitShared any;
};

// Any-hit of ray `ray` (o, d, limit and halves in `sh`) against the staged
// chunk `rows`, by one warp: for each half it needs, lane l tests
// triangles l, l + 32, l + 64, l + 96 of the half (a triangle blocks when
// |w_d| > 1e-12, 0 < t < lim, u, v >= 0 and u + v <= 1), and the first half
// in which a lane finds a blocker marks the ray occluded and ends its
// query.
__device__ __forceinline__ void occlude_warp(AnyHitShared& sh,
                                             const ChunkRows& rows, int ray,
                                             int lane) {
  const float4 o = sh.o[ray], d = sh.d[ray];
  const Ray r{o.x, o.y, o.z, o.w, d.x, d.y, d.z, d.w, 0.f, 0.f, 0.f};
  const float lim = sh.lim[ray];
  const int halves = sh.halves[ray];
  for (int s = 0; s < kSub; ++s) {
    if (!((halves >> s) & 1)) continue;
    bool hit = false;
#pragma unroll
    for (int q = 0; q < kSW / 32; ++q) {
      const Uvt h = intersect(rows, r, s * kSW + lane + 32 * q);
      hit |= h.wd_ok && h.t > 0.f && h.t < lim && h.u >= 0.f && h.v >= 0.f &&
             h.u + h.v <= 1.f;
    }
    if (__any_sync(kFull, hit)) {
      if (lane == 0) sh.occ[ray] = 1;
      return;
    }
  }
}

// Any-hit walk of kernels 2, 4 and 10, block-cooperative: shadow ray `r`
// in (0, lim) over the nc chunks in index order. A ray tests half h of
// chunk c when its slab test against the chunk's inflated box passes with
// tmin < lim, the half's own box passes too, and it is not yet occluded;
// `occ` is an OR over those tests, so neither the visit order nor the
// grouping changes it. A ray with lim <= 0 (parked) is never occluded (no
// t is in (0, lim)) and tests nothing. Who tests:
//   - the chunks in groups of 32: each unresolved ray keeps the bits of
//     the group's chunks its gate passes, and a vote word per warp names
//     the candidates (chunks some unresolved ray of the block enters);
//   - per candidate, each ray that needs it finds the halves it needs,
//     and the block lists the k rays with one (a ballot per warp);
//   - warp w tests entries w, w + 8, ... a ray at a time (occlude_warp),
//     however full the needing warps are: unlike the closest hit, a ray's
//     own thread would stop at its first blocker while its warp's other
//     lanes wait for the slowest; measured in turns on the H100, a thread
//     path where the needing warps are more than 7/8 full (as
//     walk_superchunk_coop has) cost 1% (grid) to 24% (demo) more than
//     warp sweeps alone;
//   - the rows arrive by cp.async into one of two buffers, the next
//     candidate's while the current one is swept;
//   - the block ends the walk at the first barrier where no ray is
//     unresolved (lim > 0 and not occluded).
// With kCountSweeps (kernel 4), `*chunk_sweeps` counts the chunks on which
// some unresolved ray of the block passes its chunk gate (kernel 4's row
// 47, `occluded_plain`'s sweeps): one more barrier per candidate, an OR
// of "still unresolved and the chunk's bit set". Each such chunk is a
// candidate (the ray was unresolved at the group's vote too); a candidate
// whose gate-passing rays an earlier chunk of the group occluded does not
// count, and one that lists no ray (every such ray misses both halves'
// boxes) does. Kernel 2 compiles without it.
// Every thread calls it with its own ray; returns whether it is occluded.
template <bool kCountSweeps = false>
__device__ __forceinline__ bool walk_any_coop(
    AnyHitShared& sh, const Ray& r, float lim,
    const float* __restrict__ bounds, const float* __restrict__ sub_bounds,
    int nc, const float* __restrict__ mu, const float* __restrict__ mv,
    const float* __restrict__ mw, size_t e, int tid,
    float* chunk_sweeps = nullptr) {
  const int lane = tid & 31, warp = tid >> 5;
  sh.o[tid] = make_float4(r.ox, r.oy, r.oz, r.ow);
  sh.d[tid] = make_float4(r.dx, r.dy, r.dz, r.dw);
  sh.lim[tid] = lim;
  sh.occ[tid] = 0;
  bool live = lim > 0.f;  // unresolved: not parked, not yet occluded
  CoopCursor cur{0, 0};
  for (int c0 = 0; c0 < nc; c0 += 32) {
    const int gn = min(32, nc - c0);
    unsigned bits = 0;  // this ray's gates over the group
    if (live) {
      for (int j = 0; j < gn; ++j) {
        float tmin, tmax;
        slab(r, bounds, nc, c0 + j, tmin, tmax);
        if ((tmax >= tmin) && (tmax > 0.f) && (tmin < lim)) bits |= 1u << j;
      }
    }
    coop_vote(sh.vote, cur, bits, lane, warp);
    if (!__syncthreads_or(live)) break;  // every ray resolved
    unsigned cand = coop_candidates(sh.vote, cur);
    if (cand == 0) continue;
    coop_first(sh.rows, cur, cand, c0, mu, mv, mw, e, tid);
    while (cand != 0) {
      const int j = __ffs(cand) - 1;
      const int c = c0 + j;
      cand &= cand - 1;
      const bool gate = live && ((bits >> j) & 1u);
      if constexpr (kCountSweeps) {
        if (__syncthreads_or(gate)) *chunk_sweeps += 1.f;
      }
      int halves = 0;
      if (gate) {
        for (int s = 0; s < kSub; ++s) {
          float tmin, tmax;
          slab(r, sub_bounds, kSub * nc, c * kSub + s, tmin, tmax);
          if (tmax >= tmin && tmax > 0.f && tmin < lim) halves |= 1 << s;
        }
      }
      sh.halves[tid] = halves;
      coop_ballot(sh.vote, cur, halves != 0, lane, warp);
      // The ballots, the halves and chunk c's rows; no copy is in flight
      // here, so the walk may end.
      if (!__syncthreads_or(live)) return sh.occ[tid] != 0;
      int k, nw;
      const unsigned* need = coop_list(sh.vote, cur, k, nw);
      const ChunkRows& rows = coop_rows(sh.rows, cur, cand, c0, mu, mv, mw,
                                        e, tid);
      if (k == 0) continue;
      for (int i = warp; i < k; i += kWarps) {
        occlude_warp(sh, rows, needing_ray(need, i, lane), lane);
      }
      __syncthreads();  // the occlusions; rows, halves and ballots are free
      live = live && sh.occ[tid] == 0;
    }
  }
  return sh.occ[tid] != 0;
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
