// Two-level (TLAS -> BLAS) BVH traversal for Hopper (sm_90a).
//
// Replaces `trace_bvh` (gdpathtracing_tpu/render/traverse.py:44), which
// is not a Pallas kernel: a plain-XLA lockstep while_loop, the whole
// wavefront advancing one stack pop an iteration. Here each ray is one
// thread with its own stack, the natural GPU form (the traversal the
// reference's lockstep loop was re-designed from). Contract
// (render/traverse.py, whose trace_bvh_plain this kernel equals bit for
// bit):
//
//   in   rays      (6, N) f32   o xyz, d xyz (world space)
//        active    (N,)   u8    0: the ray pops nothing
//        scene     tri_pos (T, 3, 3), node_min/max (B, 3) f32,
//                  node_left/right/first/count (B,) i32, tlas_min/max
//                  (L, 3) f32, tlas_left/right/inst (L,) i32,
//                  inst_inv (I, 3, 4) f32, inst_root (I,) i32
//        scratch   (max_stack, N) i32 when max_stack > 64 (the stacks),
//                  unused otherwise
//   out  out_f     (3, N) f32   t (1e9 on a miss), u, v
//        out_i     (4, N) i32   tri, inst, front (0/1), steps
//
// A stack entry is (inst + 1) << 21 | node as uint32 (tag 0: a TLAS node);
// the root is TLAS node 0. A pop of a TLAS leaf pushes its instance's BLAS
// root; of an inner node, the children whose slab test enters before the
// best t (strict), far first, near (dl < dr) on top; of a BLAS leaf, its
// up to 4 triangles are tested (Moller-Trumbore in object space, bounded
// by the best t, |det| >= 1e-5, 0 < t < best t). A push at ptr >=
// max_stack is dropped but ptr still rises, and a pop at ptr - 1 >=
// max_stack reads entry max_stack - 1; every table index is clamped into
// range; a ray pops at most max_iters entries. These are the reference's
// lockstep semantics per ray (its dropped scatter, its clamped gathers,
// its global iteration cap, which every live ray meets once an
// iteration).
//
// Numerics: built with -fmad=false and IEEE division; every dot and cross
// product, the affine transforms (core/math3d.py affine_apply_point /
// affine_apply_dir) and the slab test sum in the plain version's order.
// 1/d is unguarded, as the reference's Ray.rcp_d: on an axis-aligned ray
// (o - bmin) * inf can be NaN, which jnp.minimum / torch.minimum carry
// into tmin and tmax, so every comparison fails and the box is missed;
// fminf / fmaxf would drop the NaN, so the slab test checks for it.
//
// What bounds it on the H100: the pops are data-dependent, serial per ray
// and divergent across a warp; each gathers a node (or a leaf's up to
// four triangles, 36 floats) from L2 at an address no other lane shares.
// The arithmetic is a few hundred operations a pop at most (the bound
// chip_smoke.py prints counts pops, box tests, object-space rays and
// triangle tests of the plain version). This first version is simple and
// right: one thread per ray, 128 threads a block, the stack in local
// memory up to 64 entries (a deeper one in device memory, entry k of ray
// i at scratch[k * N + i], coalesced across a warp).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNodeBits = 21;
constexpr uint32_t kNodeMask = (1u << kNodeBits) - 1u;
constexpr int kMaxLeaf = 4;
constexpr int kLocalStack = 64;
constexpr int kThreads = 128;
constexpr float kMissT = 1e9f;
constexpr float kAabbMiss = 1e30f;
constexpr float kDetEps = 1e-5f;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return V3{a.x - b.x, a.y - b.y, a.z - b.z};
}

__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}

// Row k of an (R, 3) f32 table, k clamped into [0, R).
__device__ __forceinline__ V3 row3(const float* __restrict__ p, int k,
                                   int rows) {
  k = min(max(k, 0), rows - 1);
  return V3{p[3 * k], p[3 * k + 1], p[3 * k + 2]};
}

__device__ __forceinline__ int at(const int* __restrict__ p, int k,
                                  int rows) {
  return p[min(max(k, 0), rows - 1)];
}

// The reference's slab test: the entry distance, or 1e30 on a miss; a NaN
// on any axis is a miss.
__device__ __forceinline__ float intersect_aabb(V3 o, V3 rd, V3 lo, V3 hi) {
  const float t1x = (lo.x - o.x) * rd.x, t2x = (hi.x - o.x) * rd.x;
  const float t1y = (lo.y - o.y) * rd.y, t2y = (hi.y - o.y) * rd.y;
  const float t1z = (lo.z - o.z) * rd.z, t2z = (hi.z - o.z) * rd.z;
  if (isnan(t1x) || isnan(t2x) || isnan(t1y) || isnan(t2y) || isnan(t1z) ||
      isnan(t2z)) {
    return kAabbMiss;
  }
  const float tmin =
      fmaxf(fminf(t1x, t2x), fmaxf(fminf(t1y, t2y), fminf(t1z, t2z)));
  const float tmax =
      fminf(fmaxf(t1x, t2x), fminf(fmaxf(t1y, t2y), fmaxf(t1z, t2z)));
  return (tmax >= tmin && tmax > 0.f) ? tmin : kAabbMiss;
}

// m (3, 4) row-major: m p + m[:, 3] and m d, summed left to right.
__device__ __forceinline__ V3 apply_point(const float* __restrict__ m, V3 p) {
  return V3{m[0] * p.x + m[1] * p.y + m[2] * p.z + m[3],
            m[4] * p.x + m[5] * p.y + m[6] * p.z + m[7],
            m[8] * p.x + m[9] * p.y + m[10] * p.z + m[11]};
}

__device__ __forceinline__ V3 apply_dir(const float* __restrict__ m, V3 d) {
  return V3{m[0] * d.x + m[1] * d.y + m[2] * d.z,
            m[4] * d.x + m[5] * d.y + m[6] * d.z,
            m[8] * d.x + m[9] * d.y + m[10] * d.z};
}

__device__ __forceinline__ V3 rcp(V3 d) {
  return V3{1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
}

struct Best {
  float t, u, v;
  int tri, inst, front, steps;
};

// Moller-Trumbore of ray (o, d) against triangle `tri`, bounded by b.t;
// a hit replaces the best.
__device__ __forceinline__ void test_triangle(
    const float* __restrict__ tri_pos, int n_tris, int tri, int inst, V3 o,
    V3 d, Best& b) {
  const int k = min(max(tri, 0), n_tris - 1);
  const float* p = tri_pos + 9 * k;
  const V3 v0{p[0], p[1], p[2]}, v1{p[3], p[4], p[5]}, v2{p[6], p[7], p[8]};
  const V3 e1 = sub(v1, v0), e2 = sub(v2, v0);
  const V3 pvec = cross(d, e2);
  const float det = dot(e1, pvec);
  const float inv_det = fabsf(det) < kDetEps ? 0.f : 1.0f / det;
  const V3 tvec = sub(o, v0);
  const float u = dot(tvec, pvec) * inv_det;
  const V3 qvec = cross(tvec, e1);
  const float v = dot(d, qvec) * inv_det;
  const float t = dot(e2, qvec) * inv_det;
  if (fabsf(det) >= kDetEps && u >= 0.f && u <= 1.f && v >= 0.f &&
      u + v <= 1.f && t > 0.f && t < b.t) {
    b.t = t;
    b.u = u;
    b.v = v;
    b.tri = tri;
    b.inst = inst;
    b.front = dot(cross(e1, e2), d) < 0.f;
  }
}

// A ray's stack: `max_stack` entries, in registers/local memory up to
// kLocalStack, else in `scratch` (entry k at scratch[k * n]).
template <bool kLocal>
struct Stack {
  uint32_t local[kLocal ? kLocalStack : 1];
  uint32_t* scratch;
  size_t n;
  __device__ __forceinline__ uint32_t get(int k) const {
    return kLocal ? local[k] : scratch[(size_t)k * n];
  }
  __device__ __forceinline__ void set(int k, uint32_t e) {
    if (kLocal) {
      local[k] = e;
    } else {
      scratch[(size_t)k * n] = e;
    }
  }
};

template <bool kLocal>
__global__ void __launch_bounds__(kThreads) trace_bvh_kernel(
    const float* __restrict__ rays, const uint8_t* __restrict__ active,
    const float* __restrict__ tri_pos, const float* __restrict__ node_min,
    const float* __restrict__ node_max, const int* __restrict__ node_left,
    const int* __restrict__ node_right, const int* __restrict__ node_first,
    const int* __restrict__ node_count, const float* __restrict__ tlas_min,
    const float* __restrict__ tlas_max, const int* __restrict__ tlas_left,
    const int* __restrict__ tlas_right, const int* __restrict__ tlas_inst,
    const float* __restrict__ inst_inv, const int* __restrict__ inst_root,
    uint32_t* __restrict__ scratch, float* __restrict__ out_f,
    int* __restrict__ out_i, int n, int n_tris, int n_nodes, int n_tlas,
    int n_inst, int max_stack, int max_iters) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const V3 o{rays[i], rays[n + i], rays[2 * n + i]};
  const V3 d{rays[3 * n + i], rays[4 * n + i], rays[5 * n + i]};
  const V3 rw = rcp(d);

  Stack<kLocal> st;
  st.scratch = scratch + i;
  st.n = (size_t)n;
  Best b{kMissT, 0.f, 0.f, 0, 0, 0, 0};
  int ptr = active[i] ? 1 : 0;
  if (ptr) st.set(0, 0u);  // the root, TLAS node 0
  for (int it = 0; ptr > 0 && it < max_iters; ++it) {
    const uint32_t entry = st.get(min(ptr - 1, max_stack - 1));
    --ptr;
    const uint32_t tag = entry >> kNodeBits;
    const int node = (int)(entry & kNodeMask);
    uint32_t left = 0, right = 0, near = 0, far = 0;
    float dl = kAabbMiss, dr = kAabbMiss;
    bool inner = false, near_ok = false, far_ok = false;
    if (tag == 0) {
      const int l = at(tlas_left, node, n_tlas);
      if (l == 0) {  // a leaf: its instance's BLAS root goes on top
        const int li = at(tlas_inst, node, n_tlas);
        near = ((uint32_t)(li + 1) << kNodeBits) |
               (uint32_t)at(inst_root, li, n_inst);
        near_ok = true;
      } else {
        const int r = at(tlas_right, node, n_tlas);
        dl = intersect_aabb(o, rw, row3(tlas_min, l, n_tlas),
                            row3(tlas_max, l, n_tlas));
        dr = intersect_aabb(o, rw, row3(tlas_min, r, n_tlas),
                            row3(tlas_max, r, n_tlas));
        left = (uint32_t)l;
        right = (uint32_t)r;
        inner = true;
      }
    } else {
      const int inst = (int)tag - 1;
      const float* m = inst_inv + 12 * min(inst, n_inst - 1);
      const V3 oo = apply_point(m, o), dd = apply_dir(m, d);
      const int count = at(node_count, node, n_nodes);
      if (count > 0) {
        const int first = at(node_first, node, n_nodes);
#pragma unroll
        for (int k = 0; k < kMaxLeaf; ++k) {
          if (k < count) {
            ++b.steps;
            test_triangle(tri_pos, n_tris, first + k, inst, oo, dd, b);
          }
        }
      } else if (count == 0) {
        const V3 ro = rcp(dd);
        const int l = at(node_left, node, n_nodes);
        const int r = at(node_right, node, n_nodes);
        dl = intersect_aabb(oo, ro, row3(node_min, l, n_nodes),
                            row3(node_max, l, n_nodes));
        dr = intersect_aabb(oo, ro, row3(node_min, r, n_nodes),
                            row3(node_max, r, n_nodes));
        left = (tag << kNodeBits) | (uint32_t)l;
        right = (tag << kNodeBits) | (uint32_t)r;
        inner = true;
      }
    }
    if (inner) {
      const bool left_ok = dl < b.t, right_ok = dr < b.t;
      const bool left_near = dl < dr;
      near = left_near ? left : right;
      far = left_near ? right : left;
      near_ok = left_near ? left_ok : right_ok;
      far_ok = left_near ? right_ok : left_ok;
    }
    if (far_ok) {
      if (ptr < max_stack) st.set(ptr, far);
      ++ptr;
    }
    if (near_ok) {
      if (ptr < max_stack) st.set(ptr, near);
      ++ptr;
    }
  }
  out_f[i] = b.t;
  out_f[n + i] = b.u;
  out_f[2 * n + i] = b.v;
  out_i[i] = b.tri;
  out_i[n + i] = b.inst;
  out_i[2 * n + i] = b.front;
  out_i[3 * n + i] = b.steps;
}

}  // namespace

// Launches on `stream`; does not synchronise. Returns cudaGetLastError()
// (0 = launched).
extern "C" int trace_bvh(
    const void* rays, const void* active, const void* tri_pos,
    const void* node_min, const void* node_max, const void* node_left,
    const void* node_right, const void* node_first, const void* node_count,
    const void* tlas_min, const void* tlas_max, const void* tlas_left,
    const void* tlas_right, const void* tlas_inst, const void* inst_inv,
    const void* inst_root, void* scratch, void* out_f, void* out_i, int n,
    int n_tris, int n_nodes, int n_tlas, int n_inst, int max_stack,
    int max_iters, void* stream) {
  if (n <= 0 || n_tris <= 0 || n_nodes <= 0 || n_tlas <= 0 || n_inst <= 0 ||
      max_stack < 1 || max_iters < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (n + kThreads - 1) / kThreads;
  const cudaStream_t s = (cudaStream_t)stream;
#define GDPT_TRACE_BVH_ARGS                                                   \
  (const float*)rays, (const uint8_t*)active, (const float*)tri_pos,          \
      (const float*)node_min, (const float*)node_max,                         \
      (const int*)node_left, (const int*)node_right, (const int*)node_first,  \
      (const int*)node_count, (const float*)tlas_min, (const float*)tlas_max, \
      (const int*)tlas_left, (const int*)tlas_right, (const int*)tlas_inst,   \
      (const float*)inst_inv, (const int*)inst_root, (uint32_t*)scratch,      \
      (float*)out_f, (int*)out_i, n, n_tris, n_nodes, n_tlas, n_inst,         \
      max_stack, max_iters
  if (max_stack <= kLocalStack) {
    trace_bvh_kernel<true><<<blocks, kThreads, 0, s>>>(GDPT_TRACE_BVH_ARGS);
  } else {
    trace_bvh_kernel<false><<<blocks, kThreads, 0, s>>>(GDPT_TRACE_BVH_ARGS);
  }
#undef GDPT_TRACE_BVH_ARGS
  return (int)cudaGetLastError();
}
