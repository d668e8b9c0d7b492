// Regen's per-segment shading and continuation for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference runs this step as plain XLA inside
// its regen loop (gdpathtracing_tpu/render/regen.py), where XLA fuses it;
// the port ran it as ~620 PyTorch elementwise ops an iteration, each a
// launch over every lane, which kept the card idle while the host issued
// them. Contract (ops/shade.py regen_shade): one regen iteration's shading
// of a wavefront of n lanes whose segment kernel 1 (or 6) just traced,
//
//   in   rows     (48, *) f32  the winner rows (ops/intersect.py
//                              build_trace_table layout; row r at
//                              rows[r * ld_rows + lane]): 0:9 normals,
//                              17:26 material, 40 t, 41 u, 42 v, 43 w_d,
//                              45 steps
//        fs       (17, *) f32  lane state (render/regen.py): 0:3 o | 3:6 d
//                              | 6:9 throughput | 9:12 radiance | 12 prev
//                              pdf | 13 depth | 14:17 first-hit normal
//        is       (6, *) i64   0:2 PCG2D words in [0, 2^32) | 2 path id |
//                              3 bounce | 4 steps | 5 segments
//        active   (n,) u8      the lanes that hold a path
//   out  fs, is   (17, n), (6, n)  the state after the segment
//        alive, dead (n,) u8   lanes that go on; lanes that ended now
//        counts   (2,) i32     sum of alive, sum of dead
//
// Per lane, in the order of regen.py's torch body (_shade_torch): t (1e9
// where inactive), the clipped u and v and front from the rows; steps +=
// active ? rows[45] : 0, segments += active; the shading record from the
// rows (path_common.cuh shade_rows), the analytic sky, emission = hit ?
// the surface's : the sky's, radiance += throughput * emission where
// active; on bounce 0 the first-hit depth and normal; one PCG2D draw
// (taken on every lane, as the torch body does), the BRDF sample, its pdf
// and value, survival and the ray_eps offset; the survive-selects of
// origin, direction, throughput and prev pdf; bounce += active. Scope
// (ops/shade.py shade_entry): no NEE, march, transmission, textures,
// environment map or Russian roulette, and at least one bounce.
//
// What bounds it on the H100: device memory. A lane reads 23 rows of its
// winner, 17 float and 6 int64 state rows and its mask, and writes 23
// state rows and two masks: 325 bytes, ~128 MB an iteration at 393216
// lanes, ~38 us at 3.35 TB/s; ~600 operations a lane (shading, sky,
// PCG2D, BRDF sample, pdf and value) are ~4 us at 67 TFLOP/s. The design:
// a thread per lane, every row read and written once, coalesced (lane
// fastest), the two counts by __syncthreads_count and one atomicAdd each
// a block into a buffer the entry point zeroes on the same stream.
//
// The second entry, regen_shade_lite (ops/shade.py regen_shade_lite), is
// the same iteration on the winners of kernel 3 (closest_hit_sc_lite.cu),
// which returns no winner rows:
//
//   in   lite     (8, *) f32   row 0 t (1e9 on a miss), 1 eidx (exact),
//                              2 triangles swept; row r at
//                              lite[r * ld_lite + lane]
//        cols     (E, 12) f32  Scene.isect_cols row-major: the mu, mv,
//                              mw rows of each expanded triangle
//        shade    (E, 16) f32  Scene.isect_shade: 0:9 vertex normals,
//                              9:15 uvs, 15 material index
//        mats     (M, 13) f32  render/shading.py material_table (the
//                              three tables: ops/shade.py lite_tables)
//        fs, is, active, and every output as regen_shade's
//
// Per lane it first does what ops/intersect.py lite_epilogue does: eidx
// is 0 where the raw t misses; u = dot4(cols[0:4], o, 1) + t * dot4(cols
// [0:4], d, 0) and v likewise from cols[4:8], w_d = dot4(cols[8:12], d,
// 0), each 4-term dot summed left to right, u and v from the raw t and
// clipped, front = w_d < 0; steps from row 2. Then regen_shade's lane
// with the shading record of render/shading.py get_shading_data_fast:
// shade[eidx] and mats[shade[eidx][15]] give what the winner rows' 0:9 and
// 17:26 give, in the same terms, so both entries run one device function
// (shade_lane) on a `col` accessor. Bytes: 117 of state and mask, 12 of
// winners and 164 of gathers (48 + 64 + 52) read, 118 written, ~411 a
// lane, ~162 MB an iteration at 393216 lanes, ~48 us at 3.35 TB/s; the
// ~11 MB of the grid's tables stay in the 50 MB L2.

#include "path_common.cuh"

namespace {

using namespace gdpt;

constexpr int kBlock = 256;
constexpr float kMissT = 1e9f;

struct Params {
  int n, ld_fs, ld_is, bounces;
  float ray_eps;
  Sky sky;
};

// The segment of one lane as the hit source gives it: t where active
// (kMissT elsewhere), the clipped barycentrics, the side, the triangles
// swept.
struct Hit {
  float t, u, v;
  bool front;
  long long steps;
};

// One lane's shading and continuation (render/regen.py _shade_torch on
// one lane), `col` reading the hit's shading columns in the winner-row
// layout (0:9 vertex normals, 17:26 material). Writes the lane's new
// state and masks; returns alive and dead through the references.
template <typename Col>
__device__ __forceinline__ void shade_lane(
    const Col& col, const Hit& h, bool act, int lane, const float* fs,
    const long long* is, float* fs_out, long long* is_out,
    unsigned char* alive_out, unsigned char* dead_out, const Params& p,
    bool& alive, bool& dead) {
  const size_t n = (size_t)p.n;
  const float* f = fs + lane;
  const auto F = [&](int r) { return f[(size_t)r * p.ld_fs]; };
  const long long* iv = is + lane;
  const auto I = [&](int r) { return iv[(size_t)r * p.ld_is]; };
  const bool hit = h.t < kMissT && act;

  const V3 o{F(0), F(1), F(2)}, d{F(3), F(4), F(5)};
  const V3 tp{F(6), F(7), F(8)};
  V3 rad{F(9), F(10), F(11)};
  const long long bounce = I(3);

  const Shade s = shade_rows(col, h.u, h.v, h.front, o, d, h.t);
  const V3 emission = hit ? s.emission : sample_sky(d.y, p.sky);
  rad = act ? rad + tp * emission : rad;

  const bool first = bounce == 0 && hit;
  const V3 rel = s.pos - o;
  const float depth = first ? sqrtf(dot(rel, rel)) : F(13);
  const V3 n0 = first ? s.n : V3{F(14), F(15), F(16)};

  // integrator.continue_path without transmission and Russian roulette.
  unsigned sx = (unsigned)I(0), sy = (unsigned)I(1);
  float r1, r2;
  pcg2d(sx, sy, r1, r2);
  const BrdfSample b = continue_path(s, r1, r2);
  const float scale = b.pdf > (float)1e-12
                          ? b.lambert_in / clamp_lo(b.pdf, (float)1e-12)
                          : 0.f;
  const V3 mult = b.f * scale;
  const bool survive = hit && b.lambert_in > 0.f && b.pdf > (float)1e-12;
  const V3 new_o = s.pos + s.n * p.ray_eps;
  const V3 o2 = survive ? new_o : o;
  const V3 d2 = survive ? b.dir : d;
  const V3 tp2 = survive ? tp * mult : tp;
  const long long bounce2 = bounce + (act ? 1 : 0);
  alive = act && survive && bounce2 < p.bounces;
  dead = act && !alive;

  float* g = fs_out + lane;
  g[0] = o2.x;
  g[n] = o2.y;
  g[2 * n] = o2.z;
  g[3 * n] = d2.x;
  g[4 * n] = d2.y;
  g[5 * n] = d2.z;
  g[6 * n] = tp2.x;
  g[7 * n] = tp2.y;
  g[8 * n] = tp2.z;
  g[9 * n] = rad.x;
  g[10 * n] = rad.y;
  g[11 * n] = rad.z;
  g[12 * n] = survive ? b.pdf : -1.f;
  g[13 * n] = depth;
  g[14 * n] = n0.x;
  g[15 * n] = n0.y;
  g[16 * n] = n0.z;
  long long* o_is = is_out + lane;
  o_is[0] = (long long)sx;
  o_is[n] = (long long)sy;
  o_is[2 * n] = I(2);
  o_is[3 * n] = bounce2;
  o_is[4 * n] = I(4) + (act ? h.steps : 0);
  o_is[5 * n] = I(5) + (act ? 1 : 0);
  alive_out[lane] = alive ? 1 : 0;
  dead_out[lane] = dead ? 1 : 0;
}

// The block's two counts, one atomicAdd each.
__device__ __forceinline__ void add_counts(bool alive, bool dead,
                                           int* counts) {
  const int n_alive = __syncthreads_count(alive);
  const int n_dead = __syncthreads_count(dead);
  if (threadIdx.x == 0) {
    if (n_alive) atomicAdd(counts, n_alive);
    if (n_dead) atomicAdd(counts + 1, n_dead);
  }
}

__global__ void __launch_bounds__(kBlock)
regen_shade_kernel(const float* __restrict__ rows, const int ld_rows,
                   const float* __restrict__ fs,
                   const long long* __restrict__ is,
                   const unsigned char* __restrict__ active,
                   float* __restrict__ fs_out, long long* __restrict__ is_out,
                   unsigned char* __restrict__ alive_out,
                   unsigned char* __restrict__ dead_out,
                   int* __restrict__ counts, const Params p) {
  const int lane = blockIdx.x * kBlock + threadIdx.x;
  bool alive = false, dead = false;
  if (lane < p.n) {
    const float* rw = rows + lane;
    const auto col = [&](int r) { return rw[(size_t)r * ld_rows]; };
    // ops/intersect.py _hit_from_rows
    const bool act = active[lane] != 0;
    const Hit h{act ? col(40) : kMissT, clamp01(col(41), 0.f, 1.f),
                clamp01(col(42), 0.f, 1.f), col(43) < 0.f,
                (long long)(int)col(45)};
    shade_lane(col, h, act, lane, fs, is, fs_out, is_out, alive_out,
               dead_out, p, alive, dead);
  }
  add_counts(alive, dead, counts);
}

__global__ void __launch_bounds__(kBlock)
regen_shade_lite_kernel(const float* __restrict__ lite, const int ld_lite,
                        const float* __restrict__ cols,
                        const float* __restrict__ shade,
                        const float* __restrict__ mats,
                        const float* __restrict__ fs,
                        const long long* __restrict__ is,
                        const unsigned char* __restrict__ active,
                        float* __restrict__ fs_out,
                        long long* __restrict__ is_out,
                        unsigned char* __restrict__ alive_out,
                        unsigned char* __restrict__ dead_out,
                        int* __restrict__ counts, const Params p) {
  const int lane = blockIdx.x * kBlock + threadIdx.x;
  bool alive = false, dead = false;
  if (lane < p.n) {
    // ops/intersect.py lite_epilogue
    const float* lw = lite + lane;
    const float t_raw = lw[0];
    const int e = t_raw < kMissT ? (int)lw[ld_lite] : 0;
    const float* c = cols + (size_t)e * 12;
    const float* f = fs + lane;
    const auto F = [&](int r) { return f[(size_t)r * p.ld_fs]; };
    const float ox = F(0), oy = F(1), oz = F(2);
    const float dx = F(3), dy = F(4), dz = F(5);
    const auto dot4 = [&](int c0, float x, float y, float z, float w) {
      return c[c0] * x + c[c0 + 1] * y + c[c0 + 2] * z + c[c0 + 3] * w;
    };
    const float u = dot4(0, ox, oy, oz, 1.f) + t_raw * dot4(0, dx, dy, dz, 0.f);
    const float v = dot4(4, ox, oy, oz, 1.f) + t_raw * dot4(4, dx, dy, dz, 0.f);
    const float w_d = dot4(8, dx, dy, dz, 0.f);
    const bool act = active[lane] != 0;
    const Hit h{act ? t_raw : kMissT, clamp01(u, 0.f, 1.f),
                clamp01(v, 0.f, 1.f), w_d < 0.f,
                (long long)(int)lw[2 * (size_t)ld_lite]};
    // render/shading.py get_shading_data_fast: the winner-row columns 0:9
    // are shade[eidx][0:9], 17:26 the material row shade[eidx][15] picks.
    const float* sh = shade + (size_t)e * 16;
    const float* m = mats + (size_t)(long long)sh[15] * 13;
    const auto col = [&](int r) { return r < 17 ? sh[r] : m[r - 17]; };
    shade_lane(col, h, act, lane, fs, is, fs_out, is_out, alive_out,
               dead_out, p, alive, dead);
  }
  add_counts(alive, dead, counts);
}

// Checks the sizes, zeroes `counts` on `stream`; 0 or the CUDA error.
int prologue(int n, int ld_in, int ld_fs, int ld_is, int bounces,
             void* counts, cudaStream_t st) {
  if (n <= 0 || ld_in < n || ld_fs < n || ld_is < n || bounces < 1) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaMemsetAsync(counts, 0, 2 * sizeof(int), st);
}

}  // namespace

// Zeroes `counts` and launches on `stream`; does not synchronise. Returns
// the first CUDA error (0 = launched).
extern "C" int regen_shade(const void* rows, const void* fs, const void* is,
                           const void* active, void* fs_out, void* is_out,
                           void* alive, void* dead, void* counts, int n,
                           int ld_rows, int ld_fs, int ld_is, int bounces,
                           float ray_eps, float sky_hx, float sky_hy,
                           float sky_hz, float sky_dx, float sky_dy,
                           float sky_dz, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int err = prologue(n, ld_rows, ld_fs, ld_is, bounces, counts, st);
  if (err) return err;
  const Params p{n,       ld_fs,  ld_is, bounces, ray_eps,
                 Sky{sky_hx, sky_hy, sky_hz, sky_dx, sky_dy, sky_dz}};
  regen_shade_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0, st>>>(
      (const float*)rows, ld_rows, (const float*)fs, (const long long*)is,
      (const unsigned char*)active, (float*)fs_out, (long long*)is_out,
      (unsigned char*)alive, (unsigned char*)dead, (int*)counts, p);
  return (int)cudaGetLastError();
}

// The same on kernel 3's winners `lite` and the scene's tables.
extern "C" int regen_shade_lite(const void* lite, const void* cols,
                                const void* shade, const void* mats,
                                const void* fs, const void* is,
                                const void* active, void* fs_out,
                                void* is_out, void* alive, void* dead,
                                void* counts, int n, int ld_lite, int ld_fs,
                                int ld_is, int bounces, float ray_eps,
                                float sky_hx, float sky_hy, float sky_hz,
                                float sky_dx, float sky_dy, float sky_dz,
                                void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int err = prologue(n, ld_lite, ld_fs, ld_is, bounces, counts, st);
  if (err) return err;
  const Params p{n,       ld_fs,  ld_is, bounces, ray_eps,
                 Sky{sky_hx, sky_hy, sky_hz, sky_dx, sky_dy, sky_dz}};
  regen_shade_lite_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0, st>>>(
      (const float*)lite, ld_lite, (const float*)cols, (const float*)shade,
      (const float*)mats, (const float*)fs, (const long long*)is,
      (const unsigned char*)active, (float*)fs_out, (long long*)is_out,
      (unsigned char*)alive, (unsigned char*)dead, (int*)counts, p);
  return (int)cudaGetLastError();
}
