// Regen's lane bookkeeping for Hopper (sm_90a): the sort key, and the
// permute, log append and refill after the stable sort.
//
// Replaces no TPU kernel: the reference runs this step as plain XLA inside
// its regen loop (gdpathtracing_tpu/render/regen.py), where XLA fuses it;
// the port ran it as ~245 PyTorch ops an iteration (the Morton key, the two
// stack gathers, the log append, the PCG2D seed hash and draw, the camera
// ray, the refill's cat and where), each a launch, which kept the card idle
// while the host issued them. Two entry points around the stable
// torch.argsort that stays between them (ops/lanes.py):
//
// regen_lane_key: the sort key of every lane, render/regen.py's Morton key
//   in   fs       (17, *) f32  lane state (render/regen.py layout; row r at
//                              fs[r * ld_fs + lane]): 0:3 o | 3:6 d
//        alive, dead (n,) u8   lanes that go on; lanes that ended now
//        lo, span (3,) f32     render/integrator.py morton_frame
//   out  key      (n,) i32     live: integrator.morton_octant_key (the
//                              9-bit Morton cell of the origin in the 8^3
//                              grid * 8 + the octant of the direction);
//                              ended now 1 << 14; dead before 1 << 15
//
// regen_lane_refill: with perm = argsort(key, stable), so that the n_alive
// live lanes come first, then the n_fresh lanes that ended now,
//   in   perm     (n,) i64     the permutation
//        fs, is   (17, *) f32, (6, *) i64  the stacks it permutes (is:
//                              0:2 PCG2D words | 2 path id | 3 bounce |
//                              4 steps | 5 segments)
//        cam      (13,) f32    the camera's (3, 4) transform row-major,
//                              then the tan of its half FOV
//   out  log_f    (7, ld_log) f32, log_i (3, ld_log) i64: the lanes
//                              n_alive + k, k < n_fresh, append to column
//                              retired + k (radiance, depth, normal; steps
//                              clamped to 2^19 - 1, segments, path id)
//        fs, is   (17, n), (6, n)  lane i: the gathered column perm[i];
//                              where i >= n_alive and the path id
//                              next_path + i - n_alive is below n_paths,
//                              that path's fresh state instead
//        active   (n,) u8      i < n_alive, or refilled
//
// Since the sort puts every dead lane after the live ones, the torch glue's
// cumsum over the dead lanes is i - n_alive + 1 at lane i: no scan. A fresh
// path is render/regen.py's spawn in the term order of core/rng.py
// prng_seed and pcg2d and render/camera.py generate_rays: pixel id % n_pix,
// sample id / n_pix, the seed of (pixel % w, pixel / w, frame_index * spp +
// sample), one PCG2D draw, the jitter, (p + 0.5 + j) / w * 2 - 1 with an
// IEEE division (as by camera.py's device tensor), the products with
// half_tan and the aspect, the 3x3 transform summed left to right, the
// normalisation by 1 / sqrt, the origin pos + d * 0. -fmad=false keeps
// every product and sum rounded on its own, as PyTorch's ops round them;
// logf (the Gaussian jitter), sinf and cosf are the CUDA math library's,
// which PyTorch's CUDA log, sin and cos call.
//
// What bounds it on the H100: device memory, and little of it. The key
// reads 6 state rows and two masks and writes the key: 30 bytes a lane.
// The refill reads perm and a live lane's 17 float and 6 int64 rows (116
// bytes; a logged lane's 10 rows of them again), writes 116 bytes and the
// mask: ~240 bytes a lane, ~95 MB at 393216 lanes, ~28 us at 3.35 TB/s.
// The point is the launches the host no longer issues, not device time.
// Design: a thread per lane, writes coalesced (lane fastest), the gathers
// one column each, read only where the lane keeps or logs them.

#include "path_common.cuh"

namespace {

using namespace gdpt;

constexpr int kBlock = 256;
constexpr long long kStepsMax = (1LL << 19) - 1;
constexpr unsigned kGolden = 0x9E3779B9u;
enum Jitter { kNone = 0, kUniform = 1, kGauss = 2, kCircle = 3 };

// integrator.morton_octant_key's q3: the cell of x in 8 along one axis.
__device__ __forceinline__ int cell8(float x, float lo, float span) {
  return (int)clamp01((x - lo) / span * 8.0f, 0.0f, 7.0f);
}

__global__ void __launch_bounds__(kBlock)
regen_lane_key_kernel(const float* __restrict__ fs, const int ld_fs,
                      const unsigned char* __restrict__ alive,
                      const unsigned char* __restrict__ dead,
                      const float* __restrict__ lo,
                      const float* __restrict__ span, int* __restrict__ key,
                      const int n) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  if (!alive[i]) {
    key[i] = dead[i] ? (1 << 14) : (1 << 15);
    return;
  }
  const float* f = fs + i;
  const auto F = [&](int r) { return f[(size_t)r * ld_fs]; };
  const int qx = cell8(F(0), lo[0], span[0]);
  const int qy = cell8(F(1), lo[1], span[1]);
  const int qz = cell8(F(2), lo[2], span[2]);
  int cell = 0;
  for (int b = 0; b < 3; ++b) {  // 9-bit Morton interleave of 3-bit cells
    cell |= (((qx >> b) & 1) << (3 * b + 2)) |
            (((qy >> b) & 1) << (3 * b + 1)) | (((qz >> b) & 1) << (3 * b));
  }
  const int octant =
      (F(3) > 0.0f ? 4 : 0) + (F(4) > 0.0f ? 2 : 0) + (F(5) > 0.0f ? 1 : 0);
  key[i] = cell * 8 + octant;
}

struct Refill {
  int n, ld_fs, ld_is, ld_log;
  int n_alive, n_fresh, retired, next_path, n_paths;
  int width, height, jitter;
  unsigned frame_base;  // frame_index * spp mod 2^32
  float aspect, far;
};

// render/regen.py spawn of path `id`: its camera ray and its PCG2D words
// after the draw generate_rays takes.
__device__ __forceinline__ void spawn(int id, const float* __restrict__ cam,
                                      const Refill& p, V3& o, V3& d,
                                      unsigned& sx, unsigned& sy) {
  const int n_pix = p.width * p.height;
  const int pix = id % n_pix, sample = id / n_pix;
  const int ix = pix % p.width, iy = pix / p.width;
  // core/rng.py prng_seed
  const unsigned frame = p.frame_base + (unsigned)sample;
  sx = (unsigned)ix * kGolden + frame;
  sy = (unsigned)iy * kGolden + frame;
  sx = sx ^ (sx >> 16);
  sy = sy ^ (sy >> 16);
  sx = sx * kGolden;
  sy = sy * kGolden;
  // render/camera.py generate_rays
  float r1, r2;
  pcg2d(sx, sy, r1, r2);
  float jx = 0.0f, jy = 0.0f;
  const float two_pi = (float)6.2831853;
  if (p.jitter == kUniform) {
    jx = r1 - 0.5f;
    jy = r2 - 0.5f;
  } else if (p.jitter == kGauss) {
    const float radius =
        sqrtf(-2.0f * logf(clamp_lo(r1, (float)1e-10))) * 0.375f;
    const float theta = two_pi * r2;
    jx = radius * cosf(theta);
    jy = radius * sinf(theta);
  } else if (p.jitter == kCircle) {
    const float theta = two_pi * r2;
    jx = cosf(theta);
    jy = sinf(theta);
  }
  const float sxn = ((float)ix + 0.5f + jx) / (float)p.width * 2.0f - 1.0f;
  const float syn = ((float)iy + 0.5f + jy) / (float)p.height * 2.0f - 1.0f;
  const float half_tan = cam[12];
  const float cx = sxn * (half_tan * p.aspect);
  const float cy = -syn * half_tan;
  const float cz = -1.0f;
  const V3 dd{cam[0] * cx + cam[1] * cy + cam[2] * cz,
              cam[4] * cx + cam[5] * cy + cam[6] * cz,
              cam[8] * cx + cam[9] * cy + cam[10] * cz};
  d = dd * (1.0f / sqrtf(dot(dd, dd)));  // core/vec.py normalize()
  o = V3{cam[3] + d.x * 0.0f, cam[7] + d.y * 0.0f, cam[11] + d.z * 0.0f};
}

__global__ void __launch_bounds__(kBlock)
regen_lane_refill_kernel(const long long* __restrict__ perm,
                         const float* __restrict__ fs,
                         const long long* __restrict__ is,
                         const float* __restrict__ cam,
                         float* __restrict__ log_f,
                         long long* __restrict__ log_i,
                         float* __restrict__ fs_out,
                         long long* __restrict__ is_out,
                         unsigned char* __restrict__ active,
                         const Refill p) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= p.n) return;
  const size_t n = (size_t)p.n, ld_log = (size_t)p.ld_log;
  const float* f = fs + perm[i];
  const auto F = [&](int r) { return f[(size_t)r * p.ld_fs]; };
  const long long* iv = is + perm[i];
  const auto I = [&](int r) { return iv[(size_t)r * p.ld_is]; };
  const int k = i - p.n_alive;  // the lane's place among the dead
  if (k >= 0 && k < p.n_fresh) {  // the freshly dead block's log columns
    const size_t c = (size_t)p.retired + k;
    // render/regen.py _LOG_F: rows 9:12 radiance, 13 depth, 14:17 normal
    for (int r = 0; r < 7; ++r) {
      log_f[r * ld_log + c] = F(r < 3 ? 9 + r : 10 + r);
    }
    const long long steps = I(4);
    log_i[c] = steps < kStepsMax ? steps : kStepsMax;
    log_i[ld_log + c] = I(5);
    log_i[2 * ld_log + c] = I(2);
  }
  const bool can = k >= 0 && (long long)p.next_path + k < p.n_paths;
  float* g = fs_out + i;
  long long* h = is_out + i;
  if (can) {
    const int id = p.next_path + k;
    V3 o, d;
    unsigned sx, sy;
    spawn(id, cam, p, o, d, sx, sy);
    // render/regen.py's initial stacks: throughput 1, radiance 0, prev
    // pdf -1, depth far, normal 0; bounce, steps and segments 0.
    const float st[17] = {o.x,  o.y,  o.z,  d.x,   d.y,  d.z,
                          1.0f, 1.0f, 1.0f, 0.0f,  0.0f, 0.0f,
                          -1.0f, p.far, 0.0f, 0.0f, 0.0f};
    for (int r = 0; r < 17; ++r) g[r * n] = st[r];
    h[0] = (long long)sx;
    h[n] = (long long)sy;
    h[2 * n] = id;
    h[3 * n] = 0;
    h[4 * n] = 0;
    h[5 * n] = 0;
  } else {
    for (int r = 0; r < 17; ++r) g[r * n] = F(r);
    for (int r = 0; r < 6; ++r) h[r * n] = I(r);
  }
  active[i] = (k < 0 || can) ? 1 : 0;
}

}  // namespace

// Launches on `stream`; does not synchronise. Returns the first CUDA error
// (0 = launched).
extern "C" int regen_lane_key(const void* fs, const void* alive,
                              const void* dead, const void* lo,
                              const void* span, void* key, int n, int ld_fs,
                              void* stream) {
  if (n <= 0 || ld_fs < n) return (int)cudaErrorInvalidValue;
  regen_lane_key_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                          (cudaStream_t)stream>>>(
      (const float*)fs, ld_fs, (const unsigned char*)alive,
      (const unsigned char*)dead, (const float*)lo, (const float*)span,
      (int*)key, n);
  return (int)cudaGetLastError();
}

extern "C" int regen_lane_refill(const void* perm, const void* fs,
                                 const void* is, const void* cam,
                                 void* log_f, void* log_i, void* fs_out,
                                 void* is_out, void* active, int n,
                                 int ld_fs, int ld_is, int ld_log,
                                 int n_alive, int n_fresh, int retired,
                                 int next_path, int n_paths, int width,
                                 int height, int frame_base, int jitter,
                                 float aspect, float far, void* stream) {
  if (n <= 0 || ld_fs < n || ld_is < n || n_alive < 0 || n_fresh < 0 ||
      n_alive + n_fresh > n || retired < 0 || retired + n_fresh > ld_log ||
      width <= 0 || height <= 0 || jitter < kNone || jitter > kCircle) {
    return (int)cudaErrorInvalidValue;
  }
  const Refill p{n,         ld_fs,   ld_is,  ld_log,
                 n_alive,   n_fresh, retired, next_path,
                 n_paths,   width,   height, jitter,
                 (unsigned)frame_base, aspect, far};
  regen_lane_refill_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                             (cudaStream_t)stream>>>(
      (const long long*)perm, (const float*)fs, (const long long*)is,
      (const float*)cam, (float*)log_f, (long long*)log_i, (float*)fs_out,
      (long long*)is_out, (unsigned char*)active, p);
  return (int)cudaGetLastError();
}
