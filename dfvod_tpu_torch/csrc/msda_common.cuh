// Shared pieces of the CUDA kernels: the MSDA level table, sample corners
// and warp layout (msda_fwd.cu, msda_bwd.cu), the dtype codes of the Python
// wrappers, the block size and the f32 conversions (also hat_sample_fwd.cu,
// hat_sample_bwd.cu), the 16-byte vector loads and stores (also
// hat_sample_fwd.cu; the bf16 4-channel load also hat_sample_bwd.cu), the
// 16-byte vector atomics (msda_bwd.cu) and the f32 -> bf16 cast pass of the
// backward kernels' gradient accumulators.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace msda {

constexpr int kMaxLevels = 16;
constexpr int kWarpsPerBlock = 8;

// dtype codes shared with the Python wrapper
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

struct Levels {
  int n;
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

// The level table of `shapes` ((H, W) pairs). Returns 0, -1 for a level
// count outside 1..kMaxLevels, or -2 when S != sum(H * W).
inline int make_levels(int L, const int* shapes, int S, Levels* lv) {
  if (L < 1 || L > kMaxLevels) return -1;
  *lv = Levels{};
  lv->n = L;
  long long start = 0;
  for (int l = 0; l < L; ++l) {
    lv->h[l] = shapes[2 * l];
    lv->w[l] = shapes[2 * l + 1];
    lv->start[l] = (int)start;
    start += (long long)lv->h[l] * lv->w[l];
  }
  return start == S ? 0 : -2;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Add s * f[0..n) into the f32 row at p (16-byte aligned, n a multiple of
// 4) as 16-byte float4 atomics, which sm_90 has: a quarter of the scalar
// atomics' instructions.
template <int n>
__device__ __forceinline__ void atomic_add_scaled(float* p, const float* f,
                                                  float s) {
#pragma unroll
  for (int j = 0; j < n; j += 4)
    atomicAdd(reinterpret_cast<float4*>(p + j),
              make_float4(s * f[j], s * f[j + 1], s * f[j + 2], s * f[j + 3]));
}

// ---------------------------------------------------- MSDA (K1, K2)
// One 16-byte chunk of a row: kChunk<V> channels of V, loaded as raw bits
// (zero bits are 0.f in both types) and widened to f32.
template <typename V>
constexpr int kChunk = 16 / (int)sizeof(V);

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

template <typename V>
__device__ __forceinline__ void widen(uint4 u, float* f);
template <>
__device__ __forceinline__ void widen<float>(uint4 u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
template <>
__device__ __forceinline__ void widen<__nv_bfloat16>(uint4 u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// 4 bf16 channels at p (8-byte aligned), widened to f32.
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* f) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  f[0] = a.x;
  f[1] = a.y;
  f[2] = b.x;
  f[3] = b.y;
}

// kChunk<V> f32 values rounded to V, as one 16-byte word.
template <typename V>
__device__ __forceinline__ uint4 narrow(const float* f);
template <>
__device__ __forceinline__ uint4 narrow<float>(const float* f) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
template <>
__device__ __forceinline__ uint4 narrow<__nv_bfloat16>(const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

// The four corners 00 01 10 11 of one sample point on a level of H x W
// tokens: token offsets within the level (read only where ok), whether each
// lies on the map, bilinear weights (the attention weight not folded in) and
// the fractions.
struct SampleCorners {
  int t[4];
  bool ok[4];
  float w[4];
  float fx, fy;
};

// The corners of the point at normalized (lx, ly), or false when all four
// lie outside the map (a NaN or infinite coordinate included). Pixel
// coordinates are rounded as PyTorch rounds `loc * W - 0.5` (no fused
// multiply-add), so floor(px) agrees with the plain version bit for bit.
// kClosedLow keeps a point at exactly -1, whose value there is 0 but whose
// corner at 0 carries a derivative (the backward); the forward drops it.
template <bool kClosedLow>
__device__ __forceinline__ bool msda_corners(float lx, float ly, int H, int W,
                                             SampleCorners* c) {
  const float x = __fsub_rn(__fmul_rn(lx, (float)W), 0.5f);
  const float y = __fsub_rn(__fmul_rn(ly, (float)H), 0.5f);
  const bool low = kClosedLow ? (x >= -1.f && y >= -1.f)
                              : (x > -1.f && y > -1.f);
  if (!(low && x < (float)W && y < (float)H)) return false;
  const float x0f = floorf(x), y0f = floorf(y);
  const int x0 = (int)x0f, y0 = (int)y0f;
  const float fx = x - x0f, fy = y - y0f;
  const bool xl = x0 >= 0, xr = x0 + 1 < W, yt = y0 >= 0, yb = y0 + 1 < H;
  const int t00 = y0 * W + x0;
  c->t[0] = t00;
  c->t[1] = t00 + 1;
  c->t[2] = t00 + W;
  c->t[3] = t00 + W + 1;
  c->ok[0] = yt && xl;
  c->ok[1] = yt && xr;
  c->ok[2] = yb && xl;
  c->ok[3] = yb && xr;
  c->w[0] = (1.f - fy) * (1.f - fx);
  c->w[1] = (1.f - fy) * fx;
  c->w[2] = fy * (1.f - fx);
  c->w[3] = fy * fx;
  c->fx = fx;
  c->fy = fy;
  return true;
}

// The warp layout of the vector kernels. A row of D channels is `g` 16-byte
// chunks, one per lane; a slot of 2^lg_gp >= g lanes holds one sample point
// (lanes g.. of a slot idle), 2^lg_spq slots hold the points of one
// (b, q, m), and a warp holds 2^lg_qw neighbouring queries of one (b, m).
// Each slot walks `iters` of its query's L * P points, 2^lg_spq apart.
struct Slots {
  int g, lg_gp, lg_spq, lg_qw, iters;
};

// The layout for rows of D elements of elem_size bytes and np = L * P
// points per query; false where a row is not a whole number of 16-byte
// chunks or takes more than 32 of them (the scalar kernels take those).
inline bool make_slots(int D, int elem_size, int np, Slots* sl) {
  if (D <= 0 || np <= 0 || (D * elem_size) % 16 != 0) return false;
  const int g = D * elem_size / 16;
  if (g > 32) return false;
  int lg_gp = 0, lg_np = 0;
  while ((1 << lg_gp) < g) ++lg_gp;
  while ((1 << lg_np) < np) ++lg_np;
  const int lg_slots = 5 - lg_gp;  // slots per warp
  sl->g = g;
  sl->lg_gp = lg_gp;
  sl->lg_spq = lg_np < lg_slots ? lg_np : lg_slots;
  sl->lg_qw = lg_slots - sl->lg_spq;
  sl->iters = (np + (1 << sl->lg_spq) - 1) >> sl->lg_spq;
  return true;
}

// The grid of the MSDA kernels, (rows / kWarpsPerBlock, M, B) for `rows`
// warps per (b, m), so a warp finds its (b, m) and block of queries without
// a division; false when a dimension exceeds what a launch takes.
inline bool msda_grid(long long rows, int M, int B, dim3* grid) {
  const long long x = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (x > 0x7fffffffLL || M > 65535 || B > 65535) return false;
  *grid = dim3((unsigned)x, (unsigned)M, (unsigned)B);
  return true;
}

inline bool empty_grid(const dim3& grid) {
  return grid.x == 0 || grid.y == 0 || grid.z == 0;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

__global__ void cast_to_bf16(const float* __restrict__ in,
                             __nv_bfloat16* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = __float2bfloat16_rn(in[i]);
}

// Round an f32 gradient accumulator of n elements into its bf16 gradient,
// on `stream`. Returns the launch's cudaError_t.
inline int launch_cast_to_bf16(const float* in, __nv_bfloat16* out,
                               long long n, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  long long blocks = (n + 255) / 256;
  if (blocks > 132LL * 32) blocks = 132LL * 32;
  cast_to_bf16<<<(unsigned)blocks, 256, 0, stream>>>(in, out, n);
  return (int)cudaGetLastError();
}

}  // namespace msda
