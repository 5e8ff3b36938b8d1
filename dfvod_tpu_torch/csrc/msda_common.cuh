// Shared pieces of the CUDA kernels: the MSDA level table (msda_fwd.cu,
// msda_bwd.cu), the dtype codes of the Python wrappers, the block size and
// the f32 conversions (also hat_sample_fwd.cu, hat_sample_bwd.cu), the
// 8-channel vector loads (hat_sample_*.cu) and the f32 -> bf16 cast pass of
// the backward kernels' gradient accumulators (msda_bwd.cu,
// hat_sample_bwd.cu).
#pragma once

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

// 8 contiguous channels, 16-byte aligned, loaded as f32
constexpr int kVec = 8;

__device__ __forceinline__ void load8(const float* p, float f[kVec]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float f[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
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
