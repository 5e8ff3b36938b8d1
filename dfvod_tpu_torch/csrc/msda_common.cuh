// Shared pieces of the CUDA kernels: the MSDA level table (msda_fwd.cu,
// msda_bwd.cu), and the dtype codes of the Python wrappers, the block size
// and the f32 conversions (also hat_sample_fwd.cu).
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

}  // namespace msda
