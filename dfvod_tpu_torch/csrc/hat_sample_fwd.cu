// Weighted bilinear sampling over a token grid (K3) for Hopper (sm_90a):
//
//   out[bm, q, :] = sum_p aw[bm, q, p] * bilinear(value[bm], py, px)
//
// Replaces the TPU kernel dfvod_tpu/ops/msda_pallas.py::_hat_kernel (wrapper
// hat_sample), which RoIAlign reaches through
// dfvod_tpu/ops/roi_align.py::_roi_align_hat in TransVOD++'s Query-RoI
// Fusion. The token grid is regular (token s at row s / W, column s % W) and
// the coordinates are pixel indices: the weight of token (sy, sx) is the
// tent relu(1 - |px - sx|) * relu(1 - |py - sy|), so a corner outside the
// grid contributes 0 and there is no -0.5 shift. The TPU kernel builds that
// tent matrix densely, (TQ, S), and contracts it with the value slab on the
// MXU, because Mosaic had no gather. Hopper gathers well, so this kernel
// reads the four corners of each sample point directly.
//
// What bounds it. Each input read once and the output written once: at the
// QRF shape (BM = 10 frames, 38 x 50 tokens, D = 256 bf16, Lq = 300 RoIs x
// 7 x 7 bins = 14,700, PL = 2 x 2 sub-samples) that is 9.7 MB of value,
// 7.1 MB of px/py/aw and 75.3 MB of output, 92 MB, 27.5 us at 3.35 TB/s.
// The output dominates: it is 7.7x the value it is sampled from. The
// gathered traffic (4 corners x PL points x D channels per query, about
// 1.2 GB) is mostly re-reads of a frame's 0.97 MB value slab from L2.
//
// What the design does about it:
// - One warp per output row (bm, q), channels across lanes. At D = 256 each
//   lane holds 8 contiguous channels: one 16-byte load per corner in bf16,
//   two in f32, and one 16-byte store of the result in bf16.
// - Warps are numbered q-fastest, so the warps in flight share one frame's
//   value slab, which stays in L2; consecutive q are the 49 bins of one RoI
//   and read neighbouring pixels.
// - Coordinates, corner weights and the sum are f32; the output is rounded
//   once, to the value's type.
// - Any other D takes a scalar loop over channels, 32 at a time.
// - A point with a non-finite coordinate or one outside (-1, W) x (-1, H)
//   (the -1e6 padding included) is skipped before any float-to-int
//   conversion: (int)floorf(NaN) is undefined.
// Later work: TMA or vector stores of several rows, and building the
// coordinates from the boxes inside the kernel instead of reading 7 MB of
// them.
//
// Plain C interface, loaded with ctypes; see dfvod_tpu_torch/ops/hat_sample.py.

#include <cstdint>

// dtype codes, kWarpsPerBlock, f32 conversions, kVec channels per lane on
// the vector path and their 16-byte loads (load8)
#include "msda_common.cuh"

using namespace msda;

namespace {

// 8 contiguous channels, 16-byte aligned, stored from f32
__device__ __forceinline__ void store8(float* p, const float f[kVec]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(f[4], f[5], f[6], f[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float f[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i)
    h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// The corners of one sample point: token offsets (-1 where the corner is
// outside the grid) and their weights, aw folded in. False when the point
// contributes nothing.
struct Corners {
  int t[4];
  float w[4];
};

__device__ __forceinline__ bool corners(float x, float y, float a, int H,
                                        int W, Corners* c) {
  // every corner outside the grid (NaN lands here too)
  if (!(x > -1.f && y > -1.f && x < (float)W && y < (float)H)) return false;
  const float x0f = floorf(x), y0f = floorf(y);
  const int x0 = (int)x0f, y0 = (int)y0f;
  const float fx = x - x0f, fy = y - y0f;
  const bool xl = x0 >= 0, xr = x0 + 1 < W, yt = y0 >= 0, yb = y0 + 1 < H;
  const int t00 = y0 * W + x0;
  c->t[0] = yt && xl ? t00 : -1;
  c->t[1] = yt && xr ? t00 + 1 : -1;
  c->t[2] = yb && xl ? t00 + W : -1;
  c->t[3] = yb && xr ? t00 + W + 1 : -1;
  c->w[0] = a * (1.f - fy) * (1.f - fx);
  c->w[1] = a * (1.f - fy) * fx;
  c->w[2] = a * fy * (1.f - fx);
  c->w[3] = a * fy * fx;
  return true;
}

// value (BM, H*W, D); px, py, aw (BM, Lq, PL) f32; out (BM, Lq, D). All
// contiguous. kVector: D % (32 * kVec) == 0 and 16-byte aligned rows.
template <typename V, bool kVector>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    hat_sample_fwd_kernel(const V* __restrict__ value,
                          const float* __restrict__ px,
                          const float* __restrict__ py,
                          const float* __restrict__ aw, V* __restrict__ out,
                          int BM, int H, int W, int D, int Lq, int PL) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (warp >= (long long)BM * Lq) return;  // warp = bm * Lq + q
  const int bm = (int)(warp / Lq);
  const long long pt0 = warp * PL;
  const V* vb = value + (long long)bm * H * W * D;
  V* o = out + warp * D;

  if constexpr (kVector) {
    for (int d0 = 0; d0 < D; d0 += 32 * kVec) {
      const int d = d0 + lane * kVec;
      float acc[kVec] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int p = 0; p < PL; ++p) {
        Corners c;
        if (!corners(px[pt0 + p], py[pt0 + p], aw[pt0 + p], H, W, &c))
          continue;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (c.t[k] < 0) continue;
          float f[kVec];
          load8(vb + (long long)c.t[k] * D + d, f);
#pragma unroll
          for (int i = 0; i < kVec; ++i) acc[i] += c.w[k] * f[i];
        }
      }
      store8(o + d, acc);
    }
  } else {
    for (int d0 = 0; d0 < D; d0 += 32) {
      const int d = d0 + lane;
      const bool active = d < D;
      const V* vd = vb + (active ? d : 0);
      float acc = 0.f;
      for (int p = 0; p < PL; ++p) {
        Corners c;
        if (!corners(px[pt0 + p], py[pt0 + p], aw[pt0 + p], H, W, &c))
          continue;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (c.t[k] >= 0)
            acc += c.w[k] * to_float(vd[(long long)c.t[k] * D]);
      }
      if (active) o[d] = from_float<V>(acc);
    }
  }
}

template <typename V>
int launch(const void* value, const float* px, const float* py,
           const float* aw, void* out, int BM, int H, int W, int D, int Lq,
           int PL, cudaStream_t stream) {
  const long long warps = (long long)BM * Lq;
  const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return -4;
  if (blocks == 0 || D == 0) return (int)cudaGetLastError();
  const bool aligned = (reinterpret_cast<uintptr_t>(value) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const V* v = static_cast<const V*>(value);
  V* o = static_cast<V*>(out);
  if (aligned && D % (32 * kVec) == 0)
    hat_sample_fwd_kernel<V, true><<<(unsigned)blocks, kWarpsPerBlock * 32,
                                     0, stream>>>(v, px, py, aw, o, BM, H, W,
                                                  D, Lq, PL);
  else
    hat_sample_fwd_kernel<V, false><<<(unsigned)blocks, kWarpsPerBlock * 32,
                                      0, stream>>>(v, px, py, aw, o, BM, H,
                                                   W, D, Lq, PL);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns 0 on success, a cudaError_t code (> 0) if the launch failed, or a
// negative code for arguments the kernel does not take: -1 a dimension out
// of range, -3 dtype, -4 grid too large.
extern "C" int hat_sample_fwd(const void* value, const void* px,
                              const void* py, const void* aw, void* out,
                              int BM, int H, int W, int D, int Lq, int PL,
                              int value_dtype, void* stream) {
  if (BM < 0 || H < 1 || W < 1 || D < 0 || Lq < 0 || PL < 0 ||
      (long long)H * W > 0x7fffffffLL)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(px);
  const float* y = static_cast<const float*>(py);
  const float* a = static_cast<const float*>(aw);
  if (value_dtype == kFloat32)
    return launch<float>(value, x, y, a, out, BM, H, W, D, Lq, PL, s);
  if (value_dtype == kBFloat16)
    return launch<__nv_bfloat16>(value, x, y, a, out, BM, H, W, D, Lq, PL, s);
  return -3;
}

extern "C" const char* hat_sample_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
