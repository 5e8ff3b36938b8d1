// Backward of the weighted bilinear sampling over a token grid (K4) for
// Hopper (sm_90a): the VJP of hat_sample_fwd.cu (K3),
//
//   out[bm, q, :] = sum_p aw[bm, q, p] * bilinear(value[bm], py, px).
//
// Replaces the TPU kernel dfvod_tpu/ops/msda_pallas.py::_hat_bwd_kernel
// (wrapper hat_sample_bwd, custom VJP hat_sample_vjp), which TransVOD++'s
// Query-RoI Fusion reaches through dfvod_tpu/ops/roi_align.py. For each
// sample point at pixel coordinates (px, py), with x0 = floor(px),
// fx = px - x0 (and y alike), corners c = 00 01 10 11 of bilinear weight
// w_c (zero outside the grid) and d_c = <go[bm, q], value[bm, corner c]>:
//
//   gv[bm, corner c, :] += aw * w_c * go[bm, q, :]
//   gaw = sum_c w_c d_c
//   gpx = aw * ((1 - fy) (d01 - d00) + fy (d11 - d10))
//   gpy = aw * ((1 - fx) (d10 - d00) + fx (d11 - d01))
//
// So the derivative at an integer coordinate is one-sided ([x0+1] - [x0]),
// as the TPU kernel's sample-difference identity gives it
// (msda_pallas.py:568-580), an out-of-grid corner counts 0, and a point at
// exactly -1 is kept: its value there is 0 but the corner at 0 carries a
// derivative. A point outside [-1, W) x [-1, H) (the -1e6 padding included)
// or with a non-finite coordinate gets zero gradients and scatters nothing;
// the TPU kernel propagates a NaN coordinate instead.
//
// The TPU kernel builds a dense (TQ, S) tent matrix and contracts it with go
// on the MXU, carrying gv from one query block to the next in order, because
// Mosaic had no gather or scatter. On Hopper blocks run in no order, so this
// kernel is the gather/scatter form: gv by atomics.
//
// What bounds it. Each input read once and each output written once. At the
// training shape (BM = 5 frames of 38 x 50 tokens, D = 256, Lq = 300 RoIs x
// 49 bins = 14,700, PL = 4, all f32) that is go 75.3 MB + px/py/aw 3.5 MB +
// gv 9.7 MB = 88.5 MB, 26 us at 3.35 TB/s; with the point gradients add the
// value 9.7 MB and gpx/gpy/gaw 3.5 MB, 30 us. The kernel issues 301 M f32
// atomic adds into a 9.7 MB gv, about 124 per (token, channel), and real RoI
// points cluster, so same-address atomics in L2 are the likely limit.
//
// Design:
// - One warp per row (bm, q), channels across lanes; rows are numbered
//   q-fastest, so the warps in flight share one frame's gv slab (1.95 MB f32)
//   and its value slab, which stay in L2 where the atomics resolve.
// - At D = 256 each lane holds 8 channels of the go row, loaded once (16-byte
//   loads, f32 or bf16) before the loop over points; any other D takes a
//   scalar loop over channels, 32 at a time.
// - gv: f32 atomicAdd (compiled to a fire-and-forget RED; at D = 256 two
//   16-byte float4 atomics per lane and corner, which sm_90 has, a quarter
//   of the scalar ones) into an f32 buffer that the wrapper zeroes, then
//   one cast pass when the value is bf16; an f32 value accumulates in its
//   gradient directly. The order of the additions changes from run to run,
//   so gv is not bitwise deterministic.
// - The point gradients are a compile-time switch: RoIAlign's coordinates
//   and weights carry no gradient, so on the model path only gv is computed,
//   and gv needs no read of the value. With the switch on, each lane takes
//   partial dot products of its channels with the 4 corners, a warp shuffle
//   reduces them and lane 0 writes gpx, gpy and gaw (f32).
// Later work: a deterministic reduction (a sort of the corner contributions
// by token, or a segment pass), fewer same-address atomics (combining the 4
// sub-samples of a bin, which share corners, in registers first), and fusing
// the scatter into DynamicConv's backward.
//
// Plain C interface, loaded with ctypes; see dfvod_tpu_torch/ops/hat_sample.py.

#include <cstdint>

// dtype codes, kWarpsPerBlock, f32 conversions, kVec and load8, the vector
// atomics, the bf16 cast pass
#include "msda_common.cuh"

using namespace msda;

namespace {

// The corners of one sample point: token offsets (-1 where the corner is
// outside the grid), their bilinear weights (aw not folded in) and the
// fractions. False when the point contributes nothing.
struct Tent {
  int t[4];
  float w[4];
  float fx, fy;
};

__device__ __forceinline__ bool tent(float x, float y, int H, int W,
                                     Tent* c) {
  // every corner outside the grid (NaN lands here too); at exactly -1 the
  // corner at 0 still carries a derivative
  if (!(x >= -1.f && y >= -1.f && x < (float)W && y < (float)H)) return false;
  const float x0f = floorf(x), y0f = floorf(y);
  const int x0 = (int)x0f, y0 = (int)y0f;
  const float fx = x - x0f, fy = y - y0f;
  const bool xl = x0 >= 0, xr = x0 + 1 < W, yt = y0 >= 0, yb = y0 + 1 < H;
  const int t00 = y0 * W + x0;
  c->t[0] = yt && xl ? t00 : -1;
  c->t[1] = yt && xr ? t00 + 1 : -1;
  c->t[2] = yb && xl ? t00 + W : -1;
  c->t[3] = yb && xr ? t00 + W + 1 : -1;
  c->w[0] = (1.f - fy) * (1.f - fx);
  c->w[1] = (1.f - fy) * fx;
  c->w[2] = fy * (1.f - fx);
  c->w[3] = fy * fx;
  c->fx = fx;
  c->fy = fy;
  return true;
}

// Reduce the lanes' partial corner dot products and write the point's
// gradients from lane 0.
__device__ __forceinline__ void point_grads(float dot[4], const Tent& c,
                                            float a, long long i, int lane,
                                            float* gpx, float* gpy,
                                            float* gaw) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      dot[k] += __shfl_xor_sync(0xffffffffu, dot[k], o);
  }
  if (lane == 0) {
    gaw[i] = c.w[0] * dot[0] + c.w[1] * dot[1] + c.w[2] * dot[2] +
             c.w[3] * dot[3];
    gpx[i] = a * ((1.f - c.fy) * (dot[1] - dot[0]) +
                  c.fy * (dot[3] - dot[2]));
    gpy[i] = a * ((1.f - c.fx) * (dot[2] - dot[0]) +
                  c.fx * (dot[3] - dot[1]));
  }
}

// value (BM, H*W, D); px, py, aw (BM, Lq, PL) f32; go (BM, Lq, D); gv
// (BM, H*W, D) f32, zeroed, or null; gpx, gpy, gaw (BM, Lq, PL) f32, read
// only with kPointGrads. All contiguous. kVector: D == 32 * kVec and
// 16-byte aligned value and go.
template <typename V, typename G, bool kVector, bool kPointGrads>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    hat_sample_bwd_kernel(const V* __restrict__ value,
                          const float* __restrict__ px,
                          const float* __restrict__ py,
                          const float* __restrict__ aw,
                          const G* __restrict__ go, float* __restrict__ gv,
                          float* __restrict__ gpx, float* __restrict__ gpy,
                          float* __restrict__ gaw, int BM, int H, int W,
                          int D, int Lq, int PL) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (warp >= (long long)BM * Lq) return;  // warp = bm * Lq + q
  const long long base = (warp / Lq) * H * W * (long long)D;
  const long long pt0 = warp * PL;
  const G* grow = go + warp * D;

  if constexpr (kVector) {
    const int d = lane * kVec;
    float g[kVec];
    load8(grow + d, g);
    for (int p = 0; p < PL; ++p) {
      const long long i = pt0 + p;
      Tent c;
      if (!tent(px[i], py[i], H, W, &c)) {
        if (kPointGrads && lane == 0) gpx[i] = gpy[i] = gaw[i] = 0.f;
        continue;
      }
      const float a = aw[i];
      float dot[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (c.t[k] < 0) continue;
        const long long row = base + (long long)c.t[k] * D + d;
        // two 16-byte vector atomics (sm_90) instead of 8 scalar ones
        if (gv != nullptr) atomic_add_scaled<kVec>(gv + row, g, a * c.w[k]);
        if constexpr (kPointGrads) {
          float v[kVec];
          load8(value + row, v);
#pragma unroll
          for (int j = 0; j < kVec; ++j) dot[k] += g[j] * v[j];
        }
      }
      if constexpr (kPointGrads) point_grads(dot, c, a, i, lane, gpx, gpy, gaw);
    }
  } else {
    for (int p = 0; p < PL; ++p) {
      const long long i = pt0 + p;
      Tent c;
      if (!tent(px[i], py[i], H, W, &c)) {
        if (kPointGrads && lane == 0) gpx[i] = gpy[i] = gaw[i] = 0.f;
        continue;
      }
      const float a = aw[i];
      float dot[4] = {0.f, 0.f, 0.f, 0.f};
      for (int d = lane; d < D; d += 32) {
        const float g = to_float(grow[d]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (c.t[k] < 0) continue;
          const long long row = base + (long long)c.t[k] * D + d;
          if (gv != nullptr) atomicAdd(gv + row, a * c.w[k] * g);
          if constexpr (kPointGrads) dot[k] += g * to_float(value[row]);
        }
      }
      if constexpr (kPointGrads) point_grads(dot, c, a, i, lane, gpx, gpy, gaw);
    }
  }
}

template <typename V, typename G, bool kVector>
void launch_kernel(bool point_grads, unsigned blocks, const void* value,
                   const float* px, const float* py, const float* aw,
                   const void* go, float* gv, float* gpx, float* gpy,
                   float* gaw, int BM, int H, int W, int D, int Lq, int PL,
                   cudaStream_t stream) {
  const V* v = static_cast<const V*>(value);
  const G* g = static_cast<const G*>(go);
  if (point_grads)
    hat_sample_bwd_kernel<V, G, kVector, true>
        <<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
            v, px, py, aw, g, gv, gpx, gpy, gaw, BM, H, W, D, Lq, PL);
  else
    hat_sample_bwd_kernel<V, G, kVector, false>
        <<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
            v, px, py, aw, g, gv, gpx, gpy, gaw, BM, H, W, D, Lq, PL);
}

template <typename V, typename G>
int launch(const void* value, const float* px, const float* py,
           const float* aw, const void* go, float* gv32, void* gv,
           float* gpx, float* gpy, float* gaw, int BM, int H, int W, int D,
           int Lq, int PL, cudaStream_t stream) {
  const long long warps = (long long)BM * Lq;
  const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return -4;
  const bool point_grads = gpx != nullptr;
  if (blocks > 0 && D > 0) {
    const bool aligned =
        reinterpret_cast<uintptr_t>(go) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(gv32) % 16 == 0 &&
        (!point_grads || reinterpret_cast<uintptr_t>(value) % 16 == 0);
    if (aligned && D == 32 * kVec)
      launch_kernel<V, G, true>(point_grads, (unsigned)blocks, value, px, py,
                                aw, go, gv32, gpx, gpy, gaw, BM, H, W, D, Lq,
                                PL, stream);
    else
      launch_kernel<V, G, false>(point_grads, (unsigned)blocks, value, px,
                                 py, aw, go, gv32, gpx, gpy, gaw, BM, H, W, D,
                                 Lq, PL, stream);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  // a bf16 value takes its gradient from the f32 accumulator in one pass
  if (gv32 != nullptr && (void*)gv32 != gv)
    return launch_cast_to_bf16(gv32, static_cast<__nv_bfloat16*>(gv),
                               (long long)BM * H * W * D, stream);
  return (int)cudaGetLastError();
}

template <typename V>
int dispatch_go(int go_dtype, const void* value, const float* px,
                const float* py, const float* aw, const void* go, float* gv32,
                void* gv, float* gpx, float* gpy, float* gaw, int BM, int H,
                int W, int D, int Lq, int PL, cudaStream_t stream) {
  if (go_dtype == kFloat32)
    return launch<V, float>(value, px, py, aw, go, gv32, gv, gpx, gpy, gaw,
                            BM, H, W, D, Lq, PL, stream);
  if (go_dtype == kBFloat16)
    return launch<V, __nv_bfloat16>(value, px, py, aw, go, gv32, gv, gpx,
                                    gpy, gaw, BM, H, W, D, Lq, PL, stream);
  return -3;
}

}  // namespace

// grad_value_f32: the zeroed f32 accumulator (BM, H*W, D), or null when no
// value gradient is wanted; grad_value: the value-dtype gradient (the same
// pointer for an f32 value). gpx, gpy, gaw: all three, or all null when no
// point gradient is wanted. grad_out is f32 or bf16. Returns 0 on success, a
// cudaError_t code (> 0) if a launch failed, or a negative code for
// arguments the kernel does not take: -1 a dimension out of range, -3
// dtype, -4 grid too large, -5 inconsistent output pointers.
extern "C" int hat_sample_bwd(const void* value, const void* px,
                              const void* py, const void* aw,
                              const void* grad_out, float* grad_value_f32,
                              void* grad_value, float* gpx, float* gpy,
                              float* gaw, int BM, int H, int W, int D, int Lq,
                              int PL, int value_dtype, int go_dtype,
                              void* stream) {
  if (BM < 0 || H < 1 || W < 1 || D < 0 || Lq < 0 || PL < 0 ||
      (long long)H * W > 0x7fffffffLL)
    return -1;
  const bool point_grads = gpx != nullptr;
  if ((gpy != nullptr) != point_grads || (gaw != nullptr) != point_grads ||
      (grad_value_f32 == nullptr) != (grad_value == nullptr))
    return -5;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(px);
  const float* y = static_cast<const float*>(py);
  const float* a = static_cast<const float*>(aw);
  if (value_dtype == kFloat32) {
    if ((void*)grad_value_f32 != grad_value) return -5;
    return dispatch_go<float>(go_dtype, value, x, y, a, grad_out,
                              grad_value_f32, grad_value, gpx, gpy, gaw, BM,
                              H, W, D, Lq, PL, s);
  }
  if (value_dtype == kBFloat16)
    return dispatch_go<__nv_bfloat16>(go_dtype, value, x, y, a, grad_out,
                                      grad_value_f32, grad_value, gpx, gpy,
                                      gaw, BM, H, W, D, Lq, PL, s);
  return -3;
}

extern "C" const char* hat_sample_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
