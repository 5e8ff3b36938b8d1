// Weighted row gather (K5b/K5c) for Hopper (sm_90a):
//
//   out[b, q, m, :] = sum_k w[b, q, m, k] * value[b, idx[b, q, m, k], m, :]
//
// with an index outside [0, S) contributing 0.
//
// Replaces two TPU kernels of dfvod_tpu/ops/msda_pallas.py that compute this
// one function: _onehot_kernel (K5b, wrappers onehot_sample and
// ms_deform_attn_pallas_onehot), which builds the one-hot interpolation
// matrix (TQ, S) with K iota compares and contracts it with the value slab on
// the MXU, and _kernel (K5c, wrapper ms_deform_attn_pallas), an in-kernel
// row gather with fill_value=0. Both exist on the TPU in that form because
// Mosaic had no fast gather; MSDA's `flat` form (dfvod_tpu/ops/msda.py::
// ms_deform_attn_flat) is the same gather in XLA. The indices and weights
// are the folded bilinear corners of corner_indices_weights (K = L * P * 4
// per query and head); the generic onehot_sample takes any.
//
// What bounds it. Each input read once and the output written once: at the
// B=8 encoder shape (Lq = S = 1900, M = 8, D = 32, K = 16) the int32
// indices and f32 weights are 15.6 MB, the bf16 value 7.8 MB and the bf16
// output 7.8 MB: 31 MB, 9.3 us at 3.35 TB/s. The indices and weights
// dominate; a value row (64 bytes in bf16) is gathered K times per query
// and head, mostly from L2 (a head's slab is 120 KB).
//
// What the design does about it:
// - One warp per (b, q, m), channels across lanes (D = 32 is one per lane),
//   more than 32 channels in a loop of 32. Warps are numbered q-fastest, so
//   the warps in flight share one (b, m) value slab in L1/L2.
// - The row's K indices and weights are read once, 32 at a time, one per
//   lane, coalesced, and handed to every lane by shuffles.
// - f32 weights and sum whatever the value type; the output is rounded
//   once, to the value's type.
// Later work: several rows per warp with vector loads, and building the
// corners from the sampling locations inside the kernel (K1 does), which
// removes the 15.6 MB of indices and weights altogether.
//
// Plain C interface, loaded with ctypes; see
// dfvod_tpu_torch/ops/corner_gather.py.

#include <cstdint>

// dtype codes, kWarpsPerBlock, f32 conversions
#include "msda_common.cuh"

using namespace msda;

namespace {

// value (B, S, M, D); idx int32 and w f32 (B, Lq, M, K); out (B, Lq, M, D).
// All contiguous.
template <typename V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    corner_gather_fwd_kernel(const V* __restrict__ value,
                             const int* __restrict__ idx,
                             const float* __restrict__ w, V* __restrict__ out,
                             int B, int S, int M, int D, int Lq, int K) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (warp >= (long long)B * M * Lq) return;  // warp = (b * M + m) * Lq + q
  const int q = (int)(warp % Lq);
  const long long bm = warp / Lq;
  const int m = (int)(bm % M);
  const int b = (int)(bm / M);

  const long long row = (long long)M * D;  // token stride inside value
  const long long r = ((long long)b * Lq + q) * M + m;
  const int* ir = idx + r * K;
  const float* wr = w + r * K;
  const V* vb = value + (long long)b * S * row + (long long)m * D;
  V* o = out + r * D;

  for (int d0 = 0; d0 < D; d0 += 32) {
    const int d = d0 + lane;
    const bool active = d < D;
    const V* vd = vb + (active ? d : 0);
    float acc = 0.f;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int n = min(32, K - k0);
      int my_i = -1;
      float my_w = 0.f;
      if (lane < n) {
        my_i = ir[k0 + lane];
        my_w = wr[k0 + lane];
      }
      for (int j = 0; j < n; ++j) {
        const int s = __shfl_sync(0xffffffffu, my_i, j);
        const float wk = __shfl_sync(0xffffffffu, my_w, j);
        if (s >= 0 && s < S) acc += wk * to_float(vd[(long long)s * row]);
      }
    }
    if (active) o[d] = from_float<V>(acc);
  }
}

template <typename V>
int launch(const void* value, const int* idx, const float* w, void* out,
           int B, int S, int M, int D, int Lq, int K, cudaStream_t stream) {
  const long long warps = (long long)B * M * Lq;
  const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return -4;
  if (blocks > 0 && D > 0) {
    corner_gather_fwd_kernel<V><<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                                  stream>>>(
        static_cast<const V*>(value), idx, w, static_cast<V*>(out), B, S, M,
        D, Lq, K);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Returns 0 on success, a cudaError_t code (> 0) if the launch failed, or a
// negative code for arguments the kernel does not take: -1 a dimension out
// of range, -3 dtype, -4 grid too large.
extern "C" int corner_gather_fwd(const void* value, const void* idx,
                                 const void* w, void* out, int B, int S,
                                 int M, int D, int Lq, int K, int value_dtype,
                                 void* stream) {
  if (B < 0 || S < 0 || M < 1 || D < 0 || Lq < 0 || K < 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* i = static_cast<const int*>(idx);
  const float* wt = static_cast<const float*>(w);
  if (value_dtype == kFloat32)
    return launch<float>(value, i, wt, out, B, S, M, D, Lq, K, s);
  if (value_dtype == kBFloat16)
    return launch<__nv_bfloat16>(value, i, wt, out, B, S, M, D, Lq, K, s);
  return -3;
}

extern "C" const char* corner_gather_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
