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
// The vector kernel (corner_gather_fwd_vec_kernel), K1's layout
// (msda_common.cuh, Slots):
// - A row of D channels is D * sizeof(V) / 16 chunks of 16 bytes, one per
//   lane (a lane takes every 32nd chunk of a wider row). A slot of lanes
//   (the chunk count rounded up to a power of two, at most 32) gathers
//   rows of one (b, q, m): 4 lanes at bf16 D = 32, 8 at f32. Each slot
//   takes a share of the K corners in groups of 4, read as one int4 of
//   indices and one float4 of weights, and issues the 4 gathers as
//   independent 16-byte loads. At the encoder shape a warp holds 2 queries
//   x 4 slots in bf16: 32 gathers in flight where a lane per channel had
//   16 serial 2-byte loads.
// - The slots of a (b, q, m) sum with __shfl_xor_sync; the first rounds
//   once to the value's type and writes its chunk with a 16-byte store.
//   Weights and sums are f32 whatever the value type.
// - A 3-D grid (blocks of queries, m, b) gives each warp its (b, m) and
//   queries without a division; blocks run q-fastest, so the warps in
//   flight share a (b, m) value slab in cache.
// The scalar kernel (corner_gather_fwd_kernel): one warp per (b, q, m),
// a channel per lane, the row's indices and weights handed out by
// shuffles; it takes rows that are no whole number of 16-byte chunks, K
// not a multiple of 4, and base pointers that are not 16-byte aligned. The
// entry chooses and counts each path's launches
// (corner_gather_fwd_vector_launches, corner_gather_fwd_scalar_launches).
// Measured with the scalar kernel alone: 0.0780-0.0787 ms at the B=8
// encoder shape in bf16 (PERF.md, NVIDIA H100 80GB HBM3, 700.00 W).
//
// Plain C interface, loaded with ctypes; see
// dfvod_tpu_torch/ops/corner_gather.py.

#include <atomic>
#include <cstdint>

// dtype codes, kWarpsPerBlock, f32 conversions, Slots, 16-byte chunks
#include "msda_common.cuh"

using namespace msda;

namespace {

// The vector kernel. value (B, S, M, D); idx int32 and w f32 (B, Lq, M,
// K); out (B, Lq, M, D). All contiguous and 16-byte aligned; K a multiple
// of 4; a row D * sizeof(V) = 16 * chunks bytes; sl the slot layout of
// min(chunks, 32) lanes per slot and K / 4 groups of corners per query.
template <typename V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    corner_gather_fwd_vec_kernel(const V* __restrict__ value,
                                 const int* __restrict__ idx,
                                 const float* __restrict__ w,
                                 V* __restrict__ out, int S, int M, int D,
                                 int Lq, int K, Slots sl, int chunks) {
  constexpr int kN = kChunk<V>;
  const int lane = threadIdx.x & 31;
  // grid (q blocks / kWarpsPerBlock, M, B): a warp per block of queries
  const int qb = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int m = blockIdx.y, b = blockIdx.z;
  if ((qb << sl.lg_qw) >= Lq) return;
  const int lg = lane & ((1 << sl.lg_gp) - 1);  // chunk of the row
  const int slot = lane >> sl.lg_gp;
  const int s = slot & ((1 << sl.lg_spq) - 1);  // slot within its query
  const int q = (qb << sl.lg_qw) + (slot >> sl.lg_spq);
  const int groups = K >> 2;

  const long long row = (long long)M * D;  // token stride inside value
  const long long r = ((long long)b * Lq + q) * M + m;
  const int4* ir = reinterpret_cast<const int4*>(idx + r * K);
  const float4* wr = reinterpret_cast<const float4*>(w + r * K);
  const V* vb = value + (long long)b * S * row + (long long)m * D;

  for (int c0 = 0; c0 < chunks; c0 += 32) {
    const int c = c0 + lg;
    const bool active = q < Lq && lg < sl.g && c < chunks;
    float acc[kN];
#pragma unroll
    for (int j = 0; j < kN; ++j) acc[j] = 0.f;
    for (int it = 0; it < sl.iters; ++it) {
      const int gi = s + (it << sl.lg_spq);
      if (!active || gi >= groups) continue;
      const int4 i4 = __ldg(ir + gi);
      const float4 w4 = __ldg(wr + gi);
      const int ik[4] = {i4.x, i4.y, i4.z, i4.w};
      const float wk[4] = {w4.x, w4.y, w4.z, w4.w};
      uint4 raw[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        raw[k] = ik[k] >= 0 && ik[k] < S
                     ? load16(vb + (long long)ik[k] * row + c * kN)
                     : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float v[kN];
        widen<V>(raw[k], v);
#pragma unroll
        for (int j = 0; j < kN; ++j) acc[j] += wk[k] * v[j];
      }
    }
    // sum the corners of each (b, q, m) over its slots, which lie 2^lg_gp
    // lanes apart in an aligned block of 2^(lg_gp + lg_spq) lanes
    for (int o = 1 << sl.lg_gp; o < (1 << (sl.lg_gp + sl.lg_spq)); o <<= 1) {
#pragma unroll
      for (int j = 0; j < kN; ++j)
        acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
    }
    if (active && s == 0)
      *reinterpret_cast<uint4*>(out + r * D + c * kN) = narrow<V>(acc);
  }
}

// The scalar kernel: one warp per (b, q, m), a channel per lane, any D, K
// and alignment. Same layouts as the vector kernel.
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

// Launches of each path since the library was loaded.
std::atomic<long long> vector_launches{0}, scalar_launches{0};

// The vector kernel's layout, false where it does not take the input: a
// row that is no whole number of 16-byte chunks, or K not a multiple of 4.
inline bool gather_slots(int D, int elem_size, int K, Slots* sl,
                         int* chunks) {
  if (K <= 0 || K % 4 != 0 || D <= 0 || (D * elem_size) % 16 != 0)
    return false;
  *chunks = D * elem_size / 16;
  const int g = *chunks < 32 ? *chunks : 32;
  return make_slots(g * 16 / elem_size, elem_size, K / 4, sl);
}

template <typename V>
int launch(const void* value, const int* idx, const float* w, void* out,
           int B, int S, int M, int D, int Lq, int K, cudaStream_t stream) {
  Slots sl;
  int chunks = 0;
  const bool vec = gather_slots(D, (int)sizeof(V), K, &sl, &chunks) &&
                   aligned16(value) && aligned16(idx) && aligned16(w) &&
                   aligned16(out);
  if (vec) {
    dim3 grid;
    if (!msda_grid((Lq + (1LL << sl.lg_qw) - 1) >> sl.lg_qw, M, B, &grid))
      return -4;
    if (!empty_grid(grid)) {
      corner_gather_fwd_vec_kernel<V><<<grid, kWarpsPerBlock * 32, 0,
                                        stream>>>(
          static_cast<const V*>(value), idx, w, static_cast<V*>(out), S, M,
          D, Lq, K, sl, chunks);
      ++vector_launches;
    }
    return (int)cudaGetLastError();
  }
  const long long warps = (long long)B * M * Lq;
  const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return -4;
  if (blocks > 0 && D > 0) {
    corner_gather_fwd_kernel<V><<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                                  stream>>>(
        static_cast<const V*>(value), idx, w, static_cast<V*>(out), B, S, M,
        D, Lq, K);
    ++scalar_launches;
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

// Launches of each path since the library was loaded.
extern "C" long long corner_gather_fwd_vector_launches() {
  return vector_launches;
}
extern "C" long long corner_gather_fwd_scalar_launches() {
  return scalar_launches;
}
