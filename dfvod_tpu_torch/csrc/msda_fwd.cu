// Multi-scale deformable attention (MSDA) forward for Hopper (sm_90a).
//
// Replaces the TPU kernel dfvod_tpu/ops/msda_pallas.py::_msda_hat_fwd_kernel
// (wrapper ms_deform_attn_pallas_hat). Both compute, for every (b, q, m):
//
//   out[b, q, m, :] = sum_{l, p} attw[b, q, m, l, p]
//                     * bilinear(value_l[b, :, m, :], loc * (W_l, H_l) - 0.5)
//
// with grid_sample's align_corners=False convention and zeros outside the
// map. The TPU kernel builds a dense tent-weight matrix (TQ, S) and multiplies
// it with the (S, D) value slab because Mosaic had no fast gather. Hopper
// gathers well, so this kernel reads the four corners of each sample
// directly, as the reference's im2col kernel does.
//
// What bounds it. The least traffic is one read of value, loc and attw and
// one write of out: about 20 MB at the B=8 encoder shape (Lq=S=1900, M=8,
// D=32, P=4, bf16 value, f32 loc), about 6 us at 3.35 TB/s. The gathered
// traffic is much larger (4 corners x L*P points x D channels per query,
// about 124 MB at that shape), but a head's value slab (S x D, 120 KB in
// bf16) is re-read by every query of that head and stays in L1/L2, so the
// kernel is bound by how many gathers it keeps in flight and by its
// per-warp work (with every point outside the map, coordinates, loc and
// attw alone, it takes over half its time), not by bytes.
//
// Design (the vector kernel; msda_common.cuh has the layout, Slots):
// - A row of D channels is g = D * sizeof(V) / 16 chunks of 16 bytes, one
//   per lane: 4 lanes of 8 channels for bf16 at D = 32, 8 lanes of 4 for
//   f32. Such a group of lanes (rounded up to a power of two, the spare
//   lanes idle) is a slot, and a slot holds one sample point: it loads its
//   loc and attw, computes the coordinates, corner weights and validity
//   once, and issues its 4 corner gathers together. At the encoder shape a
//   warp holds 2 queries x 4 points (bf16) or 1 x 4 (f32): 32 independent
//   16-byte gathers in flight where one lane per channel had 4 serial
//   groups of 4-byte loads. A point loop remains only where L * P exceeds a
//   query's slots (TDAM's 20 points: 3 rounds in bf16).
// - The slots of one (b, q, m) sum their points with __shfl_xor_sync; the
//   first slot rounds once to the value's type and writes its chunk with
//   one 16-byte store. Coordinates, weights and sums are f32 whatever the
//   storage types.
// - A 3-D grid (blocks of queries, m, b) gives each warp its (b, m) and
//   queries without a division; blocks run q-fastest and a warp never
//   mixes (b, m) pairs, so the warps in flight together share a value slab
//   in cache; queries past Lq idle.
// - Pixel coordinates come from msda_corners (no fused multiply-add), as in
//   msda_bwd.cu and the plain version. A point outside (-1, W) x (-1, H),
//   NaN or infinite included, adds nothing.
// - The scalar kernel (one warp per (b, q, m), a channel per lane) takes
//   rows that are no whole number of 16-byte chunks or more than 32 of them,
//   and base pointers that are not 16-byte aligned; the entry chooses and
//   counts each kernel's launches (msda_fwd_vector_launches,
//   msda_fwd_scalar_launches).
// Measured before this design: 0.0988-0.0992 ms at the B=8 encoder shape in
// the serving mix, one warp per (b, q, m) with a channel per lane
// (PERF.md, NVIDIA H100 80GB HBM3, 700.00 W).
//
// Plain C interface, loaded with ctypes; see dfvod_tpu_torch/ops/msda.py.

#include <atomic>

#include "msda_common.cuh"

using namespace msda;

namespace {

// Launches of each kernel (vector, scalar) since the library was loaded,
// counted where the entry chooses.
std::atomic<long long> vector_launches{0}, scalar_launches{0};

// value (B, S, M, D); loc (B, Lq, M, L, P, 2) in (x, y) order;
// attw (B, Lq, M, L, P); out (B, Lq, M, D). All contiguous; value and out
// 16-byte aligned, D * sizeof(V) = 16 * sl.g.
template <typename V, typename C, typename A>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    msda_fwd_vec_kernel(const V* __restrict__ value, const C* __restrict__ loc,
                        const A* __restrict__ attw, V* __restrict__ out,
                        int S, int M, int D, int Lq, int P, Levels lv,
                        Slots sl) {
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
  const bool active = q < Lq && lg < sl.g;

  const int np = lv.n * P;
  const long long row = (long long)M * D;  // token stride inside value
  const long long pt0 = (((long long)b * Lq + q) * M + m) * np;
  const V* vb = value + (long long)b * S * row + (long long)m * D + lg * kN;

  float acc[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) acc[j] = 0.f;
  for (int it = 0; it < sl.iters; ++it) {
    const int pi = s + (it << sl.lg_spq);
    if (!active || pi >= np) continue;
    const int l = pi / P;
    const long long i = pt0 + pi;
    SampleCorners c;
    if (!msda_corners<false>(to_float(loc[2 * i]), to_float(loc[2 * i + 1]),
                             lv.h[l], lv.w[l], &c))
      continue;
    const float aw = to_float(attw[i]);
    const V* vl = vb + (long long)lv.start[l] * row;
    uint4 raw[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      raw[k] = c.ok[k] ? load16(vl + (long long)c.t[k] * row)
                       : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float v[kN];
      widen<V>(raw[k], v);
      const float wk = aw * c.w[k];
#pragma unroll
      for (int j = 0; j < kN; ++j) acc[j] += wk * v[j];
    }
  }
  // sum the points of each (b, q, m) over its slots, which lie 2^lg_gp
  // lanes apart in an aligned block of 2^(lg_gp + lg_spq) lanes
  for (int o = 1 << sl.lg_gp; o < (1 << (sl.lg_gp + sl.lg_spq)); o <<= 1) {
#pragma unroll
    for (int j = 0; j < kN; ++j)
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
  }
  if (active && s == 0)
    *reinterpret_cast<uint4*>(out + (((long long)b * Lq + q) * M + m) * D +
                              lg * kN) = narrow<V>(acc);
}

// The scalar kernel: one warp per (b, q, m), a channel per lane, any D and
// any alignment. Same layouts as the vector kernel.
template <typename V, typename C, typename A>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    msda_fwd_kernel(const V* __restrict__ value, const C* __restrict__ loc,
                    const A* __restrict__ attw, V* __restrict__ out, int S,
                    int M, int D, int Lq, int P, Levels lv) {
  const int lane = threadIdx.x & 31;
  // grid (Lq / kWarpsPerBlock, M, B): a warp per (b, q, m)
  const int q = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int m = blockIdx.y, b = blockIdx.z;
  if (q >= Lq) return;

  const long long row = (long long)M * D;  // token stride inside value
  const long long pt0 = (((long long)b * Lq + q) * M + m) * lv.n * P;
  const V* vb = value + (long long)b * S * row + (long long)m * D;
  V* o = out + (((long long)b * Lq + q) * M + m) * D;

  for (int d0 = 0; d0 < D; d0 += 32) {
    const int d = d0 + lane;
    const bool active = d < D;
    const V* vd = vb + (active ? d : 0);
    float acc = 0.f;
    for (int l = 0; l < lv.n; ++l) {
      const V* vl = vd + (long long)lv.start[l] * row;
      for (int p = 0; p < P; ++p) {
        const long long i = pt0 + (long long)l * P + p;
        SampleCorners c;
        if (!msda_corners<false>(to_float(loc[2 * i]),
                                 to_float(loc[2 * i + 1]), lv.h[l], lv.w[l],
                                 &c))
          continue;
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (c.ok[k]) s += c.w[k] * to_float(vl[(long long)c.t[k] * row]);
        acc += to_float(attw[i]) * s;
      }
    }
    if (active) o[d] = from_float<V>(acc);
  }
}

template <typename V, typename C, typename A>
int launch(const void* value, const void* loc, const void* attw, void* out,
           int B, int S, int M, int D, int Lq, int P, const Levels& lv,
           cudaStream_t stream) {
  Slots sl;
  const bool vec = make_slots(D, (int)sizeof(V), lv.n * P, &sl) &&
                   aligned16(value) && aligned16(out);
  dim3 grid;
  if (!msda_grid(vec ? (Lq + (1LL << sl.lg_qw) - 1) >> sl.lg_qw : Lq, M, B,
                 &grid))
    return -4;
  if (!empty_grid(grid)) {
    const V* v = static_cast<const V*>(value);
    const C* c = static_cast<const C*>(loc);
    const A* a = static_cast<const A*>(attw);
    V* o = static_cast<V*>(out);
    if (vec) {
      msda_fwd_vec_kernel<V, C, A><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
          v, c, a, o, S, M, D, Lq, P, lv, sl);
      ++vector_launches;
    } else {
      msda_fwd_kernel<V, C, A><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
          v, c, a, o, S, M, D, Lq, P, lv);
      ++scalar_launches;
    }
  }
  return (int)cudaGetLastError();
}

template <typename V>
int dispatch_coords(int loc_dtype, int attw_dtype, const void* value,
                    const void* loc, const void* attw, void* out, int B,
                    int S, int M, int D, int Lq, int P, const Levels& lv,
                    cudaStream_t stream) {
  if (loc_dtype == kFloat32 && attw_dtype == kFloat32)
    return launch<V, float, float>(value, loc, attw, out, B, S, M, D, Lq, P,
                                   lv, stream);
  if (loc_dtype == kFloat32 && attw_dtype == kBFloat16)
    return launch<V, float, __nv_bfloat16>(value, loc, attw, out, B, S, M, D,
                                           Lq, P, lv, stream);
  if (loc_dtype == kBFloat16 && attw_dtype == kFloat32)
    return launch<V, __nv_bfloat16, float>(value, loc, attw, out, B, S, M, D,
                                           Lq, P, lv, stream);
  if (loc_dtype == kBFloat16 && attw_dtype == kBFloat16)
    return launch<V, __nv_bfloat16, __nv_bfloat16>(value, loc, attw, out, B,
                                                   S, M, D, Lq, P, lv,
                                                   stream);
  return -3;
}

}  // namespace

// Returns 0 on success, a cudaError_t code (> 0) if the launch failed, or a
// negative code for arguments the kernel does not take:
// -1 level count, -2 S != sum(H*W), -3 dtype combination, -4 grid too large.
extern "C" int msda_fwd(const void* value, const void* loc, const void* attw,
                        void* out, int B, int S, int M, int D, int Lq, int L,
                        int P, const int* shapes, int value_dtype,
                        int loc_dtype, int attw_dtype, void* stream) {
  Levels lv;
  const int rc = make_levels(L, shapes, S, &lv);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_dtype == kFloat32)
    return dispatch_coords<float>(loc_dtype, attw_dtype, value, loc, attw,
                                  out, B, S, M, D, Lq, P, lv, s);
  if (value_dtype == kBFloat16)
    return dispatch_coords<__nv_bfloat16>(loc_dtype, attw_dtype, value, loc,
                                          attw, out, B, S, M, D, Lq, P, lv,
                                          s);
  return -3;
}

extern "C" const char* msda_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches of each kernel since the library was loaded.
extern "C" long long msda_fwd_vector_launches() { return vector_launches; }
extern "C" long long msda_fwd_scalar_launches() { return scalar_launches; }
