// Weighted bilinear sampling over MSDA's levels stacked along y (K5a) for
// Hopper (sm_90a):
//
//   out[bm, q, :] = sum_{l, p} aw[bm, q, c] * bilinear(level_l[bm],
//                                                      py[bm, q, c] - yo_l,
//                                                      px[bm, q, c])
//
// with c = l * P + p: point column c belongs to level c / P, and level l's
// rows sit at y offset yo_l = sum_{j<l} (H_j + 2).
//
// Replaces the TPU kernel dfvod_tpu/ops/msda_pallas.py::
// _hat_sparse_kernel_factory (wrapper hat_sample_sparse), which
// ms_deform_attn_pallas_hat(sparse=True) reaches with the level offsets of
// _hat_coords. The coordinates are pixel indices: the weight of token
// (sy, sx) is the tent relu(1 - |px - sx|) * relu(1 - |py - sy|), so a
// corner outside its level contributes 0 and there is no -0.5 shift (the
// caller applies it). The TPU kernel builds that tent matrix densely, (TQ,
// 256-token chunk), for every chunk some point of a 128-query block
// touches, and contracts it with the value slab on the MXU, because Mosaic
// had no gather. Hopper gathers well, so this kernel reads the four corners
// of each sample point directly: chunk skipping has no counterpart.
//
// Each point samples only its own level: with y taken back to the level
// (y = py - yo_l), a corner outside the level counts 0, as
// ms_deform_attn_xla and the reference CUDA kernel do. The TPU's stacked
// tent matrix reads a neighbouring level for a point more than about one
// row outside its own (ROADMAP, known differences). yo_l is an integer and
// py is near it, so py - yo_l is exact (Sterbenz) and the corner weights
// equal the stacked tent's.
//
// What bounds it. Each input read once and the output written once: at
// MSDA's B=8 encoder shape (BM = 64 heads, S = Lq = 1900, D = 32 bf16,
// PL = 4) the value and the output are 7.8 MB each and the f32 px, py, aw
// 5.8 MB: 21.4 MB, 6.4 us at 3.35 TB/s. At four levels of a 608x800 frame
// (strides 8-64, S = Lq = 10105, PL = 16) 207 MB, 62 us. The gathered
// traffic (4 corners x PL points x D channels per query) is mostly re-reads
// of a head's value slab (121.6 KB at the encoder shape) from L1/L2, so the
// kernel is bound by how many gathers it keeps in flight and by its
// per-point work, as K1 (msda_fwd.cu) is at the same shape.
//
// The vector kernel (hat_sample_sparse_fwd_vec_kernel), K1's layout
// (msda_common.cuh, Slots):
// - A row of D channels is g = D * sizeof(V) / 16 chunks of 16 bytes, one
//   per lane: 4 lanes of 8 channels for bf16 at D = 32, 8 lanes of 4 for
//   f32. Such a group of lanes (rounded up to a power of two, the spare
//   lanes idle) is a slot, and a slot holds one sample point: it loads its
//   px, py and aw once (in (BM, Lq, PL) a warp's points are contiguous, so
//   each array is one coalesced request), takes its level from its column
//   and that level's start, H, W and yo from the table in the kernel's
//   parameters, computes the four corners once, and issues their 16-byte
//   gathers together. At the encoder shape a warp holds 2 queries x 4
//   points in bf16 (1 x 4 in f32): 32 gathers in flight where a lane per
//   channel issued one point's 4 at a time. Four levels x P = 4 take one
//   query per warp in 2 rounds (bf16).
// - The slots of one query sum their points with __shfl_xor_sync; the first
//   slot rounds once to the value's type and writes its chunk with one
//   16-byte store. Coordinates, weights and sums are f32.
// - A 2-D grid (blocks of queries, BM) gives each warp its head and queries
//   without a division; blocks run q-fastest, so the warps in flight share
//   one head's value slab in cache. One level takes an instance without the
//   level lookup (kOneLevel).
// - Corners are not merged across a query's points (K3's
//   __match_any_sync): at MSDA's points the four corners of the points are
//   distinct tokens.
// - A point with a non-finite coordinate or one outside (-1, W) x (-1, H)
//   of its level (the -1e6 padding included) is skipped before any
//   float-to-int conversion: (int)floorf(NaN) is undefined. The TPU kernel
//   gives 0 for such a point only when no point of its query block
//   activates a chunk (ROADMAP, known differences).
// The scalar kernel (hat_sample_levels_kernel): one warp per (bm, q), a
// channel per lane, a level loop over each level's points. It takes rows
// that are no whole number of 16-byte chunks or more than 32 of them, base
// pointers that are not 16-byte aligned, and grids the vector kernel's
// launch does not take. The entry chooses and counts each path's launches
// (hat_sample_sparse_fwd_vector_launches, _scalar_launches).
// Measured before this design (PERF.md, NVIDIA H100 80GB HBM3, 700.00 W):
// 0.0719-0.0727 ms at the encoder shape in bf16, K3's scalar kernel.
//
// Plain C interface, loaded with ctypes; see dfvod_tpu_torch/ops/hat_sample.py.

#include <atomic>
#include <cstdint>

// dtype codes, the level table, kWarpsPerBlock, f32 conversions, Slots,
// the 16-byte loads (load16, widen) and stores (narrow)
#include "msda_common.cuh"
// Corners, corners(): a sample point's four tokens and weights
#include "hat_corners.cuh"

using namespace hat;
using namespace msda;

namespace {

// The stacked levels: P point columns per level, level l's rows offset by
// yo[l] in py.
struct Stack {
  Levels lv;
  int P;
  float yo[kMaxLevels];
};

// The vector kernel. value (BM, S, D); px, py, aw (BM, Lq, L * P) f32;
// out (BM, Lq, D). All contiguous; value and out 16-byte aligned,
// D * sizeof(V) = 16 * sl.g; sl the slot layout of L * P points per query.
template <typename V, bool kOneLevel>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    hat_sample_sparse_fwd_vec_kernel(const V* __restrict__ value,
                                     const float* __restrict__ px,
                                     const float* __restrict__ py,
                                     const float* __restrict__ aw,
                                     V* __restrict__ out, int S, int D,
                                     int Lq, Stack st, Slots sl) {
  constexpr int kN = kChunk<V>;
  const int lane = threadIdx.x & 31;
  // grid (q blocks / kWarpsPerBlock, BM): a warp per block of queries
  const int qb = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int bm = blockIdx.y;
  if ((qb << sl.lg_qw) >= Lq) return;
  const int lg = lane & ((1 << sl.lg_gp) - 1);  // chunk of the row
  const int slot = lane >> sl.lg_gp;
  const int s = slot & ((1 << sl.lg_spq) - 1);  // slot within its query
  const int q = (qb << sl.lg_qw) + (slot >> sl.lg_spq);
  const bool active = q < Lq && lg < sl.g;

  const int np = st.lv.n * st.P;
  const long long row = (long long)bm * Lq + q;  // (bm, q)
  const V* vb = value + (long long)bm * S * D + lg * kN;

  float acc[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) acc[j] = 0.f;
  for (int it = 0; it < sl.iters; ++it) {
    const int pi = s + (it << sl.lg_spq);
    if (!active || pi >= np) continue;
    const int l = kOneLevel ? 0 : pi / st.P;
    const long long i = row * np + pi;
    Corners c;
    if (!corners(px[i], kOneLevel ? py[i] : py[i] - st.yo[l], aw[i],
                 st.lv.h[l], st.lv.w[l], &c))
      continue;
    const V* vl = kOneLevel ? vb : vb + (long long)st.lv.start[l] * D;
    uint4 raw[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      raw[k] = c.t[k] >= 0 ? load16(vl + (long long)c.t[k] * D)
                           : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float v[kN];
      widen<V>(raw[k], v);
#pragma unroll
      for (int j = 0; j < kN; ++j) acc[j] += c.w[k] * v[j];
    }
  }
  // sum the points of each query over its slots, which lie 2^lg_gp lanes
  // apart in an aligned block of 2^(lg_gp + lg_spq) lanes
  for (int o = 1 << sl.lg_gp; o < (1 << (sl.lg_gp + sl.lg_spq)); o <<= 1) {
#pragma unroll
    for (int j = 0; j < kN; ++j)
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
  }
  if (active && s == 0)
    *reinterpret_cast<uint4*>(out + row * D + lg * kN) = narrow<V>(acc);
}

// value (BM, S, D); px, py, aw (BM, Lq, n * P) f32; out (BM, Lq, D). All
// contiguous. The scalar channel loop of the kernel above, over each
// level's points on that level's grid: MSDA's heads are narrow (D = 32).
template <typename V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    hat_sample_levels_kernel(const V* __restrict__ value,
                             const float* __restrict__ px,
                             const float* __restrict__ py,
                             const float* __restrict__ aw, V* __restrict__ out,
                             int BM, int S, int D, int Lq, Stack st) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (warp >= (long long)BM * Lq) return;  // warp = bm * Lq + q
  const int bm = (int)(warp / Lq);
  const long long pt0 = warp * st.lv.n * st.P;
  const V* vb = value + (long long)bm * S * D;
  V* o = out + warp * D;
  for (int d0 = 0; d0 < D; d0 += 32) {
    const int d = d0 + lane;
    const bool active = d < D;
    float acc = 0.f;
    for (int l = 0; l < st.lv.n; ++l) {
      const V* vl = vb + (long long)st.lv.start[l] * D + (active ? d : 0);
      for (int j = 0; j < st.P; ++j) {
        const long long i = pt0 + l * st.P + j;
        Corners c;
        if (!corners(px[i], py[i] - st.yo[l], aw[i], st.lv.h[l], st.lv.w[l],
                     &c))
          continue;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (c.t[k] >= 0)
            acc += c.w[k] * to_float(vl[(long long)c.t[k] * D]);
      }
    }
    if (active) o[d] = from_float<V>(acc);
  }
}

// Launches of each path since the library was loaded.
std::atomic<long long> vector_launches{0}, scalar_launches{0};

template <typename V>
int launch(const void* value, const float* px, const float* py,
           const float* aw, void* out, int BM, int S, int D, int Lq,
           const Stack& st, cudaStream_t stream) {
  const V* v = static_cast<const V*>(value);
  V* o = static_cast<V*>(out);
  Slots sl;
  dim3 grid;
  if (make_slots(D, (int)sizeof(V), st.lv.n * st.P, &sl) &&
      aligned16(value) && aligned16(out) &&
      msda_grid((Lq + (1LL << sl.lg_qw) - 1) >> sl.lg_qw, BM, 1, &grid)) {
    if (!empty_grid(grid)) {
      if (st.lv.n == 1)
        hat_sample_sparse_fwd_vec_kernel<V, true>
            <<<grid, kWarpsPerBlock * 32, 0, stream>>>(v, px, py, aw, o, S,
                                                       D, Lq, st, sl);
      else
        hat_sample_sparse_fwd_vec_kernel<V, false>
            <<<grid, kWarpsPerBlock * 32, 0, stream>>>(v, px, py, aw, o, S,
                                                       D, Lq, st, sl);
      ++vector_launches;
    }
    return (int)cudaGetLastError();
  }
  const long long warps = (long long)BM * Lq;
  const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return -4;
  if (blocks > 0 && D > 0) {
    hat_sample_levels_kernel<V><<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                                  stream>>>(v, px, py, aw, o, BM, S, D, Lq,
                                            st);
    ++scalar_launches;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Returns 0 on success, a cudaError_t code (> 0) if the launch failed, or a
// negative code for arguments the kernel does not take: -1 a dimension or
// level count out of range, -2 S != sum(H*W), -3 dtype, -4 grid too large.
// shapes holds the L levels' (H, W); the point columns are L * P.
extern "C" int hat_sample_sparse_fwd(const void* value, const void* px,
                                     const void* py, const void* aw,
                                     void* out, int BM, int S, int D, int Lq,
                                     int L, int P, const int* shapes,
                                     int value_dtype, void* stream) {
  if (BM < 0 || D < 0 || Lq < 0 || P < 0) return -1;
  Stack st{};
  const int rc = make_levels(L, shapes, S, &st.lv);
  if (rc != 0) return rc;
  st.P = P;
  float yo = 0.f;
  for (int l = 0; l < L; ++l) {
    if (st.lv.h[l] < 1 || st.lv.w[l] < 1) return -1;
    st.yo[l] = yo;
    yo += (float)st.lv.h[l] + 2.f;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(px);
  const float* y = static_cast<const float*>(py);
  const float* a = static_cast<const float*>(aw);
  if (value_dtype == kFloat32)
    return launch<float>(value, x, y, a, out, BM, S, D, Lq, st, s);
  if (value_dtype == kBFloat16)
    return launch<__nv_bfloat16>(value, x, y, a, out, BM, S, D, Lq, st, s);
  return -3;
}

extern "C" const char* hat_sample_sparse_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches of each path since the library was loaded.
extern "C" long long hat_sample_sparse_fwd_vector_launches() {
  return vector_launches;
}
extern "C" long long hat_sample_sparse_fwd_scalar_launches() {
  return scalar_launches;
}
