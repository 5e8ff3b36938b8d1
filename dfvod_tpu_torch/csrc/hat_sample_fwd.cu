// Weighted bilinear sampling over a token grid (K3) for Hopper (sm_90a):
//
//   out[bm, q, :] = sum_p aw[bm, q, p] * bilinear(value[bm], py, px)
//
// Replaces the TPU kernel dfvod_tpu/ops/msda_pallas.py::_hat_kernel
// (wrapper hat_sample), which RoIAlign reaches through
// dfvod_tpu/ops/roi_align.py::_roi_align_hat in TransVOD++'s Query-RoI
// Fusion: the regular grid (token s at row s / W, column s % W). The
// coordinates are pixel indices: the weight of token (sy, sx) is the tent
// relu(1 - |px - sx|) * relu(1 - |py - sy|), so a corner outside the grid
// contributes 0 and there is no -0.5 shift. The TPU kernel builds that tent
// matrix densely, (TQ, S), and contracts it with the value slab on the MXU,
// because Mosaic had no gather. Hopper gathers well, so this kernel reads
// the four corners of each sample point directly. (The same sampling over
// MSDA's stacked levels, K5a, is hat_sample_sparse_fwd.cu.)
//
// What bounds it. Each input read once and the output written once: at the
// QRF shape (BM = 10 frames, 38 x 50 tokens, D = 256 bf16, Lq = 300 RoIs x
// 7 x 7 bins = 14,700, PL = 2 x 2 sub-samples) that is 9.7 MB of value,
// 7.1 MB of px/py/aw and 75.3 MB of output, 92 MB, 27.5 us at 3.35 TB/s.
// The output dominates: it is 7.7x the value it is sampled from. The
// gathered traffic (4 corners x PL points x D channels per query, about
// 1.2 GB) is mostly re-reads of a frame's 0.97 MB value slab from L2.
//
// At the QRF points a bin's 16 corners fall on about 6 tokens: its 4
// sub-samples lie within one token of each other.
//
// What the design does about it:
// - The vector path (D a multiple of 256, aligned rows;
//   hat_sample_fwd_vec_kernel) takes two queries per warp, 16 lanes each,
//   and a query's points in rounds of up to 4: lane 4 p + k loads its
//   point's px, py, aw (one coalesced request for the round) and computes
//   corner k. Lanes of equal tokens within a query find each other with
//   __match_any_sync; the lowest sums their weights (in lane order), so each
//   distinct token is gathered once: at the QRF points 2.6x fewer row
//   gathers than corners. The merged rows are gathered kBatch at a time
//   (4 loads of 16 bytes per lane in flight), each 16 lanes covering 256
//   contiguous bytes of a row per access; a lane sums 16 channels in f32
//   and stores them in 16-byte pieces. Two queries per warp halve the
//   per-query work of the merge (its shuffles and the row bookkeeping);
//   batches of 8 and 16 loads in flight, and one query per warp, measured
//   slower (PERF.md).
// - Warps are numbered q-fastest, so the warps in flight share one frame's
//   value slab, which stays in L2; consecutive q are the 49 bins of one
//   RoI and read neighbouring pixels.
// - Coordinates, corner weights and the sum are f32; the output is rounded
//   once, to the value's type.
// - Any other D and unaligned rows (hat_sample_fwd_kernel) take a scalar
//   loop over channels, 32 at a time, point by point.
// - A point with a non-finite coordinate or one outside (-1, W) x (-1, H)
//   (the -1e6 padding included) is skipped before any float-to-int
//   conversion: (int)floorf(NaN) is undefined.
// Measured before this design (PERF.md, NVIDIA H100 80GB HBM3, 700.00 W):
// 0.149-0.150 ms at the QRF shape, each point's 4 corners gathered in turn.
// Later work: staging a tile's distinct value rows in shared memory
// (cp.async or TMA), TMA or vector stores of several rows, and building the
// coordinates from the boxes inside the kernel instead of reading 7 MB of
// them.
//
// Plain C interface, loaded with ctypes; see dfvod_tpu_torch/ops/hat_sample.py.

#include <cstdint>

// dtype codes, kWarpsPerBlock, f32 conversions, the 16-byte loads
// (load16, widen) and stores (narrow) of the vector path
#include "msda_common.cuh"
// Corners, corners(): a sample point's four tokens and weights
#include "hat_corners.cuh"

using namespace hat;
using namespace msda;

namespace {

// The vector path takes two queries per warp, 16 lanes each: a lane per
// corner of a round of 4 points, then 16 channels per lane of a 256-channel
// row chunk, in pieces of 16 bytes (kChunk<V> channels): piece i of lane l
// holds channels [i * 16 * kChunk + l * kChunk, + kChunk), so the 16 lanes of
// a query cover 256 contiguous bytes of a row in each 16-byte access.
constexpr int kRow = 256;
constexpr int kQueryLanes = 16;
constexpr int kRoundPoints = kQueryLanes / 4;
template <typename V>
constexpr int kPieces = kRow / kQueryLanes / kChunk<V>;
// Merged rows whose gathers are in flight together: 4 loads of 16 bytes
// per lane (2 rows in bf16, 1 in f32; chosen by measurement, PERF.md).
template <typename V>
constexpr int kBatch = 4 / kPieces<V>;

// The vector path. value (BM, H*W, D); px, py, aw (BM, Lq, PL) f32; out
// (BM, Lq, D). All contiguous; D % 256 == 0, value and out 16-byte aligned.
template <typename V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    hat_sample_fwd_vec_kernel(const V* __restrict__ value,
                              const float* __restrict__ px,
                              const float* __restrict__ py,
                              const float* __restrict__ aw,
                              V* __restrict__ out, int BM, int H, int W,
                              int D, int Lq, int PL) {
  constexpr int kN = kChunk<V>;
  const int lane = threadIdx.x & 31, half = lane >> 4, hl = lane & 15;
  const long long rows = (long long)BM * Lq;
  const long long first =
      ((long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * 2;
  if (first >= rows) return;
  const long long row = first + half;  // row = bm * Lq + q
  const bool has = row < rows;
  const V* vb = value + (has ? row / Lq : 0) * H * W * (long long)D;
  const unsigned half_lanes = 0xffffu << (16 * half);
  // lane 4 p + k of a half in a round: corner k (00 01 10 11) of point p
  const int p = hl >> 2, dx = hl & 1, dy = (hl >> 1) & 1;

  for (int d0 = 0; d0 < D; d0 += kRow) {
    float acc[kRow / kQueryLanes];
#pragma unroll
    for (int c = 0; c < kRow / kQueryLanes; ++c) acc[c] = 0.f;
    for (int p0 = 0; p0 < PL; p0 += kRoundPoints) {
      const int np = PL - p0 < kRoundPoints ? PL - p0 : kRoundPoints;
      // the lane's corner: its token and weight, aw folded in; a negative
      // key of its own where the corner is outside the grid, or its point
      // is non-finite or outside (-1, W) x (-1, H)
      int key = -1 - lane;
      float w = 0.f;
      if (has && p < np) {
        const long long i = row * PL + p0 + p;
        const float x = px[i], y = py[i];
        if (x > -1.f && y > -1.f && x < (float)W && y < (float)H) {
          const float x0f = floorf(x), y0f = floorf(y);
          const int cx = (int)x0f + dx, cy = (int)y0f + dy;
          const float fx = x - x0f, fy = y - y0f;
          if (cx >= 0 && cx < W && cy >= 0 && cy < H) {
            key = cy * W + cx;
            w = aw[i] * ((dy ? fy : 1.f - fy) * (dx ? fx : 1.f - fx));
          }
        }
      }
      // the lowest lane of each token in a half sums the weights of that
      // token's lanes in the half, in lane order; those lanes are the
      // query's merged rows
      const unsigned same = __match_any_sync(0xffffffffu, key) & half_lanes;
      float wsum = 0.f;
      for (int j = 0; j < 4 * np; ++j) {
        const float wj = __shfl_sync(0xffffffffu, w, j, kQueryLanes);
        if (same >> (16 * half + j) & 1u) wsum += wj;
      }
      unsigned todo = __ballot_sync(0xffffffffu,
                                    key >= 0 && __ffs(same) - 1 == lane) >>
                      (16 * half) & 0xffffu;
      // kBatch rows' gathers per query issued together, then their
      // multiply-adds
      while (__any_sync(0xffffffffu, todo != 0u)) {
        uint4 u[kBatch<V>][kPieces<V>];
        float ws[kBatch<V>];
#pragma unroll
        for (int b = 0; b < kBatch<V>; ++b) {
          const int j = __ffs(todo) - 1;  // -1 once every row is taken
          todo &= todo - 1u;
          const int t = __shfl_sync(0xffffffffu, key, j & 15, kQueryLanes);
          const float wt = __shfl_sync(0xffffffffu, wsum, j & 15,
                                       kQueryLanes);
          ws[b] = j >= 0 ? wt : 0.f;
          const V* r = vb + (long long)t * D + d0 + hl * kN;
#pragma unroll
          for (int i = 0; i < kPieces<V>; ++i)
            u[b][i] = j >= 0 ? load16(r + i * kQueryLanes * kN)
                             : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int b = 0; b < kBatch<V>; ++b) {
#pragma unroll
          for (int i = 0; i < kPieces<V>; ++i) {
            float f[kN];
            widen<V>(u[b][i], f);
#pragma unroll
            for (int c = 0; c < kN; ++c) acc[i * kN + c] += ws[b] * f[c];
          }
        }
      }
    }
    if (has) {
      V* o = out + row * D + d0 + hl * kN;
#pragma unroll
      for (int i = 0; i < kPieces<V>; ++i)
        *reinterpret_cast<uint4*>(o + i * kQueryLanes * kN) =
            narrow<V>(acc + i * kN);
    }
  }
}

// The scalar path (any D, any alignment). value (BM, H*W, D); px, py, aw
// (BM, Lq, PL) f32; out (BM, Lq, D). All contiguous.
template <typename V>
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

// hat_sample_fwd_vec_kernel (D a multiple of 256, aligned rows) or
// hat_sample_fwd_kernel.
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
  if (aligned && D % kRow == 0)
    hat_sample_fwd_vec_kernel<V>
        <<<(unsigned)((warps + 2 * kWarpsPerBlock - 1) /
                      (2 * kWarpsPerBlock)),
           kWarpsPerBlock * 32, 0, stream>>>(v, px, py, aw, o, BM, H, W, D,
                                             Lq, PL);
  else
    hat_sample_fwd_kernel<V><<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                               stream>>>(v, px, py, aw, o, BM, H, W, D, Lq,
                                         PL);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns 0 on success, a cudaError_t code (> 0) if the launch failed, or a
// negative code for arguments the kernel does not take: -1 a dimension out
// of range, -3 dtype, -4 grid too large. value is (BM, H * W, D).
extern "C" int hat_sample_fwd(const void* value, const void* px,
                              const void* py, const void* aw, void* out,
                              int BM, int H, int W, int D, int Lq, int PL,
                              int value_dtype, void* stream) {
  if (BM < 0 || H < 1 || W < 1 || D < 0 || Lq < 0 || PL < 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(px);
  const float* y = static_cast<const float*>(py);
  const float* a = static_cast<const float*>(aw);
  if (value_dtype == kFloat32)
    return launch<float>(value, x, y, a, out, BM, H, W, D, Lq, PL, s);
  if (value_dtype == kBFloat16)
    return launch<__nv_bfloat16>(value, x, y, a, out, BM, H, W, D, Lq, PL,
                                 s);
  return -3;
}

extern "C" const char* hat_sample_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
