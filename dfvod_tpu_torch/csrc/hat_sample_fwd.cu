// Weighted bilinear sampling over stacked token grids (K3, K5a) for Hopper
// (sm_90a):
//
//   out[bm, q, :] = sum_p aw[bm, q, p] * bilinear(level_l(p)[bm], py - yo_l,
//                                                 px)
//
// Replaces two TPU kernels of dfvod_tpu/ops/msda_pallas.py:
// - _hat_kernel (K3, wrapper hat_sample), which RoIAlign reaches through
//   dfvod_tpu/ops/roi_align.py::_roi_align_hat in TransVOD++'s Query-RoI
//   Fusion: one level, the regular grid (token s at row s / W, column
//   s % W);
// - _hat_sparse_kernel_factory (K5a, wrapper hat_sample_sparse), which
//   ms_deform_attn_pallas_hat(sparse=True) reaches: the MSDA levels stacked
//   along y (_hat_coords: level l's rows offset by yo_l = sum_{j<l} H_j + 2),
//   the point columns level-major (column p belongs to level p / P).
// The coordinates are pixel indices: the weight of token (sy, sx) is the
// tent relu(1 - |px - sx|) * relu(1 - |py - sy|), so a corner outside the
// grid contributes 0 and there is no -0.5 shift (MSDA's callers apply it).
// The TPU kernels build that tent matrix densely, (TQ, S), and contract it
// with the value slab on the MXU, because Mosaic had no gather; K5a skips
// the 256-token chunks that no point of a 128-query block touches. Hopper
// gathers well, so this kernel reads the four corners of each sample point
// directly, and a gather touches only the tokens it needs: chunk skipping
// has no counterpart.
//
// Each point samples only its own level: with y taken back to the level
// (y = py - yo_l), a corner outside the level counts 0, as
// ms_deform_attn_xla and the reference CUDA kernel do. The TPU's stacked
// tent matrix reads a neighbouring level for a point more than about one
// row outside its own (ROADMAP, known differences). One level takes K3's
// kernel as it is; more levels take a level loop of its scalar path. yo_l is
// an integer and py is near it, so py - yo_l is exact (Sterbenz) and the
// corner weights equal the stacked tent's.
//
// What bounds it. Each input read once and the output written once: at the
// QRF shape (BM = 10 frames, 38 x 50 tokens, D = 256 bf16, Lq = 300 RoIs x
// 7 x 7 bins = 14,700, PL = 2 x 2 sub-samples) that is 9.7 MB of value,
// 7.1 MB of px/py/aw and 75.3 MB of output, 92 MB, 27.5 us at 3.35 TB/s.
// The output dominates: it is 7.7x the value it is sampled from. The
// gathered traffic (4 corners x PL points x D channels per query, about
// 1.2 GB) is mostly re-reads of a frame's 0.97 MB value slab from L2. At
// MSDA's encoder shape (BM = 64 heads, 1900 tokens, D = 32 bf16, PL = 4)
// the value and the output are 7.8 MB each and the f32 points 5.8 MB:
// 21.4 MB, 6.4 us.
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
//   (or head's) value slab, which stays in L2; consecutive q are the 49
//   bins of one RoI and read neighbouring pixels.
// - Coordinates, corner weights and the sum are f32; the output is rounded
//   once, to the value's type.
// - Any other D, unaligned rows (hat_sample_fwd_kernel, K5a's path at one
//   level), and any stacking of more than one level
//   (hat_sample_levels_kernel) take a scalar loop over channels, 32 at a
//   time, point by point.
// - A point with a non-finite coordinate or one outside (-1, W) x (-1, H)
//   of its level (the -1e6 padding included) is skipped before any
//   float-to-int conversion: (int)floorf(NaN) is undefined. The TPU's K5a
//   gives 0 for such a point only when no point of its query block
//   activates a chunk (ROADMAP, known differences).
// Measured before this design (PERF.md, NVIDIA H100 80GB HBM3, 700.00 W):
// 0.149-0.150 ms at the QRF shape, each point's 4 corners gathered in turn.
// Later work: staging a tile's distinct value rows in shared memory
// (cp.async or TMA), TMA or vector stores of several rows, and building the
// coordinates from the boxes inside the kernel instead of reading 7 MB of
// them.
//
// Plain C interface, loaded with ctypes; see dfvod_tpu_torch/ops/hat_sample.py.

#include <cstdint>

// dtype codes, the level table, kWarpsPerBlock, f32 conversions, the
// 16-byte loads (load16, widen) and stores (narrow) of the vector path
#include "msda_common.cuh"

using namespace msda;

namespace {

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

// The scalar path (any D, any alignment; K5a at one level). value (BM,
// H*W, D); px, py, aw (BM, Lq, PL) f32; out (BM, Lq, D). All contiguous.
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

// The stacked levels (K5a, more than one level): P point columns per level,
// level l's rows offset by yo[l] in py.
struct Stack {
  Levels lv;
  int P;
  float yo[kMaxLevels];
};

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

// One level (K3, and K5a at one level, where yo = 0):
// hat_sample_fwd_vec_kernel or hat_sample_fwd_kernel; more:
// hat_sample_levels_kernel.
template <typename V>
int launch(const void* value, const float* px, const float* py,
           const float* aw, void* out, int BM, int S, int D, int Lq,
           const Stack& st, cudaStream_t stream) {
  const long long warps = (long long)BM * Lq;
  const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return -4;
  if (blocks == 0 || D == 0) return (int)cudaGetLastError();
  const bool aligned = (reinterpret_cast<uintptr_t>(value) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const V* v = static_cast<const V*>(value);
  V* o = static_cast<V*>(out);
  const int H = st.lv.h[0], W = st.lv.w[0], PL = st.P;
  if (st.lv.n > 1)
    hat_sample_levels_kernel<V><<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                                  stream>>>(v, px, py, aw, o, BM, S, D, Lq,
                                            st);
  else if (aligned && D % kRow == 0)
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
// negative code for arguments the kernel does not take: -1 a dimension or
// level count out of range, -2 S != sum(H*W), -3 dtype, -4 grid too large.
// shapes holds the L levels' (H, W); the point columns are L * P.
extern "C" int hat_sample_fwd(const void* value, const void* px,
                              const void* py, const void* aw, void* out,
                              int BM, int S, int D, int Lq, int L, int P,
                              const int* shapes, int value_dtype,
                              void* stream) {
  if (BM < 0 || D < 0 || Lq < 0 || P < 0) return -1;
  Stack st;
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

extern "C" const char* hat_sample_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
