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
// value 9.7 MB and gpx/gpy/gaw 3.5 MB, 30 us. Scattered point by point, the
// 1.18 M corners of the QRF points become 2.35 M warp-wide 16-byte atomic
// instructions into a 9.7 MB gv: the L2's rate of atomic sector requests
// set the pace (0.935 ms, PERF.md). But a RoI's 196 points fall on about
// 65 tokens: the corners of neighbouring bins coincide.
//
// Design:
// - The merged path (hat_sample_bwd_tile_kernel; D = 256, PL <= kMaxPL): a
//   block takes a tile of kTileQ consecutive rows (bm, q), rows numbered
//   q-fastest, so a tile may straddle frames. It stages the tile's go
//   rows in shared memory (f32), writes one key per corner, (frame offset *
//   H * W + token, query, entry), sorts the keys (a bitonic sort in shared
//   memory), and each warp sums the runs of equal tokens that start in its
//   eighth of the sorted keys, sum_e aw_e * w_e * go[q_e], in registers, in
//   key order, then adds each sum into gv once. At the QRF points a tile's
//   256 corners fall on about 36 tokens, so gv takes 7x fewer atomic rows
//   than corners. Segments are summed in registers, so no tile is refused
//   for the number of tokens it touches: the shared memory is the go tile
//   and the keys, fixed by kTileQ and PL. The path takes any points: where
//   no corner coincides (uniform points) it adds each corner once, as a
//   scatter point by point would, after a sort of 36 steps. The C entry
//   counts the tiles it launches (hat_sample_bwd_merged_tiles).
// - Measured on the H100 (PERF.md): with the atomics merged, the
//   staging, the sort and the segment sums set the pace, not the atomics
//   (without them the kernel is 5% faster); tiles of 16 rows beat 8, 32
//   and 64, and blocks of 8 warps beat 2 and 4. Merging a query's equal
//   corners in registers before the sort (a warp per query,
//   __match_any_sync) gained nothing and is not kept.
// - The lane layout of a 256-channel row: lane l holds channels [4l, 4l+4)
//   and [128+4l, 128+4l+4), so each warp-wide 16-byte atomic (or load)
//   covers 512 contiguous bytes of an f32 row, 16 whole 32-byte sectors,
//   where 8 contiguous channels per lane half-cover 32 sectors.
// - The scalar path (hat_sample_bwd_kernel), for every other input (any D
//   but 256, unaligned pointers, PL > kMaxPL, a map whose keys would not fit
//   32 bits): one warp per row (bm, q), a loop over channels, 32 at a time,
//   one f32 atomic per corner and channel. No workload reaches it at D =
//   256: RoIAlign's PL is its sampling_ratio squared, 4 in the QRF.
// - gv: f32 atomicAdd (compiled to fire-and-forget REDs) into an f32 buffer
//   that the wrapper zeroes, then one cast pass when the value is bf16; an
//   f32 value accumulates in its gradient directly. Within a tile the order
//   of the additions is fixed; across tiles the atomics land in an order
//   that changes from run to run, so gv is not bitwise deterministic.
// - The point gradients are a compile-time switch: RoIAlign's coordinates
//   and weights carry no gradient, so on the model path only gv is computed,
//   and gv needs no read of the value. With the switch on, each warp takes
//   its queries one by one (the go row from the staged tile on the merged
//   path): each lane takes partial dot products of its channels with the 4
//   corners, a warp shuffle reduces them and lane 0 writes gpx, gpy and gaw
//   (f32).
// Measured before this design (PERF.md, NVIDIA H100 80GB HBM3, 700.00 W):
// 0.935-0.946 ms at the training shape, one warp per row and two 16-byte
// atomics of 8 contiguous channels per lane and corner.
// Later work: loading the next tile's go rows while one is sorted, a
// deterministic order across tiles (a second pass over the tiles' sums),
// and fusing the scatter into DynamicConv's backward.
//
// Plain C interface, loaded with ctypes; see dfvod_tpu_torch/ops/hat_sample.py.

#include <atomic>
#include <cstdint>

// dtype codes, kWarpsPerBlock, f32 conversions, the bf16 4-channel loads,
// the bf16 cast pass
#include "msda_common.cuh"

using namespace msda;

namespace {

// Rows (bm, q) per tile of the merged path, chosen by measurement on the
// H100 (PERF.md): 8, 16, 32 and 64 were timed at the QRF training
// shape.
constexpr int kTileQ = 16;
// The most points per query the merged path takes: a tile's kTileQ * PL * 4
// corner keys are sorted in shared memory.
constexpr int kMaxPL = 8;
// Warps per block of the merged path (2, 4 and 8 timed).
constexpr int kTileWarps = 8;
// Channels of a row on the vector paths.
constexpr int kRow = 256;
constexpr unsigned long long kNoKey = ~0ull;

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

// This lane's 8 channels of a 256-channel row (16-byte aligned) in the lane
// layout, [4 lane, 4 lane + 4) and [128 + 4 lane, 128 + 4 lane + 4), as f32.
__device__ __forceinline__ void load_row(const float* p, int lane,
                                         float f[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p + 4 * lane));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 128 + 4 * lane));
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, int lane,
                                         float f[8]) {
  load4(p + 4 * lane, f);
  load4(p + 128 + 4 * lane, f + 4);
}

// The row of shared memory at p, in the lane layout.
__device__ __forceinline__ void store_shared_row(float* p, int lane,
                                                 const float f[8]) {
  *reinterpret_cast<float4*>(p + 4 * lane) =
      make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(p + 128 + 4 * lane) =
      make_float4(f[4], f[5], f[6], f[7]);
}
__device__ __forceinline__ void load_shared_row(const float* p, int lane,
                                                float f[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p + 4 * lane);
  const float4 b = *reinterpret_cast<const float4*>(p + 128 + 4 * lane);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// Add s * f into the f32 row at p in the lane layout: two 16-byte atomics,
// each covering 16 whole sectors across the warp.
__device__ __forceinline__ void add_row(float* p, int lane, const float f[8],
                                        float s) {
  atomicAdd(reinterpret_cast<float4*>(p + 4 * lane),
            make_float4(s * f[0], s * f[1], s * f[2], s * f[3]));
  atomicAdd(reinterpret_cast<float4*>(p + 128 + 4 * lane),
            make_float4(s * f[4], s * f[5], s * f[6], s * f[7]));
}

// The partial dot products of this lane's channels g with the 4 corners.
template <typename V>
__device__ __forceinline__ void corner_dots(const V* vb, const Tent& c,
                                            int lane, const float g[8],
                                            float dot[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    dot[k] = 0.f;
    if (c.t[k] < 0) continue;
    float v[8];
    load_row(vb + (long long)c.t[k] * kRow, lane, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) dot[k] += g[j] * v[j];
  }
}

// Sort n keys (n a power of two) in shared memory, ascending: a bitonic
// sort, one compare-exchange per thread and pair, every step followed by a
// barrier.
__device__ __forceinline__ void sort_keys(unsigned long long* keys, int n) {
  for (int k = 2; k <= n; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < n / 2; p += blockDim.x) {
        const int lo = 2 * p - (p & (j - 1));  // bit j of lo is clear
        const unsigned long long a = keys[lo], b = keys[lo + j];
        if ((a > b) == ((lo & k) == 0)) {
          keys[lo] = b;
          keys[lo + j] = a;
        }
      }
      __syncthreads();
    }
}

// The merged path. value (BM, H*W, 256), only read with kPointGrads; px, py,
// aw (BM, Lq, PL) f32; go (BM, Lq, 256); gv (BM, H*W, 256) f32, zeroed, or
// null; gpx, gpy, gaw (BM, Lq, PL) f32, only written with kPointGrads. All
// contiguous and 16-byte aligned (value only with kPointGrads). rows = BM *
// Lq; 1 <= PL <= kMaxPL; n, the keys sorted per tile, a power of two >=
// kTileQ * PL * 4; kTileQ * H * W < 2^32 - 1. Dynamic shared memory:
// kTileQ * 256 f32 of go, n keys and n weights.
template <typename V, typename G, bool kPointGrads>
__global__ void __launch_bounds__(kTileWarps * 32)
    hat_sample_bwd_tile_kernel(const V* __restrict__ value,
                               const float* __restrict__ px,
                               const float* __restrict__ py,
                               const float* __restrict__ aw,
                               const G* __restrict__ go,
                               float* __restrict__ gv,
                               float* __restrict__ gpx,
                               float* __restrict__ gpy,
                               float* __restrict__ gaw, long long rows,
                               int H, int W, int Lq, int PL, int n) {
  extern __shared__ float4 smem[];
  float* go_s = reinterpret_cast<float*>(smem);
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(go_s + kTileQ * kRow);
  float* wts = reinterpret_cast<float*>(keys + n);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long r0 = (long long)blockIdx.x * kTileQ;  // the tile's rows
  const int nq = (int)(rows - r0 < kTileQ ? rows - r0 : kTileQ);
  const long long bm0 = r0 / Lq;
  const unsigned q0 = (unsigned)(r0 - bm0 * Lq);  // row j is frame bm0 +
  const unsigned HW = (unsigned)H * (unsigned)W;  // (q0 + j) / Lq

  for (int j = warp; j < nq; j += kTileWarps) {
    float g[8];
    load_row(go + (r0 + j) * kRow, lane, g);
    store_shared_row(go_s + j * kRow, lane, g);
  }

  if (gv != nullptr) {
    // one thread per sample point i = j * PL + p of the tile: its corner
    // entries e = 4 i + k, keyed (frame offset * HW + token, j, e), or no
    // key outside the grid; padding past the tile's points has none
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x) {
      const int j = i / PL;
      Tent c;
      bool ok = false;
      float a = 0.f;
      unsigned base = 0;
      if (j < nq) {
        const long long gi = r0 * PL + i;
        ok = tent(px[gi], py[gi], H, W, &c);
        a = aw[gi];
        base = (q0 + (unsigned)j) / (unsigned)Lq * HW;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int e = 4 * i + k;
        if (ok && c.t[k] >= 0) {
          keys[e] = (unsigned long long)(base + (unsigned)c.t[k]) << 32 |
                    (unsigned)j << 16 | (unsigned)e;
          wts[e] = a * c.w[k];
        } else {
          keys[e] = kNoKey;
        }
      }
    }
    __syncthreads();
    sort_keys(keys, n);
    // each warp takes the runs of equal tokens that start in its share of
    // the sorted keys; the keys without a token sort last
    const int share = n / kTileWarps;
    for (int s = warp * share; s < (warp + 1) * share; ++s) {
      const unsigned long long head = keys[s];
      if (head == kNoKey) break;
      const unsigned tok = (unsigned)(head >> 32);
      if (s > 0 && (unsigned)(keys[s - 1] >> 32) == tok) continue;
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int u = s; u < n; ++u) {
        const unsigned long long key = keys[u];
        if ((unsigned)(key >> 32) != tok) break;
        const float wt = wts[key & 0xffffu];
        float g[8];
        load_shared_row(go_s + ((key >> 16) & 0xffffu) * kRow, lane, g);
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[c] += wt * g[c];
      }
      const unsigned frame = tok / HW;
      add_row(gv + ((bm0 + frame) * HW + (tok - frame * HW)) * kRow, lane,
              acc, 1.f);
    }
  } else {
    __syncthreads();  // the staged go rows
  }

  if constexpr (kPointGrads) {
    for (int j = warp; j < nq; j += kTileWarps) {
      const long long bm = bm0 + (q0 + (unsigned)j) / (unsigned)Lq;
      const V* vb = value + bm * HW * kRow;
      float g[8];
      load_shared_row(go_s + j * kRow, lane, g);
      for (int p = 0; p < PL; ++p) {
        const long long i = (r0 + j) * PL + p;
        Tent c;
        if (!tent(px[i], py[i], H, W, &c)) {
          if (lane == 0) gpx[i] = gpy[i] = gaw[i] = 0.f;
          continue;
        }
        float dot[4];
        corner_dots(vb, c, lane, g, dot);
        point_grads(dot, c, aw[i], i, lane, gpx, gpy, gaw);
      }
    }
  }
}

// The scalar path, for the inputs the merged path does not take (any D but
// 256, unaligned pointers, PL > kMaxPL, a map whose keys would not fit 32
// bits): one warp per row (bm, q), channels across lanes, 32 at a time, one
// f32 atomic per valid corner and channel. value (BM, H*W, D); px, py, aw
// (BM, Lq, PL) f32; go (BM, Lq, D); gv (BM, H*W, D) f32, zeroed, or null;
// gpx, gpy, gaw (BM, Lq, PL) f32, written only with kPointGrads. All
// contiguous.
template <typename V, typename G, bool kPointGrads>
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

// The merged path's shared memory at its most points per query: within
// the 48 KB a launch takes without opting in to more.
static_assert(sizeof(float) * kTileQ * kRow +
                      (sizeof(unsigned long long) + sizeof(float)) * kTileQ *
                          kMaxPL * 4 <=
                  48 * 1024,
              "the merged path's tile exceeds 48 KB of shared memory");

// Tiles launched on the merged path since the library was loaded (read by
// hat_sample_bwd_merged_tiles).
std::atomic<long long> merged_tiles{0};

// The merged path's launch: kTileQ rows per block (fewer blocks than the
// scalar path's, whose count the caller has checked).
template <typename V, typename G, bool kPointGrads>
void launch_tiles(long long rows, const V* v, const float* px,
                  const float* py, const float* aw, const G* g, float* gv,
                  float* gpx, float* gpy, float* gaw, int H, int W, int Lq,
                  int PL, cudaStream_t stream) {
  const long long blocks = (rows + kTileQ - 1) / kTileQ;
  int n = 32;
  while (n < kTileQ * PL * 4) n <<= 1;
  const size_t smem = sizeof(float) * kTileQ * kRow +
                      (sizeof(unsigned long long) + sizeof(float)) * n;
  hat_sample_bwd_tile_kernel<V, G, kPointGrads>
      <<<(unsigned)blocks, kTileWarps * 32, smem, stream>>>(
          v, px, py, aw, g, gv, gpx, gpy, gaw, rows, H, W, Lq, PL, n);
  merged_tiles += blocks;
}

template <typename V, typename G>
int launch(const void* value, const float* px, const float* py,
           const float* aw, const void* go, float* gv32, void* gv,
           float* gpx, float* gpy, float* gaw, int BM, int H, int W, int D,
           int Lq, int PL, cudaStream_t stream) {
  const long long rows = (long long)BM * Lq;
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return -4;
  const bool point_grads = gpx != nullptr;
  if (blocks > 0 && D > 0) {
    const V* v = static_cast<const V*>(value);
    const G* g = static_cast<const G*>(go);
    const bool tiles =
        D == kRow && PL >= 1 && PL <= kMaxPL &&
        (long long)kTileQ * H * W < 0xffffffffLL &&
        reinterpret_cast<uintptr_t>(go) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(gv32) % 16 == 0 &&
        (!point_grads || reinterpret_cast<uintptr_t>(value) % 16 == 0);
    if (tiles && point_grads)
      launch_tiles<V, G, true>(rows, v, px, py, aw, g, gv32, gpx, gpy, gaw,
                               H, W, Lq, PL, stream);
    else if (tiles)
      launch_tiles<V, G, false>(rows, v, px, py, aw, g, gv32, gpx, gpy, gaw,
                                H, W, Lq, PL, stream);
    else if (point_grads)
      hat_sample_bwd_kernel<V, G, true>
          <<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
              v, px, py, aw, g, gv32, gpx, gpy, gaw, BM, H, W, D, Lq, PL);
    else
      hat_sample_bwd_kernel<V, G, false>
          <<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
              v, px, py, aw, g, gv32, gpx, gpy, gaw, BM, H, W, D, Lq, PL);
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

// The merged path's rows per tile, and the tiles it has launched since the
// library was loaded: what a caller reads to see which path a call took.
extern "C" int hat_sample_bwd_tile_rows() { return kTileQ; }
extern "C" long long hat_sample_bwd_merged_tiles() { return merged_tiles; }
