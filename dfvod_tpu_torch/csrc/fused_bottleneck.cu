// One ResNet bottleneck block, fused (K6), for Hopper (sm_90a). Three
// launches, one per block, run ResNet-50's layer1:
//
//   t   = relu(x . w1 + b1)                    rounded to bf16, 0 outside
//                                              the image (the 3x3's padding)
//   u   = relu(conv3x3(t, w2) + b2)            rounded to bf16
//   out = relu((u . w3 + b3) + idn)            rounded to bf16
//   idn = x . wd + bd   (first block)   or   x   (the others)
//
// with FrozenBN folded into the weights (bf16) and biases (f32) by the
// caller, every product accumulated in f32.
//
// Replaces the TPU kernel dfvod_tpu/ops/fused_bottleneck.py::_stage_pallas
// (body _block_body), which runs the whole stage for a strip of TR rows out
// of VMEM, recomputing a halo row per block. Its rounding points are kept.
//
// What bounds it. At the serving shape (B = 8, 152 x 200, 64 -> 256
// channels) the stage is 212,992 multiply-adds per position, 103.6 GFLOP:
// 0.105 ms at 989 TFLOP/s bf16. One launch per block moves each block's
// input and output once: 31.1 + 3 x 124.5 + 2 x 124.5 MB, about 654 MB,
// 0.195 ms at 3.35 TB/s. So a launch per block is bound by bytes (0.195
// ms); a single launch for the whole stage would move 155.6 MB (0.046 ms)
// and be bound by operations, but needs a halo of 3 (block 1's t on 14 x 22
// positions for an 8 x 16 tile) and breaks the shared-memory plan below.
//
// Two paths; the C entry chooses and counts each one's launches
// (fused_bottleneck_layer1_launches, fused_bottleneck_generic_launches).
//
// The layer1 path (fused_bottleneck_layer1_kernel; Cm = 64, Cout = 256,
// Cin = 64 with a projection or Cin = 256 with the identity, 16-byte
// aligned weights and activations):
// - A persistent grid: one CTA of 8 warps (two warpgroups) per SM walks
//   the output tiles of 8 rows x 16 columns (128 positions; w fastest,
//   then h, then b).
// - Every weight of the block stays in shared memory for the whole launch,
//   loaded once per CTA with cp.async: w1 (Cin x 64), w2 (9 x 64 x 64), w3
//   and wd as four 64-column blocks of 64 x 64, each a column of 128-byte
//   rows whose 16-byte chunks are swizzled by (chunk ^ row % 8): the
//   128-byte swizzle, so wgmma reads them by descriptor and ldmatrix
//   without bank conflicts. The output's bias (b3 + bd, summed once in
//   f32) beside them; b1 and b2 are read through L1.
// - x's (8 + 2) x (16 + 2) halo streams in chunks of 64 channels (180
//   positions x 128 bytes) through a ring of slots, loaded with cp.async
//   (zero fill outside the image), a commit group per chunk. A chunk is
//   issued as soon as the chunk that last held its slot is consumed: at
//   Cin = 64 (2 slots) the next tile's halo loads under the current
//   tile's t, u and out; at Cin = 256 (3 slots) the next tile's first
//   three chunks load under u and out, and its fourth under the first two.
// - Products on the tensor cores with f32 accumulators. wgmma m64n64k16 of
//   a warpgroup (64 rows: 16 per warp) with A from registers (ldmatrix,
//   the rows of t or x that a shifted window needs) and B by descriptor;
//   mma.sync m16n8k16 for the halo rows past 128.
//   t: halo rows 0..127 by the two warpgroups' wgmma, rows 128..179 by
//   every warp's mma.sync while those run. u: 9 taps x 4 k steps of
//   wgmma, warpgroup g taking output rows 4 g .. 4 g + 3, A from t's
//   halo rows shifted by the tap (no im2col), the next tap's A loaded
//   while the current tap's products run. out: four blocks of 64
//   channels, u . w3 (and x . wd) summed into one accumulator, the next
//   block's products running while one block's epilogue does.
// - Epilogues from the accumulator registers: bias, ReLU, the zero of t
//   outside the image and the bf16 rounding where the fragment lies; u is
//   held in registers until every warp has read t and then written over
//   it. At Cin = 256 each lane copies its outputs' identity residual from
//   the halo chunks as they pass through the ring, into registers in the
//   accumulators' layout. The output leaves through t's rows, now free:
//   stmatrix puts a warp's 16 positions x 64 channels in 16 rows, and 16-
//   byte loads and stores move whole 128-byte rows to device memory.
// - Shared memory: Cin = 256: weights 136 KB + 3 halo slots 67.5 KB + t/u
//   22.5 KB + bias 1 KB = 227 KB (232,448 bytes, all a CTA can have); Cin
//   = 64: weights 144 KB (wd included) + 2 slots 45 KB + 22.5 + 1 = 212.5
//   KB.
// - CTA-wide barriers remain where a phase reads what every warp wrote:
//   once per halo chunk, after t, after u's products, after u's stores and
//   after out's A loads.
// - Measured on the H100 (PERF.md, NVIDIA H100 80GB HBM3, 700.00 W):
//   0.425-0.429 ms for the 3 launches at the serving shape, 5.0x the
//   generic path. A tile of a Cin = 256 block takes about 18,200 cycles
//   (clock64 in a profiling copy): the halo chunks' waits and barriers
//   20%, t 25%, u's products 22%, out's epilogue 17%.
//
// The generic path (fused_bottleneck_generic_kernel; any channels in
// multiples of 16, an identity first block): a CTA of 8 warps per 8 x 16
// tile with the halo of x, t and u in shared memory (rows padded by 16
// bf16, 168 KB at 256 input channels), WMMA m16n16k16 products with the
// B tiles read through L1/L2, and epilogues through a per-warp scratch.
// Measured before the layer1 path, at the serving shape: 2.1287-2.1525 ms
// for the 3 launches (PERF.md, NVIDIA H100 80GB HBM3, 700.00 W).
//
// Plain C interface, loaded with ctypes; see
// dfvod_tpu_torch/ops/fused_bottleneck.py.

#include <atomic>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTH = 8, kTW = 16;                 // output tile
constexpr int kHC = kTW + 2;                     // halo columns
constexpr int kHalo = (kTH + 2) * kHC;           // 180 halo positions
constexpr int kHaloPad = (kHalo + 15) / 16 * 16; // 192: whole m-tiles
constexpr int kWarps = 8;
constexpr int kMaxSmem = 232448;

struct Params {
  const bf16* x;
  bf16* out;
  const bf16 *w1, *w2, *w3, *wd;
  const float *b1, *b2, *b3, *bd;
  int H, W, Cin, Cm, Cout;
};

// ------------------------------------------------------------ layer1 path
namespace l1 {

constexpr int kCm = 64, kCout = 256;
constexpr int kRow = 128;  // bytes of a shared row: 64 bf16

// Byte offsets of the regions in dynamic shared memory: the weights, the
// halo ring (3 slots at Cin = 256; 2 at Cin = 64, where wd leaves no room
// for a third), t (then u, then the output's staging), 180 rows each, and
// the output's f32 bias.
template <int kCin>
struct Layout {
  static constexpr bool kProj = kCin != kCout;
  static constexpr int kSlots = kProj ? 2 : 3;
  static constexpr int kW1 = 0;                               // kCin rows
  static constexpr int kW2 = kW1 + kCin * kRow;               // 9 x 64 rows
  static constexpr int kW3 = kW2 + 9 * kCm * kRow;            // 4 x 64 rows
  static constexpr int kWd = kW3 + 4 * kCm * kRow;            // 4 x 64 rows
  static constexpr int kX = kWd + (kProj ? 4 * kCm * kRow : 0);
  static constexpr int kSlot = kHalo * kRow;
  static constexpr int kT = kX + kSlots * kSlot;
  static constexpr int kBo = kT + kHalo * kRow;               // b3 (+ bd)
  static constexpr int kBytes = kBo + kCout * 4;
};
static_assert(Layout<64>::kBytes <= kMaxSmem, "Cin = 64 exceeds 227 KB");
static_assert(Layout<256>::kBytes <= kMaxSmem, "Cin = 256 exceeds 227 KB");

// Offset of 16-byte chunk `chunk` of shared row `row`, swizzled.
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * kRow + ((chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Wait until at most `pending` (0..2) of this thread's newest commit groups
// are still in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// Four 8 x 8 bf16 matrices from the mma fragments r0..r3 into shared rows
// of 16 bytes, lanes 8 i .. 8 i + 7 giving the row addresses of matrix i.
__device__ __forceinline__ void stsm_x4(uint32_t addr, uint32_t r0,
                                        uint32_t r1, uint32_t r2,
                                        uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
      :
      : "r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}

// c += a . b for one m16n8k16 tile: a the A fragment (ldmatrix x4), b0 b1
// the B fragment of one n8 column block.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[i][j] += A_i . B_j over one k16 step of m16n8k16 tiles. A: the
// region at shared address `a`, this lane's ldmatrix row a_row[i] of
// m-tile i, 16-byte chunk a_chunk. B: the row-major (K x 64) weights at
// shared address `b`, this lane's k row b_row, n chunk b_chunk + 2 j for
// the pair of n8 blocks j.
template <int MI, int NJ>
__device__ __forceinline__ void mma_step(float (&acc)[MI][NJ][4], uint32_t a,
                                         const int (&a_row)[MI], int a_chunk,
                                         uint32_t b, int b_row, int b_chunk) {
  uint32_t af[MI][4], bf[NJ / 2][4];
#pragma unroll
  for (int i = 0; i < MI; ++i) ldsm_x4(a + swz(a_row[i], a_chunk), af[i]);
#pragma unroll
  for (int j = 0; j < NJ / 2; ++j)
    ldsm_x4_t(b + swz(b_row, b_chunk + 2 * j), bf[j]);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      mma(acc[i][j], af[i], bf[j >> 1][(j & 1) * 2],
          bf[j >> 1][(j & 1) * 2 + 1]);
}

// wgmma: the shared-memory descriptor of the B operand of one k16 step, a
// (16 x 64) block of row-major weights in 128-byte rows swizzled in 16-byte
// chunks by (chunk ^ row % 8) -- the 128-byte swizzle of an MN-major
// operand, 1024-byte aligned: start address, the stride between 64-column
// atoms (LBO, unused at n64) and between groups of 8 k rows (SBO), and the
// swizzle mode.
__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(8192 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accesses of d across a wgmma wait.
__device__ __forceinline__ void wg_hold(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A . B for a warpgroup's m64n64k16: A from registers (this warp's
// 16 rows, the mma.sync m16n8k16 A fragment), B by descriptor (MN-major),
// d as 8 n8 blocks of the mma.sync C fragment; d is overwritten where
// accumulate is 0.
__device__ __forceinline__ void wgmma64(float (&d)[32], const uint32_t (&a)[4],
                                        uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

template <int MI, int NJ>
__device__ __forceinline__ void zero(float (&acc)[MI][NJ][4]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

__device__ __forceinline__ void store_bf16x2(unsigned char* smem, int off,
                                             float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(smem + off) = __floats2bfloat162_rn(a, b);
}

// This lane's identity residual from a halo chunk of 64 channels, in the
// layout of the output's accumulators: the bf16 pairs at output row `row`
// of the tile, columns g8 + 8 hf, channels 8 j + 2 t4 of the chunk.
__device__ __forceinline__ void take_residual(uint32_t (&r)[2][8],
                                              const unsigned char* slot,
                                              int row, int g8, int t4) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int hp = (row + 1) * kHC + 1 + g8 + 8 * hf;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      r[hf][j] =
          *reinterpret_cast<const uint32_t*>(slot + swz(hp, j) + 4 * t4);
  }
}

struct Tile {
  int b, h0, w0;
};

__device__ __forceinline__ Tile tile_of(int t, int tiles_w, int tiles_h) {
  const int tx = t % tiles_w, r = t / tiles_w;
  return {r / tiles_h, (r % tiles_h) * kTH, tx * kTW};
}

// A thread copies 16-byte chunk threadIdx.x % 8 of the halo positions
// threadIdx.x / 8 + 32 m, m < kHaloLoads (the last only for the first
// threads); all of them share one swizzle (row % 8), so their shared
// offsets are swz(threadIdx.x / 8, chunk) + 32 m rows.
constexpr int kHaloLoads = (kHalo * 8 + kWarps * 32 - 1) / (kWarps * 32);

// Issue the cp.asyncs of 64 channels (chunk c) of tile tl's x halo into
// the slot at shared address `slot`: zeros outside the image, whose test
// only a tile on the image's border makes.
template <int kCin>
__device__ __forceinline__ void load_halo(const Params& p, uint32_t slot,
                                          const Tile& tl, int c) {
  const int k = threadIdx.x & 7, h8 = threadIdx.x >> 3;
  const bool inner = tl.h0 >= 1 && tl.h0 + kTH < p.H && tl.w0 >= 1 &&
                     tl.w0 + kTW < p.W;
  const long long base =
      (((long long)tl.b * p.H + tl.h0 - 1) * p.W + tl.w0 - 1) * kCin +
      c * 64 + k * 8;
  const uint32_t dst = slot + swz(h8, k);
#pragma unroll
  for (int m = 0; m < kHaloLoads; ++m) {
    const int hp = h8 + 32 * m;
    if (hp >= kHalo) break;
    bool in = inner;
    if (!inner) {
      const int h = tl.h0 - 1 + hp / kHC, w = tl.w0 - 1 + hp % kHC;
      in = h >= 0 && h < p.H && w >= 0 && w < p.W;
    }
    cp_async16(dst + 32 * m * kRow,
               in ? p.x + (base + (hp / kHC * p.W + hp % kHC) * kCin) : p.x,
               in);
  }
}

// Issue the cp.asyncs of `rows` shared rows of 64 weights at `dst` from
// the row-major matrix src of leading dimension ld: shared row r reads
// row r of src, or with `split` row r % 64, columns 64 (r / 64) ...
__device__ __forceinline__ void load_weights(uint32_t dst, const bf16* src,
                                             int rows, int ld, bool split) {
  for (int i = threadIdx.x; i < rows * 8; i += kWarps * 32) {
    const int r = i >> 3, k = i & 7;
    const bf16* s = split ? src + (long long)(r & 63) * ld + (r >> 6) * 64
                          : src + (long long)r * ld;
    cp_async16(dst + swz(r, k), s + k * 8, true);
  }
}

template <int kCin>
__global__ void __launch_bounds__(kWarps * 32, 1)
    fused_bottleneck_layer1_kernel(Params p, int tiles_w, int tiles_h,
                                   int tiles) {
  using L = Layout<kCin>;
  constexpr int kChunks = kCin / 64;  // halo chunks per tile
  constexpr int kSlots = L::kSlots;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  // ldmatrix roles: A row within the m-tile and k chunk; B k row within
  // the k16 step and n chunk
  const int a_r = lane & 15, a_c = lane >> 4;
  const int b_r = (lane & 7) + ((lane >> 3) & 1) * 8, b_c = lane >> 4;
  // u and out: warpgroup warp / 4 takes output rows 4 (warp / 4) .. + 3,
  // this warp the row orow (16 positions, the rows of its A fragment)
  const int orow = warp;

  // the weights, once per CTA
  load_weights(sbase + L::kW1, p.w1, kCin, kCm, false);
  load_weights(sbase + L::kW2, p.w2, 9 * kCm, kCm, false);
  load_weights(sbase + L::kW3, p.w3, 4 * kCm, kCout, true);
  if (L::kProj) load_weights(sbase + L::kWd, p.wd, 4 * kCm, kCout, true);
  cp_async_commit();
  float* bos = reinterpret_cast<float*>(smem + L::kBo);
  for (int i = threadIdx.x; i < kCout; i += kWarps * 32)
    bos[i] = L::kProj ? p.b3[i] + p.bd[i] : p.b3[i];

  // The halo ring: chunk g of this CTA's walk (tile g / kChunks, channels
  // 64 (g % kChunks) ..) goes into slot g % kSlots once chunk g - kSlots
  // is consumed; every chunk is a commit group of its own.
  const int my_tiles = (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const int total = my_tiles * kChunks;
  int issued = 0, loading = -1;  // loading: the walk's tile of `lt`
  Tile lt;
  auto issue_upto = [&](int limit) {
    for (; issued < limit && issued < total; ++issued) {
      if (issued / kChunks != loading) {
        loading = issued / kChunks;
        lt = tile_of(blockIdx.x + loading * gridDim.x, tiles_w, tiles_h);
      }
      load_halo<kCin>(p, sbase + L::kX + (issued % kSlots) * L::kSlot, lt,
                      issued % kChunks);
      cp_async_commit();
    }
  };
  issue_upto(kSlots);

  for (int n = 0; n < my_tiles; ++n) {
    const Tile tl = tile_of(blockIdx.x + n * gridDim.x, tiles_w, tiles_h);
    // ---- t = relu(x . w1 + b1) on the halo: halo rows 64 (warp / 4) ..
    // + 63 as a warpgroup's m64n64k16 products (A from registers, w1 by
    // descriptor); the rows from 128 (up to the halo's 180; this warp's 16
    // of them, channels 32 (warp / 4) ..) by mma.sync while those run
    const int tg = warp >> 2, tq = warp & 3;
    float tw[32], tm[1][4][4];
    zero(tm);
    const int m_rows[1] = {min(128 + 16 * tq + a_r, kHalo - 1)};
    // the identity residual of this lane's outputs in the out phase's four
    // blocks of 64 channels, taken from the halo chunks as they pass
    uint32_t res[2][2][2][8];  // [block of 128][of 64][hf][j]
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int g = n * kChunks + c;
      cp_async_wait(issued - g - 1);
      // the weights reach wgmma through the async proxy
      if (g == 0)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();  // chunk g landed; every warp is done with g - 1
      issue_upto(g + kSlots);
      const int slot = L::kX + (g % kSlots) * L::kSlot;
      const uint32_t xs = sbase + slot;
      uint32_t aw[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldsm_x4(xs + swz(64 * tg + 16 * tq + a_r, 2 * kk + a_c), aw[kk]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma64(tw, aw[kk],
                desc_b(sbase + L::kW1 + (c * 64 + kk * 16) * kRow),
                c + kk);
      wg_commit();
      if (!L::kProj)  // channels of the out phase's block c
        take_residual(res[c >> 1][c & 1], smem + slot, orow, g8, t4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_step(tm, xs, m_rows, 2 * kk + a_c, sbase + L::kW1,
                 c * 64 + kk * 16 + b_r, 4 * tg + b_c);
      wg_wait<0>();
    }
    wg_hold(tw);
    // t's epilogue: rows of the halo inside the image, zeros outside
    auto store_t = [&](int hp, int ch, float a, float b) {
      const int h = tl.h0 - 1 + hp / kHC, w = tl.w0 - 1 + hp % kHC;
      const bool in = h >= 0 && h < p.H && w >= 0 && w < p.W;
      const float2 bb = __ldg(reinterpret_cast<const float2*>(p.b1 + ch));
      store_bf16x2(smem, L::kT + swz(hp, ch >> 3) + (ch & 7) * 2,
                   in ? fmaxf(a + bb.x, 0.f) : 0.f,
                   in ? fmaxf(b + bb.y, 0.f) : 0.f);
    };
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int hp = 64 * tg + 16 * tq + g8 + 8 * hf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        store_t(hp, 8 * j + 2 * t4, tw[4 * j + 2 * hf],
                tw[4 * j + 2 * hf + 1]);
      const int hq = 128 + 16 * tq + g8 + 8 * hf;
      if (hq < kHalo) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          store_t(hq, 32 * tg + 8 * j + 2 * t4, tm[0][j][2 * hf],
                  tm[0][j][2 * hf + 1]);
      }
    }
    __syncthreads();

    // ---- u = relu(conv3x3(t) + b2): a warpgroup's m64n64k16 products, B
    // (w2) by descriptor, A (shifted halo rows of t) loaded for the next
    // step while the current one runs
    float au[32];
    {
      auto a_addr = [&](int tap, int kk) {
        const int dy = tap / 3, dx = tap - 3 * dy;
        return sbase + L::kT +
               swz((orow + dy) * kHC + dx + a_r, 2 * kk + a_c);
      };
      // the A fragments of a tap's 4 k steps, loaded while the previous
      // tap's products run
      uint32_t af[2][4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) ldsm_x4(a_addr(0, kk), af[0][kk]);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma64(au, af[tap & 1][kk],
                  desc_b(sbase + L::kW2 + (4 * tap + kk) * 16 * kRow),
                  tap + kk);
        wg_commit();
        // at Cin = 256 this tile's chunks are all consumed (the residual is
        // in registers): the next tile's load under u and out, issued
        // while the first tap's products run
        if (tap == 0 && !L::kProj) issue_upto((n + 1) * kChunks + kSlots);
        if (tap + 1 < 9) {
          wg_wait<1>();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            ldsm_x4(a_addr(tap + 1, kk), af[(tap + 1) & 1][kk]);
        }
      }
      wg_wait<0>();
      wg_hold(au);
    }
    __syncthreads();  // every warp has read t: u goes over it
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int pos = orow * kTW + g8 + 8 * hf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ch = 8 * j + 2 * t4;
        const float2 bb = __ldg(reinterpret_cast<const float2*>(p.b2 + ch));
        store_bf16x2(smem, L::kT + swz(pos, ch >> 3) + (ch & 7) * 2,
                     fmaxf(au[4 * j + 2 * hf] + bb.x, 0.f),
                     fmaxf(au[4 * j + 2 * hf + 1] + bb.y, 0.f));
      }
    }
    __syncthreads();

    // ---- out = relu(u . w3 (+ x . wd) + b + idn): two passes of 128
    // channels, two m64n64k16 products per k step (w3, then wd, by
    // descriptor; A from u, then from x's halo, loaded once for both)
    constexpr int kSteps = L::kProj ? 8 : 4;
    uint32_t ua[kSteps][4];
    {
      const uint32_t xs = sbase + L::kX + (n * kChunks % kSlots) * L::kSlot;
#pragma unroll
      for (int k = 0; k < kSteps; ++k)
        ldsm_x4(k < 4 ? sbase + L::kT + swz(orow * kTW + a_r, 2 * k + a_c)
                      : xs + swz((orow + 1) * kHC + 1 + a_r, 2 * (k - 4) + a_c),
                ua[k]);
    }
    __syncthreads();  // every warp holds its u: t/u's rows stage the output
    const uint32_t stage = sbase + L::kT + warp * kTW * kRow;
    const int h = tl.h0 + orow;
    // block nb of 64 output channels into acc[nb % 2]; the next block's
    // products run while this one's epilogue does
    float ao[2][32];
    auto issue_out = [&](int nb) {
      wg_fence();
#pragma unroll
      for (int k = 0; k < kSteps; ++k)
        wgmma64(ao[nb & 1], ua[k],
                desc_b(sbase + (k < 4 ? L::kW3 : L::kWd) +
                       (nb * 64 + (k & 3) * 16) * kRow),
                k);
      wg_commit();
    };
    issue_out(0);
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      if (nb + 1 < 4) {
        issue_out(nb + 1);
        wg_wait<1>();
      } else {
        wg_wait<0>();
      }
      float(&acc)[32] = ao[nb & 1];
      wg_hold(acc);
      // bias, residual, ReLU and the rounding in the accumulators' layout,
      // then through this warp's 16 staging rows (its positions x 64
      // channels), two n8 blocks at a time
      const int m = lane >> 3;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t y[2][2];  // [n8 block 2 q + jj][hf]
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * q + jj;
          const float2 bb = *reinterpret_cast<const float2*>(
              bos + nb * 64 + 8 * j + 2 * t4);
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            float2 r = make_float2(0.f, 0.f);
            if (!L::kProj) {
              const uint32_t rw = res[nb >> 1][nb & 1][hf][j];
              r = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(&rw));
            }
            const __nv_bfloat162 v = __floats2bfloat162_rn(
                fmaxf(acc[4 * j + 2 * hf] + bb.x + r.x, 0.f),
                fmaxf(acc[4 * j + 2 * hf + 1] + bb.y + r.y, 0.f));
            y[jj][hf] = *reinterpret_cast<const uint32_t*>(&v);
          }
        }
        stsm_x4(stage + swz((m & 1) * 8 + (lane & 7), 2 * q + (m >> 1)),
                y[0][0], y[0][1], y[1][0], y[1][1]);
      }
      __syncwarp();
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        const int row = it * 4 + (lane >> 3), chunk = lane & 7;
        const int w = tl.w0 + row;
        uint4 val;
        asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(val.x), "=r"(val.y), "=r"(val.z), "=r"(val.w)
                     : "r"(stage + swz(row, chunk))
                     : "memory");
        if (h < p.H && w < p.W)
          *reinterpret_cast<uint4*>(
              p.out + (((long long)tl.b * p.H + h) * p.W + w) * kCout +
              nb * 64 + chunk * 8) = val;
      }
      __syncwarp();
    }
  }
  cp_async_wait_all();
}

// Launches of the layer1 path since the library was loaded.
std::atomic<long long> launches{0};

template <int kCin>
int launch(const Params& p, int B, cudaStream_t stream) {
  const long long tw = (p.W + kTW - 1) / kTW, th = (p.H + kTH - 1) / kTH;
  const long long tiles = (long long)B * tw * th;
  if (tiles > 0x7fffffffLL) return -4;
  if (tiles == 0) return (int)cudaGetLastError();
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fused_bottleneck_layer1_kernel<kCin>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Layout<kCin>::kBytes);
  if (e != cudaSuccess) return (int)e;
  const int grid = (int)(tiles < sms ? tiles : sms);
  fused_bottleneck_layer1_kernel<kCin>
      <<<grid, kWarps * 32, Layout<kCin>::kBytes, stream>>>(
          p, (int)tw, (int)th, (int)tiles);
  ++launches;
  return (int)cudaGetLastError();
}

}  // namespace l1

// ----------------------------------------------------------- generic path
namespace generic {

constexpr int kPad = 16;  // bf16 past each shared row: 32-byte alignment

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
    FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

size_t smem_bytes(int Cin, int Cm) {
  return 2 * ((size_t)kHaloPad * (Cin + kPad) + (size_t)kHaloPad * (Cm + kPad)
              + (size_t)kTH * kTW * (Cm + kPad))
         + (size_t)kWarps * 2 * 256 * sizeof(float);
}

// acc[i] += A_i . B over K, A_i = a + i * a_step (row-major, lda), B
// row-major (ldb); each B tile is loaded once for the MT products.
template <int MT>
__device__ __forceinline__ void mma_tiles(FragC (&acc)[MT], const bf16* a,
                                          int lda, int a_step, const bf16* b,
                                          int ldb, int K) {
  for (int k = 0; k < K; k += 16) {
    FragB fb;
    wmma::load_matrix_sync(fb, b + (long long)k * ldb, ldb);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      FragA fa;
      wmma::load_matrix_sync(fa, a + i * a_step + k, lda);
      wmma::mma_sync(acc[i], fa, fb, acc[i]);
    }
  }
}

template <int MT>
__device__ __forceinline__ void zero(FragC (&acc)[MT]) {
#pragma unroll
  for (int i = 0; i < MT; ++i) wmma::fill_fragment(acc[i], 0.f);
}

__global__ void __launch_bounds__(kWarps * 32, 1)
    fused_bottleneck_generic_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldx = p.Cin + kPad, ldt = p.Cm + kPad;
  bf16* xs = reinterpret_cast<bf16*>(smem);      // (kHaloPad, ldx) halo x
  bf16* ts = xs + kHaloPad * ldx;                // (kHaloPad, ldt) t
  bf16* us = ts + kHaloPad * ldt;                // (kTH * kTW, ldt) u
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* sc = reinterpret_cast<float*>(us + kTH * kTW * ldt) + warp * 512;
  const int b = blockIdx.z, h0 = blockIdx.y * kTH, w0 = blockIdx.x * kTW;
  const bf16* xb = p.x + (long long)b * p.H * p.W * p.Cin;

  // x's halo tile, zeros outside the image and past the 180 positions
  const int vecs = p.Cin / 8;
  for (int i = threadIdx.x; i < kHaloPad * vecs; i += blockDim.x) {
    const int hp = i / vecs, v = i - hp * vecs;
    const int h = h0 - 1 + hp / kHC, w = w0 - 1 + hp % kHC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (hp < kHalo && h >= 0 && h < p.H && w >= 0 && w < p.W)
      val = *reinterpret_cast<const uint4*>(
          xb + ((long long)h * p.W + w) * p.Cin + v * 8);
    *reinterpret_cast<uint4*>(xs + hp * ldx + v * 8) = val;
  }
  __syncthreads();

  // t on the halo: 12 m-tiles in 2 groups of 6, per n-tile of Cm
  const int ntm = p.Cm / 16;
  for (int job = warp; job < 2 * ntm; job += kWarps) {
    const int nt = job % ntm, m0 = (job / ntm) * 6;
    FragC acc[6];
    zero(acc);
    mma_tiles(acc, xs + m0 * 16 * ldx, ldx, 16 * ldx, p.w1 + nt * 16, p.Cm,
              p.Cin);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      wmma::store_matrix_sync(sc, acc[i], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int hp = (m0 + i) * 16 + (e >> 4), n = nt * 16 + (e & 15);
        const int h = h0 - 1 + hp / kHC, w = w0 - 1 + hp % kHC;
        const bool inside =
            hp < kHalo && h >= 0 && h < p.H && w >= 0 && w < p.W;
        const float v = fmaxf(sc[e] + p.b1[n], 0.f);
        ts[hp * ldt + n] = __float2bfloat16_rn(inside ? v : 0.f);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // u: 8 output rows in 2 groups of 4, 9 tap products each
  for (int job = warp; job < 2 * ntm; job += kWarps) {
    const int nt = job % ntm, r0 = (job / ntm) * 4;
    FragC acc[4];
    zero(acc);
    for (int dy = 0; dy < 3; ++dy)
      for (int dx = 0; dx < 3; ++dx)
        mma_tiles(acc, ts + ((r0 + dy) * kHC + dx) * ldt, ldt, kHC * ldt,
                  p.w2 + (long long)(dy * 3 + dx) * p.Cm * p.Cm + nt * 16,
                  p.Cm, p.Cm);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      wmma::store_matrix_sync(sc, acc[i], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int n = nt * 16 + (e & 15);
        us[((r0 + i) * kTW + (e >> 4)) * ldt + n] =
            __float2bfloat16_rn(fmaxf(sc[e] + p.b2[n], 0.f));
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // out: 8 output rows in 2 groups of 4, per n-tile of Cout
  const int nto = p.Cout / 16;
  float* sd = sc + 256;
  const bf16* xc = xs + (kHC + 1) * ldx;  // x at output position (0, 0)
  for (int job = warp; job < 2 * nto; job += kWarps) {
    const int nt = job % nto, r0 = (job / nto) * 4;
    FragC acc[4], idn[4];
    zero(acc);
    mma_tiles(acc, us + r0 * kTW * ldt, ldt, kTW * ldt, p.w3 + nt * 16,
              p.Cout, p.Cm);
    if (p.wd != nullptr) {
      zero(idn);
      mma_tiles(idn, xc + r0 * kHC * ldx, ldx, kHC * ldx, p.wd + nt * 16,
                p.Cout, p.Cin);
    }
    // each lane: position lane / 2, 8 channels from (lane % 2) * 8
    const int pos = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      wmma::store_matrix_sync(sc, acc[i], 16, wmma::mem_row_major);
      if (p.wd != nullptr)
        wmma::store_matrix_sync(sd, idn[i], 16, wmma::mem_row_major);
      __syncwarp();
      const int r = r0 + i, h = h0 + r, w = w0 + pos;
      if (h < p.H && w < p.W) {
        float o[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = nt * 16 + c0 + j;
          const float y = sc[pos * 16 + c0 + j] + p.b3[n];
          const float id =
              p.wd != nullptr
                  ? sd[pos * 16 + c0 + j] + p.bd[n]
                  : __bfloat162float(xc[(r * kHC + pos) * ldx + n]);
          o[j] = fmaxf(y + id, 0.f);
        }
        uint4 packed;
        __nv_bfloat162* hv = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          hv[j] = __floats2bfloat162_rn(o[2 * j], o[2 * j + 1]);
        *reinterpret_cast<uint4*>(
            p.out + (((long long)b * p.H + h) * p.W + w) * p.Cout + nt * 16 +
            c0) = packed;
      }
      __syncwarp();
    }
  }
}

// Launches of the generic path since the library was loaded.
std::atomic<long long> launches{0};

int launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.Cin, p.Cm);
  if (smem > (size_t)kMaxSmem) return -5;
  const dim3 grid((p.W + kTW - 1) / kTW, (p.H + kTH - 1) / kTH, B);
  if (grid.y > 65535u || grid.z > 65535u) return -4;
  if (B == 0) return (int)cudaGetLastError();
  const cudaError_t e = cudaFuncSetAttribute(
      fused_bottleneck_generic_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  fused_bottleneck_generic_kernel<<<grid, kWarps * 32, smem, stream>>>(p);
  ++launches;
  return (int)cudaGetLastError();
}

}  // namespace generic

bool aligned(const void* ptr, uintptr_t n) {
  return reinterpret_cast<uintptr_t>(ptr) % n == 0;
}

}  // namespace

// One bottleneck block. x (B, H, W, Cin) and out (B, H, W, Cout) bf16,
// NHWC, contiguous; w1 (Cin, Cm), w2 (3, 3, Cm, Cm), w3 (Cm, Cout) and wd
// (Cin, Cout) bf16, row-major (matmul layouts); b1, b2 (Cm) and b3, bd
// (Cout) f32. wd and bd are both null for an identity block (Cin == Cout).
// Layer1's widths (Cm = 64, Cout = 256; Cin = 64 with wd or 256 without)
// with every pointer 16-byte aligned take the layer1 path, anything else
// the generic path. Returns 0 on success, a cudaError_t code (> 0) if the
// launch failed, or a negative code for arguments the kernel does not
// take: -1 a dimension out of range (channels must be multiples of 16), -4
// grid too large, -5 shared memory too large, -6 a misaligned pointer (x
// and out 16 bytes; on the generic path the weights 32 bytes).
extern "C" int fused_bottleneck_block(const void* x, void* out,
                                      const void* w1, const void* b1,
                                      const void* w2, const void* b2,
                                      const void* w3, const void* b3,
                                      const void* wd, const void* bd, int B,
                                      int H, int W, int Cin, int Cm, int Cout,
                                      void* stream) {
  if (B < 0 || H < 1 || W < 1 || Cin < 16 || Cm < 16 || Cout < 16 ||
      Cin % 16 || Cm % 16 || Cout % 16)
    return -1;
  if ((wd == nullptr) != (bd == nullptr) || (wd == nullptr && Cin != Cout))
    return -1;
  if (!aligned(x, 16) || !aligned(out, 16)) return -6;
  Params p{static_cast<const bf16*>(x), static_cast<bf16*>(out),
           static_cast<const bf16*>(w1), static_cast<const bf16*>(w2),
           static_cast<const bf16*>(w3), static_cast<const bf16*>(wd),
           static_cast<const float*>(b1), static_cast<const float*>(b2),
           static_cast<const float*>(b3), static_cast<const float*>(bd),
           H, W, Cin, Cm, Cout};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool fast_aligned = aligned(w1, 16) && aligned(w2, 16) &&
                         aligned(w3, 16) && (!wd || aligned(wd, 16)) &&
                         aligned(b1, 8) && aligned(b2, 8);
  if (Cm == l1::kCm && Cout == l1::kCout && fast_aligned) {
    if (Cin == 64 && wd != nullptr) return l1::launch<64>(p, B, s);
    if (Cin == 256 && wd == nullptr) return l1::launch<256>(p, B, s);
  }
  if (!aligned(w1, 32) || !aligned(w2, 32) || !aligned(w3, 32) ||
      (wd && !aligned(wd, 32)))
    return -6;
  return generic::launch(p, B, s);
}

extern "C" const char* fused_bottleneck_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory per CTA of the path that takes layer1's widths
// (Cm = 64, Cout = 256; Cin = 64 or 256) or, for any other widths, of the
// generic path; -1 for widths no path takes.
extern "C" long long fused_bottleneck_smem_bytes(int Cin, int Cm, int Cout) {
  if (Cm == l1::kCm && Cout == l1::kCout && Cin == 64)
    return l1::Layout<64>::kBytes;
  if (Cm == l1::kCm && Cout == l1::kCout && Cin == 256)
    return l1::Layout<256>::kBytes;
  const size_t smem = generic::smem_bytes(Cin, Cm);
  return Cin < 16 || Cm < 16 || smem > (size_t)kMaxSmem ? -1
                                                         : (long long)smem;
}

// Launches of each path since the library was loaded.
extern "C" long long fused_bottleneck_layer1_launches() {
  return l1::launches;
}
extern "C" long long fused_bottleneck_generic_launches() {
  return generic::launches;
}
