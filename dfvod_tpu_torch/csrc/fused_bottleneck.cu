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
// 0.195 ms at 3.35 TB/s. So this design is bound by bytes (0.195 ms); a
// single launch for the whole stage would move 155.6 MB (0.046 ms) and be
// bound by operations.
//
// The design:
// - One CTA of 8 warps per output tile of 8 rows x 16 columns (128
//   positions). It loads the (8 + 2) x (16 + 2) halo tile of x once into
//   shared memory (16-byte loads, zeros outside the image), computes t on
//   all 180 halo positions (the 3x3 needs them), u on the 128 positions,
//   then the output, and writes it with 16-byte stores. t and u never
//   leave shared memory. H and W need not be multiples of the tile.
// - Every product is a WMMA bf16 m16n16k16 tile product on the tensor
//   cores (mma.sync) with an f32 accumulator, written here; no library
//   GEMM. A 16-position m-tile is a run of 16 halo or output positions, so
//   the 3x3 is 9 tap products whose A tiles are shifted views of t in
//   shared memory: no im2col.
// - The weights (139-147 KB a block) are read through L1/L2 as WMMA B
//   tiles; each warp keeps 4-6 accumulators of one n-tile and loads each B
//   tile once for all of them.
// - Shared-memory rows are padded by 16 bf16 so every WMMA tile pointer is
//   32-byte aligned: 168 KB at 256 input channels (dynamic shared memory,
//   above the 48 KB default), one CTA per SM.
// Later work: the whole stage in one launch (155.6 MB), wgmma with TMA-fed
// weights in shared memory, and a persistent grid.
//
// Plain C interface, loaded with ctypes; see
// dfvod_tpu_torch/ops/fused_bottleneck.py.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int kTH = 8, kTW = 16;                 // output tile
constexpr int kHC = kTW + 2;                     // halo columns
constexpr int kHalo = (kTH + 2) * kHC;           // 180 halo positions
constexpr int kHaloPad = (kHalo + 15) / 16 * 16; // 192: whole m-tiles
constexpr int kWarps = 8;
constexpr int kPad = 16;  // bf16 past each shared row: 32-byte alignment
constexpr int kMaxSmem = 232448;

typedef __nv_bfloat16 bf16;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
    FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

struct Params {
  const bf16* x;
  bf16* out;
  const bf16 *w1, *w2, *w3, *wd;
  const float *b1, *b2, *b3, *bd;
  int H, W, Cin, Cm, Cout;
};

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
    fused_bottleneck_kernel(Params p) {
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

bool aligned(const void* ptr, uintptr_t n) {
  return reinterpret_cast<uintptr_t>(ptr) % n == 0;
}

}  // namespace

// One bottleneck block. x (B, H, W, Cin) and out (B, H, W, Cout) bf16,
// NHWC, contiguous; w1 (Cin, Cm), w2 (3, 3, Cm, Cm), w3 (Cm, Cout) and wd
// (Cin, Cout) bf16, row-major (matmul layouts); b1, b2 (Cm) and b3, bd
// (Cout) f32. wd and bd are both null for an identity block (Cin == Cout).
// Returns 0 on success, a cudaError_t code (> 0) if the launch failed, or a
// negative code for arguments the kernel does not take: -1 a dimension out
// of range (channels must be multiples of 16), -4 grid too large, -5 shared
// memory too large, -6 a misaligned pointer (x and out 16 bytes, weights
// 32 bytes).
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
  const size_t smem = smem_bytes(Cin, Cm);
  if (smem > (size_t)kMaxSmem) return -5;
  if (!aligned(x, 16) || !aligned(out, 16) || !aligned(w1, 32) ||
      !aligned(w2, 32) || !aligned(w3, 32) || (wd && !aligned(wd, 32)))
    return -6;
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
  if (grid.y > 65535u || grid.z > 65535u) return -4;
  if (B == 0) return (int)cudaGetLastError();
  const cudaError_t e = cudaFuncSetAttribute(
      fused_bottleneck_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  Params p{static_cast<const bf16*>(x), static_cast<bf16*>(out),
           static_cast<const bf16*>(w1), static_cast<const bf16*>(w2),
           static_cast<const bf16*>(w3), static_cast<const bf16*>(wd),
           static_cast<const float*>(b1), static_cast<const float*>(b2),
           static_cast<const float*>(b3), static_cast<const float*>(bd),
           H, W, Cin, Cm, Cout};
  fused_bottleneck_kernel<<<grid, kWarps * 32, smem,
                            static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* fused_bottleneck_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
