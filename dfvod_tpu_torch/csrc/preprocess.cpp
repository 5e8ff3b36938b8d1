// Host-side resize and RGB-D interleave of the port's data path (plain C
// interface, loaded with ctypes by dfvod_tpu_torch/data/native.py).
//
// The port's own copy of resize_bilinear_u8 and pack_rgbd_u8 of
// native/preprocess.cpp:47-105 (the JAX package's native library).
// Bilinear convention: half-pixel centres (align_corners=False), no
// antialiasing, coefficients in float, rounded by +0.5 and truncation.
//
// The resize computes in float, so the compiler's flags decide its bits.
// The JAX package builds with -march=native, under which GCC contracts
// w00*a + w01*b + ... into fused multiply-adds; this copy is built with
// -ffp-contract=off and no machine-specific target
// (dfvod_tpu_torch/ops/build.py HOST_FLAGS), so it rounds after every
// product and sum and gives the same bits on every machine. The two differ
// by one level on about 0.015% of the values of the repository's frames.
// The rows run in one thread: the loader's threads run frames in parallel.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

inline void bilinear_coeffs(int out_i, float scale, int src_size, int* i0,
                            int* i1, float* w1) {
  float src = (out_i + 0.5f) * scale - 0.5f;
  float floor_src = std::floor(src);
  *w1 = src - floor_src;
  int lo = static_cast<int>(floor_src);
  *i0 = std::min(std::max(lo, 0), src_size - 1);
  *i1 = std::min(std::max(lo + 1, 0), src_size - 1);
}

}  // namespace

extern "C" {

// Bilinear resize, uint8 (sh, sw, c) -> uint8 (dh, dw, c).
void resize_bilinear_u8(const uint8_t* src, int sh, int sw, int c,
                        uint8_t* dst, int dh, int dw) {
  const float sy = static_cast<float>(sh) / dh;
  const float sx = static_cast<float>(sw) / dw;
  std::vector<int> xi0(dw), xi1(dw);
  std::vector<float> xf(dw);
  for (int x = 0; x < dw; ++x) {
    bilinear_coeffs(x, sx, sw, &xi0[x], &xi1[x], &xf[x]);
    xi0[x] *= c;
    xi1[x] *= c;
  }
  for (int y = 0; y < dh; ++y) {
    int y0, y1;
    float fy;
    bilinear_coeffs(y, sy, sh, &y0, &y1, &fy);
    const uint8_t* r0 = src + static_cast<int64_t>(y0) * sw * c;
    const uint8_t* r1 = src + static_cast<int64_t>(y1) * sw * c;
    uint8_t* out_row = dst + static_cast<int64_t>(y) * dw * c;
    const float gy = 1.0f - fy;
    for (int x = 0; x < dw; ++x) {
      const int a = xi0[x], b = xi1[x];
      const float fx = xf[x];
      const float w00 = gy * (1 - fx), w01 = gy * fx;
      const float w10 = fy * (1 - fx), w11 = fy * fx;
      for (int k = 0; k < c; ++k) {
        float v = w00 * r0[a + k] + w01 * r0[b + k] + w10 * r1[a + k] +
                  w11 * r1[b + k];
        out_row[x * c + k] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

// Interleave (h, w, 3) RGB + (h, w) depth into the top-left of a uint8
// canvas of 4 channels whose rows are out_row_stride bytes apart.
void pack_rgbd_u8(const uint8_t* rgb, const uint8_t* depth, int h, int w,
                  uint8_t* out, int64_t out_row_stride) {
  for (int y = 0; y < h; ++y) {
    const uint8_t* r = rgb + static_cast<int64_t>(y) * w * 3;
    const uint8_t* d = depth + static_cast<int64_t>(y) * w;
    uint8_t* o = out + y * out_row_stride;
    for (int x = 0; x < w; ++x) {
      o[4 * x + 0] = r[3 * x + 0];
      o[4 * x + 1] = r[3 * x + 1];
      o[4 * x + 2] = r[3 * x + 2];
      o[4 * x + 3] = d[x];
    }
  }
}

}  // extern "C"
