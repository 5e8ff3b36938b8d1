// HSV conversions of the photometric augmentation (plain C interface,
// loaded with ctypes by dfvod_tpu_torch/data/photometric.py).
//
// The JAX package converts with OpenCV, cv2.COLOR_RGB2HSV_FULL and
// cv2.COLOR_HSV2RGB_FULL on uint8, hue over 0..255; the card machine has no
// OpenCV, so these are its own integer versions, bitwise OpenCV's over all
// 2^24 inputs (tests/test_torch_photometric.py):
//
// - RGB -> HSV: OpenCV's fixed-point algorithm, 12-bit reciprocal tables of
//   the saturation (255 << 12) / v and the hue (256 << 12) / (6 diff),
//   rounded half to even as cvRound rounds.
// - HSV -> RGB: the exact value of OpenCV's formula with the hue scaled by
//   6/255, in integers, rounded half up. OpenCV computes it in float32,
//   which lands on the other side of a half at a few inputs whose exact
//   value lies within 1.2e-4 of one: the caller passes those inputs and
//   OpenCV's results (`tie_keys`, sorted, and `tie_values`), and they are
//   looked up wherever the exact value is that close to a half.

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kShift = 12;

struct Tables {
  int32_t sdiv[256];
  int32_t hdiv[256];
  Tables() {
    sdiv[0] = hdiv[0] = 0;
    for (int i = 1; i < 256; ++i) {
      sdiv[i] = static_cast<int32_t>(
          std::nearbyint(static_cast<double>(255 << kShift) / i));
      hdiv[i] = static_cast<int32_t>(
          std::nearbyint(static_cast<double>(256 << kShift) / (6.0 * i)));
    }
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

// (b, g, r) of each hue sector as indices into
// (v, v(1 - s), v(1 - s f), v(1 - s(1 - f)))
constexpr int kSectors[6][3] = {{1, 3, 0}, {1, 0, 2}, {3, 0, 1},
                                {0, 2, 1}, {0, 1, 3}, {2, 1, 0}};

}  // namespace

extern "C" {

// n pixels of uint8 RGB -> uint8 HSV (hue 0..255).
void rgb_to_hsv_u8(const uint8_t* src, int64_t n, uint8_t* dst) {
  const Tables& t = tables();
  constexpr int half = 1 << (kShift - 1);
  for (int64_t i = 0; i < n; ++i) {
    const int r = src[3 * i], g = src[3 * i + 1], b = src[3 * i + 2];
    const int v = std::max(std::max(r, g), b);
    const int diff = v - std::min(std::min(r, g), b);
    const int s = (diff * t.sdiv[v] + half) >> kShift;
    int h = v == r ? g - b : v == g ? b - r + 2 * diff : r - g + 4 * diff;
    h = (h * t.hdiv[diff] + half) >> kShift;
    if (h < 0) h += 256;
    dst[3 * i] = static_cast<uint8_t>(h);
    dst[3 * i + 1] = static_cast<uint8_t>(s);
    dst[3 * i + 2] = static_cast<uint8_t>(v);
  }
}

// n pixels of uint8 HSV (hue 0..255) -> uint8 RGB.
void hsv_to_rgb_u8(const uint8_t* src, int64_t n, const int32_t* tie_keys,
                   const int32_t* tie_values, int n_ties, uint8_t* dst) {
  constexpr int32_t d = 255 * 255;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t h = src[3 * i], s = src[3 * i + 1], v = src[3 * i + 2];
    const int32_t k = (6 * h) / 255, f = 6 * h - 255 * k;
    const int32_t tab[4] = {v * d, v * (255 - s) * 255, v * (d - s * f),
                            v * (d - s * (255 - f))};
    bool near_half = false;
    for (int c = 0; c < 3; ++c) {
      const int32_t num = tab[kSectors[k % 6][2 - c]];
      // round half up: floor((2 num + d) / 2d)
      dst[3 * i + c] = static_cast<uint8_t>((2 * num + d) / (2 * d));
      // within 15/(2 d) of a half
      const int32_t off = (2 * num) % (2 * d) - d;
      near_half |= off >= -15 && off <= 15;
    }
    if (near_half) {
      const int32_t key = (h << 16) | (s << 8) | v;
      const int32_t* hit = std::lower_bound(tie_keys, tie_keys + n_ties, key);
      if (hit != tie_keys + n_ties && *hit == key) {
        const int32_t val = tie_values[hit - tie_keys];
        dst[3 * i] = static_cast<uint8_t>(val >> 16);
        dst[3 * i + 1] = static_cast<uint8_t>((val >> 8) & 255);
        dst[3 * i + 2] = static_cast<uint8_t>(val & 255);
      }
    }
  }
}

}  // extern "C"
