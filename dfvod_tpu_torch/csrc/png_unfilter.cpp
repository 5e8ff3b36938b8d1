// PNG row unfiltering for the port's PNG reader (plain C interface, loaded
// with ctypes by dfvod_tpu_torch/data/image_io.py).
//
// The reader inflates the IDAT stream with Python's zlib and passes the
// result here: h rows, each a filter-type byte and `row_bytes` filtered
// bytes (PNG 1.2 section 6 and 9: None, Sub, Up, Average, Paeth; `bpp` is
// the bytes of one pixel, at least 1, as for 1/2/4-bit samples). The rows
// are rebuilt in place of the output, `h * row_bytes` bytes of raw
// samples. An Adam7-interlaced image comes here one pass at a time, each
// pass a reduced image of its own rows.

#include <cstdint>
#include <cstdlib>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

}  // namespace

extern "C" {

// 0 on success; 1 if `n` is not h * (1 + row_bytes); 2 + row if a row
// names a filter type other than 0-4.
int64_t png_unfilter(const uint8_t* data, int64_t n, int h, int64_t row_bytes,
                     int bpp, uint8_t* out) {
  if (n != static_cast<int64_t>(h) * (1 + row_bytes)) return 1;
  for (int y = 0; y < h; ++y) {
    const uint8_t* src = data + static_cast<int64_t>(y) * (1 + row_bytes);
    const uint8_t filter = src[0];
    ++src;
    uint8_t* cur = out + static_cast<int64_t>(y) * row_bytes;
    const uint8_t* up = y ? cur - row_bytes : nullptr;
    switch (filter) {
      case 0:
        for (int64_t i = 0; i < row_bytes; ++i) cur[i] = src[i];
        break;
      case 1:
        for (int64_t i = 0; i < row_bytes; ++i)
          cur[i] = static_cast<uint8_t>(src[i] +
                                        (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < row_bytes; ++i)
          cur[i] = static_cast<uint8_t>(src[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < row_bytes; ++i) {
          int a = i >= bpp ? cur[i - bpp] : 0;
          int b = up ? up[i] : 0;
          cur[i] = static_cast<uint8_t>(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < row_bytes; ++i) {
          int a = i >= bpp ? cur[i - bpp] : 0;
          int b = up ? up[i] : 0;
          int c = (up && i >= bpp) ? up[i - bpp] : 0;
          cur[i] = static_cast<uint8_t>(src[i] + paeth(a, b, c));
        }
        break;
      default:
        return 2 + y;
    }
  }
  return 0;
}

}  // extern "C"
