// Baseline JPEG decoder for the port's data path (host C++, plain C
// interface, loaded with ctypes by dfvod_tpu_torch/data/image_io.py).
//
// Counterpart of what the JAX package's dataset calls to read frames:
// PIL.Image.open(...).convert("RGB") (dfvod_tpu/data/dataset.py:162-174) and
// cv2.imread(..., IMREAD_UNCHANGED) (:29), both libjpeg-turbo underneath. It
// decodes the files the repository's datasets hold, bit for bit as
// libjpeg-turbo does, by following its routines:
//   - Huffman decoding as jdhuff.c (canonical tables, 8-bit lookahead,
//     DC prediction kept in an int and stored as a 16-bit coefficient);
//   - the integer "islow" inverse DCT of jidctint.c (13-bit constants, two
//     passes, the post-IDCT range-limit table of jdmaster.c);
//   - fancy upsampling of jdsample.c (h2v1_fancy_upsample and
//     h2v2_fancy_upsample with their rounding biases; plain replication
//     when the subsampled width is 2 or less, as jinit_upsampler chooses);
//   - the fixed-point YCbCr->RGB tables of jdcolor.c (16 fraction bits).
//
// Scope: 8-bit baseline (SOF0) or extended sequential (SOF1) Huffman
// files with 1 or 3 components, sampling ratios 1x1, 2x1 and 2x2 between
// luma and chroma, restart intervals, one interleaved scan or one scan per
// component. Progressive, arithmetic-coded, 12-bit, lossless, hierarchical,
// 4-component (CMYK) and truncated files are refused with an error code;
// jpeg_strerror names it.
//
// Every call keeps its state on its own stack and heap: the functions are
// reentrant, and ctypes releases the GIL around them, so loader threads
// decode in parallel.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum Err {
  OK = 0,
  E_NOT_JPEG,
  E_PROGRESSIVE,
  E_ARITHMETIC,
  E_LOSSLESS,
  E_HIERARCHICAL,
  E_PRECISION,
  E_COMPONENTS,
  E_SAMPLING,
  E_TRUNCATED,
  E_CORRUPT,
  E_NO_FRAME,
  E_OUTPUT,
  E_DNL,
};

const char* const kMessages[] = {
    "ok",
    "not a JPEG file (no SOI marker)",
    "progressive JPEG is not supported (baseline sequential only)",
    "arithmetic-coded JPEG is not supported (Huffman only)",
    "lossless JPEG is not supported",
    "hierarchical (differential) JPEG is not supported",
    "only 8-bit JPEG is supported (12- and 16-bit samples are not)",
    "only 1- or 3-component JPEG is supported (CMYK / 4-component is not)",
    "unsupported sampling factors (luma:chroma must be 1x1, 2x1 or 2x2)",
    "truncated JPEG file (entropy-coded data ends early)",
    "corrupt JPEG data",
    "no frame header (SOF) before the scan",
    "output buffer does not match the image",
    "DNL marker (height defined after the scan) is not supported",
};

// jpeg_natural_order with libjpeg's 16 guard entries for a corrupt run
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huff {
  bool defined = false;
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t huffval[256];
  uint8_t look_nbits[256];
  uint8_t look_sym[256];
};

// jdhuff.c jpeg_make_d_derived_tbl
Err build_huff(const uint8_t bits[17], const uint8_t* vals, int nvals,
               bool is_dc, Huff* h) {
  char huffsize[257];
  uint32_t huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < bits[l]; ++i) huffsize[p++] = static_cast<char>(l);
  huffsize[p] = 0;
  const int numsymbols = p;
  if (numsymbols != nvals || numsymbols > 256) return E_CORRUPT;
  uint32_t code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (1u << si)) return E_CORRUPT;
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (bits[l]) {
      h->valoffset[l] = p - static_cast<int32_t>(huffcode[p]);
      p += bits[l];
      h->maxcode[l] = static_cast<int32_t>(huffcode[p - 1]);
    } else {
      h->maxcode[l] = -1;
    }
  }
  h->valoffset[17] = 0;
  h->maxcode[17] = 0xFFFFF;
  std::memset(h->look_nbits, 0, sizeof(h->look_nbits));
  p = 0;
  for (int l = 1; l <= 8; ++l) {
    for (int i = 1; i <= bits[l]; ++i, ++p) {
      int look = static_cast<int>(huffcode[p] << (8 - l));
      for (int c = 1 << (8 - l); c > 0; --c, ++look) {
        h->look_nbits[look] = static_cast<uint8_t>(l);
        h->look_sym[look] = vals[p];
      }
    }
  }
  std::memcpy(h->huffval, vals, nvals);
  if (is_dc)
    for (int i = 0; i < nvals; ++i)
      if (vals[i] > 15) return E_CORRUPT;
  h->defined = true;
  return OK;
}

// Entropy-coded data of one segment (up to the next marker). Past the
// marker or the end of the file, zero bytes are fed, as libjpeg does;
// ``fake`` counts them, so that consuming one is seen as truncation.
struct Bits {
  const uint8_t* d;
  int64_t n, pos;
  uint64_t acc = 0;
  int bits = 0;
  int64_t fake = 0;
  bool stopped = false;

  void fill() {
    while (bits <= 56) {
      uint8_t b = 0;
      if (!stopped && pos < n) {
        b = d[pos];
        if (b == 0xFF) {
          int64_t q = pos + 1;
          while (q < n && d[q] == 0xFF) ++q;
          if (q < n && d[q] == 0x00) {
            pos = q + 1;  // stuffed 0xFF
          } else {
            stopped = true;  // a marker (or the end) at pos
            b = 0;
            ++fake;
          }
        } else {
          ++pos;
        }
      } else {
        stopped = true;
        ++fake;
      }
      acc = (acc << 8) | b;
      bits += 8;
    }
  }
  inline uint32_t peek(int nb) {
    if (bits < nb) fill();
    return static_cast<uint32_t>(acc >> (bits - nb)) & ((1u << nb) - 1);
  }
  inline void skip(int nb) { bits -= nb; }
  inline uint32_t get(int nb) {
    if (nb == 0) return 0;
    uint32_t v = peek(nb);
    bits -= nb;
    return v;
  }
  // more bits consumed than the segment held
  bool overrun() const { return bits < 8 * fake; }
  // drop what is left of the segment: restart with the bytes at pos
  void reset(int64_t at) {
    pos = at;
    acc = 0;
    bits = 0;
    fake = 0;
    stopped = false;
  }
};

inline int huff_decode(Bits& br, const Huff& h, Err* err) {
  uint32_t look = br.peek(8);
  int nb = h.look_nbits[look];
  if (nb) {
    br.skip(nb);
    return h.look_sym[look];
  }
  // jdhuff.c jpeg_huff_decode: codes longer than 8 bits
  int l = 9;
  int32_t code = static_cast<int32_t>(br.get(9));
  while (l <= 16 && code > h.maxcode[l]) {
    code = (code << 1) | static_cast<int32_t>(br.get(1));
    ++l;
  }
  if (l > 16) {
    *err = E_CORRUPT;
    return 0;
  }
  return h.huffval[(code + h.valoffset[l]) & 0xFF];
}

inline int extend(int x, int s) {
  return x < (1 << (s - 1)) ? x + static_cast<int>((~0u) << s) + 1 : x;
}

// jidctint.c jpeg_idct_islow, writing 8x8 samples at out (row stride)
constexpr int CONST_BITS = 13, PASS1_BITS = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
                  FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
                  FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
                  FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
                  FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

// jdmaster.c's post-IDCT range limit: table[x & 1023] seen from the centre
inline uint8_t range_limit(int64_t x) {
  const int v = static_cast<int>(x) & 1023;
  if (v < 128) return static_cast<uint8_t>(v + 128);
  if (v < 512) return 255;
  if (v < 896) return 0;
  return static_cast<uint8_t>(v - 896);
}

void idct_islow(const int16_t* coef, const int16_t* quant, uint8_t* out,
                int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const int16_t* q = quant + c;
    int* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 &&
        in[40] == 0 && in[48] == 0 && in[56] == 0) {
      int dc = (in[0] * q[0]) * (1 << PASS1_BITS);
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = in[16] * q[16], z3 = in[48] * q[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = in[0] * q[0];
    z3 = in[32] * q[32];
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = in[56] * q[56];
    tmp1 = in[40] * q[40];
    tmp2 = in[24] * q[24];
    tmp3 = in[8] * q[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CONST_BITS - PASS1_BITS;
    w[0] = static_cast<int>(descale(tmp10 + tmp3, sh));
    w[56] = static_cast<int>(descale(tmp10 - tmp3, sh));
    w[8] = static_cast<int>(descale(tmp11 + tmp2, sh));
    w[48] = static_cast<int>(descale(tmp11 - tmp2, sh));
    w[16] = static_cast<int>(descale(tmp12 + tmp1, sh));
    w[40] = static_cast<int>(descale(tmp12 - tmp1, sh));
    w[24] = static_cast<int>(descale(tmp13 + tmp0, sh));
    w[32] = static_cast<int>(descale(tmp13 - tmp0, sh));
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + static_cast<int64_t>(r) * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
        w[6] == 0 && w[7] == 0) {
      uint8_t dc = range_limit(descale(w[0], PASS1_BITS + 3));
      for (int c = 0; c < 8; ++c) o[c] = dc;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << CONST_BITS);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CONST_BITS + PASS1_BITS + 3;
    o[0] = range_limit(descale(tmp10 + tmp3, sh));
    o[7] = range_limit(descale(tmp10 - tmp3, sh));
    o[1] = range_limit(descale(tmp11 + tmp2, sh));
    o[6] = range_limit(descale(tmp11 - tmp2, sh));
    o[2] = range_limit(descale(tmp12 + tmp1, sh));
    o[5] = range_limit(descale(tmp12 - tmp1, sh));
    o[3] = range_limit(descale(tmp13 + tmp0, sh));
    o[4] = range_limit(descale(tmp13 - tmp0, sh));
  }
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;  // Huffman tables of the current scan
  int16_t quant[64];   // natural order, latched at its first scan
  bool latched = false;
  int width = 0, height = 0;    // downsampled size (real samples)
  int bw = 0, bh = 0;           // plane size in blocks (MCU-padded)
  std::vector<uint8_t> plane;   // bh*8 rows of bw*8 samples
  int last_dc = 0;
};

struct Decoder {
  const uint8_t* d;
  int64_t n;
  int64_t pos = 0;
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  bool frame = false, adobe = false, jfif = false;
  int adobe_transform = -1;
  int restart_interval = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  Component comp[3];

  int u16(int64_t at) const { return (d[at] << 8) | d[at + 1]; }

  // the next marker code at or after pos (skipping fill bytes), or -1
  int next_marker() {
    while (pos + 1 < n) {
      if (d[pos] == 0xFF && d[pos + 1] != 0xFF && d[pos + 1] != 0x00) {
        int m = d[pos + 1];
        pos += 2;
        return m;
      }
      ++pos;
    }
    return -1;
  }

  Err segment(int64_t* start, int* len) {
    if (pos + 2 > n) return E_TRUNCATED;
    *len = u16(pos);
    if (*len < 2) return E_CORRUPT;
    if (pos + *len > n) return E_TRUNCATED;
    *start = pos + 2;
    pos += *len;
    *len -= 2;
    return OK;
  }

  Err read_sof(int64_t s, int len, int marker) {
    if (frame) return E_CORRUPT;
    if (len < 6) return E_CORRUPT;
    if (d[s] != 8) return E_PRECISION;
    height = u16(s + 1);
    width = u16(s + 3);
    ncomp = d[s + 5];
    if (height == 0) return E_DNL;
    if (width == 0) return E_CORRUPT;
    if (ncomp == 4) return E_COMPONENTS;
    if (ncomp != 1 && ncomp != 3) return E_COMPONENTS;
    if (len < 6 + 3 * ncomp) return E_CORRUPT;
    (void)marker;
    hmax = vmax = 1;
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = d[s + 6 + 3 * i];
      c.h = d[s + 7 + 3 * i] >> 4;
      c.v = d[s + 7 + 3 * i] & 15;
      c.tq = d[s + 8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        return E_CORRUPT;
      hmax = c.h > hmax ? c.h : hmax;
      vmax = c.v > vmax ? c.v : vmax;
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      // ratios to the largest factors: 1 (full size) or 2 (subsampled)
      const int rh = hmax / c.h, rv = vmax / c.v;
      if (ncomp > 1 && (hmax % c.h || vmax % c.v || rh > 2 || rv > 2 ||
                        rv > rh))
        return E_SAMPLING;
      c.width = static_cast<int>((int64_t(width) * c.h + hmax - 1) / hmax);
      c.height = static_cast<int>((int64_t(height) * c.v + vmax - 1) / vmax);
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.plane.assign(static_cast<size_t>(c.bw) * 8 * c.bh * 8, 0);
    }
    frame = true;
    return OK;
  }

  Err read_dqt(int64_t s, int len) {
    int64_t e = s + len;
    while (s < e) {
      const int pq = d[s] >> 4, tq = d[s] & 15;
      if (tq > 3 || pq > 1) return E_CORRUPT;
      const int size = pq ? 128 : 64;
      if (s + 1 + size > e) return E_CORRUPT;
      for (int i = 0; i < 64; ++i)
        qt[tq][kNatural[i]] = static_cast<uint16_t>(
            pq ? u16(s + 1 + 2 * i) : d[s + 1 + i]);
      qt_defined[tq] = true;
      s += 1 + size;
    }
    return OK;
  }

  Err read_dht(int64_t s, int len) {
    int64_t e = s + len;
    while (s < e) {
      if (s + 17 > e) return E_CORRUPT;
      const int tc = d[s] >> 4, th = d[s] & 15;
      if (tc > 1 || th > 3) return E_CORRUPT;
      uint8_t bits[17];
      bits[0] = 0;
      int count = 0;
      for (int i = 1; i <= 16; ++i) {
        bits[i] = d[s + i];
        count += bits[i];
      }
      if (count > 256 || s + 17 + count > e) return E_CORRUPT;
      Err err = build_huff(bits, d + s + 17, count, tc == 0,
                           tc == 0 ? &dc[th] : &ac[th]);
      if (err != OK) return err;
      s += 17 + count;
    }
    return OK;
  }

  void read_app(int marker, int64_t s, int len) {
    if (marker == 0xE0 && len >= 5 && std::memcmp(d + s, "JFIF\0", 5) == 0)
      jfif = true;
    if (marker == 0xEE && len >= 12 && std::memcmp(d + s, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = d[s + 11];
    }
  }

  Err decode_block(Bits& br, Component& c, int bx, int by) {
    int16_t coef[64];
    std::memset(coef, 0, sizeof(coef));
    Err err = OK;
    const Huff& hd = dc[c.td];
    const Huff& ha = ac[c.ta];
    int s = huff_decode(br, hd, &err);
    if (err != OK) return err;
    if (s) s = extend(static_cast<int>(br.get(s)), s);
    const int dcv = static_cast<int>(static_cast<unsigned>(s) +
                                     static_cast<unsigned>(c.last_dc));
    c.last_dc = dcv;
    coef[0] = static_cast<int16_t>(dcv);
    for (int k = 1; k < 64; ++k) {
      s = huff_decode(br, ha, &err);
      if (err != OK) return err;
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        r = static_cast<int>(br.get(s));
        coef[kNatural[k]] = static_cast<int16_t>(extend(r, s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    const int stride = c.bw * 8;
    idct_islow(coef, c.quant, c.plane.data() +
               (static_cast<int64_t>(by) * 8) * stride + bx * 8, stride);
    return OK;
  }

  // one restart interval ends: the RSTn marker must follow
  Err restart(Bits& br, int* expected) {
    if (br.overrun()) return E_TRUNCATED;
    pos = br.pos;
    int m = next_marker();
    if (m < 0) return E_TRUNCATED;
    if (m != 0xD0 + *expected) return E_CORRUPT;
    *expected = (*expected + 1) & 7;
    br.reset(pos);
    for (int i = 0; i < ncomp; ++i) comp[i].last_dc = 0;
    return OK;
  }

  Err read_scan(int64_t s, int len) {
    if (!frame) return E_NO_FRAME;
    const int ns = d[s];
    if (ns < 1 || ns > ncomp || len != 4 + 2 * ns) return E_CORRUPT;
    Component* sc[3];
    for (int i = 0; i < ns; ++i) {
      const int cid = d[s + 1 + 2 * i];
      Component* c = nullptr;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == cid) c = &comp[j];
      if (!c) return E_CORRUPT;
      c->td = d[s + 2 + 2 * i] >> 4;
      c->ta = d[s + 2 + 2 * i] & 15;
      if (c->td > 3 || c->ta > 3 || !dc[c->td].defined ||
          !ac[c->ta].defined)
        return E_CORRUPT;
      if (!c->latched) {
        if (!qt_defined[c->tq]) return E_CORRUPT;
        for (int k = 0; k < 64; ++k)
          c->quant[k] = static_cast<int16_t>(qt[c->tq][k]);
        c->latched = true;
      }
      c->last_dc = 0;
      sc[i] = c;
    }
    const int ss = d[s + 1 + 2 * ns], se = d[s + 2 + 2 * ns];
    if (ss != 0 || se != 63) return E_CORRUPT;

    Bits br{d, n, pos};
    int expected = 0, left = restart_interval;
    Err err = OK;
    if (ns == 1) {
      Component& c = *sc[0];
      const int bw = (c.width + 7) / 8, bh = (c.height + 7) / 8;
      for (int by = 0; by < bh; ++by)
        for (int bx = 0; bx < bw; ++bx) {
          if (restart_interval) {
            if (left == 0) {
              if ((err = restart(br, &expected)) != OK) return err;
              left = restart_interval;
            }
            --left;
          }
          if ((err = decode_block(br, c, bx, by)) != OK)
            return br.overrun() ? E_TRUNCATED : err;
        }
    } else {
      for (int my = 0; my < mcuy; ++my)
        for (int mx = 0; mx < mcux; ++mx) {
          if (restart_interval) {
            if (left == 0) {
              if ((err = restart(br, &expected)) != OK) return err;
              left = restart_interval;
            }
            --left;
          }
          for (int i = 0; i < ns; ++i) {
            Component& c = *sc[i];
            for (int y = 0; y < c.v; ++y)
              for (int x = 0; x < c.h; ++x)
                if ((err = decode_block(br, c, mx * c.h + x, my * c.v + y)) !=
                    OK)
                  return br.overrun() ? E_TRUNCATED : err;
          }
        }
    }
    if (br.overrun()) return E_TRUNCATED;
    pos = br.pos;
    return OK;
  }

  Err parse(bool header_only) {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) return E_NOT_JPEG;
    pos = 2;
    int scans = 0;
    for (;;) {
      const int m = next_marker();
      if (m < 0) return E_TRUNCATED;  // no EOI: PIL refuses it too
      if (m == 0xD9) return scans ? OK : E_NO_FRAME;
      if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
      int64_t s;
      int len;
      Err err = segment(&s, &len);
      if (err != OK) return err;
      switch (m) {
        case 0xC0:
        case 0xC1:
          if ((err = read_sof(s, len, m)) != OK) return err;
          if (header_only) return OK;
          break;
        case 0xC2:
        case 0xC6:
        case 0xCA:
        case 0xCE:
          return E_PROGRESSIVE;
        case 0xC3:
        case 0xC7:
        case 0xCB:
        case 0xCF:
          return E_LOSSLESS;
        case 0xC5:
          return E_HIERARCHICAL;
        case 0xC9:
        case 0xCD:
        case 0xCC:
          return E_ARITHMETIC;
        case 0xC4:
          if ((err = read_dht(s, len)) != OK) return err;
          break;
        case 0xDB:
          if ((err = read_dqt(s, len)) != OK) return err;
          break;
        case 0xDD:
          if (len < 2) return E_CORRUPT;
          restart_interval = u16(s);
          break;
        case 0xDC:
          return E_DNL;
        case 0xDA:
          if ((err = read_scan(s, len)) != OK) return err;
          ++scans;
          break;
        default:
          if (m >= 0xE0 && m <= 0xEF) read_app(m, s, len);
          break;  // COM and the rest: skipped
      }
    }
  }

  // libjpeg's default colour space guess (jdapimin.c default_decompress_parms)
  bool is_rgb() const {
    if (jfif) return false;
    if (adobe) return adobe_transform == 0;
    return comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
  }
};

// jdsample.c h2v1_fancy_upsample / h2v2_fancy_upsample, or replication
// (h2v1_upsample / h2v2_upsample) when the subsampled width is 2 or less.
// Writes ``height`` rows of ``width`` samples.
void upsample(const Component& c, int rh, int rv, int width, int height,
              uint8_t* out) {
  const int stride = c.bw * 8;
  const int dw = c.width;
  const uint8_t* p = c.plane.data();
  auto row = [&](int y) {
    y = y < 0 ? 0 : (y >= c.height ? c.height - 1 : y);
    return p + static_cast<int64_t>(y) * stride;
  };
  if (rh == 1 && rv == 1) {
    for (int y = 0; y < height; ++y)
      std::memcpy(out + static_cast<int64_t>(y) * width, row(y), width);
    return;
  }
  std::vector<uint8_t> line(2 * static_cast<size_t>(dw) + 2);
  const bool fancy = dw > 2;
  for (int y = 0; y < height; ++y) {
    uint8_t* o = out + static_cast<int64_t>(y) * width;
    if (!fancy) {
      const uint8_t* in = row(rv == 2 ? y / 2 : y);
      for (int x = 0; x < width; ++x) o[x] = in[x / 2];
      continue;
    }
    if (rv == 1) {
      const uint8_t* in = row(y);
      uint8_t* t = line.data();
      int inv = in[0];
      t[0] = static_cast<uint8_t>(inv);
      t[1] = static_cast<uint8_t>((inv * 3 + in[1] + 2) >> 2);
      for (int i = 1; i < dw - 1; ++i) {
        inv = in[i] * 3;
        t[2 * i] = static_cast<uint8_t>((inv + in[i - 1] + 1) >> 2);
        t[2 * i + 1] = static_cast<uint8_t>((inv + in[i + 1] + 2) >> 2);
      }
      inv = in[dw - 1];
      t[2 * dw - 2] = static_cast<uint8_t>((inv * 3 + in[dw - 2] + 1) >> 2);
      t[2 * dw - 1] = static_cast<uint8_t>(inv);
      std::memcpy(o, t, width);
      continue;
    }
    // h2v2: the nearer input row (y/2) and the next nearest (above for an
    // even output row, below for an odd one), clamped at the edges
    const int iy = y / 2;
    const uint8_t* in0 = row(iy);
    const uint8_t* in1 = row((y & 1) ? iy + 1 : iy - 1);
    uint8_t* t = line.data();
    int32_t thiscol = in0[0] * 3 + in1[0];
    int32_t nextcol = in0[1] * 3 + in1[1];
    t[0] = static_cast<uint8_t>((thiscol * 4 + 8) >> 4);
    t[1] = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
    int32_t lastcol = thiscol;
    thiscol = nextcol;
    for (int i = 1; i < dw - 1; ++i) {
      nextcol = in0[i + 1] * 3 + in1[i + 1];
      t[2 * i] = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
      t[2 * i + 1] = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
      lastcol = thiscol;
      thiscol = nextcol;
    }
    t[2 * dw - 2] = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
    t[2 * dw - 1] = static_cast<uint8_t>((thiscol * 4 + 7) >> 4);
    std::memcpy(o, t, width);
  }
}

// jdcolor.c build_ycc_rgb_table + ycc_rgb_convert
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    constexpr int SCALEBITS = 16;
    constexpr int64_t ONE_HALF = int64_t(1) << (SCALEBITS - 1);
    auto fix = [](double x) {
      return static_cast<int64_t>(x * (int64_t(1) << SCALEBITS) + 0.5);
    };
    for (int i = 0, x = -128; i <= 255; ++i, ++x) {
      cr_r[i] = static_cast<int>((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + ONE_HALF;
    }
  }
};

const YccTables kYcc;

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

}  // namespace

extern "C" {

const char* jpeg_strerror(int code) {
  if (code < 0 || code > E_DNL) return "unknown error";
  return kMessages[code];
}

// Size and component count from the frame header. Returns 0 or an error.
int jpeg_header(const uint8_t* data, int64_t n, int* height, int* width,
                int* components) {
  Decoder dec{data, n};
  Err err = dec.parse(true);
  if (err != OK) return err;
  if (!dec.frame) return E_NO_FRAME;
  *height = dec.height;
  *width = dec.width;
  *components = dec.ncomp;
  return OK;
}

// Decode into ``out``: (height, width, out_channels) uint8, out_channels 3
// (RGB; a grayscale file's samples replicated, as PIL's convert("RGB")) or
// 1 (a grayscale file only). Returns 0 or an error.
int jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, int height,
                int width, int out_channels) {
  Decoder dec{data, n};
  Err err = dec.parse(false);
  if (err != OK) return err;
  if (dec.height != height || dec.width != width ||
      (out_channels != 1 && out_channels != 3) ||
      (out_channels == 1 && dec.ncomp != 1))
    return E_OUTPUT;
  for (int i = 0; i < dec.ncomp; ++i)
    if (!dec.comp[i].latched) return E_TRUNCATED;  // a component never coded
  const int64_t npix = static_cast<int64_t>(width) * height;
  if (dec.ncomp == 1) {
    std::vector<uint8_t> y(npix);
    upsample(dec.comp[0], 1, 1, width, height, y.data());
    if (out_channels == 1) {
      std::memcpy(out, y.data(), npix);
    } else {
      for (int64_t i = 0; i < npix; ++i)
        out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
    }
    return OK;
  }
  std::vector<uint8_t> planes[3];
  for (int i = 0; i < 3; ++i) {
    const Component& c = dec.comp[i];
    planes[i].resize(npix);
    upsample(c, dec.hmax / c.h, dec.vmax / c.v, width, height,
             planes[i].data());
  }
  const uint8_t* y = planes[0].data();
  const uint8_t* cb = planes[1].data();
  const uint8_t* cr = planes[2].data();
  if (dec.is_rgb()) {
    for (int64_t i = 0; i < npix; ++i) {
      out[3 * i] = y[i];
      out[3 * i + 1] = cb[i];
      out[3 * i + 2] = cr[i];
    }
    return OK;
  }
  for (int64_t i = 0; i < npix; ++i) {
    const int yy = y[i], b = cb[i], r = cr[i];
    out[3 * i] = clamp255(yy + kYcc.cr_r[r]);
    out[3 * i + 1] = clamp255(
        yy + static_cast<int>((kYcc.cb_g[b] + kYcc.cr_g[r]) >> 16));
    out[3 * i + 2] = clamp255(yy + kYcc.cb_b[b]);
  }
  return OK;
}

}  // extern "C"
