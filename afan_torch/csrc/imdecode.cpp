// Host image decoding for the port's data pipeline: PNG unfiltering and
// JPEG (baseline, extended-sequential and progressive, Huffman- or
// arithmetic-coded, and lossless Huffman), giving the bytes that Pillow
// gives (`Image.open(p).convert("RGB")`, Pillow's JPEG codec being
// libjpeg-turbo 3 with its default settings).
//
// The JPEG path follows libjpeg-turbo's choices one by one:
//   - progressive scans (jdphuff.c: DC and AC first and refinement scans,
//     EOB runs, restarts resetting the run and the DC predictions) fill a
//     whole-image coefficient buffer, which is transformed once the file has
//     ended; a file whose first ten coefficients are not all complete by
//     then is block-smoothed first (jdcoefct.c decompress_smooth_data, as
//     libjpeg-turbo 2.1 and later: the 3x3 and 5x5 DC-neighbourhood
//     estimates, and the DC's own smoothing when no AC scan came);
//   - arithmetic coding (jdarith.c, SOF9 and SOF10): the QM-coder with the
//     Qe table of jaricom.c, zeros fed after a marker, DC statistics
//     conditioned on L and U and AC statistics split at Kx (the DAC
//     marker's, else 0, 1 and 5), restarts resetting the statistics, the
//     registers and the DC contexts; the sequential and the four
//     progressive scan kinds fill the same coefficient buffers as Huffman;
//   - lossless Huffman coding (jdlhuff.c, jdlossls.c, jddiffct.c, SOF3):
//     differences (SSSS 16 is 32768, sums modulo 2^16), the seven
//     predictors, the first row of a scan predicted from the left and its
//     first sample from 1 << (7 - Pt), the first column from above, samples
//     scaled back by << Pt; a restart starts the first row over at the
//     next iMCU row that libjpeg undifferences, as jddiffct.c does;
//   - the integer "islow" inverse DCT (jidctint.c: 13-bit constants, 2 pass
//     bits, the post-IDCT range-limit table, indexed modulo 1024);
//   - upsampling (jdsample.c): "fancy" h2v1 (biases 1 and 2), h1v2 (biases 1
//     and 2) and h2v2 (biases 8 and 7), the chroma's first and last real row
//     and column repeated past the image; a chroma plane of at most two
//     columns under h2v1 / h2v2, every other integral factor, and every
//     factor of a lossless file (its DCT size is 1), is replicated;
//   - the table-driven YCbCr -> RGB conversion (jdcolor.c, 16 scale bits),
//     and YCCK -> CMYK with the same tables;
//   - the colour space: JFIF is YCbCr, Adobe APP14 with transform 0 is RGB,
//     1 is YCbCr, and without either, component ids 'R' 'G' 'B' mean RGB,
//     as every id does in a lossless file; four components are CMYK, or
//     YCCK under Adobe's transform 2, which Pillow reads inverted ("CMYK;I")
//     and turns into RGB with its cmyk2rgb (Convert.c).
// No EXIF orientation is applied (Image.open applies none).
//
// What it refuses, Pillow refuses too, and the message says what it met:
// hierarchical JPEG (SOF5-7, SOF13-15), lossless arithmetic coding (SOF11,
// which libjpeg-turbo does not implement), lossless YCbCr or YCCK (libjpeg-
// turbo converts no colours in lossless mode), samples of other than 8 bits
// (Pillow opens no other precision), a height of 0 (the DNL marker),
// fractional sampling ratios, a progression that breaks libjpeg's order,
// corrupt entropy data and truncated files. Pillow also refuses an
// arithmetic-coded file whose scan does not fit in one of its 64 KiB reads
// (libjpeg's arithmetic decoder cannot suspend); this decoder reads it. The
// PNG side unfilters rows of any pixel size (sub-byte, 8- and 16-bit
// samples); the chunk parse, the inflate, Adam7's pass split and the
// unpacking of samples are the caller's.
//
// No global state: every call works on its own buffers, so threads may
// call it at once.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct DecodeError {
  std::string what;
};

[[noreturn]] void fail(const std::string& what) { throw DecodeError{what}; }

int report(const DecodeError& e, char* err, int32_t err_len) {
  if (err && err_len > 0) {
    std::snprintf(err, static_cast<size_t>(err_len), "%s", e.what.c_str());
  }
  return -1;
}

// ---------------------------------------------------------------- PNG

inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// Rows of ceil(width * bits / 8) bytes; the filters' byte distance is
// max(1, bits / 8).
void png_unfilter(const uint8_t* raw, int64_t raw_len, int32_t width,
                  int32_t height, int32_t bits, uint8_t* out) {
  const int64_t stride = (static_cast<int64_t>(width) * bits + 7) / 8;
  const int64_t bpp = std::max(1, bits / 8);
  if (raw_len < (stride + 1) * height) {
    fail("truncated image data: " + std::to_string(raw_len) +
         " bytes inflated, " + std::to_string((stride + 1) * height) +
         " needed");
  }
  for (int32_t y = 0; y < height; ++y) {
    const uint8_t* src = raw + y * (stride + 1);
    const int filter = src[0];
    ++src;
    uint8_t* dst = out + y * stride;
    const uint8_t* up = y > 0 ? dst - stride : nullptr;
    switch (filter) {
      case 0:
        std::memcpy(dst, src, static_cast<size_t>(stride));
        break;
      case 1:
        for (int64_t i = 0; i < stride; ++i) {
          int a = i >= bpp ? dst[i - bpp] : 0;
          dst[i] = static_cast<uint8_t>(src[i] + a);
        }
        break;
      case 2:
        for (int64_t i = 0; i < stride; ++i) {
          dst[i] = static_cast<uint8_t>(src[i] + (up ? up[i] : 0));
        }
        break;
      case 3:
        for (int64_t i = 0; i < stride; ++i) {
          int a = i >= bpp ? dst[i - bpp] : 0;
          int b = up ? up[i] : 0;
          dst[i] = static_cast<uint8_t>(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < stride; ++i) {
          int a = i >= bpp ? dst[i - bpp] : 0;
          int b = up ? up[i] : 0;
          int c = (up && i >= bpp) ? up[i - bpp] : 0;
          dst[i] = static_cast<uint8_t>(src[i] + paeth(a, b, c));
        }
        break;
      default:
        fail("unknown PNG filter type " + std::to_string(filter) +
             " on row " + std::to_string(y));
    }
  }
}

// ---------------------------------------------------------------- JPEG

// Zigzag position -> natural position, with 16 extra entries so that a run
// past the block's end writes coefficient 63, as jpeg_natural_order does.
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};
// the coefficients block smoothing estimates: zigzag 0-9 (jdcoefct.c)
constexpr int kSavedCoefs = 10;


struct Huffman {
  bool defined = false;
  // jdhuff.c's derived table: maxcode per length, offsets into vals.
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  // 9-bit lookahead: (length << 8) | value, 0 when the code is longer.
  uint16_t look[512];
};

void build_huffman(Huffman& h, const uint8_t bits[17], const uint8_t* vals,
                   int nvals) {
  int huffsize[257];
  uint32_t huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < bits[l]; ++i) huffsize[p++] = l;
  }
  huffsize[p] = 0;
  uint32_t code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) {
      huffcode[p++] = code;
      ++code;
    }
    if (code >= (1u << si)) fail("bad Huffman table");
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (bits[l]) {
      h.valoffset[l] = p - static_cast<int32_t>(huffcode[p]);
      p += bits[l];
      h.maxcode[l] = static_cast<int32_t>(huffcode[p - 1]);
    } else {
      h.maxcode[l] = -1;
    }
  }
  h.valoffset[17] = 0;
  h.maxcode[17] = 0x7FFFFFFF;
  std::memcpy(h.vals, vals, static_cast<size_t>(nvals));
  std::memset(h.look, 0, sizeof(h.look));
  p = 0;
  for (int l = 1; l <= 9; ++l) {
    for (int i = 0; i < bits[l]; ++i, ++p) {
      uint32_t lookbits = huffcode[p] << (9 - l);
      for (int ctr = 1 << (9 - l); ctr > 0; --ctr) {
        h.look[lookbits++] = static_cast<uint16_t>((l << 8) | vals[p]);
      }
    }
  }
  h.defined = true;
}

// jdmarker.c next_marker: from pos, skip to an FF followed by a byte that is
// neither FF nor 0 (fill bytes and stuffed zeros are skipped); returns that
// marker code, pos left after it.
int next_marker_from(const uint8_t* data, int64_t len, int64_t& pos) {
  for (;;) {
    while (pos < len && data[pos] != 0xFF) ++pos;
    while (pos < len && data[pos] == 0xFF) ++pos;
    if (pos >= len) fail("truncated file: no marker after the scan data");
    const int code = data[pos++];
    if (code != 0) return code;
  }
}

struct BitReader {
  const uint8_t* data;
  int64_t len;
  int64_t pos;
  uint64_t acc = 0;
  int bits = 0;   // valid bits in acc (real and inserted zeros)
  int fake = 0;   // of those, zero bits inserted past a marker or the end

  void fill() {
    while (bits <= 56) {
      uint8_t byte = 0;
      if (pos >= len) {
        fake += 8;
      } else if (data[pos] == 0xFF) {
        int64_t q = pos + 1;
        while (q < len && data[q] == 0xFF) ++q;   // fill bytes
        if (q < len && data[q] == 0x00) {
          byte = 0xFF;
          pos = q + 1;
        } else {
          pos = q - 1;   // stay on the marker (or the end)
          if (q >= len) pos = len;
          fake += 8;
        }
      } else {
        byte = data[pos++];
      }
      acc |= static_cast<uint64_t>(byte) << (56 - bits);
      bits += 8;
    }
  }

  inline uint32_t peek(int n) {
    if (bits < n) fill();
    return static_cast<uint32_t>(acc >> (64 - n));
  }

  inline void skip(int n) {
    acc <<= n;
    bits -= n;
    if (bits < fake) fail("truncated or corrupt entropy-coded data");
  }

  inline int get(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    skip(n);
    return static_cast<int>(v);
  }

  int decode(const Huffman& h) {
    uint32_t look = peek(16);
    uint16_t e = h.look[look >> 7];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    int l = 10;
    int32_t code = static_cast<int32_t>(look >> 6);
    while (l <= 16 && code > h.maxcode[l]) {
      ++l;
      code = static_cast<int32_t>(look >> (16 - l));
    }
    if (l > 16) fail("corrupt JPEG data: bad Huffman code");
    skip(l);
    return h.vals[(code + h.valoffset[l]) & 0xFF];
  }

  // Discard what is buffered and move to the next marker; returns it.
  int next_marker() {
    acc = 0;
    bits = 0;
    fake = 0;
    return next_marker_from(data, len, pos);
  }
};

// jaricom.c jpeg_aritab (T.81 Table D.2): Qe << 16 | Next_Index_MPS << 8 |
// Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed 0.5 estimate.
#define QE(qe, lps, mps, sw) \
  ((int64_t(qe) << 16) | ((mps) << 8) | ((sw) << 7) | (lps))
const int64_t kQe[114] = {
    QE(0x5a1d, 1, 1, 1),    QE(0x2586, 14, 2, 0),   QE(0x1114, 16, 3, 0),
    QE(0x080b, 18, 4, 0),   QE(0x03d8, 20, 5, 0),   QE(0x01da, 23, 6, 0),
    QE(0x00e5, 25, 7, 0),   QE(0x006f, 28, 8, 0),   QE(0x0036, 30, 9, 0),
    QE(0x001a, 33, 10, 0),  QE(0x000d, 35, 11, 0),  QE(0x0006, 9, 12, 0),
    QE(0x0003, 10, 13, 0),  QE(0x0001, 12, 13, 0),  QE(0x5a7f, 15, 15, 1),
    QE(0x3f25, 36, 16, 0),  QE(0x2cf2, 38, 17, 0),  QE(0x207c, 39, 18, 0),
    QE(0x17b9, 40, 19, 0),  QE(0x1182, 42, 20, 0),  QE(0x0cef, 43, 21, 0),
    QE(0x09a1, 45, 22, 0),  QE(0x072f, 46, 23, 0),  QE(0x055c, 48, 24, 0),
    QE(0x0406, 49, 25, 0),  QE(0x0303, 51, 26, 0),  QE(0x0240, 52, 27, 0),
    QE(0x01b1, 54, 28, 0),  QE(0x0144, 56, 29, 0),  QE(0x00f5, 57, 30, 0),
    QE(0x00b7, 59, 31, 0),  QE(0x008a, 60, 32, 0),  QE(0x0068, 62, 33, 0),
    QE(0x004e, 63, 34, 0),  QE(0x003b, 32, 35, 0),  QE(0x002c, 33, 9, 0),
    QE(0x5ae1, 37, 37, 1),  QE(0x484c, 64, 38, 0),  QE(0x3a0d, 65, 39, 0),
    QE(0x2ef1, 67, 40, 0),  QE(0x261f, 68, 41, 0),  QE(0x1f33, 69, 42, 0),
    QE(0x19a8, 70, 43, 0),  QE(0x1518, 72, 44, 0),  QE(0x1177, 73, 45, 0),
    QE(0x0e74, 74, 46, 0),  QE(0x0bfb, 75, 47, 0),  QE(0x09f8, 77, 48, 0),
    QE(0x0861, 78, 49, 0),  QE(0x0706, 79, 50, 0),  QE(0x05cd, 48, 51, 0),
    QE(0x04de, 50, 52, 0),  QE(0x040f, 50, 53, 0),  QE(0x0363, 51, 54, 0),
    QE(0x02d4, 52, 55, 0),  QE(0x025c, 53, 56, 0),  QE(0x01f8, 54, 57, 0),
    QE(0x01a4, 55, 58, 0),  QE(0x0160, 56, 59, 0),  QE(0x0125, 57, 60, 0),
    QE(0x00f6, 58, 61, 0),  QE(0x00cb, 59, 62, 0),  QE(0x00ab, 61, 63, 0),
    QE(0x008f, 61, 32, 0),  QE(0x5b12, 65, 65, 1),  QE(0x4d04, 80, 66, 0),
    QE(0x412c, 81, 67, 0),  QE(0x37d8, 82, 68, 0),  QE(0x2fe8, 83, 69, 0),
    QE(0x293c, 84, 70, 0),  QE(0x2379, 86, 71, 0),  QE(0x1edf, 87, 72, 0),
    QE(0x1aa9, 87, 73, 0),  QE(0x174e, 72, 74, 0),  QE(0x1424, 72, 75, 0),
    QE(0x119c, 74, 76, 0),  QE(0x0f6b, 74, 77, 0),  QE(0x0d51, 75, 78, 0),
    QE(0x0bb6, 77, 79, 0),  QE(0x0a40, 77, 48, 0),  QE(0x5832, 80, 81, 1),
    QE(0x4d1c, 88, 82, 0),  QE(0x438e, 89, 83, 0),  QE(0x3bdd, 90, 84, 0),
    QE(0x34ee, 91, 85, 0),  QE(0x2eae, 92, 86, 0),  QE(0x299a, 93, 87, 0),
    QE(0x2516, 86, 71, 0),  QE(0x5570, 88, 89, 1),  QE(0x4ca9, 95, 90, 0),
    QE(0x44d9, 96, 91, 0),  QE(0x3e22, 97, 92, 0),  QE(0x3824, 99, 93, 0),
    QE(0x32b4, 99, 94, 0),  QE(0x2e17, 93, 86, 0),  QE(0x56a8, 95, 96, 1),
    QE(0x4f46, 101, 97, 0), QE(0x47e5, 102, 98, 0), QE(0x41cf, 103, 99, 0),
    QE(0x3c3d, 104, 100, 0), QE(0x375e, 99, 93, 0), QE(0x5231, 105, 102, 0),
    QE(0x4c0f, 106, 103, 0), QE(0x4639, 107, 104, 0),
    QE(0x415e, 103, 99, 0), QE(0x5627, 105, 106, 1),
    QE(0x50e7, 108, 107, 0), QE(0x4b85, 109, 103, 0),
    QE(0x5597, 110, 109, 0), QE(0x504f, 111, 107, 0),
    QE(0x5a10, 110, 111, 1), QE(0x5522, 112, 109, 0),
    QE(0x59eb, 112, 111, 1), QE(0x5a1d, 113, 113, 0)};
#undef QE

// jdarith.c's QM-decoder: the C and A registers and the bit counter CT
// (-16 until two bytes are in), reading the scan's bytes from pos; once it
// meets a marker it feeds zeros, as the coding allows.
struct ArithDecoder {
  const uint8_t* data;
  int64_t len;
  int64_t pos;
  int64_t c = 0, a = 0;
  int ct = -16;
  int marker = 0;          // the marker met, 0 while none
  int64_t marker_at = 0;   // the position of its code byte

  int byte() {
    if (pos >= len) fail("truncated file inside an arithmetic-coded scan");
    return data[pos++];
  }

  // arith_decode: one binary decision with the adaptive state *st.
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        int d = 0;
        if (!marker) {
          d = byte();
          if (d == 0xFF) {
            do d = byte(); while (d == 0xFF);
            if (d == 0) {
              d = 0xFF;
            } else {
              marker = d;
              marker_at = pos - 1;
              d = 0;
            }
          }
        }
        c = (c << 8) | d;
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;   // the two first bytes
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kQe[sv & 0x7F];
    const int nl = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    const int nm = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {                 // conditional LPS exchange
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {                 // conditional MPS exchange
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  // jdmarker.c read_restart_marker: the marker met, else the next one;
  // then the registers start over behind it.
  int next_marker() {
    int m = marker;
    if (!m) m = next_marker_from(data, len, pos);
    marker = 0;
    c = a = 0;
    ct = -16;
    return m;
  }

  // The position of the FF before the marker that ends the scan.
  int64_t scan_end() {
    if (marker) return marker_at - 1;
    int64_t p = pos;
    next_marker_from(data, len, p);
    return p - 2;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int dc_pred = 0;
  int dc_context = 0;             // arithmetic: the DC statistics' offset
  int plane_w = 0, plane_h = 0;   // samples, MCU-padded
  int down_w = 0, down_h = 0;     // samples that belong to the image
  int blocks_w = 0, blocks_h = 0; // blocks (lossless: samples) of a
                                  // non-interleaved scan
  bool decoded = false;           // sequential: its one scan is done
  bool quant_latched = false;     // progressive: table of its first scan
  int coef_bits[64];              // progressive: bit still to come, -1 none
  int16_t quant[64];              // natural order
  std::vector<int16_t> coefs;     // progressive: (plane_h/8) x (plane_w/8) blocks
  std::vector<uint8_t> plane;
};

// jidctint.c jpeg_idct_islow
constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;
constexpr int64_t FIX_0_298631336 = 2446;
constexpr int64_t FIX_0_390180644 = 3196;
constexpr int64_t FIX_0_541196100 = 4433;
constexpr int64_t FIX_0_765366865 = 6270;
constexpr int64_t FIX_0_899976223 = 7373;
constexpr int64_t FIX_1_175875602 = 9633;
constexpr int64_t FIX_1_501321110 = 12299;
constexpr int64_t FIX_1_847759065 = 15137;
constexpr int64_t FIX_1_961570560 = 16069;
constexpr int64_t FIX_2_053119869 = 16819;
constexpr int64_t FIX_2_562915447 = 20995;
constexpr int64_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

// libjpeg's post-IDCT range limit: the index is taken modulo 1024, values
// -512..511 around the centre; below -128 gives 0, above 127 gives 255.
inline uint8_t range_limit(int64_t x) {
  int v = static_cast<int>(x & 1023);
  if (v >= 512) v -= 1024;
  v += 128;
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

void idct_islow(const int16_t* coef, const int16_t* quant, uint8_t* out,
                int stride) {
  int64_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const int16_t* q = quant + c;
    int64_t* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 &&
        in[40] == 0 && in[48] == 0 && in[56] == 0) {
      int64_t dc = static_cast<int64_t>(int(in[0]) * int(q[0])) << PASS1_BITS;
      for (int r = 0; r < 8; ++r) w[8 * r] = static_cast<int>(dc);
      continue;
    }
    int64_t z2 = int(in[16]) * int(q[16]);
    int64_t z3 = int(in[48]) * int(q[48]);
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int(in[0]) * int(q[0]);
    z3 = int(in[32]) * int(q[32]);
    int64_t tmp0 = (z2 + z3) << CONST_BITS;
    int64_t tmp1 = (z2 - z3) << CONST_BITS;
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int(in[56]) * int(q[56]);
    tmp1 = int(in[40]) * int(q[40]);
    tmp2 = int(in[24]) * int(q[24]);
    tmp3 = int(in[8]) * int(q[8]);
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
    const int n = CONST_BITS - PASS1_BITS;
    // the work array is int in libjpeg
    w[0] = static_cast<int>(descale(tmp10 + tmp3, n));
    w[56] = static_cast<int>(descale(tmp10 - tmp3, n));
    w[8] = static_cast<int>(descale(tmp11 + tmp2, n));
    w[48] = static_cast<int>(descale(tmp11 - tmp2, n));
    w[16] = static_cast<int>(descale(tmp12 + tmp1, n));
    w[40] = static_cast<int>(descale(tmp12 - tmp1, n));
    w[24] = static_cast<int>(descale(tmp13 + tmp0, n));
    w[32] = static_cast<int>(descale(tmp13 - tmp0, n));
  }
  const int n = CONST_BITS + PASS1_BITS + 3;
  for (int r = 0; r < 8; ++r) {
    const int64_t* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
        w[6] == 0 && w[7] == 0) {
      uint8_t dc = range_limit(descale(w[0], PASS1_BITS + 3));
      for (int c = 0; c < 8; ++c) o[c] = dc;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (w[0] + w[4]) << CONST_BITS;
    int64_t tmp1 = (w[0] - w[4]) << CONST_BITS;
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
    o[0] = range_limit(descale(tmp10 + tmp3, n));
    o[7] = range_limit(descale(tmp10 - tmp3, n));
    o[1] = range_limit(descale(tmp11 + tmp2, n));
    o[6] = range_limit(descale(tmp11 - tmp2, n));
    o[2] = range_limit(descale(tmp12 + tmp1, n));
    o[5] = range_limit(descale(tmp12 - tmp1, n));
    o[3] = range_limit(descale(tmp13 + tmp0, n));
    o[4] = range_limit(descale(tmp13 - tmp0, n));
  }
}

// jdcolor.c build_ycc_rgb_table (16 scale bits); cb_g carries ONE_HALF.
struct YccTables {
  static constexpr int SCALEBITS = 16;
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    constexpr int64_t ONE_HALF = int64_t(1) << (SCALEBITS - 1);
    auto fix = [](double x) {
      return static_cast<int64_t>(x * (int64_t(1) << SCALEBITS) + 0.5);
    };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = static_cast<int>((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + ONE_HALF;
    }
  }
  int green(int cb, int cr) const {
    return static_cast<int>((cb_g[cb] + cr_g[cr]) >> SCALEBITS);
  }
};

inline uint8_t clamp8(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

struct Jpeg {
  const uint8_t* data;
  int64_t len;
  int64_t pos = 0;
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1;
  bool have_frame = false;
  bool progressive = false;
  bool arith = false;      // SOF9, SOF10
  bool lossless = false;   // SOF3
  int eobrun = 0;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = -1;
  int restart_interval = 0;
  bool have_quant[4] = {false, false, false, false};
  uint16_t quant[4][64];   // natural order
  Huffman dc[4], ac[4];
  Component comp[4];
  // arithmetic coding: the DAC conditioning and the statistics of each of
  // the 16 tables (jdarith.c DC_STAT_BINS, AC_STAT_BINS)
  uint8_t dc_L[16], dc_U[16], ac_K[16];
  uint8_t dc_stats[16][64], ac_stats[16][256];
  uint8_t fixed_bin = 113;   // the fixed 0.5 estimate of signs and refinements

  Jpeg() {
    std::fill(dc_L, dc_L + 16, 0);
    std::fill(dc_U, dc_U + 16, 1);
    std::fill(ac_K, ac_K + 16, 5);
  }

  int u8() {
    if (pos >= len) fail("truncated file");
    return data[pos++];
  }
  int u16() {
    int a = u8();
    return (a << 8) | u8();
  }

  void read_dqt(int64_t end) {
    while (pos < end) {
      int pq_tq = u8();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3) fail("bad quantization table id " + std::to_string(tq));
      for (int k = 0; k < 64; ++k) {
        quant[tq][kNatural[k]] = static_cast<uint16_t>(pq ? u16() : u8());
      }
      have_quant[tq] = true;
    }
  }

  void read_dht(int64_t end) {
    while (pos < end) {
      int tc_th = u8();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("bad Huffman table id");
      uint8_t bits[17] = {0};
      int count = 0;
      for (int l = 1; l <= 16; ++l) {
        bits[l] = static_cast<uint8_t>(u8());
        count += bits[l];
      }
      if (count > 256) fail("bad Huffman table");
      uint8_t vals[256];
      for (int i = 0; i < count; ++i) vals[i] = static_cast<uint8_t>(u8());
      build_huffman(tc ? ac[th] : dc[th], bits, vals, count);
    }
  }

  // jdmarker.c get_dac: L and U of a DC table, Kx of an AC table.
  void read_dac(int64_t end) {
    while (pos + 1 < end) {
      const int index = u8(), val = u8();
      if (index >= 32) {
        fail("bad arithmetic table index " + std::to_string(index));
      }
      if (index >= 16) {
        ac_K[index - 16] = static_cast<uint8_t>(val);
      } else {
        dc_L[index] = static_cast<uint8_t>(val & 15);
        dc_U[index] = static_cast<uint8_t>(val >> 4);
        if (dc_L[index] > dc_U[index]) fail("bad arithmetic DC conditioning");
      }
    }
    if (pos != end) fail("bad DAC marker length");
  }

  void read_sof(int marker) {
    if (have_frame) fail("more than one frame");
    progressive = marker == 0xC2 || marker == 0xCA;
    arith = marker == 0xC9 || marker == 0xCA;
    lossless = marker == 0xC3;
    int precision = u8();
    if (precision != 8) {
      fail(std::to_string(precision) + "-bit samples are not decoded");
    }
    height = u16();
    width = u16();
    ncomp = u8();
    if (height == 0) fail("a height of 0 (DNL marker) is not decoded");
    if (width == 0) fail("a width of 0");
    if (ncomp != 1 && ncomp != 3 && ncomp != 4) {
      fail(std::to_string(ncomp) + " components are not decoded");
    }
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) {
        fail("bad component sampling or table");
      }
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    for (int i = 0; i < ncomp; ++i) {
      if (hmax % comp[i].h || vmax % comp[i].v) {   // jdsample.c refuses
        std::string f;
        for (int j = 0; j < ncomp; ++j) {
          f += (j ? "," : "") + std::to_string(comp[j].h) + "x" +
               std::to_string(comp[j].v);
        }
        fail("sampling " + f + " (a fractional ratio) is not decoded");
      }
    }
    const int block = lossless ? 1 : 8;   // a lossless "block" is a sample
    const int mcux = (width + block * hmax - 1) / (block * hmax);
    const int mcuy = (height + block * vmax - 1) / (block * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.down_w = (width * c.h + hmax - 1) / hmax;
      c.down_h = (height * c.v + vmax - 1) / vmax;
      c.blocks_w = (c.down_w + block - 1) / block;
      c.blocks_h = (c.down_h + block - 1) / block;
      c.plane_w = std::max(mcux * c.h, c.blocks_w) * block;
      c.plane_h = std::max(mcuy * c.v, c.blocks_h) * block;
    }
    have_frame = true;
  }

  // jdhuff.c decode_mcu, for one block of zeroed coefficients.
  void decode_block(BitReader& br, Component& c, int16_t* coef) {
    const Huffman& hd = dc[c.td];
    const Huffman& ha = ac[c.ta];
    int s = br.decode(hd);
    if (s > 15) fail("corrupt JPEG data: DC category " + std::to_string(s));
    int diff = s ? extend(br.get(s), s) : 0;
    c.dc_pred += diff;
    coef[0] = static_cast<int16_t>(c.dc_pred);
    for (int k = 1; k < 64; ++k) {
      int rs = br.decode(ha);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        coef[kNatural[k]] = static_cast<int16_t>(extend(br.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  // jdphuff.c decode_mcu_DC_first, for one block.
  void dc_first(BitReader& br, Component& c, int16_t* coef, int al) {
    int s = br.decode(dc[c.td]);
    if (s > 15) fail("corrupt JPEG data: DC category " + std::to_string(s));
    int diff = s ? extend(br.get(s), s) : 0;
    c.dc_pred += diff;
    coef[0] = static_cast<int16_t>(static_cast<unsigned>(c.dc_pred) << al);
  }

  // decode_mcu_DC_refine: the next bit of the two's-complement DC value.
  static void dc_refine(BitReader& br, int16_t* coef, int al) {
    if (br.get(1)) coef[0] = static_cast<int16_t>(coef[0] | (1 << al));
  }

  // decode_mcu_AC_first: one block of the band ss..se; an EOB run spans
  // blocks.
  void ac_first(BitReader& br, const Component& c, int16_t* coef, int ss,
                int se, int al) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    const Huffman& ha = ac[c.ta];
    for (int k = ss; k <= se; ++k) {
      int rs = br.decode(ha);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        coef[kNatural[k]] = static_cast<int16_t>(
            static_cast<unsigned>(extend(br.get(s), s)) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = (1 << r) + (r ? br.get(r) : 0) - 1;
        break;
      }
    }
  }

  // decode_mcu_AC_refine: correction bits for the nonzero coefficients of
  // the band, newly nonzero ones of magnitude 1 << al.
  void ac_refine(BitReader& br, const Component& c, int16_t* coef, int ss,
                 int se, int al) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    auto correct = [&](int16_t& v) {
      if (br.get(1) && (v & p1) == 0) {
        v = static_cast<int16_t>(v >= 0 ? v + p1 : v + m1);
      }
    };
    int k = ss;
    if (eobrun == 0) {
      const Huffman& ha = ac[c.ta];
      for (; k <= se; ++k) {
        int rs = br.decode(ha);
        int r = rs >> 4, s = rs & 15;
        if (s) {   // libjpeg warns when s != 1 and goes on as here
          s = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = (1 << r) + (r ? br.get(r) : 0);
          break;
        }
        do {
          int16_t& v = coef[kNatural[k]];
          if (v != 0) {
            correct(v);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) coef[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t& v = coef[kNatural[k]];
        if (v != 0) correct(v);
      }
      --eobrun;
    }
  }

  // ---- arithmetic decoding (jdarith.c); libjpeg's JWRN_ARITH_BAD_CODE
  // (a magnitude or a run past its limit) is refused here.

  [[noreturn]] static void bad_arith_code() {
    fail("corrupt JPEG data: bad arithmetic code");
  }

  // Figures F.23-F.24: a nonzero value's magnitude, |v|. The category's
  // first decision is at st (AC: its first two), its further ones from x1;
  // m is the category's top bit, which conditions the next DC.
  static int arith_magnitude(ArithDecoder& ad, uint8_t* st, uint8_t* x1,
                             bool ac, int* top = nullptr) {
    int m = ad.decode(st);
    if (m && (!ac || ad.decode(st))) {
      if (ac) m <<= 1;
      st = x1;
      while (ad.decode(st)) {
        if ((m <<= 1) == 0x8000) bad_arith_code();
        ++st;
      }
    }
    if (top) *top = m;
    int v = m;
    st += 14;
    while (m >>= 1) {
      if (ad.decode(st)) v |= m;
    }
    return v + 1;
  }

  // decode_mcu's DC part: the DC difference in context c.dc_context, the
  // context of the next one from its category (L, U of the table).
  void arith_dc(ArithDecoder& ad, Component& c) {
    uint8_t* base = dc_stats[c.td];
    uint8_t* st = base + c.dc_context;
    if (ad.decode(st) == 0) {
      c.dc_context = 0;
      return;
    }
    const int sign = ad.decode(st + 1);
    st += 2 + sign;
    int top;
    int v = arith_magnitude(ad, st, base + 20, false, &top);
    if (top < ((1 << dc_L[c.td]) >> 1)) {
      c.dc_context = 0;
    } else if (top > ((1 << dc_U[c.td]) >> 1)) {
      c.dc_context = 12 + sign * 4;
    } else {
      c.dc_context = 4 + sign * 4;
    }
    if (sign) v = -v;
    c.dc_pred = (c.dc_pred + v) & 0xFFFF;
  }

  // The AC values ss..se of one block (Figure F.20), each shifted by al.
  void arith_ac(ArithDecoder& ad, const Component& c, int16_t* coef, int ss,
                int se, int al) {
    uint8_t* base = ac_stats[c.ta];
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = base + 3 * (k - 1);
      if (ad.decode(st)) break;   // EOB
      while (ad.decode(st + 1) == 0) {
        st += 3;
        if (++k > se) bad_arith_code();
      }
      const int sign = ad.decode(&fixed_bin);
      st += 2;
      int v = arith_magnitude(ad, st, base + (k <= ac_K[c.ta] ? 189 : 217),
                              true);
      if (sign) v = -v;
      coef[kNatural[k]] =
          static_cast<int16_t>(static_cast<unsigned>(v) << al);
    }
  }

  // decode_mcu: one sequential block of zeroed coefficients.
  void arith_block(ArithDecoder& ad, Component& c, int16_t* coef) {
    arith_dc(ad, c);
    coef[0] = static_cast<int16_t>(c.dc_pred);
    arith_ac(ad, c, coef, 1, 63, 0);
  }

  // decode_mcu_DC_first, for one block.
  void arith_dc_first(ArithDecoder& ad, Component& c, int16_t* coef, int al) {
    arith_dc(ad, c);
    coef[0] = static_cast<int16_t>(static_cast<unsigned>(c.dc_pred) << al);
  }

  // decode_mcu_DC_refine: the next bit of the DC value, at the fixed 0.5.
  void arith_dc_refine(ArithDecoder& ad, int16_t* coef, int al) {
    if (ad.decode(&fixed_bin)) {
      coef[0] = static_cast<int16_t>(coef[0] | (1 << al));
    }
  }

  // decode_mcu_AC_refine: past the previous stage's end of block (EOBx) an
  // EOB decision; a nonzero coefficient gets its correction bit, a zero one
  // may become +-(1 << al).
  void arith_ac_refine(ArithDecoder& ad, const Component& c, int16_t* coef,
                       int ss, int se, int al) {
    uint8_t* base = ac_stats[c.ta];
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int kex = se;
    for (; kex > 0; --kex) {
      if (coef[kNatural[kex]]) break;
    }
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = base + 3 * (k - 1);
      if (k > kex && ad.decode(st)) break;   // EOB
      for (;;) {
        int16_t& v = coef[kNatural[k]];
        if (v) {
          if (ad.decode(st + 2)) {
            v = static_cast<int16_t>(v < 0 ? v + m1 : v + p1);
          }
          break;
        }
        if (ad.decode(st + 1)) {
          v = static_cast<int16_t>(ad.decode(&fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) bad_arith_code();
      }
    }
  }

  // start_pass and process_restart: the statistics of the tables the scan
  // uses start over, and the DC predictions and contexts with them.
  void reset_arith(Component* const* sc, int ns, int ss, int ah) {
    for (int i = 0; i < ns; ++i) {
      Component& c = *sc[i];
      if (!progressive || (ss == 0 && ah == 0)) {
        std::memset(dc_stats[c.td], 0, sizeof(dc_stats[0]));
        c.dc_pred = 0;
        c.dc_context = 0;
      }
      if (!progressive || ss) {
        std::memset(ac_stats[c.ta], 0, sizeof(ac_stats[0]));
      }
    }
  }

  // A restart's marker must be RSTn, n counting 0-7 in turn.
  static void expect_restart(int marker, int& next_rst) {
    if (marker != 0xD0 + next_rst) {
      fail("corrupt JPEG data: expected RST" + std::to_string(next_rst));
    }
    next_rst = (next_rst + 1) & 7;
  }

  // ---- lossless Huffman decoding (jdlhuff.c, jddiffct.c, jdlossls.c)

  // One difference: SSSS from the component's DC table, 16 meaning 32768.
  int lossless_diff(BitReader& br, const Component& c) {
    const int s = br.decode(dc[c.td]);
    if (s == 0) return 0;
    if (s == 16) return 32768;
    if (s > 16) {
      fail("corrupt JPEG data: difference category " + std::to_string(s));
    }
    return extend(br.get(s), s);
  }

  // A scan of predictor psv (1-7) and point transform pt. As jddiffct.c
  // decompress_data: each iMCU row (an MCU row of an interleaved scan, v
  // rows of a lone component) is decoded, restarts met on the way, then
  // undifferenced row by row; a restart makes the next row undifferenced
  // a first row (jdlossls.c start_pass_lossless), so in a lone component
  // of v = 2 a restart between its two rows reaches back to the first.
  void lossless_scan(Component* const* sc, int ns, int psv, int pt) {
    const bool inter = ns > 1;
    const int mcus_w = inter ? (width + hmax - 1) / hmax : sc[0]->down_w;
    if (restart_interval % mcus_w) {
      fail("a restart interval of " + std::to_string(restart_interval) +
           " is not a whole number of MCU rows of " +
           std::to_string(mcus_w));
    }
    const int restart_rows = restart_interval / mcus_w;
    const int imcu_rows = (height + vmax - 1) / vmax;
    std::vector<int32_t> diff[4], prev[4], cur[4];
    bool first[4];
    for (int i = 0; i < ns; ++i) {
      Component& c = *sc[i];
      const int w = inter ? mcus_w * c.h : c.down_w;
      diff[i].assign(static_cast<size_t>(w) * c.v, 0);
      prev[i].assign(static_cast<size_t>(c.down_w), 0);
      cur[i].assign(static_cast<size_t>(c.down_w), 0);
      first[i] = true;
    }
    const int initial = 1 << (8 - pt - 1);
    BitReader br{data, len, pos};
    int to_go = restart_rows, next_rst = 0;
    for (int g = 0; g < imcu_rows; ++g) {
      const bool last = g == imcu_rows - 1;
      auto rows_of = [&](const Component& c) {
        const int r = c.down_h % c.v;
        return last && r ? r : c.v;
      };
      const int mcu_rows = inter ? 1 : rows_of(*sc[0]);
      for (int yo = 0; yo < mcu_rows; ++yo) {
        if (restart_interval) {
          if (to_go == 0) {
            expect_restart(br.next_marker(), next_rst);
            std::fill(first, first + ns, true);
            to_go = restart_rows;
          }
          --to_go;
        }
        for (int mx = 0; mx < mcus_w; ++mx) {
          if (!inter) {
            diff[0][static_cast<size_t>(yo) * mcus_w + mx] =
                lossless_diff(br, *sc[0]);
            continue;
          }
          for (int i = 0; i < ns; ++i) {
            const Component& c = *sc[i];
            const size_t w = static_cast<size_t>(mcus_w) * c.h;
            for (int v = 0; v < c.v; ++v) {
              for (int h = 0; h < c.h; ++h) {
                diff[i][v * w + mx * c.h + h] = lossless_diff(br, c);
              }
            }
          }
        }
      }
      for (int i = 0; i < ns; ++i) {
        Component& c = *sc[i];
        const int w = c.down_w;
        const size_t dw = inter ? static_cast<size_t>(mcus_w) * c.h : w;
        for (int row = 0; row < rows_of(c); ++row) {
          const int32_t* d = diff[i].data() + row * dw;
          int32_t* o = cur[i].data();
          const int32_t* up = prev[i].data();
          if (first[i]) {   // jpeg_undifference_first_row
            o[0] = (d[0] + initial) & 0xFFFF;
            for (int x = 1; x < w; ++x) o[x] = (d[x] + o[x - 1]) & 0xFFFF;
            first[i] = false;
          } else {
            o[0] = (d[0] + up[0]) & 0xFFFF;
            for (int x = 1; x < w; ++x) {
              const int ra = o[x - 1], rb = up[x], rc = up[x - 1];
              int px;
              switch (psv) {
                case 1: px = ra; break;
                case 2: px = rb; break;
                case 3: px = rc; break;
                case 4: px = ra + rb - rc; break;
                case 5: px = ra + ((rb - rc) >> 1); break;
                case 6: px = rb + ((ra - rc) >> 1); break;
                default: px = (ra + rb) >> 1; break;
              }
              o[x] = (d[x] + px) & 0xFFFF;
            }
          }
          uint8_t* out = c.plane.data() +
                         static_cast<size_t>(g * c.v + row) * c.plane_w;
          for (int x = 0; x < w; ++x) {
            out[x] = static_cast<uint8_t>(o[x] << pt);
          }
          prev[i].swap(cur[i]);
        }
      }
    }
    br.next_marker();
    pos = br.pos - 2;
  }

  // jdphuff.c start_pass_phuff_decoder's checks, which libjpeg partly only
  // warns about; a progression it would warn about is refused here.
  void check_progressive_scan(Component* const* sc, int ns, int ss, int se,
                              int ah, int al) {
    bool bad = ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1);
    if ((ah != 0 && al != ah - 1) || al > 13) bad = true;
    if (bad) fail("bad progressive scan parameters");
    for (int i = 0; i < ns; ++i) {
      int* bits = sc[i]->coef_bits;
      if (ss != 0 && bits[0] < 0) fail("an AC scan before the DC scan");
      for (int k = ss; k <= se; ++k) {
        if (ah != (bits[k] < 0 ? 0 : bits[k])) {
          fail("a progressive scan out of order");
        }
        bits[k] = al;
      }
    }
  }

  void read_sos() {
    if (!have_frame) fail("scan before frame header");
    int ns = u8();
    if (ns < 1 || ns > ncomp) fail("bad scan header");
    Component* sc[4];
    int tables[4];
    for (int i = 0; i < ns; ++i) {
      int cid = u8();
      tables[i] = u8();
      Component* found = nullptr;
      for (int j = 0; j < ncomp; ++j) {
        if (comp[j].id == cid) found = &comp[j];
      }
      if (!found) fail("scan names an unknown component");
      for (int j = 0; j < i; ++j) {
        if (sc[j] == found) fail("a scan names a component twice");
      }
      sc[i] = found;
    }
    const int ss = u8(), se = u8(), ahl = u8();
    const int ah = ahl >> 4, al = ahl & 15;
    if (ns > 1) {
      int blocks = 0;
      for (int i = 0; i < ns; ++i) blocks += sc[i]->h * sc[i]->v;
      if (blocks > 10) fail("more than 10 blocks in an MCU");
    }
    if (lossless) {   // jdlossls.c start_pass_lossless
      if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= 8) {
        fail("bad lossless scan parameters");
      }
    } else if (progressive) {
      check_progressive_scan(sc, ns, ss, se, ah, al);
    } else if (ss != 0 || se != 63 || ahl != 0) {
      fail("bad sequential scan header");
    }
    for (int i = 0; i < ns; ++i) {
      Component& c = *sc[i];
      if (!progressive && c.decoded) fail("a component is coded in two scans");
      c.td = tables[i] >> 4;
      c.ta = tables[i] & 15;
      const bool need_dc = !progressive || (ss == 0 && ah == 0);
      const bool need_ac = !lossless && (!progressive || ss > 0);
      if (!arith &&
          (c.td > 3 || c.ta > 3 || (need_dc && !dc[c.td].defined) ||
           (need_ac && !ac[c.ta].defined))) {
        fail("scan uses an undefined Huffman table");
      }
      if (!lossless && !c.quant_latched) {   // jddctmgr.c latch_quant_tables
        if (!have_quant[c.tq]) {
          fail("component uses an undefined quantization table");
        }
        for (int k = 0; k < 64; ++k) {
          c.quant[k] = static_cast<int16_t>(quant[c.tq][k]);
        }
        c.quant_latched = progressive;
      }
      c.dc_pred = 0;
      if (progressive && c.coefs.empty()) {
        c.coefs.assign(static_cast<size_t>(c.plane_w) * c.plane_h, 0);
      } else if (!progressive && c.plane.empty()) {
        c.plane.assign(static_cast<size_t>(c.plane_w) * c.plane_h, 0);
      }
    }
    eobrun = 0;
    if (lossless) {
      lossless_scan(sc, ns, ss, al);
      for (int i = 0; i < ns; ++i) sc[i]->decoded = true;
      return;
    }
    if (arith) reset_arith(sc, ns, ss, ah);

    BitReader br{data, len, pos};
    ArithDecoder ad{data, len, pos};
    int16_t coef[64];
    auto block = [&](Component& c, int bx, int by) {
      if (!progressive) {
        std::memset(coef, 0, sizeof(coef));
        if (arith) {
          arith_block(ad, c, coef);
        } else {
          decode_block(br, c, coef);
        }
        idct_islow(coef, c.quant,
                   c.plane.data() + static_cast<size_t>(by) * 8 * c.plane_w +
                       bx * 8,
                   c.plane_w);
        return;
      }
      int16_t* co =
          c.coefs.data() +
          (static_cast<size_t>(by) * (c.plane_w / 8) + bx) * 64;
      if (ss == 0) {
        if (ah != 0) {
          arith ? arith_dc_refine(ad, co, al) : dc_refine(br, co, al);
        } else if (arith) {
          arith_dc_first(ad, c, co, al);
        } else {
          dc_first(br, c, co, al);
        }
      } else if (ah == 0) {
        arith ? arith_ac(ad, c, co, ss, se, al)
              : ac_first(br, c, co, ss, se, al);
      } else {
        arith ? arith_ac_refine(ad, c, co, ss, se, al)
              : ac_refine(br, c, co, ss, se, al);
      }
    };
    int mcus_w, mcus_h;
    if (ns == 1) {
      mcus_w = sc[0]->blocks_w;
      mcus_h = sc[0]->blocks_h;
    } else {
      mcus_w = (width + 8 * hmax - 1) / (8 * hmax);
      mcus_h = (height + 8 * vmax - 1) / (8 * vmax);
    }
    const int64_t total = static_cast<int64_t>(mcus_w) * mcus_h;
    int next_rst = 0;
    for (int64_t m = 0; m < total; ++m) {
      if (restart_interval && m > 0 && m % restart_interval == 0) {
        expect_restart(arith ? ad.next_marker() : br.next_marker(), next_rst);
        for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
        eobrun = 0;
        if (arith) reset_arith(sc, ns, ss, ah);
      }
      const int mx = static_cast<int>(m % mcus_w);
      const int my = static_cast<int>(m / mcus_w);
      if (ns == 1) {
        block(*sc[0], mx, my);
      } else {
        for (int i = 0; i < ns; ++i) {
          Component& c = *sc[i];
          for (int v = 0; v < c.v; ++v) {
            for (int h = 0; h < c.h; ++h) {
              block(c, mx * c.h + h, my * c.v + v);
            }
          }
        }
      }
    }
    for (int i = 0; i < ns; ++i) sc[i]->decoded = true;
    // step back onto the marker that ends the scan
    if (arith) {
      pos = ad.scan_end();
    } else {
      br.next_marker();
      pos = br.pos - 2;
    }
  }

  // jdcoefct.c smoothing_ok: block smoothing runs when every component's
  // DC is at least partly known, its DC and first nine AC quantizers are
  // nonzero, and one of the first ten coefficients of some component still
  // lacks bits.
  bool smoothing_ok() const {
    bool useful = false;
    for (int i = 0; i < ncomp; ++i) {
      const Component& c = comp[i];
      for (int k = 0; k < kSavedCoefs; ++k) {
        if (c.quant[kNatural[k]] == 0) return false;
      }
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < kSavedCoefs; ++k) {
        if (c.coef_bits[k] != 0) useful = true;
      }
    }
    return useful;
  }

  // jdcoefct.c decompress_smooth_data (libjpeg-turbo 2.1 and later) for one
  // component: each block's still-zero AC coefficients among the first nine
  // are estimated from the DC values of its 5x5 neighbourhood of blocks,
  // each estimate clamped below 1 << Al of the bits not yet coded; when no
  // AC scan came at all the DC is smoothed too and AC03-AC30 are estimated
  // (the 5x5 kernels). Rows and columns past the component's edge repeat
  // the edge's DC values, and the row test runs on libjpeg's iMCU-row
  // arithmetic, which in the last iMCU row counts fewer block rows.
  void idct_smoothed(Component& c) {
    const int v = c.v;
    const int bw = c.plane_w / 8;
    const int total = (height + 8 * vmax - 1) / (8 * vmax);
    const int* bits = c.coef_bits;
    bool change_dc = true;
    for (int k = 1; k < kSavedCoefs; ++k) change_dc &= bits[k] == -1;
    const int64_t Q00 = c.quant[0], Q01 = c.quant[1], Q10 = c.quant[8],
                  Q20 = c.quant[16], Q11 = c.quant[9], Q02 = c.quant[2],
                  Q03 = c.quant[3], Q12 = c.quant[10], Q21 = c.quant[17],
                  Q30 = c.quant[24];
    auto predict = [](int64_t num, int64_t q, int al) {
      int pred = static_cast<int>(((q << 7) + (num >= 0 ? num : -num)) /
                                  (q << 8));
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      return num >= 0 ? pred : -pred;
    };
    auto row_of = [&](int r) {
      return c.coefs.data() + static_cast<size_t>(r) * bw * 64;
    };
    const int last_col = c.blocks_w - 1;
    int16_t ws[64];
    for (int imcu = 0; imcu < total; ++imcu) {
      int block_rows = v;
      if (imcu == total - 1) {
        block_rows = c.blocks_h % v;
        if (block_rows == 0) block_rows = v;
      }
      const int image_block_rows = block_rows * total;
      for (int br = 0; br < block_rows; ++br) {
        const int ibr = imcu * block_rows + br;
        const int r = imcu * v + br;
        const int16_t* cur = row_of(r);
        const int16_t* prev = ibr > 0 ? row_of(r - 1) : cur;
        const int16_t* pprev = ibr > 1 ? row_of(r - 2) : prev;
        const int16_t* next = ibr < image_block_rows - 1 ? row_of(r + 1) : cur;
        const int16_t* nnext =
            ibr < image_block_rows - 2 ? row_of(r + 2) : next;
        int DC01, DC02, DC03, DC04, DC05, DC06, DC07, DC08, DC09, DC10;
        int DC11, DC12, DC13, DC14, DC15, DC16, DC17, DC18, DC19, DC20;
        int DC21, DC22, DC23, DC24, DC25;
        DC01 = DC02 = DC03 = DC04 = DC05 = pprev[0];
        DC06 = DC07 = DC08 = DC09 = DC10 = prev[0];
        DC11 = DC12 = DC13 = DC14 = DC15 = cur[0];
        DC16 = DC17 = DC18 = DC19 = DC20 = next[0];
        DC21 = DC22 = DC23 = DC24 = DC25 = nnext[0];
        for (int bn = 0; bn <= last_col; ++bn) {
          const size_t o = static_cast<size_t>(bn) * 64;
          std::memcpy(ws, cur + o, sizeof(ws));
          if (bn == 0 && bn < last_col) {
            DC04 = DC05 = pprev[o + 64];
            DC09 = DC10 = prev[o + 64];
            DC14 = DC15 = cur[o + 64];
            DC19 = DC20 = next[o + 64];
            DC24 = DC25 = nnext[o + 64];
          }
          if (bn + 1 < last_col) {
            DC05 = pprev[o + 128];
            DC10 = prev[o + 128];
            DC15 = cur[o + 128];
            DC20 = next[o + 128];
            DC25 = nnext[o + 128];
          }
          int al;
          if ((al = bits[1]) != 0 && ws[1] == 0) {   // AC01
            const int64_t num = Q00 * (change_dc ?
                (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 -
                 13 * DC09 + 3 * DC10 - 3 * DC11 + 38 * DC12 - 38 * DC14 +
                 3 * DC15 - 3 * DC16 + 13 * DC17 - 13 * DC19 + 3 * DC20 -
                 DC21 - DC22 + DC24 + DC25) :
                (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15));
            ws[1] = static_cast<int16_t>(predict(num, Q01, al));
          }
          if ((al = bits[2]) != 0 && ws[8] == 0) {   // AC10
            const int64_t num = Q00 * (change_dc ?
                (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 +
                 13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 + DC16 -
                 13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 +
                 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25) :
                (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23));
            ws[8] = static_cast<int16_t>(predict(num, Q10, al));
          }
          if ((al = bits[3]) != 0 && ws[16] == 0) {  // AC20
            const int64_t num = Q00 * (change_dc ?
                (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 -
                 14 * DC13 - 5 * DC14 + 2 * DC17 + 7 * DC18 + 2 * DC19 +
                 DC23) :
                (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23));
            ws[16] = static_cast<int16_t>(predict(num, Q20, al));
          }
          if ((al = bits[4]) != 0 && ws[9] == 0) {   // AC11
            const int64_t num = Q00 * (change_dc ?
                (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 +
                 DC21 - DC25) :
                (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 -
                 DC24 + DC04 - DC06 + 10 * DC07 - 10 * DC09));
            ws[9] = static_cast<int16_t>(predict(num, Q11, al));
          }
          if ((al = bits[5]) != 0 && ws[2] == 0) {   // AC02
            const int64_t num = Q00 * (change_dc ?
                (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 -
                 14 * DC13 + 7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 +
                 2 * DC19) :
                (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15));
            ws[2] = static_cast<int16_t>(predict(num, Q02, al));
          }
          if (change_dc) {
            if ((al = bits[6]) != 0 && ws[3] == 0) {   // AC03
              const int64_t num =
                  Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19);
              ws[3] = static_cast<int16_t>(predict(num, Q03, al));
            }
            if ((al = bits[7]) != 0 && ws[10] == 0) {  // AC12
              const int64_t num =
                  Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19);
              ws[10] = static_cast<int16_t>(predict(num, Q12, al));
            }
            if ((al = bits[8]) != 0 && ws[17] == 0) {  // AC21
              const int64_t num =
                  Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19);
              ws[17] = static_cast<int16_t>(predict(num, Q21, al));
            }
            if ((al = bits[9]) != 0 && ws[24] == 0) {  // AC30
              const int64_t num =
                  Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19);
              ws[24] = static_cast<int16_t>(predict(num, Q30, al));
            }
            // the DC itself, a weighted mean of the 25 (weights sum to 256)
            const int64_t num = Q00 *
                (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 -
                 6 * DC06 + 6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 -
                 8 * DC11 + 42 * DC12 + 152 * DC13 + 42 * DC14 - 8 * DC15 -
                 6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 -
                 2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25);
            ws[0] = static_cast<int16_t>(predict(num, Q00, 0));
          }
          idct_islow(ws, c.quant,
                     c.plane.data() + static_cast<size_t>(r) * 8 * c.plane_w +
                         bn * 8,
                     c.plane_w);
          DC01 = DC02; DC02 = DC03; DC03 = DC04; DC04 = DC05;
          DC06 = DC07; DC07 = DC08; DC08 = DC09; DC09 = DC10;
          DC11 = DC12; DC12 = DC13; DC13 = DC14; DC14 = DC15;
          DC16 = DC17; DC17 = DC18; DC18 = DC19; DC19 = DC20;
          DC21 = DC22; DC22 = DC23; DC23 = DC24; DC24 = DC25;
        }
      }
    }
  }

  // After the last scan of a progressive file: the inverse DCT of every
  // block of the image (jdcoefct.c decompress_data), or block smoothing
  // (decompress_smooth_data) where smoothing_ok says so.
  void transform_progressive() {
    const bool smooth = smoothing_ok();
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.plane.assign(static_cast<size_t>(c.plane_w) * c.plane_h, 0);
      if (smooth) {
        idct_smoothed(c);
      } else {
        for (int by = 0; by < c.blocks_h; ++by) {
          for (int bx = 0; bx < c.blocks_w; ++bx) {
            idct_islow(
                c.coefs.data() +
                    (static_cast<size_t>(by) * (c.plane_w / 8) + bx) * 64,
                c.quant,
                c.plane.data() + static_cast<size_t>(by) * 8 * c.plane_w +
                    bx * 8,
                c.plane_w);
          }
        }
      }
      std::vector<int16_t>().swap(c.coefs);
    }
  }

  void parse(bool header_only) {
    if (len < 2 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG");
    pos = 2;
    for (;;) {
      if (pos >= len) fail("truncated file: no end-of-image marker");
      if (data[pos] != 0xFF) {
        // garbage between markers: libjpeg skips it with a warning
        while (pos < len && data[pos] != 0xFF) ++pos;
        continue;
      }
      while (pos < len && data[pos] == 0xFF) ++pos;
      int marker = u8();
      if (marker == 0xD9) break;                     // EOI
      if (marker >= 0xD0 && marker <= 0xD7) continue; // stray RST
      if (marker == 0x01) continue;                  // TEM
      int64_t seg_len = u16();
      if (seg_len < 2) fail("bad marker length");
      int64_t end = pos + seg_len - 2;
      if (end > len) fail("truncated file in a marker segment");
      switch (marker) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
        case 0xC3:
        case 0xC9:
        case 0xCA:
          read_sof(marker);
          if (header_only) return;
          break;
        case 0xCB:   // libjpeg-turbo: "arithmetic coding is not implemented"
          fail("lossless arithmetic-coded JPEG is not decoded");
        case 0xC5:
        case 0xC6:
        case 0xC7:
        case 0xCD:
        case 0xCE:
        case 0xCF:
          fail("hierarchical JPEG is not decoded");
        case 0xCC:
          read_dac(end);
          break;
        case 0xC4:
          read_dht(end);
          break;
        case 0xDB:
          read_dqt(end);
          break;
        case 0xDD:
          restart_interval = u16();
          break;
        case 0xDC:
          fail("a DNL marker is not decoded");
        case 0xDA:
          read_sos();
          continue;   // pos is on the next marker
        case 0xE0:
          if (seg_len >= 16 && std::memcmp(data + pos, "JFIF\0", 5) == 0) {
            saw_jfif = true;
          }
          break;
        case 0xEE:
          if (seg_len >= 14 && std::memcmp(data + pos, "Adobe", 5) == 0) {
            saw_adobe = true;
            adobe_transform = data[pos + 11];
          }
          break;
        default:
          break;   // APPn, COM and others: skipped
      }
      pos = end;
    }
    if (!have_frame) fail("no frame header");
    for (int i = 0; i < ncomp; ++i) {
      if (!comp[i].decoded || (progressive && comp[i].coef_bits[0] < 0)) {
        fail("a component has no scan");
      }
    }
    if (progressive) transform_progressive();
    const Space space = colour_space();
    if (lossless && (space == Space::kYcc || space == Space::kYcck)) {
      fail(std::string("lossless JPEG in ") +
           (space == Space::kYcc ? "YCbCr" : "YCCK") +
           " is not decoded (libjpeg-turbo converts no colours in lossless "
           "mode)");
    }
  }

  // jdapimin.c default_decompress_parms
  enum class Space { kGray, kRgb, kYcc, kCmyk, kYcck };
  Space colour_space() const {
    if (ncomp == 1) return Space::kGray;
    if (ncomp == 4) {
      return saw_adobe && adobe_transform != 0 ? Space::kYcck : Space::kCmyk;
    }
    if (saw_jfif) return Space::kYcc;
    if (saw_adobe) return adobe_transform == 0 ? Space::kRgb : Space::kYcc;
    if (lossless) return Space::kRgb;
    const bool rgb_ids =
        comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66;
    return rgb_ids ? Space::kRgb : Space::kYcc;
  }

  // jdsample.c: the plane of c upsampled to the image's size.
  void upsample(const Component& c, uint8_t* out) const {
    const int rh = hmax / c.h, rv = vmax / c.v;
    const int dw = c.down_w, dh = c.down_h;
    const uint8_t* p = c.plane.data();
    const int pw = c.plane_w;
    const bool fancy = !lossless;   // do_fancy needs a DCT size above 1
    if (rh == 1 && rv == 1) {   // fullsize_upsample
      for (int y = 0; y < height; ++y) {
        std::memcpy(out + static_cast<size_t>(y) * width, p + y * pw,
                    static_cast<size_t>(width));
      }
      return;
    }
    if (fancy && rh == 1 && rv == 2) {   // h1v2_fancy_upsample
      for (int y = 0; y < height; ++y) {
        int near_row = y >> 1;
        int far_row = (y & 1) ? near_row + 1 : near_row - 1;
        far_row = std::min(std::max(far_row, 0), dh - 1);
        const int bias = (y & 1) ? 2 : 1;
        const uint8_t* in0 = p + near_row * pw;
        const uint8_t* in1 = p + far_row * pw;
        uint8_t* o = out + static_cast<size_t>(y) * width;
        for (int x = 0; x < width; ++x) {
          o[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
        }
      }
      return;
    }
    if (!fancy || rh != 2 || rv > 2 || dw <= 2) {
      // h2v1_upsample / h2v2_upsample at two columns or fewer, and
      // int_upsample for every other factor: replication
      for (int y = 0; y < height; ++y) {
        const uint8_t* row = p + (y / rv) * pw;
        uint8_t* o = out + static_cast<size_t>(y) * width;
        for (int x = 0; x < width; ++x) o[x] = row[x / rh];
      }
      return;
    }
    std::vector<int> colsum(static_cast<size_t>(dw));
    for (int y = 0; y < height; ++y) {
      uint8_t* o = out + static_cast<size_t>(y) * width;
      if (rv == 1) {   // h2v1_fancy_upsample
        const uint8_t* in = p + y * pw;
        for (int x = 0; x < width; ++x) {
          int i = x >> 1;
          int near3 = in[i] * 3;
          if (x & 1) {
            int nb = in[i + 1 < dw ? i + 1 : dw - 1];
            o[x] = static_cast<uint8_t>((near3 + nb + 2) >> 2);
          } else {
            int nb = in[i > 0 ? i - 1 : 0];
            o[x] = static_cast<uint8_t>((near3 + nb + 1) >> 2);
          }
        }
      } else {         // h2v2_fancy_upsample
        int near_row = y >> 1;
        int far_row = (y & 1) ? near_row + 1 : near_row - 1;
        far_row = std::min(std::max(far_row, 0), dh - 1);
        const uint8_t* in0 = p + near_row * pw;
        const uint8_t* in1 = p + far_row * pw;
        for (int i = 0; i < dw; ++i) colsum[i] = in0[i] * 3 + in1[i];
        for (int x = 0; x < width; ++x) {
          int i = x >> 1;
          int this3 = colsum[i] * 3;
          if (x & 1) {
            int nb = colsum[i + 1 < dw ? i + 1 : dw - 1];
            o[x] = static_cast<uint8_t>((this3 + nb + 7) >> 4);
          } else {
            int nb = colsum[i > 0 ? i - 1 : 0];
            o[x] = static_cast<uint8_t>((this3 + nb + 8) >> 4);
          }
        }
      }
    }
  }

  void to_rgb(uint8_t* out) const {
    const size_t n = static_cast<size_t>(width) * height;
    if (ncomp == 1) {
      const Component& c = comp[0];
      for (int y = 0; y < height; ++y) {
        const uint8_t* row =
            c.plane.data() + static_cast<size_t>(y) * c.plane_w;
        uint8_t* o = out + static_cast<size_t>(y) * width * 3;
        for (int x = 0; x < width; ++x) {
          o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = row[x];
        }
      }
      return;
    }
    std::vector<uint8_t> full(ncomp * n);
    for (int i = 0; i < ncomp; ++i) upsample(comp[i], full.data() + i * n);
    const uint8_t* c0 = full.data();
    const uint8_t* c1 = full.data() + n;
    const uint8_t* c2 = full.data() + 2 * n;
    const YccTables t;
    if (ncomp == 4) {
      // jdcolor.c: Adobe's transform 0 (or none) is CMYK as stored, any
      // other YCCK (ycck_cmyk_convert); then Pillow's "CMYK;I" (each sample
      // inverted) and cmyk2rgb: nk - nk * c / 255, with MULDIV255's
      // rounding, where nk = 255 - K read inverted, the stored K.
      const bool ycck = colour_space() == Space::kYcck;
      const uint8_t* c3 = full.data() + 3 * n;
      for (size_t k = 0; k < n; ++k) {
        int s0 = c0[k], s1 = c1[k], s2 = c2[k];
        if (ycck) {
          const int y = s0, cb = s1, cr = s2;
          s0 = clamp8(255 - (y + t.cr_r[cr]));
          s1 = clamp8(255 - (y + t.green(cb, cr)));
          s2 = clamp8(255 - (y + t.cb_b[cb]));
        }
        const int nk = c3[k];
        const int sv[3] = {s0, s1, s2};
        for (int ch = 0; ch < 3; ++ch) {
          const int tmp = (255 - sv[ch]) * nk + 128;
          out[3 * k + ch] = clamp8(nk - (((tmp >> 8) + tmp) >> 8));
        }
      }
      return;
    }
    if (colour_space() == Space::kRgb) {
      for (size_t k = 0; k < n; ++k) {
        out[3 * k] = c0[k];
        out[3 * k + 1] = c1[k];
        out[3 * k + 2] = c2[k];
      }
      return;
    }
    // jdcolor.c ycc_rgb_convert
    for (size_t k = 0; k < n; ++k) {
      int y = c0[k], cb = c1[k], cr = c2[k];
      out[3 * k] = clamp8(y + t.cr_r[cr]);
      out[3 * k + 1] = clamp8(y + t.green(cb, cr));
      out[3 * k + 2] = clamp8(y + t.cb_b[cb]);
    }
  }
};

}  // namespace

extern "C" {

// Unfilter `height` rows of `width` pixels of `bits` bits each from the
// inflated PNG stream `raw` into `out` (height * ceil(width * bits / 8)
// bytes, the rows as packed). 0 or -1 (err).
int afan_png_unfilter(const uint8_t* raw, int64_t raw_len, int32_t width,
                      int32_t height, int32_t bits, uint8_t* out, char* err,
                      int32_t err_len) {
  try {
    png_unfilter(raw, raw_len, width, height, bits, out);
    return 0;
  } catch (const DecodeError& e) {
    return report(e, err, err_len);
  }
}

// The frame header: info = {width, height, components}. 0 or -1 (err).
int afan_jpeg_header(const uint8_t* data, int64_t len, int32_t* info,
                     char* err, int32_t err_len) {
  try {
    Jpeg j;
    j.data = data;
    j.len = len;
    j.parse(true);
    if (!j.have_frame) fail("no frame header");
    info[0] = j.width;
    info[1] = j.height;
    info[2] = j.ncomp;
    return 0;
  } catch (const DecodeError& e) {
    return report(e, err, err_len);
  }
}

// Decode to RGB into `out` (height * width * 3 bytes, out_len checked).
int afan_jpeg_decode_rgb(const uint8_t* data, int64_t len, uint8_t* out,
                         int64_t out_len, char* err, int32_t err_len) {
  try {
    Jpeg j;
    j.data = data;
    j.len = len;
    j.parse(false);
    if (out_len != static_cast<int64_t>(j.width) * j.height * 3) {
      fail("output buffer of the wrong size");
    }
    j.to_rgb(out);
    return 0;
  } catch (const DecodeError& e) {
    return report(e, err, err_len);
  } catch (const std::bad_alloc&) {
    return report(DecodeError{"out of memory"}, err, err_len);
  }
}

}  // extern "C"
