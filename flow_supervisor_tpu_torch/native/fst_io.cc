// fst_io — the port's host decoders (counterpart of the repository's
// native/fst_io.cc), built by g++ at first use and bound with ctypes by
// flow_supervisor_tpu_torch/data/native.py.
//
// - Middlebury .flo: magic 202021.25f, [w, h] int32, interleaved (u, v) f32.
// - PPM P6 (FlyingChairs): maxval 255, RGB bytes -> float x / 255.0f, the
//   value numpy's float32 division (and cv2's read then / 255) gives.
// - PFM (FlyingThings): PF/Pf header, the scale's sign gives the byte
//   order, rows stored bottom-up.
// - The threaded batch readers of .flo and .ppm files.
// - Baseline JPEG: SOF0 / SOF1 with Huffman coding at 8 bits, 1 or 3
//   components, any integer sampling (fancy upsampling at 4:2:2, 4:2:0 and
//   4:4:0), restart markers, interleaved or per-component scans, images of
//   any size. The decode follows libjpeg-turbo (what cv2.imread uses)
//   sample for sample: the integer "islow" IDCT of jidctint.c with its
//   range-limit table, the triangular upsampling of jdsample.c over the
//   real (not padded) samples with edge rows and columns repeated, and the
//   16-bit fixed-point YCbCr -> RGB tables of jdcolor.c. A grey image comes
//   out as three equal channels. Progressive, lossless, hierarchical and
//   arithmetic-coded files, precisions other than 8 bits, 2- and
//   4-component (CMYK) images and truncated files are refused with a
//   message. EXIF orientation is not applied.
//
// Every entry returns 0 on success; the JPEG entries write a message into
// err on failure.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr float kFloMagic = 202021.25f;

// An open file, closed when it goes out of scope. The readers take each
// header from the stream and read the samples straight into their output,
// so a file's bytes are read once and copied at most once.
struct File {
  FILE* f;
  explicit File(const char* path) : f(std::fopen(path, "rb")) {}
  ~File() {
    if (f) std::fclose(f);
  }
  File(const File&) = delete;
  File& operator=(const File&) = delete;
  bool read(void* dst, size_t n) { return std::fread(dst, 1, n, f) == n; }
};

bool pnm_space(int ch) { return ch == ' ' || ch == '\t' || ch == '\r' || ch == '\n'; }

// Skips PNM whitespace and comments; returns the next int or -1. One
// whitespace byte after the number is consumed (the one that ends a P6
// header).
int pnm_next_int(FILE* f) {
  int ch = std::getc(f);
  for (;;) {
    if (ch == '#') {
      while (ch != EOF && ch != '\n') ch = std::getc(f);
    } else if (pnm_space(ch)) {
      ch = std::getc(f);
    } else {
      break;
    }
  }
  int v = 0;
  bool any = false;
  while (ch >= '0' && ch <= '9') {
    if (v > 100000000) return -1;
    v = v * 10 + (ch - '0');
    any = true;
    ch = std::getc(f);
  }
  if (ch != EOF && !pnm_space(ch)) std::ungetc(ch, f);
  return any ? v : -1;
}

// ---- JPEG ------------------------------------------------------------------

struct JpegError {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw JpegError{msg}; }

// zigzag index -> natural (row-major) index
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

constexpr int kLookBits = 9;

struct Huffman {
  bool present = false;
  int maxcode[18];      // largest code of each length, -1 if none
  int valoffset[17];    // symbol index of a code of each length, minus its value
  uint8_t vals[256];
  uint16_t look[1 << kLookBits];  // (length << 8) | symbol, 0 = longer code

  void build(const uint8_t* counts, const uint8_t* symbols, int nsym) {
    std::memcpy(vals, symbols, nsym);
    int code = 0, k = 0;
    std::memset(look, 0, sizeof(look));
    for (int len = 1; len <= 16; ++len) {
      // As libjpeg: the codes of a length must fit in its bits, and none may
      // be all ones. Checked before the codes fill the lookup table.
      if (code + counts[len - 1] >= (1 << len)) fail("bad Huffman table (too many codes of a length)");
      valoffset[len] = k - code;
      if (counts[len - 1]) {
        for (int i = 0; i < counts[len - 1]; ++i, ++k, ++code) {
          if (len <= kLookBits) {
            int shift = kLookBits - len;
            for (int j = 0; j < (1 << shift); ++j)
              look[(code << shift) | j] = static_cast<uint16_t>((len << 8) | vals[k]);
          }
        }
        maxcode[len] = code - 1;
      } else {
        maxcode[len] = -1;
      }
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    present = true;
  }
};

// The entropy-coded segment's bits, with 0xFF00 unstuffed. At a marker or
// the end of the data it feeds zero bits and counts them: consuming one of
// those means the data ended early.
struct BitReader {
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  uint64_t buf = 0;
  int cnt = 0;   // bits in buf
  int fake = 0;  // of which the trailing ones are padding
  bool at_marker = false;

  void fill() {
    while (cnt <= 56) {
      uint32_t b = 0;
      if (at_marker || p >= end) {
        fake += 8;
      } else if (*p == 0xFF) {
        if (p + 1 < end && p[1] == 0x00) {
          b = 0xFF;
          p += 2;
        } else {
          at_marker = true;  // p stays on the marker
          fake += 8;
        }
      } else {
        b = *p++;
      }
      buf |= static_cast<uint64_t>(b) << (56 - cnt);
      cnt += 8;
    }
  }
  int peek(int n) {
    if (cnt < n) fill();
    return static_cast<int>(buf >> (64 - n));
  }
  void skip(int n) {
    buf <<= n;
    cnt -= n;
    if (cnt < fake) fail("truncated or corrupt entropy-coded data (premature end of data)");
  }
  int get(int n) {
    if (n == 0) return 0;
    int v = peek(n);
    skip(n);
    return v;
  }
  int decode(const Huffman& h) {
    int look = peek(kLookBits);
    uint16_t e = h.look[look];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    int code = peek(16);
    int len = kLookBits + 1;
    while (len <= 16 && (code >> (16 - len)) > h.maxcode[len]) ++len;
    if (len > 16) fail("corrupt Huffman code");
    skip(len);
    return h.vals[(code >> (16 - len)) + h.valoffset[len]];
  }
  // Drop the buffered bits and move to the next marker (after a restart
  // interval or a scan): p then points at its 0xFF.
  void to_marker() {
    buf = 0;
    cnt = 0;
    fake = 0;
    if (!at_marker) {
      while (p < end && !(p[0] == 0xFF && p + 1 < end && p[1] != 0x00)) ++p;
    }
    at_marker = false;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int dw = 0, dh = 0;      // downsampled (real) width and height
  int bw = 0, bh = 0;      // blocks across and down in the plane
  int stride = 0;
  int pred = 0;
  std::vector<uint8_t> plane;
};

// jidctint.c's constants (CONST_BITS 13, PASS1_BITS 2)
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
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

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// libjpeg's post-IDCT range limit: idct_limit[x & 1023] (jdmaster.c
// prepare_range_limit_table, offset by CENTERJSAMPLE)
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      if (i < 128) t[i] = static_cast<uint8_t>(i + 128);
      else if (i < 512) t[i] = 255;
      else if (i < 896) t[i] = 0;
      else t[i] = static_cast<uint8_t>(i - 896);
    }
  }
};
const RangeLimit kLimit;

// One 8x8 block: dequantize, islow IDCT, write 8 rows of 8 samples.
void idct_islow(const int16_t* coef, const int* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const int* qq = q + c;
    int* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 && in[40] == 0 &&
        in[48] == 0 && in[56] == 0) {
      int dc = (in[0] * qq[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = in[16] * qq[16], z3 = in[48] * qq[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = in[0] * qq[0];
    z3 = in[32] * qq[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = in[56] * qq[56];
    tmp1 = in[40] * qq[40];
    tmp2 = in[24] * qq[24];
    tmp3 = in[8] * qq[8];
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
    const int n = kConstBits - kPass1Bits;
    w[0] = static_cast<int>(descale(tmp10 + tmp3, n));
    w[56] = static_cast<int>(descale(tmp10 - tmp3, n));
    w[8] = static_cast<int>(descale(tmp11 + tmp2, n));
    w[48] = static_cast<int>(descale(tmp11 - tmp2, n));
    w[16] = static_cast<int>(descale(tmp12 + tmp1, n));
    w[40] = static_cast<int>(descale(tmp12 - tmp1, n));
    w[24] = static_cast<int>(descale(tmp13 + tmp0, n));
    w[32] = static_cast<int>(descale(tmp13 - tmp0, n));
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    const int n = kConstBits + kPass1Bits + 3;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 && w[6] == 0 &&
        w[7] == 0) {
      uint8_t dc = kLimit.t[static_cast<int>(descale(w[0], kPass1Bits + 3)) & 1023];
      for (int i = 0; i < 8; ++i) o[i] = dc;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (1 << kConstBits);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (1 << kConstBits);
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
    o[0] = kLimit.t[static_cast<int>(descale(tmp10 + tmp3, n)) & 1023];
    o[7] = kLimit.t[static_cast<int>(descale(tmp10 - tmp3, n)) & 1023];
    o[1] = kLimit.t[static_cast<int>(descale(tmp11 + tmp2, n)) & 1023];
    o[6] = kLimit.t[static_cast<int>(descale(tmp11 - tmp2, n)) & 1023];
    o[2] = kLimit.t[static_cast<int>(descale(tmp12 + tmp1, n)) & 1023];
    o[5] = kLimit.t[static_cast<int>(descale(tmp12 - tmp1, n)) & 1023];
    o[3] = kLimit.t[static_cast<int>(descale(tmp13 + tmp0, n)) & 1023];
    o[4] = kLimit.t[static_cast<int>(descale(tmp13 - tmp0, n)) & 1023];
  }
}

// jdcolor.c's YCbCr -> RGB tables (SCALEBITS 16)
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int kScale = 16;
    const int64_t half = int64_t(1) << (kScale - 1);
    auto fix = [](double x) { return static_cast<int64_t>(x * (1 << 16) + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = static_cast<int>((fix(1.40200) * x + half) >> kScale);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + half) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

class JpegDecoder {
 public:
  JpegDecoder(const uint8_t* data, size_t n) : d_(data), n_(n) {}

  // Parses markers up to the first scan: width, height, components.
  void header() {
    if (n_ < 4 || d_[0] != 0xFF || d_[1] != 0xD8) fail("not a JPEG file (no SOI marker)");
    pos_ = 2;
    while (true) {
      int m = next_marker();
      if (m == 0xDA) {
        if (comps_.empty()) fail("scan before the frame header");
        sos_pos_ = pos_;
        return;
      }
      segment(m);
    }
  }

  int width() const { return width_; }
  int height() const { return height_; }
  int ncomp() const { return static_cast<int>(comps_.size()); }

  // Decodes every scan, then upsamples and converts into out [H, W, 3] RGB.
  void decode(uint8_t* out) {
    for (auto& c : comps_) {
      c.plane.assign(static_cast<size_t>(c.stride) * c.bh * 8, 0);
    }
    pos_ = sos_pos_;
    int scans = 0;
    while (true) {
      scan();
      ++scans;
      int m;
      while (true) {
        m = next_marker();
        if (m == 0xD9 || m == 0xDA) break;
        segment(m);
      }
      if (m == 0xD9) break;
    }
    finish(out);
  }

 private:
  const uint8_t* d_;
  size_t n_;
  size_t pos_ = 0, sos_pos_ = 0;
  int width_ = 0, height_ = 0, hmax_ = 1, vmax_ = 1;
  int mcux_ = 0, mcuy_ = 0;
  int restart_ = 0;
  bool jfif_ = false, adobe_ = false;
  int adobe_transform_ = -1;
  int quant_[4][64];
  bool quant_set_[4] = {false, false, false, false};
  Huffman dc_[4], ac_[4];
  std::vector<Component> comps_;

  int u8() {
    if (pos_ >= n_) fail("truncated file (the data ends inside a marker segment)");
    return d_[pos_++];
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  // The next marker code at pos_ (fill bytes skipped); pos_ then follows it.
  int next_marker() {
    if (pos_ >= n_) fail("truncated file (no EOI marker)");
    if (d_[pos_] != 0xFF) fail("corrupt file (a marker was expected)");
    while (pos_ < n_ && d_[pos_] == 0xFF) ++pos_;
    if (pos_ >= n_) fail("truncated file (no EOI marker)");
    return d_[pos_++];
  }

  void segment(int m) {
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) return;  // no length
    size_t start = pos_;
    int len = u16();
    if (len < 2 || start + len > n_) fail("truncated file (a marker segment runs past the end)");
    size_t end = start + len;
    switch (m) {
      case 0xC0:
      case 0xC1:
        frame(end);
        break;
      case 0xC2:
      case 0xC6:
      case 0xCA:
      case 0xCE:
        fail("progressive JPEG is not decoded (baseline and extended sequential only)");
      case 0xC3:
      case 0xC7:
      case 0xCB:
      case 0xCF:
        fail("lossless JPEG is not decoded (baseline and extended sequential only)");
      case 0xC5:
        fail("hierarchical (differential) JPEG is not decoded");
      case 0xC9:
      case 0xCD:
      case 0xCC:
        fail("arithmetic-coded JPEG is not decoded (Huffman coding only)");
      case 0xC4:
        huffman(end);
        break;
      case 0xDB:
        quant(end);
        break;
      case 0xDD:
        restart_ = u16();
        break;
      case 0xE0:
        if (end - pos_ >= 5 && std::memcmp(d_ + pos_, "JFIF\0", 5) == 0) jfif_ = true;
        break;
      case 0xEE:
        if (end - pos_ >= 12 && std::memcmp(d_ + pos_, "Adobe", 5) == 0) {
          adobe_ = true;
          adobe_transform_ = d_[pos_ + 11];
        }
        break;
      default:
        break;
    }
    pos_ = end;
  }

  void frame(size_t end) {
    if (!comps_.empty()) fail("corrupt file (two frame headers)");
    int precision = u8();
    if (precision != 8) fail(std::to_string(precision) + "-bit JPEG is not decoded (8-bit samples only)");
    height_ = u16();
    width_ = u16();
    int nc = u8();
    if (height_ <= 0) fail("JPEG without its height in the frame header (DNL) is not decoded");
    if (width_ <= 0) fail("corrupt frame header (zero width)");
    if (nc == 4) fail("4-component (CMYK / YCCK) JPEG is not decoded (grey and 3-component colour only)");
    if (nc != 1 && nc != 3) fail(std::to_string(nc) + "-component JPEG is not decoded");
    if (pos_ + 3 * nc > end) fail("corrupt frame header");
    for (int i = 0; i < nc; ++i) {
      Component c;
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) fail("corrupt frame header (sampling or table)");
      hmax_ = std::max(hmax_, c.h);
      vmax_ = std::max(vmax_, c.v);
      comps_.push_back(c);
    }
    mcux_ = (width_ + 8 * hmax_ - 1) / (8 * hmax_);
    mcuy_ = (height_ + 8 * vmax_ - 1) / (8 * vmax_);
    for (auto& c : comps_) {
      if (hmax_ % c.h || vmax_ % c.v) fail("sampling factors that do not divide the largest are not decoded");
      c.dw = static_cast<int>((static_cast<int64_t>(width_) * c.h + hmax_ - 1) / hmax_);
      c.dh = static_cast<int>((static_cast<int64_t>(height_) * c.v + vmax_ - 1) / vmax_);
      c.bw = mcux_ * c.h;
      c.bh = mcuy_ * c.v;
      c.stride = c.bw * 8;
    }
  }

  void huffman(size_t end) {
    while (pos_ < end) {
      int tc_th = u8();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("corrupt Huffman table header");
      uint8_t counts[16];
      int total = 0;
      for (int i = 0; i < 16; ++i) {
        counts[i] = static_cast<uint8_t>(u8());
        total += counts[i];
      }
      if (total > 256 || pos_ + total > end) fail("corrupt Huffman table");
      (tc ? ac_[th] : dc_[th]).build(counts, d_ + pos_, total);
      pos_ += total;
    }
  }

  void quant(size_t end) {
    while (pos_ < end) {
      int pq_tq = u8();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (pq > 1 || tq > 3) fail("corrupt quantization table header");
      for (int k = 0; k < 64; ++k) quant_[tq][kNatural[k]] = pq ? u16() : u8();
      quant_set_[tq] = true;
    }
  }

  void scan() {
    size_t start = pos_;
    int len = u16();
    int ns = u8();
    if (ns < 1 || ns > 4 || len != 6 + 2 * ns) fail("corrupt scan header");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      int id = u8(), t = u8();
      Component* c = nullptr;
      for (auto& k : comps_)
        if (k.id == id) c = &k;
      if (!c) fail("scan names an unknown component");
      c->td = t >> 4;
      c->ta = t & 15;
      if (c->td > 3 || c->ta > 3 || !dc_[c->td].present || !ac_[c->ta].present)
        fail("scan uses an undefined Huffman table");
      if (!quant_set_[c->tq]) fail("component uses an undefined quantization table");
      c->pred = 0;
      sc.push_back(c);
    }
    int ss = u8(), se = u8(), ahal = u8();
    if (ss != 0 || se != 63 || ahal != 0) fail("corrupt sequential scan (spectral selection)");
    pos_ = start + len;

    BitReader br;
    br.p = d_ + pos_;
    br.end = d_ + n_;
    int16_t coef[64];
    // Per block: decode, IDCT into the component's plane.
    auto block = [&](Component& c, int bx, int by) {
      std::memset(coef, 0, sizeof(coef));
      int s = br.decode(dc_[c.td]);
      if (s > 11) fail("corrupt DC coefficient");
      int diff = s ? extend(br.get(s), s) : 0;
      c.pred += diff;
      coef[0] = static_cast<int16_t>(c.pred);
      const Huffman& ac = ac_[c.ta];
      for (int k = 1; k < 64; ++k) {
        int rs = br.decode(ac);
        int r = rs >> 4, sz = rs & 15;
        if (sz) {
          k += r;
          if (k > 63) fail("corrupt AC coefficients (run past the block)");
          coef[kNatural[k]] = static_cast<int16_t>(extend(br.get(sz), sz));
        } else if (r == 15) {
          k += 15;
        } else {
          break;
        }
      }
      idct_islow(coef, quant_[c.tq], c.plane.data() + static_cast<size_t>(by) * 8 * c.stride + bx * 8,
                 c.stride);
    };
    int64_t total;
    int across;
    if (ns == 1) {  // non-interleaved: a block is an MCU, over the real samples' blocks
      Component& c = *sc[0];
      across = (c.dw + 7) / 8;
      total = static_cast<int64_t>(across) * ((c.dh + 7) / 8);
    } else {
      across = mcux_;
      total = static_cast<int64_t>(mcux_) * mcuy_;
    }
    int next_rst = 0;
    for (int64_t m = 0; m < total; ++m) {
      if (restart_ && m > 0 && m % restart_ == 0) {
        br.to_marker();
        const uint8_t* p = br.p;
        while (p < br.end && *p == 0xFF) ++p;
        if (p >= br.end || *p != 0xD0 + next_rst) fail("missing or out-of-order restart marker");
        br.p = p + 1;
        next_rst = (next_rst + 1) & 7;
        for (auto* c : sc) c->pred = 0;
      }
      int mx = static_cast<int>(m % across), my = static_cast<int>(m / across);
      if (ns == 1) {
        block(*sc[0], mx, my);
      } else {
        for (auto* c : sc)
          for (int by = 0; by < c->v; ++by)
            for (int bx = 0; bx < c->h; ++bx) block(*c, mx * c->h + bx, my * c->v + by);
      }
    }
    br.to_marker();
    pos_ = static_cast<size_t>(br.p - d_);
  }

  // The component's samples at full size [H, W] by libjpeg-turbo's upsampler.
  std::vector<uint8_t> upsample(const Component& c) const {
    const int W = width_, H = height_;
    const int fh = hmax_ / c.h, fv = vmax_ / c.v;
    std::vector<uint8_t> out(static_cast<size_t>(W) * H);
    auto in = [&](int r, int x) {  // the real samples, edge rows repeated
      r = std::min(std::max(r, 0), c.dh - 1);
      return static_cast<int>(c.plane[static_cast<size_t>(r) * c.stride + x]);
    };
    if (fh == 1 && fv == 1) {
      for (int y = 0; y < H; ++y) std::memcpy(&out[static_cast<size_t>(y) * W], &c.plane[static_cast<size_t>(y) * c.stride], W);
    } else if (fh == 2 && fv == 1 && c.dw > 2) {  // h2v1_fancy_upsample
      std::vector<uint8_t> row(2 * c.dw);
      for (int y = 0; y < H; ++y) {
        const int dw = c.dw;
        int v0 = in(y, 0);
        row[0] = static_cast<uint8_t>(v0);
        row[1] = static_cast<uint8_t>((v0 * 3 + in(y, 1) + 2) >> 2);
        for (int x = 1; x < dw - 1; ++x) {
          int v = in(y, x) * 3;
          row[2 * x] = static_cast<uint8_t>((v + in(y, x - 1) + 1) >> 2);
          row[2 * x + 1] = static_cast<uint8_t>((v + in(y, x + 1) + 2) >> 2);
        }
        int vl = in(y, dw - 1);
        row[2 * dw - 2] = static_cast<uint8_t>((vl * 3 + in(y, dw - 2) + 1) >> 2);
        row[2 * dw - 1] = static_cast<uint8_t>(vl);
        std::memcpy(&out[static_cast<size_t>(y) * W], row.data(), W);
      }
    } else if (fh == 1 && fv == 2) {  // h1v2_fancy_upsample
      for (int y = 0; y < H; ++y) {
        int r = y >> 1, far = (y & 1) ? r + 1 : r - 1, bias = (y & 1) ? 2 : 1;
        for (int x = 0; x < W; ++x)
          out[static_cast<size_t>(y) * W + x] = static_cast<uint8_t>((in(r, x) * 3 + in(far, x) + bias) >> 2);
      }
    } else if (fh == 2 && fv == 2 && c.dw > 2) {  // h2v2_fancy_upsample
      std::vector<int> sum(c.dw);
      std::vector<uint8_t> row(2 * c.dw);
      for (int y = 0; y < H; ++y) {
        int r = y >> 1, far = (y & 1) ? r + 1 : r - 1;
        const int dw = c.dw;
        for (int x = 0; x < dw; ++x) sum[x] = in(r, x) * 3 + in(far, x);
        row[0] = static_cast<uint8_t>((sum[0] * 4 + 8) >> 4);
        row[1] = static_cast<uint8_t>((sum[0] * 3 + sum[1] + 7) >> 4);
        for (int x = 1; x < dw - 1; ++x) {
          row[2 * x] = static_cast<uint8_t>((sum[x] * 3 + sum[x - 1] + 8) >> 4);
          row[2 * x + 1] = static_cast<uint8_t>((sum[x] * 3 + sum[x + 1] + 7) >> 4);
        }
        row[2 * dw - 2] = static_cast<uint8_t>((sum[dw - 1] * 3 + sum[dw - 2] + 8) >> 4);
        row[2 * dw - 1] = static_cast<uint8_t>((sum[dw - 1] * 4 + 7) >> 4);
        std::memcpy(&out[static_cast<size_t>(y) * W], row.data(), W);
      }
    } else {  // h2v1 / h2v2 at 2 columns or fewer, and other integer factors: replication
      for (int y = 0; y < H; ++y)
        for (int x = 0; x < W; ++x)
          out[static_cast<size_t>(y) * W + x] = c.plane[static_cast<size_t>(y / fv) * c.stride + x / fh];
    }
    return out;
  }

  void finish(uint8_t* out) {
    const size_t npix = static_cast<size_t>(width_) * height_;
    if (comps_.size() == 1) {
      std::vector<uint8_t> g = upsample(comps_[0]);
      for (size_t i = 0; i < npix; ++i) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = g[i];
      return;
    }
    std::vector<uint8_t> a = upsample(comps_[0]), b = upsample(comps_[1]), c = upsample(comps_[2]);
    bool rgb;
    if (jfif_) {
      rgb = false;
    } else if (adobe_) {
      rgb = adobe_transform_ == 0;
    } else {
      rgb = comps_[0].id == 82 && comps_[1].id == 71 && comps_[2].id == 66;
    }
    if (rgb) {
      for (size_t i = 0; i < npix; ++i) {
        out[3 * i] = a[i];
        out[3 * i + 1] = b[i];
        out[3 * i + 2] = c[i];
      }
      return;
    }
    for (size_t i = 0; i < npix; ++i) {
      int y = a[i], cb = b[i], cr = c[i];
      out[3 * i] = clamp255(y + kYcc.cr_r[cr]);
      out[3 * i + 1] = clamp255(y + static_cast<int>((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
      out[3 * i + 2] = clamp255(y + kYcc.cb_b[cb]);
    }
  }
};

void set_err(char* err, int32_t errlen, const std::string& msg) {
  if (err && errlen > 0) {
    std::snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
  }
}

}  // namespace

extern "C" {

// ---- .flo ------------------------------------------------------------

// Returns 0 on success and writes (h, w) into dims[2].
int fst_flo_dims(const char* path, int32_t* dims) {
  File file(path);
  if (!file.f) return 1;
  float magic;
  int32_t wh[2];
  if (!file.read(&magic, 4) || magic != kFloMagic || !file.read(wh, 8)) return 2;
  dims[0] = wh[1];
  dims[1] = wh[0];
  return 0;
}

// out must hold h*w*2 floats.
int fst_read_flo(const char* path, float* out, int32_t h, int32_t w) {
  File file(path);
  if (!file.f) return 1;
  float magic;
  int32_t wh[2];
  if (!file.read(&magic, 4) || !file.read(wh, 8)) return 2;
  if (magic != kFloMagic) return 3;
  if (wh[0] != w || wh[1] != h) return 4;
  if (!file.read(out, static_cast<size_t>(h) * w * 2 * 4)) return 5;
  return 0;
}

// ---- PPM (P6) ----------------------------------------------------------

// Reads "P6 <w> <h> <maxval>" and the one whitespace byte after it.
bool ppm_header(FILE* f, int& w, int& h, int& maxv) {
  if (std::getc(f) != 'P' || std::getc(f) != '6') return false;
  w = pnm_next_int(f);
  h = pnm_next_int(f);
  maxv = pnm_next_int(f);
  return w > 0 && h > 0;
}

int fst_ppm_dims(const char* path, int32_t* dims) {
  File file(path);
  if (!file.f) return 1;
  int w, h, maxv;
  if (!ppm_header(file.f, w, h, maxv)) return 2;
  dims[0] = h;
  dims[1] = w;
  return 0;
}

// out must hold h*w*3 floats: each sample / 255.0f.
int fst_read_ppm(const char* path, float* out, int32_t h, int32_t w) {
  File file(path);
  if (!file.f) return 1;
  int fw, fh, maxv;
  if (!ppm_header(file.f, fw, fh, maxv)) return 2;
  if (fw != w || fh != h || maxv != 255) return 3;
  size_t need = static_cast<size_t>(h) * w * 3;
  std::unique_ptr<uint8_t[]> p(new uint8_t[need]);
  if (!file.read(p.get(), need)) return 4;
  for (size_t k = 0; k < need; ++k) out[k] = static_cast<float>(p[k]) / 255.0f;
  return 0;
}

// ---- PFM ---------------------------------------------------------------

// Reads "PF|Pf <w> <h>" and the scale line; c = 3 for PF, 1 for Pf.
bool pfm_header(FILE* f, int& w, int& h, int& c, float& scale) {
  if (std::getc(f) != 'P') return false;
  int kind = std::getc(f);
  if (kind != 'F' && kind != 'f') return false;
  c = kind == 'F' ? 3 : 1;
  w = pnm_next_int(f);
  h = pnm_next_int(f);
  int ch = std::getc(f);
  while (ch == ' ' || ch == '\n' || ch == '\r') ch = std::getc(f);
  std::string line;
  while (ch != EOF && ch != '\n') {
    line.push_back(static_cast<char>(ch));
    ch = std::getc(f);
  }
  scale = std::strtof(line.c_str(), nullptr);
  return w > 0 && h > 0;
}

// dims[3] = (h, w, channels)
int fst_pfm_dims(const char* path, int32_t* dims) {
  File file(path);
  if (!file.f) return 1;
  int w, h, c;
  float scale;
  if (!pfm_header(file.f, w, h, c, scale)) return 2;
  dims[0] = h;
  dims[1] = w;
  dims[2] = c;
  return 0;
}

// out must hold h*w*c floats, top row first, in the host's byte order.
int fst_read_pfm(const char* path, float* out, int32_t h, int32_t w, int32_t c) {
  File file(path);
  if (!file.f) return 1;
  int fw, fh, fc;
  float scale;
  if (!pfm_header(file.f, fw, fh, fc, scale)) return 2;
  if (fw != w || fh != h || fc != c) return 3;
  // rows are stored bottom-up: read them all, then swap them end for end
  size_t row = static_cast<size_t>(w) * c, count = row * h;
  if (!file.read(out, count * 4)) return 4;
  std::unique_ptr<float[]> tmp(new float[row]);
  for (int r = 0; r < h / 2; ++r) {
    float* top = out + r * row;
    float* bottom = out + (h - 1 - r) * row;
    std::memcpy(tmp.get(), top, row * 4);
    std::memcpy(top, bottom, row * 4);
    std::memcpy(bottom, tmp.get(), row * 4);
  }
  if (scale >= 0.0f) {  // big-endian samples
    uint8_t* b = reinterpret_cast<uint8_t*>(out);
    for (size_t k = 0; k < count; ++k, b += 4) {
      std::swap(b[0], b[3]);
      std::swap(b[1], b[2]);
    }
  }
  return 0;
}

// ---- threaded batch readers ------------------------------------------------

// Load n .flo files (all h x w) into out[n, h, w, 2] with `threads` workers.
// Returns the number of failures.
int fst_read_flo_batch(const char** paths, int32_t n, float* out, int32_t h, int32_t w,
                       int32_t threads) {
  if (threads < 1) threads = 1;
  std::vector<int> failures(threads, 0);
  std::vector<std::thread> pool;
  size_t stride = static_cast<size_t>(h) * w * 2;
  for (int t = 0; t < threads; ++t) {
    pool.emplace_back([&, t]() {
      for (int k = t; k < n; k += threads)
        if (fst_read_flo(paths[k], out + stride * k, h, w) != 0) ++failures[t];
    });
  }
  for (auto& th : pool) th.join();
  int total = 0;
  for (int v : failures) total += v;
  return total;
}

int fst_read_ppm_batch(const char** paths, int32_t n, float* out, int32_t h, int32_t w,
                       int32_t threads) {
  if (threads < 1) threads = 1;
  std::vector<int> failures(threads, 0);
  std::vector<std::thread> pool;
  size_t stride = static_cast<size_t>(h) * w * 3;
  for (int t = 0; t < threads; ++t) {
    pool.emplace_back([&, t]() {
      for (int k = t; k < n; k += threads)
        if (fst_read_ppm(paths[k], out + stride * k, h, w) != 0) ++failures[t];
    });
  }
  for (auto& th : pool) th.join();
  int total = 0;
  for (int v : failures) total += v;
  return total;
}

// ---- JPEG --------------------------------------------------------------

// dims[3] = (h, w, components) of the JPEG bytes data[n].
int fst_jpeg_info(const uint8_t* data, int64_t n, int32_t* dims, char* err, int32_t errlen) {
  try {
    JpegDecoder dec(data, static_cast<size_t>(n));
    dec.header();
    dims[0] = dec.height();
    dims[1] = dec.width();
    dims[2] = dec.ncomp();
    return 0;
  } catch (const JpegError& e) {
    set_err(err, errlen, e.msg);
    return 1;
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
    return 2;
  }
}

// Decodes the JPEG bytes data[n] into out [h, w, 3] RGB (h, w from
// fst_jpeg_info).
int fst_jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, int32_t h, int32_t w, char* err,
                    int32_t errlen) {
  try {
    JpegDecoder dec(data, static_cast<size_t>(n));
    dec.header();
    if (dec.height() != h || dec.width() != w) fail("output size differs from the frame header's");
    dec.decode(out);
    return 0;
  } catch (const JpegError& e) {
    set_err(err, errlen, e.msg);
    return 1;
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
    return 2;
  }
}

}  // extern "C"
