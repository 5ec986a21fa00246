// Host image codec and pixel operations of the port's input pipeline, in
// C++ behind a plain C interface (bound with ctypes in
// zutis_tpu_torch/native/image.py, built with g++ by ops/_build.py).
//
// The card's machine has no image library, and the loaders must give the
// pixels the JAX package's loaders get from Pillow and OpenCV, bit for bit,
// so that a sample of the port can be held against the JAX one. So this
// file reproduces what those libraries compute:
//
//   * JPEG decoding as Pillow's libjpeg-turbo does it by default: Huffman
//     coding only, 8-bit samples; baseline (SOF0), extended sequential
//     (SOF1) and progressive (SOF2) frames; restart intervals; 1, 3 and 4
//     components. The integer "islow" IDCT (jidctint.c), "fancy" triangle
//     upsampling for h2v1, h1v2 and h2v2 (jdsample.c; plain replication
//     for other integral factors), and the fixed-point YCbCr -> RGB tables
//     of jdcolor.c. Grayscale comes out replicated to RGB, as
//     `Image.open(p).convert("RGB")` gives it, and Adobe CMYK as the
//     inverted samples of Pillow's "CMYK" mode (its conversion to RGB is
//     data/image_io.py's `to_rgb`). Arithmetic coding,
//     lossless and hierarchical frames, 12-bit samples, YCCK and a
//     truncated or corrupt stream are refused with a message.
//   * PNG: undoing the five row filters (inflate happens in Python, with
//     zlib). Average and Paeth are serial along a row.
//   * cv2.GaussianBlur on 8-bit images: OpenCV's bit-exact fixed-point
//     path (a kernel of 8 fractional bits whose taps are the steps of the
//     rounded running sum of the Gaussian, as OpenCV 5's
//     getGaussianKernelBitExact makes it; the row pass exact in 16 bits,
//     the column pass rounded once from 32 bits), BORDER_REFLECT_101.
//   * Pillow's RGB -> HSV -> RGB round trip with a hue shift (Convert.c's
//     rgb2hsv_row and hsv2rgb, in their float and double arithmetic).
//
// Every entry point returns 0 on success, or -1 with a message in `err`.

#include <algorithm>
#include <cmath>
#include <cstdlib>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  explicit Error(const std::string& m) : std::runtime_error(m) {}
};

int fail(const char* msg, char* err, int err_cap) {
  if (err && err_cap > 0) {
    std::snprintf(err, err_cap, "%s", msg);
  }
  return -1;
}

// ------------------------------------------------------------------ JPEG

const int kZigzag[80] = {  // jpeg_natural_order, with a safety tail
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  // a 16-bit lookahead table: entry = (code length << 8) | symbol, 0 when
  // no code of at most 16 bits starts with those bits
  std::vector<uint16_t> table;
  bool defined = false;
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;  // downsampled size in samples
  int bw = 0, bh = 0;  // blocks per row and column, padded to the MCU grid
  int td = 0, ta = 0;  // Huffman table selectors of the current scan
  int pred = 0;
  bool quant_latched = false;
  uint16_t quant[64];
  std::vector<int16_t> coef;  // bw * bh blocks of 64, natural order
};

class BitReader {
 public:
  BitReader(const uint8_t* p, const uint8_t* end) : p_(p), end_(end) {}

  const uint8_t* pos() const { return p_; }

  // restart: drop the byte's fill bits and expect RSTn
  void restart(int n) {
    buf_ = 0;
    cnt_ = 0;
    pad_ = 0;
    marker_ = false;
    if (p_ + 1 >= end_) throw Error("truncated JPEG stream (missing restart marker)");
    if (p_[0] != 0xFF || p_[1] != 0xD0 + (n & 7)) {
      throw Error("corrupt JPEG stream (restart marker out of place)");
    }
    p_ += 2;
  }

  uint32_t peek16() {
    if (cnt_ < 16) fill();
    return (uint32_t)(buf_ >> (cnt_ - 16)) & 0xFFFF;
  }

  void skip(int n) {
    if (n > cnt_ - pad_) overrun();
    cnt_ -= n;
  }

  int bits(int n) {
    if (n == 0) return 0;
    if (cnt_ < n) fill();
    if (n > cnt_ - pad_) overrun();
    cnt_ -= n;
    return (int)((buf_ >> cnt_) & ((1ull << n) - 1));
  }

  int bit() { return bits(1); }

  int decode(const Huffman& t) {
    uint32_t e = t.table[peek16()];
    if (e == 0) throw Error("corrupt JPEG stream (bad Huffman code)");
    skip(e >> 8);
    return e & 0xFF;
  }

  // the value of `s` bits, sign-extended as JPEG codes a coefficient
  int receive_extend(int s) {
    if (s == 0) return 0;
    if (s > 16) throw Error("corrupt JPEG stream (coefficient too long)");
    int v = bits(s);
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
  }

 private:
  [[noreturn]] void overrun() {
    if (p_ >= end_) throw Error("truncated JPEG stream");
    throw Error("corrupt JPEG stream (entropy data ran into a marker)");
  }

  void fill() {
    while (cnt_ <= 56) {
      uint32_t byte = 0;
      if (marker_ || p_ >= end_) {
        pad_ += 8;  // zeros past the data: an error once consumed
      } else if (p_[0] == 0xFF) {
        if (p_ + 1 < end_ && p_[1] == 0x00) {
          byte = 0xFF;
          p_ += 2;
        } else if (p_ + 1 < end_ && p_[1] == 0xFF) {
          p_ += 1;  // a fill byte before a marker
          continue;
        } else {
          marker_ = true;
          pad_ += 8;
        }
      } else {
        byte = *p_++;
      }
      buf_ = (buf_ << 8) | byte;
      cnt_ += 8;
    }
  }

  const uint8_t* p_;
  const uint8_t* end_;
  uint64_t buf_ = 0;
  int cnt_ = 0;
  int pad_ = 0;  // padding bits at the bottom of the buffer
  bool marker_ = false;
};

// jidctint.c's jpeg_idct_islow, with its range limit (RANGE_MASK wrap)
const int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
              FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
              FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
              FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
              FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;
const int CONST_BITS = 13, PASS1_BITS = 2;

inline int64_t descale(int64_t x, int n) {
  return (x + ((int64_t)1 << (n - 1))) >> n;
}

inline uint8_t idct_limit(int64_t x) {
  int t = (int)(x & 1023);  // RANGE_MASK: the table wraps at 4 * 256
  if (t >= 512) t -= 1024;
  t += 128;
  return (uint8_t)(t < 0 ? 0 : (t > 255 ? 255 : t));
}

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12,
        tmp13;
    z2 = (int64_t)ip[16] * qp[16];
    z3 = (int64_t)ip[48] * qp[48];
    z1 = (z2 + z3) * FIX_0_541196100;
    tmp2 = z1 + z3 * (-FIX_1_847759065);
    tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int64_t)ip[0] * qp[0];
    z3 = (int64_t)ip[32] * qp[32];
    tmp0 = (z2 + z3) * (1 << CONST_BITS);
    tmp1 = (z2 - z3) * (1 << CONST_BITS);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)ip[56] * qp[56];
    tmp1 = (int64_t)ip[40] * qp[40];
    tmp2 = (int64_t)ip[24] * qp[24];
    tmp3 = (int64_t)ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * (-FIX_0_899976223);
    z2 = z2 * (-FIX_2_562915447);
    z3 = z3 * (-FIX_1_961570560);
    z4 = z4 * (-FIX_0_390180644);
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CONST_BITS - PASS1_BITS;
    ws[c + 0] = (int)descale(tmp10 + tmp3, sh);
    ws[c + 56] = (int)descale(tmp10 - tmp3, sh);
    ws[c + 8] = (int)descale(tmp11 + tmp2, sh);
    ws[c + 48] = (int)descale(tmp11 - tmp2, sh);
    ws[c + 16] = (int)descale(tmp12 + tmp1, sh);
    ws[c + 40] = (int)descale(tmp12 - tmp1, sh);
    ws[c + 24] = (int)descale(tmp13 + tmp0, sh);
    ws[c + 32] = (int)descale(tmp13 - tmp0, sh);
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + r * 8;
    uint8_t* o = out + (int64_t)r * stride;
    int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12,
        tmp13;
    z2 = w[2];
    z3 = w[6];
    z1 = (z2 + z3) * FIX_0_541196100;
    tmp2 = z1 + z3 * (-FIX_1_847759065);
    tmp3 = z1 + z2 * FIX_0_765366865;
    tmp0 = ((int64_t)w[0] + w[4]) * (1 << CONST_BITS);
    tmp1 = ((int64_t)w[0] - w[4]) * (1 << CONST_BITS);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * (-FIX_0_899976223);
    z2 = z2 * (-FIX_2_562915447);
    z3 = z3 * (-FIX_1_961570560);
    z4 = z4 * (-FIX_0_390180644);
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CONST_BITS + PASS1_BITS + 3;
    o[0] = idct_limit(descale(tmp10 + tmp3, sh));
    o[7] = idct_limit(descale(tmp10 - tmp3, sh));
    o[1] = idct_limit(descale(tmp11 + tmp2, sh));
    o[6] = idct_limit(descale(tmp11 - tmp2, sh));
    o[2] = idct_limit(descale(tmp12 + tmp1, sh));
    o[5] = idct_limit(descale(tmp12 - tmp1, sh));
    o[3] = idct_limit(descale(tmp13 + tmp0, sh));
    o[4] = idct_limit(descale(tmp13 - tmp0, sh));
  }
}

struct Plane {
  int w = 0, h = 0;  // allocated size
  std::vector<uint8_t> px;
  uint8_t* row(int y) { return px.data() + (int64_t)y * w; }
};

// jdsample.c, for one component: `in` holds dw x dh real samples (rows
// padded to in.w); the result is (dw * hr) x (dh * vr)
Plane upsample(Plane& in, int dw, int dh, int hr, int vr) {
  Plane out;
  out.w = dw * hr;
  out.h = dh * vr;
  out.px.resize((size_t)out.w * out.h);
  if (hr == 1 && vr == 1) {
    for (int y = 0; y < dh; ++y) std::memcpy(out.row(y), in.row(y), dw);
    return out;
  }
  if (hr == 2 && vr == 1 && dw > 2) {  // h2v1_fancy_upsample
    for (int y = 0; y < dh; ++y) {
      const uint8_t* ip = in.row(y);
      uint8_t* op = out.row(y);
      int v = ip[0];
      op[0] = (uint8_t)v;
      op[1] = (uint8_t)((v * 3 + ip[1] + 2) >> 2);
      for (int x = 1; x < dw - 1; ++x) {
        v = ip[x] * 3;
        op[2 * x] = (uint8_t)((v + ip[x - 1] + 1) >> 2);
        op[2 * x + 1] = (uint8_t)((v + ip[x + 1] + 2) >> 2);
      }
      v = ip[dw - 1];
      op[2 * dw - 2] = (uint8_t)((v * 3 + ip[dw - 2] + 1) >> 2);
      op[2 * dw - 1] = (uint8_t)v;
    }
    return out;
  }
  if (hr == 1 && vr == 2) {  // h1v2_fancy_upsample
    for (int y = 0; y < dh; ++y) {
      const uint8_t* c0 = in.row(y);
      const uint8_t* up = in.row(y > 0 ? y - 1 : 0);
      const uint8_t* dn = in.row(y + 1 < dh ? y + 1 : dh - 1);
      uint8_t* o0 = out.row(2 * y);
      uint8_t* o1 = out.row(2 * y + 1);
      for (int x = 0; x < dw; ++x) {
        o0[x] = (uint8_t)((c0[x] * 3 + up[x] + 1) >> 2);
        o1[x] = (uint8_t)((c0[x] * 3 + dn[x] + 2) >> 2);
      }
    }
    return out;
  }
  if (hr == 2 && vr == 2 && dw > 2) {  // h2v2_fancy_upsample
    for (int y = 0; y < dh; ++y) {
      const uint8_t* c0 = in.row(y);
      for (int vv = 0; vv < 2; ++vv) {
        const uint8_t* c1 =
            vv == 0 ? in.row(y > 0 ? y - 1 : 0) : in.row(y + 1 < dh ? y + 1 : dh - 1);
        uint8_t* op = out.row(2 * y + vv);
        int this_sum = c0[0] * 3 + c1[0];
        int next_sum = c0[1] * 3 + c1[1];
        op[0] = (uint8_t)((this_sum * 4 + 8) >> 4);
        op[1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
        int last_sum = this_sum;
        this_sum = next_sum;
        for (int x = 1; x < dw - 1; ++x) {
          next_sum = c0[x + 1] * 3 + c1[x + 1];
          op[2 * x] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
          op[2 * x + 1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
          last_sum = this_sum;
          this_sum = next_sum;
        }
        op[2 * dw - 2] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
        op[2 * dw - 1] = (uint8_t)((this_sum * 4 + 7) >> 4);
      }
    }
    return out;
  }
  // int_upsample (h2v1_upsample and h2v2_upsample are its special cases)
  for (int y = 0; y < dh; ++y) {
    const uint8_t* ip = in.row(y);
    uint8_t* op = out.row(y * vr);
    for (int x = 0; x < dw; ++x) {
      std::memset(op + (int64_t)x * hr, ip[x], hr);
    }
    for (int r = 1; r < vr; ++r) std::memcpy(out.row(y * vr + r), op, out.w);
  }
  return out;
}

class JpegDecoder {
 public:
  JpegDecoder(const uint8_t* data, int64_t n) : d_(data), end_(data + n) {}

  void read_header() {
    if (end_ - d_ < 4 || d_[0] != 0xFF || d_[1] != 0xD8) {
      throw Error("not a JPEG stream (no SOI marker)");
    }
    p_ = d_ + 2;
    while (true) {
      int m = next_marker();
      if (m == 0xDA) {  // SOS before a frame
        if (!frame_) throw Error("corrupt JPEG stream (scan before frame)");
        p_ -= 2;  // leave SOS for decode()
        return;
      }
      if (m == 0xD9) throw Error("truncated JPEG stream (no scan)");
      handle_marker(m);
    }
  }

  int width() const { return width_; }
  int height() const { return height_; }
  int components() const { return (int)comps_.size(); }

  // Decode into `out`: [H, W, 3] RGB for one or three components, the
  // [H, W, 4] samples of Pillow's "CMYK" mode for four.
  void decode(uint8_t* out) {
    while (true) {
      int m = next_marker();
      if (m == 0xD9) break;
      if (m == 0xDA) {
        scan();
        ++n_scans_;
      } else {
        handle_marker(m);
      }
    }
    if (n_scans_ == 0) throw Error("truncated JPEG stream (no scan)");
    output(out);
  }

 private:
  int u8() {
    if (p_ >= end_) throw Error("truncated JPEG stream");
    return *p_++;
  }
  int u16() {
    int a = u8();
    return (a << 8) | u8();
  }

  int next_marker() {
    // skip anything up to an 0xFF, then fill bytes
    while (true) {
      if (p_ >= end_) throw Error("truncated JPEG stream (no EOI marker)");
      if (*p_ != 0xFF) {
        ++p_;
        continue;
      }
      while (p_ < end_ && *p_ == 0xFF) ++p_;
      if (p_ >= end_) throw Error("truncated JPEG stream (no EOI marker)");
      int m = *p_++;
      if (m == 0x00 || (m >= 0xD0 && m <= 0xD7)) continue;  // stray data
      return m;
    }
  }

  void handle_marker(int m) {
    switch (m) {
      case 0xC0:
      case 0xC1:
      case 0xC2:
        frame(m == 0xC2);
        return;
      case 0xC3:
        throw Error("lossless JPEG (SOF3) is not supported");
      case 0xC5:
      case 0xC6:
      case 0xC7:
        throw Error("hierarchical JPEG (SOF5-7) is not supported");
      case 0xC9:
      case 0xCA:
      case 0xCB:
      case 0xCD:
      case 0xCE:
      case 0xCF:
      case 0xCC:
        throw Error("arithmetic-coded JPEG is not supported");
      case 0xC4:
        dht();
        return;
      case 0xDB:
        dqt();
        return;
      case 0xDD: {
        int len = u16();
        if (len != 4) throw Error("corrupt JPEG stream (bad DRI length)");
        restart_interval_ = u16();
        return;
      }
      case 0xE0:
      case 0xEE:
        app(m);
        return;
      case 0xD8:
        throw Error("corrupt JPEG stream (a second SOI)");
      case 0xDC:
        throw Error("JPEG with a DNL marker is not supported");
      default: {
        int len = u16();
        if (len < 2 || end_ - p_ < len - 2) throw Error("truncated JPEG stream");
        p_ += len - 2;
      }
    }
  }

  void app(int m) {
    int len = u16();
    if (len < 2 || end_ - p_ < len - 2) throw Error("truncated JPEG stream");
    const uint8_t* s = p_;
    int n = len - 2;
    if (m == 0xE0 && n >= 5 && std::memcmp(s, "JFIF\0", 5) == 0) saw_jfif_ = true;
    if (m == 0xEE && n >= 12 && std::memcmp(s, "Adobe", 5) == 0) {
      saw_adobe_ = true;
      adobe_transform_ = s[11];
    }
    p_ += n;
  }

  void frame(bool progressive) {
    if (frame_) throw Error("corrupt JPEG stream (a second frame)");
    int len = u16();
    int precision = u8();
    height_ = u16();
    width_ = u16();
    int nc = u8();
    if (precision != 8) {
      throw Error(precision == 12 ? "12-bit JPEG is not supported"
                                  : "JPEG sample precision other than 8 bits");
    }
    if (height_ == 0) throw Error("JPEG with height 0 (DNL) is not supported");
    if (width_ == 0) throw Error("corrupt JPEG stream (width 0)");
    if (nc != 1 && nc != 3 && nc != 4) {
      throw Error("JPEG with " + std::to_string(nc) + " components is not supported");
    }
    if (len != 8 + 3 * nc) throw Error("corrupt JPEG stream (bad SOF length)");
    progressive_ = progressive;
    comps_.resize(nc);
    hmax_ = vmax_ = 1;
    for (auto& c : comps_) {
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) {
        throw Error("corrupt JPEG stream (bad sampling factors)");
      }
      hmax_ = std::max(hmax_, c.h);
      vmax_ = std::max(vmax_, c.v);
    }
    mcux_ = (width_ + 8 * hmax_ - 1) / (8 * hmax_);
    mcuy_ = (height_ + 8 * vmax_ - 1) / (8 * vmax_);
    for (auto& c : comps_) {
      if (hmax_ % c.h || vmax_ % c.v) {
        throw Error("JPEG with fractional sampling factors is not supported");
      }
      c.dw = (int)(((int64_t)width_ * c.h + hmax_ - 1) / hmax_);
      c.dh = (int)(((int64_t)height_ * c.v + vmax_ - 1) / vmax_);
      c.bw = mcux_ * c.h;
      c.bh = mcuy_ * c.v;
      c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    }
    frame_ = true;
  }

  void dqt() {
    int len = u16() - 2;
    while (len > 0) {
      int pq = u8();
      int t = pq & 15, prec = pq >> 4;
      if (t > 3 || prec > 1) throw Error("corrupt JPEG stream (bad DQT)");
      for (int k = 0; k < 64; ++k) {
        quant_[t][kZigzag[k]] = (uint16_t)(prec ? u16() : u8());
      }
      quant_defined_[t] = true;
      len -= 1 + 64 * (prec + 1);
    }
    if (len != 0) throw Error("corrupt JPEG stream (bad DQT length)");
  }

  void dht() {
    int len = u16() - 2;
    while (len > 0) {
      int tc_th = u8();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) throw Error("corrupt JPEG stream (bad DHT)");
      int counts[17] = {0};
      int total = 0;
      for (int l = 1; l <= 16; ++l) {
        counts[l] = u8();
        total += counts[l];
      }
      if (total > 256) throw Error("corrupt JPEG stream (bad DHT)");
      Huffman& t = huff_[tc][th];
      t.table.assign(65536, 0);
      uint32_t code = 0;
      for (int l = 1; l <= 16; ++l) {
        for (int i = 0; i < counts[l]; ++i) {
          int sym = u8();
          if (code >= (1u << l)) throw Error("corrupt JPEG stream (bad Huffman table)");
          uint32_t lo = code << (16 - l), hi = (code + 1) << (16 - l);
          for (uint32_t e = lo; e < hi; ++e) t.table[e] = (uint16_t)((l << 8) | sym);
          ++code;
        }
        code <<= 1;
      }
      t.defined = true;
      len -= 17 + total;
    }
    if (len != 0) throw Error("corrupt JPEG stream (bad DHT length)");
  }

  void scan() {
    int len = u16();
    int ns = u8();
    if (ns < 1 || ns > 4 || len != 6 + 2 * ns) {
      throw Error("corrupt JPEG stream (bad SOS)");
    }
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      int id = u8(), tt = u8();
      Component* found = nullptr;
      for (auto& c : comps_) {
        if (c.id == id) found = &c;
      }
      if (!found) throw Error("corrupt JPEG stream (scan of an unknown component)");
      found->td = tt >> 4;
      found->ta = tt & 15;
      if (found->td > 3 || found->ta > 3) throw Error("corrupt JPEG stream (bad SOS)");
      sc.push_back(found);
    }
    int ss = u8(), se = u8(), a = u8();
    int ah = a >> 4, al = a & 15;
    if (!progressive_) {
      ss = 0;
      se = 63;
      ah = al = 0;
    } else if (ss > se || se > 63 || (ss == 0 && se != 0) || (ss > 0 && ns != 1) ||
               al > 13) {
      throw Error("corrupt JPEG stream (bad progressive scan)");
    }
    for (Component* c : sc) {
      if (!c->quant_latched) {  // latch_quant_tables: at the first scan
        if (!quant_defined_[c->tq]) throw Error("corrupt JPEG stream (no quantisation table)");
        std::memcpy(c->quant, quant_[c->tq], sizeof(c->quant));
        c->quant_latched = true;
      }
      bool dc = !progressive_ || (ss == 0 && ah == 0);
      bool ac = !progressive_ || ss > 0;
      if ((dc && !huff_[0][c->td].defined) || (ac && !huff_[1][c->ta].defined)) {
        throw Error("corrupt JPEG stream (no Huffman table)");
      }
      c->pred = 0;
    }
    eobrun_ = 0;
    BitReader br(p_, end_);
    int64_t n_units;
    bool single = ns == 1;
    int sbw = 0;
    if (single) {
      sbw = (sc[0]->dw + 7) / 8;
      n_units = (int64_t)sbw * ((sc[0]->dh + 7) / 8);
    } else {
      n_units = (int64_t)mcux_ * mcuy_;
    }
    int rst = 0;
    for (int64_t u = 0; u < n_units; ++u) {
      if (restart_interval_ && u > 0 && u % restart_interval_ == 0) {
        br.restart(rst++);
        for (Component* c : sc) c->pred = 0;
        eobrun_ = 0;
      }
      if (single) {
        Component* c = sc[0];
        int bx = (int)(u % sbw), by = (int)(u / sbw);
        block(br, *c, c->coef.data() + ((int64_t)by * c->bw + bx) * 64, ss, se,
              ah, al);
      } else {
        int mx = (int)(u % mcux_), my = (int)(u / mcux_);
        for (Component* c : sc) {
          for (int v = 0; v < c->v; ++v) {
            for (int h = 0; h < c->h; ++h) {
              int64_t bi = (int64_t)(my * c->v + v) * c->bw + mx * c->h + h;
              block(br, *c, c->coef.data() + bi * 64, ss, se, ah, al);
            }
          }
        }
      }
    }
    p_ = br.pos();
  }

  void block(BitReader& br, Component& c, int16_t* b, int ss, int se, int ah,
             int al) {
    if (!progressive_) {
      int s = br.decode(huff_[0][c.td]);
      c.pred += br.receive_extend(s);
      b[0] = (int16_t)c.pred;
      const Huffman& act = huff_[1][c.ta];
      for (int k = 1; k < 64; ++k) {
        int rs = br.decode(act);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          if (k > 63) throw Error("corrupt JPEG stream (coefficient index past 63)");
          b[kZigzag[k]] = (int16_t)br.receive_extend(s);
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
      return;
    }
    if (ss == 0) {  // DC scans
      if (ah == 0) {
        int s = br.decode(huff_[0][c.td]);
        c.pred += br.receive_extend(s);
        b[0] = (int16_t)(c.pred * (1 << al));
      } else if (br.bit()) {
        b[0] = (int16_t)(b[0] | (1 << al));
      }
      return;
    }
    const Huffman& act = huff_[1][c.ta];
    if (ah == 0) {  // AC first
      if (eobrun_ > 0) {
        --eobrun_;
        return;
      }
      for (int k = ss; k <= se; ++k) {
        int rs = br.decode(act);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          k += r;
          if (k > 63) throw Error("corrupt JPEG stream (coefficient index past 63)");
          b[kZigzag[k]] = (int16_t)(br.receive_extend(s) * (1 << al));
        } else if (r < 15) {
          eobrun_ = 1 << r;
          if (r) eobrun_ += br.bits(r);
          --eobrun_;
          break;
        } else {
          k += 15;
        }
      }
      return;
    }
    // AC refinement (jdphuff.c decode_mcu_AC_refine)
    int p1 = 1 << al, m1 = -(1 << al);
    int k = ss;
    if (eobrun_ == 0) {
      for (; k <= se; ++k) {
        int rs = br.decode(act);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          if (s != 1) throw Error("corrupt JPEG stream (bad refinement)");
          s = br.bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun_ = 1 << r;
          if (r) eobrun_ += br.bits(r);
          break;
        }
        do {
          int16_t* coef = b + kZigzag[k];
          if (*coef != 0) {
            if (br.bit() && (*coef & p1) == 0) {
              *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
            }
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) {
          if (k > 63) throw Error("corrupt JPEG stream (coefficient index past 63)");
          b[kZigzag[k]] = (int16_t)s;
        }
      }
    }
    if (eobrun_ > 0) {
      for (; k <= se; ++k) {
        int16_t* coef = b + kZigzag[k];
        if (*coef != 0 && br.bit() && (*coef & p1) == 0) {
          *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
        }
      }
      --eobrun_;
    }
  }

  void output(uint8_t* rgb) {
    int nc = (int)comps_.size();
    std::vector<Plane> full(nc);
    for (int i = 0; i < nc; ++i) {
      Component& c = comps_[i];
      if (!c.quant_latched) throw Error("truncated JPEG stream (a component was never scanned)");
      Plane p;
      p.w = c.bw * 8;
      p.h = c.bh * 8;
      p.px.resize((size_t)p.w * p.h);
      for (int by = 0; by < c.bh; ++by) {
        for (int bx = 0; bx < c.bw; ++bx) {
          idct_islow(c.coef.data() + ((int64_t)by * c.bw + bx) * 64, c.quant,
                     p.row(by * 8) + bx * 8, p.w);
        }
      }
      full[i] = upsample(p, c.dw, c.dh, hmax_ / c.h, vmax_ / c.v);
    }
    const int64_t W = width_, H = height_;
    if (nc == 1) {
      for (int64_t y = 0; y < H; ++y) {
        const uint8_t* yp = full[0].row((int)y);
        uint8_t* o = rgb + y * W * 3;
        for (int64_t x = 0; x < W; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = yp[x];
      }
      return;
    }
    if (nc == 3) {
      bool is_rgb;
      if (saw_jfif_) {
        is_rgb = false;
      } else if (saw_adobe_) {
        is_rgb = adobe_transform_ == 0;
      } else {
        is_rgb = comps_[0].id == 'R' && comps_[1].id == 'G' && comps_[2].id == 'B';
      }
      // jdcolor.c build_ycc_rgb_table, SCALEBITS 16
      int cr_r[256], cb_b[256];
      int64_t cr_g[256], cb_g[256];
      for (int i = 0; i < 256; ++i) {
        int64_t x = i - 128;
        cr_r[i] = (int)((91881 * x + 32768) >> 16);
        cb_b[i] = (int)((116130 * x + 32768) >> 16);
        cr_g[i] = -46802 * x;
        cb_g[i] = -22554 * x + 32768;
      }
      auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); };
      for (int64_t y = 0; y < H; ++y) {
        const uint8_t* p0 = full[0].row((int)y);
        const uint8_t* p1 = full[1].row((int)y);
        const uint8_t* p2 = full[2].row((int)y);
        uint8_t* o = rgb + y * W * 3;
        for (int64_t x = 0; x < W; ++x) {
          if (is_rgb) {
            o[3 * x] = p0[x];
            o[3 * x + 1] = p1[x];
            o[3 * x + 2] = p2[x];
            continue;
          }
          int yy = p0[x], cb = p1[x], cr = p2[x];
          o[3 * x] = clamp(yy + cr_r[cr]);
          o[3 * x + 1] = clamp(yy + (int)((cb_g[cb] + cr_g[cr]) >> 16));
          o[3 * x + 2] = clamp(yy + cb_b[cb]);
        }
      }
      return;
    }
    // four components: CMYK unless Adobe says YCCK (or anything but 0)
    if (saw_adobe_ && adobe_transform_ != 0) {
      throw Error("YCCK JPEG is not supported");
    }
    for (int64_t y = 0; y < H; ++y) {  // Pillow's "CMYK;I" raw mode
      const uint8_t* pc[4];
      for (int i = 0; i < 4; ++i) pc[i] = full[i].row((int)y);
      uint8_t* o = rgb + y * W * 4;
      for (int64_t x = 0; x < W; ++x) {
        for (int i = 0; i < 4; ++i) o[4 * x + i] = (uint8_t)(255 - pc[i][x]);
      }
    }
  }

  const uint8_t* d_;
  const uint8_t* end_;
  const uint8_t* p_ = nullptr;
  bool frame_ = false, progressive_ = false;
  bool saw_jfif_ = false, saw_adobe_ = false;
  int adobe_transform_ = -1;
  int width_ = 0, height_ = 0, hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  int restart_interval_ = 0, eobrun_ = 0, n_scans_ = 0;
  std::vector<Component> comps_;
  uint16_t quant_[4][64];
  bool quant_defined_[4] = {false, false, false, false};
  Huffman huff_[2][4];
};

// ----------------------------------------------------- Gaussian blur (cv2)

// getGaussianKernelBitExact for ufixedpoint16 (8 fractional bits), as
// OpenCV 5.0 computes it
std::vector<uint32_t> gaussian_kernel_fixed(int n, double sigma) {
  std::vector<uint32_t> k(n);
  if (n == 1) {
    k[0] = 256;
    return k;
  }
  double scale2 = -0.125 / (sigma * sigma);
  int n2 = (n - 1) / 2;
  std::vector<double> values(n2 + 1);
  double sum = 0.0;
  for (int i = 0, x = 1 - n; i < n2; ++i, x += 2) {
    double t = std::exp((double)(x * x) * scale2);
    values[i] = t;
    sum += t;
  }
  sum *= 2.0;
  sum += 1.0;
  if ((n & 1) == 0) sum += 1.0;
  double mul1 = 1.0 / sum;
  // each tap is the step of the rounded running sum, so that the rounding
  // errors do not accumulate along the kernel
  double cum = 0.0;
  uint32_t prev = 0;
  for (int i = 0; i < n2; ++i) {
    cum += values[i] * mul1;
    uint32_t c = (uint32_t)std::nearbyint(cum * 256.0);
    k[i] = k[n - 1 - i] = c - prev;
    prev = c;
  }
  k[n2] = 256 - 2 * prev;
  if ((n & 1) == 0) k[n2 + 1] = k[n2];
  return k;
}

inline int reflect101(int p, int len) {
  if (len == 1) return 0;
  while (p < 0 || p >= len) p = p < 0 ? -p : 2 * len - 2 - p;
  return p;
}

}  // namespace

extern "C" {

// Parse a JPEG's headers: dims = {height, width, components}.
int jpeg_header(const uint8_t* data, int64_t n, int* dims, char* err,
                int err_cap) {
  try {
    JpegDecoder dec(data, n);
    dec.read_header();
    dims[0] = dec.height();
    dims[1] = dec.width();
    dims[2] = dec.components();
    return 0;
  } catch (const std::exception& e) {
    return fail(e.what(), err, err_cap);
  }
}

// Decode a one- or three-component JPEG into out [height, width, 3] RGB
// (dims from jpeg_header).
int jpeg_decode_rgb(const uint8_t* data, int64_t n, uint8_t* out, int h, int w,
                    char* err, int err_cap) {
  try {
    JpegDecoder dec(data, n);
    dec.read_header();
    if (dec.height() != h || dec.width() != w) throw Error("size mismatch");
    if (dec.components() == 4) {
      throw Error("a four-component (CMYK) JPEG decodes with jpeg_decode_cmyk");
    }
    dec.decode(out);
    return 0;
  } catch (const std::bad_alloc&) {
    return fail("out of memory decoding the JPEG", err, err_cap);
  } catch (const std::exception& e) {
    return fail(e.what(), err, err_cap);
  }
}

// Decode a four-component JPEG into out [height, width, 4]: the pixels of
// Pillow's "CMYK" mode (dims from jpeg_header).
int jpeg_decode_cmyk(const uint8_t* data, int64_t n, uint8_t* out, int h,
                     int w, char* err, int err_cap) {
  try {
    JpegDecoder dec(data, n);
    dec.read_header();
    if (dec.height() != h || dec.width() != w) throw Error("size mismatch");
    if (dec.components() != 4) throw Error("not a four-component (CMYK) JPEG");
    dec.decode(out);
    return 0;
  } catch (const std::bad_alloc&) {
    return fail("out of memory decoding the JPEG", err, err_cap);
  } catch (const std::exception& e) {
    return fail(e.what(), err, err_cap);
  }
}

// Undo PNG row filters: `raw` holds h rows of (1 + rowbytes) bytes, each a
// filter type then the filtered row; `out` gets h * rowbytes bytes. `bpp`
// is the filter unit: bytes per complete pixel, at least 1.
int png_unfilter(const uint8_t* raw, int h, int64_t rowbytes, int bpp,
                 uint8_t* out, char* err, int err_cap) {
  for (int y = 0; y < h; ++y) {
    const uint8_t* src = raw + (int64_t)y * (rowbytes + 1);
    int f = src[0];
    ++src;
    uint8_t* cur = out + (int64_t)y * rowbytes;
    const uint8_t* prev = y > 0 ? cur - rowbytes : nullptr;
    switch (f) {
      case 0:
        std::memcpy(cur, src, rowbytes);
        break;
      case 1:
        for (int64_t i = 0; i < rowbytes; ++i) {
          cur[i] = (uint8_t)(src[i] + (i >= bpp ? cur[i - bpp] : 0));
        }
        break;
      case 2:
        for (int64_t i = 0; i < rowbytes; ++i) {
          cur[i] = (uint8_t)(src[i] + (prev ? prev[i] : 0));
        }
        break;
      case 3:
        for (int64_t i = 0; i < rowbytes; ++i) {
          int a = i >= bpp ? cur[i - bpp] : 0, b = prev ? prev[i] : 0;
          cur[i] = (uint8_t)(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < rowbytes; ++i) {
          int a = i >= bpp ? cur[i - bpp] : 0, b = prev ? prev[i] : 0;
          int c = (i >= bpp && prev) ? prev[i - bpp] : 0;
          int p = a + b - c;
          int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = (uint8_t)(src[i] + pred);
        }
        break;
      default: {
        char msg[64];
        std::snprintf(msg, sizeof msg, "bad PNG filter type %d in row %d", f, y);
        return fail(msg, err, err_cap);
      }
    }
  }
  return 0;
}

// cv2.GaussianBlur(src, (ksize, ksize), sigma) on [h, w, cn] uint8,
// BORDER_REFLECT_101.
int gaussian_blur_u8(const uint8_t* src, uint8_t* dst, int h, int w, int cn,
                     int ksize, double sigma) {
  if (ksize < 1 || (ksize & 1) == 0 || sigma <= 0.0 || h < 1 || w < 1) return -1;
  // cv2 drops a dimension of one pixel from the kernel
  std::vector<uint32_t> kx = gaussian_kernel_fixed(w == 1 ? 1 : ksize, sigma);
  std::vector<uint32_t> ky = gaussian_kernel_fixed(h == 1 ? 1 : ksize, sigma);
  const int rx = (int)kx.size() / 2, ry = (int)ky.size() / 2;
  const int64_t rowlen = (int64_t)w * cn;
  // row pass: exact sums in units of 1/256 (at most 255 * 256); taps
  // that round to zero are skipped, they add nothing
  std::vector<uint32_t> rows((size_t)h * rowlen);
  std::vector<uint32_t> pad((size_t)(w + 2 * rx) * cn);
  for (int y = 0; y < h; ++y) {
    const uint8_t* s = src + (int64_t)y * rowlen;
    for (int x = -rx; x < w + rx; ++x) {
      const uint8_t* sp = s + (int64_t)reflect101(x, w) * cn;
      for (int c = 0; c < cn; ++c) pad[(int64_t)(x + rx) * cn + c] = sp[c];
    }
    uint32_t* r = rows.data() + (int64_t)y * rowlen;
    std::fill(r, r + rowlen, 0u);
    for (size_t t = 0; t < kx.size(); ++t) {
      const uint32_t kt = kx[t];
      if (kt == 0) continue;
      const uint32_t* pp = pad.data() + (int64_t)t * cn;
      for (int64_t i = 0; i < rowlen; ++i) r[i] += kt * pp[i];
    }
  }
  // column pass: units of 1/65536 (at most 255 * 65536), rounded once
  std::vector<uint32_t> acc((size_t)rowlen);
  for (int y = 0; y < h; ++y) {
    std::fill(acc.begin(), acc.end(), 0u);
    for (size_t t = 0; t < ky.size(); ++t) {
      const uint32_t kt = ky[t];
      if (kt == 0) continue;
      const uint32_t* rp = rows.data() + (int64_t)reflect101(y - ry + (int)t, h) * rowlen;
      for (int64_t i = 0; i < rowlen; ++i) acc[i] += kt * rp[i];
    }
    uint8_t* d = dst + (int64_t)y * rowlen;
    for (int64_t i = 0; i < rowlen; ++i) {
      uint32_t v = (acc[i] + 32768) >> 16;
      d[i] = (uint8_t)(v > 255 ? 255 : v);
    }
  }
  return 0;
}

// Pillow's image.convert("HSV"), a hue shift of `shift` (mod 256), then
// .convert("RGB"), in place on n RGB pixels.
void rgb_hue_shift(uint8_t* rgb, int64_t n, int shift) {
  for (int64_t i = 0; i < n; ++i) {
    uint8_t* px = rgb + 3 * i;
    // Convert.c rgb2hsv_row
    uint8_t r = px[0], g = px[1], b = px[2];
    uint8_t maxc = std::max(r, std::max(g, b));
    uint8_t minc = std::min(r, std::min(g, b));
    uint8_t uh, us, uv = maxc;
    if (minc == maxc) {
      uh = 0;
      us = 0;
    } else {
      float cr = (float)(maxc - minc);
      float s = cr / (float)maxc;
      float rc = ((float)(maxc - r)) / cr;
      float gc = ((float)(maxc - g)) / cr;
      float bc = ((float)(maxc - b)) / cr;
      float hh;
      if (r == maxc) {
        hh = bc - gc;
      } else if (g == maxc) {
        hh = 2.0 + rc - bc;
      } else {
        hh = 4.0 + gc - rc;
      }
      hh = std::fmod((hh / 6.0 + 1.0), 1.0);
      int ih = (int)(hh * 255.0), is = (int)(s * 255.0);
      uh = (uint8_t)(ih < 0 ? 0 : (ih > 255 ? 255 : ih));
      us = (uint8_t)(is < 0 ? 0 : (is > 255 ? 255 : is));
    }
    uh = (uint8_t)((uh + shift) & 255);
    // Convert.c hsv2rgb
    uint8_t h = uh, s = us, v = uv;
    if (s == 0) {
      px[0] = px[1] = px[2] = v;
      continue;
    }
    int ii = (int)std::floor((float)h * 6.0 / 255.0);
    float f = (float)h * 6.0 / 255.0 - (float)ii;
    float fs = ((float)s) / 255.0;
    int p = (int)std::round((float)v * (1.0 - fs));
    int q = (int)std::round((float)v * (1.0 - fs * f));
    int t = (int)std::round((float)v * (1.0 - fs * (1.0 - f)));
    auto clip = [](int x) { return (uint8_t)(x < 0 ? 0 : (x > 255 ? 255 : x)); };
    uint8_t up = clip(p), uq = clip(q), ut = clip(t);
    switch (ii % 6) {
      case 0: px[0] = v; px[1] = ut; px[2] = up; break;
      case 1: px[0] = uq; px[1] = v; px[2] = up; break;
      case 2: px[0] = up; px[1] = v; px[2] = ut; break;
      case 3: px[0] = up; px[1] = uq; px[2] = v; break;
      case 4: px[0] = ut; px[1] = up; px[2] = v; break;
      case 5: px[0] = v; px[1] = up; px[2] = uq; break;
    }
  }
}

}  // extern "C"
