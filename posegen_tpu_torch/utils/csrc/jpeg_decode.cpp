// A baseline JPEG decoder with a C ABI, for the port's image readers
// (posegen_tpu_torch/utils/jpeg.py binds it with ctypes).
//
// It decodes what libjpeg-turbo decodes with its defaults (JDCT_ISLOW,
// fancy upsampling, the jdcolor.c tables), to the same bytes:
//   * SOF0 / SOF1 at 8-bit precision, 1 or 3 components, sampling factors of
//     1 or 2 on each axis (4:4:4, 4:2:2, 4:2:0, 4:4:0), interleaved or
//     single-component scans;
//   * any number of DQT (8- or 16-bit entries) and DHT tables, DRI restart
//     intervals with RSTn markers, 0xFF00 stuffing and 0xFF fill bytes;
//   * APPn / COM segments skipped, but for JFIF (APP0) and the Adobe APP14
//     transform flag, which with the component ids pick the colour space
//     by libjpeg's rule (jdapimin.c default_decompress_parms).
// The integer IDCT is jidctint.c's jpeg_idct_islow (13-bit constants, 2
// pass-1 bits), its output clamped to 0..255 as the library's SIMD build
// clamps it. Chroma is upsampled by jdsample.c's triangle filters (h2v1,
// h1v2, h2v2 with their alternating rounding biases; a box where the
// library takes one: h2v1 / h2v2 at a downsampled width of 2 or less) over
// the component's whole plane, its edges replicated as the library's
// context rows replicate them. YCbCr becomes RGB through jdcolor.c's
// 16-bit fixed-point tables.
//
// Anything else is refused with a message: progressive, arithmetic,
// lossless and hierarchical frames, 12-bit samples, 2 or 4 components,
// other sampling factors, a truncated stream, a missing SOI or EOI, a bad
// Huffman code, a missing restart marker, an unknown marker where a segment
// is due.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 jpeg_decode.cpp -o libjpeg.so

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Error{msg}; }

// jpeg_natural_order: zigzag index -> natural index, with 16 extra entries
// so that a corrupt run past 63 lands on 63 as in libjpeg
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct Huff {
  bool present = false;
  uint8_t look_len[1 << kLookBits];  // 0: the code is longer than kLookBits
  uint8_t look_val[1 << kLookBits];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;        // the current scan's table selectors
  int bw = 0, bh = 0;        // blocks per row / column of the plane
  int dw = 0, dh = 0;        // downsampled width / height (real samples)
  std::vector<uint8_t> plane;  // bw*8 x bh*8 samples
  int64_t dc_pred = 0;  // wide: a corrupt stream's DC sums cannot overflow
  bool seen = false;
};

struct Decoder {
  const uint8_t* data;
  size_t n;
  size_t pos = 0;

  uint16_t qt[4][64];  // natural order
  bool qt_present[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  int restart_interval = 0;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0;

  bool have_frame = false;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int mcux = 0, mcuy = 0;
  Component comp[3];
  bool any_scan = false;

  // bit reader over one scan's entropy-coded data
  uint64_t buf = 0;
  int bits = 0;      // valid bits in buf, MSB first
  int fake = 0;      // zero bits appended after a marker or the end of data
  bool at_marker = false;

  Decoder(const uint8_t* d, size_t len) : data(d), n(len) {}

  int u8() {
    if (pos >= n) fail("truncated stream (it ends inside a segment)");
    return data[pos++];
  }
  int u16() {
    int a = u8();
    return (a << 8) | u8();
  }

  // -- segments ------------------------------------------------------------
  // The next marker code: 0xFF, any 0xFF fill bytes, then the code.
  int next_marker() {
    if (pos >= n) fail("truncated stream (no EOI marker)");
    if (data[pos] != 0xFF)
      fail("no marker where a segment is due (byte 0x" + hex(data[pos]) + " at offset " +
           std::to_string(pos) + ")");
    while (pos < n && data[pos] == 0xFF) pos++;
    if (pos >= n) fail("truncated stream (no EOI marker)");
    return data[pos++];
  }

  static std::string hex(int b) {
    static const char* d = "0123456789ABCDEF";
    return std::string{d[(b >> 4) & 15], d[b & 15]};
  }

  size_t segment_end() {
    int len = u16();
    if (len < 2 || pos - 2 + len > n) fail("truncated stream (a segment runs past the end)");
    return pos - 2 + len;
  }

  void read_app(int marker) {
    size_t end = segment_end();
    size_t len = end - pos;
    const uint8_t* d = data + pos;
    // libjpeg's examine_app0 / examine_app14: JFIF needs 14 bytes, Adobe 12
    if (marker == 0xE0 && len >= 14 && std::memcmp(d, "JFIF\0", 5) == 0) saw_jfif = true;
    if (marker == 0xEE && len >= 12 && std::memcmp(d, "Adobe", 5) == 0) {
      saw_adobe = true;
      adobe_transform = d[11];
    }
    pos = end;
  }

  void read_dqt() {
    size_t end = segment_end();
    while (pos < end) {
      int pq_tq = u8();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) fail("bad DQT table");
      for (int k = 0; k < 64; k++) qt[tq][kNatural[k]] = static_cast<uint16_t>(pq ? u16() : u8());
      qt_present[tq] = true;
    }
    if (pos != end) fail("bad DQT length");
  }

  void read_dht() {
    size_t end = segment_end();
    while (pos < end) {
      int tc_th = u8();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("bad DHT table class or id");
      uint8_t counts[17] = {0};
      int total = 0;
      for (int l = 1; l <= 16; l++) total += counts[l] = static_cast<uint8_t>(u8());
      if (total > 256) fail("bad DHT table (more than 256 codes)");
      Huff& t = tc == 0 ? dc[th] : ac[th];
      for (int i = 0; i < total; i++) t.vals[i] = static_cast<uint8_t>(u8());
      build_huff(t, counts);
    }
    if (pos != end) fail("bad DHT length");
  }

  static void build_huff(Huff& t, const uint8_t* counts) {
    std::memset(t.look_len, 0, sizeof(t.look_len));
    int code = 0, k = 0;
    for (int l = 1; l <= 16; l++) {
      t.valoffset[l] = k - code;
      for (int i = 0; i < counts[l]; i++, k++, code++) {
        if (code >= (1 << l)) fail("bad DHT table (over-subscribed codes)");
        if (l <= kLookBits) {
          int shift = kLookBits - l;
          for (int j = 0; j < (1 << shift); j++) {
            t.look_len[(code << shift) | j] = static_cast<uint8_t>(l);
            t.look_val[(code << shift) | j] = t.vals[k];
          }
        }
      }
      t.maxcode[l] = counts[l] ? code - 1 : -1;
      code <<= 1;
    }
    t.maxcode[17] = 0x7FFFFFFF;
    t.present = true;
  }

  void read_dri() {
    size_t end = segment_end();
    restart_interval = u16();
    if (pos != end) fail("bad DRI length");
  }

  void read_sof(int marker) {
    if (have_frame) fail("a second frame header");
    size_t end = segment_end();
    int precision = u8();
    height = u16();
    width = u16();
    ncomp = u8();
    if (precision != 8) fail(std::to_string(precision) + "-bit samples (only 8-bit reads here)");
    if (height == 0) fail("a height of 0 (set by a DNL marker; not read here)");
    if (width == 0) fail("a width of 0");
    if (ncomp == 4) fail("4 components (CMYK / YCCK; only grey and 3-component colour read here)");
    if (ncomp != 1 && ncomp != 3) fail(std::to_string(ncomp) + " components");
    hmax = vmax = 1;
    for (int c = 0; c < ncomp; c++) {
      Component& k = comp[c];
      k.id = u8();
      int hv = u8();
      k.h = hv >> 4;
      k.v = hv & 15;
      k.tq = u8();
      if (k.h < 1 || k.h > 2 || k.v < 1 || k.v > 2)
        fail("sampling factors " + std::to_string(k.h) + "x" + std::to_string(k.v) +
             " (only 1 or 2 on each axis read here: 4:4:4, 4:2:2, 4:2:0, 4:4:0)");
      if (k.tq > 3) fail("bad quantization table id");
      hmax = hmax > k.h ? hmax : k.h;
      vmax = vmax > k.v ? vmax : k.v;
    }
    if (pos != end) fail("bad SOF length");
    (void)marker;
    if (ncomp == 1) comp[0].h = comp[0].v = hmax = vmax = 1;  // one component: no subsampling
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int c = 0; c < ncomp; c++) {
      Component& k = comp[c];
      k.dw = static_cast<int>((static_cast<int64_t>(width) * k.h + hmax - 1) / hmax);
      k.dh = static_cast<int>((static_cast<int64_t>(height) * k.v + vmax - 1) / vmax);
      k.bw = mcux * k.h;
      k.bh = mcuy * k.v;
      k.plane.assign(static_cast<size_t>(k.bw) * 8 * k.bh * 8, 0);
    }
    have_frame = true;
  }

  // -- the bit reader ------------------------------------------------------
  // Appends whole bytes while at most 56 bits are held. At a marker (or the
  // end of the data) it stops reading and appends zero bits instead, as
  // libjpeg does, counting them in `fake`.
  void fill() {
    while (bits <= 56) {
      uint32_t b = 0;
      if (!at_marker) {
        if (pos >= n) {
          at_marker = true;
        } else if (data[pos] != 0xFF) {
          b = data[pos++];
        } else {
          size_t q = pos + 1;
          while (q < n && data[q] == 0xFF) q++;
          if (q < n && data[q] == 0) {
            b = 0xFF;
            pos = q + 1;
          } else {
            at_marker = true;  // pos stays on the marker's first 0xFF
          }
        }
      }
      if (at_marker) fake += 8;
      buf |= static_cast<uint64_t>(b) << (56 - bits);
      bits += 8;
    }
  }

  void consume(int k) {
    buf <<= k;
    bits -= k;
  }

  int decode(const Huff& t) {
    if (bits < 16) fill();
    uint32_t look = static_cast<uint32_t>(buf >> (64 - kLookBits));
    int len = t.look_len[look];
    if (len) {
      consume(len);
      return t.look_val[look];
    }
    int32_t code = static_cast<int32_t>(buf >> (64 - 16));
    for (len = kLookBits + 1; len <= 16; len++) {
      int32_t c = code >> (16 - len);
      if (c <= t.maxcode[len]) {
        consume(len);
        return t.vals[t.valoffset[len] + c];
      }
    }
    fail("bad Huffman code");
  }

  int receive_extend(int s) {
    if (s == 0) return 0;
    if (bits < s) fill();
    int v = static_cast<int>(buf >> (64 - s));
    consume(s);
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
  }

  void check_not_short() {
    if (bits < fake) fail("truncated stream (a scan ends before its last block)");
  }

  // Drops what the reader holds, skips to the next marker and returns its code.
  int end_of_segment() {
    while (!at_marker) {
      buf = 0;
      bits = fake = 0;
      fill();
    }
    buf = 0;
    bits = fake = 0;
    at_marker = false;
    if (pos >= n) fail("truncated stream (no EOI marker)");
    return next_marker();
  }

  // -- blocks --------------------------------------------------------------
  void decode_block(Component& k, int bx, int by) {
    int16_t coef[64];
    std::memset(coef, 0, sizeof(coef));
    const Huff& tdc = dc[k.td];
    const Huff& tac = ac[k.ta];
    int s = decode(tdc);
    if (s > 15) fail("bad DC coefficient size");
    k.dc_pred += receive_extend(s);
    coef[0] = static_cast<int16_t>(k.dc_pred);
    for (int i = 1; i < 64; i++) {
      int rs = decode(tac);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        i += r;
        int v = receive_extend(s);
        coef[kNatural[i > 63 + 16 ? 63 + 16 : i]] = static_cast<int16_t>(v);
      } else {
        if (r != 15) break;
        i += 15;
      }
    }
    int stride = k.bw * 8;
    idct_islow(coef, qt[k.tq], k.plane.data() + static_cast<size_t>(by) * 8 * stride + bx * 8,
               stride);
  }

  // jidctint.c's jpeg_idct_islow
  static inline uint8_t clamp_out(int64_t x) {
    x += 128;
    return static_cast<uint8_t>(x < 0 ? 0 : (x > 255 ? 255 : x));
  }

  static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
    constexpr int CB = 13, P1 = 2;
    constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                      F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                      F2562 = 20995, F3072 = 25172;
    int ws[64];
    for (int c = 0; c < 8; c++) {
      const int16_t* ip = in + c;
      const uint16_t* qp = q + c;
      int* wp = ws + c;
      if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 &&
          ip[48] == 0 && ip[56] == 0) {
        int dcval = (ip[0] * qp[0]) * (1 << P1);
        for (int r = 0; r < 8; r++) wp[8 * r] = dcval;
        continue;
      }
      int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      z2 = ip[0] * qp[0];
      z3 = ip[32] * qp[32];
      int64_t tmp0 = (z2 + z3) * (1 << CB);
      int64_t tmp1 = (z2 - z3) * (1 << CB);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = ip[56] * qp[56];
      tmp1 = ip[40] * qp[40];
      tmp2 = ip[24] * qp[24];
      tmp3 = ip[8] * qp[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      constexpr int S = CB - P1;
      constexpr int64_t R = int64_t{1} << (S - 1);
      wp[0] = static_cast<int>((tmp10 + tmp3 + R) >> S);
      wp[56] = static_cast<int>((tmp10 - tmp3 + R) >> S);
      wp[8] = static_cast<int>((tmp11 + tmp2 + R) >> S);
      wp[48] = static_cast<int>((tmp11 - tmp2 + R) >> S);
      wp[16] = static_cast<int>((tmp12 + tmp1 + R) >> S);
      wp[40] = static_cast<int>((tmp12 - tmp1 + R) >> S);
      wp[24] = static_cast<int>((tmp13 + tmp0 + R) >> S);
      wp[32] = static_cast<int>((tmp13 - tmp0 + R) >> S);
    }
    for (int r = 0; r < 8; r++) {
      const int* wp = ws + 8 * r;
      uint8_t* op = out + static_cast<size_t>(r) * stride;
      if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 && wp[6] == 0 &&
          wp[7] == 0) {
        uint8_t v = clamp_out((static_cast<int64_t>(wp[0]) + (1 << (P1 + 2))) >> (P1 + 3));
        for (int c = 0; c < 8; c++) op[c] = v;
        continue;
      }
      int64_t z2 = wp[2], z3 = wp[6];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      int64_t tmp0 = (static_cast<int64_t>(wp[0]) + wp[4]) * (1 << CB);
      int64_t tmp1 = (static_cast<int64_t>(wp[0]) - wp[4]) * (1 << CB);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = wp[7];
      tmp1 = wp[5];
      tmp2 = wp[3];
      tmp3 = wp[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      constexpr int S = CB + P1 + 3;
      constexpr int64_t R = int64_t{1} << (S - 1);
      op[0] = clamp_out((tmp10 + tmp3 + R) >> S);
      op[7] = clamp_out((tmp10 - tmp3 + R) >> S);
      op[1] = clamp_out((tmp11 + tmp2 + R) >> S);
      op[6] = clamp_out((tmp11 - tmp2 + R) >> S);
      op[2] = clamp_out((tmp12 + tmp1 + R) >> S);
      op[5] = clamp_out((tmp12 - tmp1 + R) >> S);
      op[3] = clamp_out((tmp13 + tmp0 + R) >> S);
      op[4] = clamp_out((tmp13 - tmp0 + R) >> S);
    }
  }

  // -- scans ---------------------------------------------------------------
  // Returns the marker that follows the scan's entropy-coded data.
  int read_sos() {
    if (!have_frame) fail("a scan before the frame header");
    size_t end = segment_end();
    int ns = u8();
    if (ns < 1 || ns > ncomp) fail("bad scan component count");
    Component* sc[3];
    for (int i = 0; i < ns; i++) {
      int id = u8(), tdta = u8();
      Component* k = nullptr;
      for (int c = 0; c < ncomp; c++)
        if (comp[c].id == id) k = &comp[c];
      if (!k) fail("a scan names an unknown component");
      k->td = tdta >> 4;
      k->ta = tdta & 15;
      if (k->td > 3 || k->ta > 3 || !dc[k->td].present || !ac[k->ta].present)
        fail("a scan uses an undefined Huffman table");
      if (!qt_present[k->tq]) fail("a component uses an undefined quantization table");
      k->seen = true;
      sc[i] = k;
    }
    int ss = u8(), se = u8(), ah_al = u8();
    if (ss != 0 || se != 63 || ah_al != 0) fail("a scan with spectral selection (progressive)");
    if (pos != end) fail("bad SOS length");
    for (int i = 0; i < ns; i++) sc[i]->dc_pred = 0;
    any_scan = true;
    buf = 0;
    bits = fake = 0;
    at_marker = false;

    int64_t n_mcu, per_row;
    if (ns == 1) {
      Component& k = *sc[0];
      per_row = (k.dw + 7) / 8;
      n_mcu = per_row * ((k.dh + 7) / 8);
    } else {
      per_row = mcux;
      n_mcu = static_cast<int64_t>(mcux) * mcuy;
    }
    int rst_expect = 0;
    for (int64_t m = 0; m < n_mcu; m++) {
      if (restart_interval && m && m % restart_interval == 0) {
        check_not_short();
        int mk = end_of_segment();
        if (mk != 0xD0 + rst_expect)
          fail("restart marker RST" + std::to_string(rst_expect) + " missing (marker 0x" +
               hex(mk) + " found)");
        rst_expect = (rst_expect + 1) & 7;
        for (int i = 0; i < ns; i++) sc[i]->dc_pred = 0;
      }
      int mx = static_cast<int>(m % per_row), my = static_cast<int>(m / per_row);
      if (ns == 1) {
        decode_block(*sc[0], mx, my);
      } else {
        for (int i = 0; i < ns; i++) {
          Component& k = *sc[i];
          for (int by = 0; by < k.v; by++)
            for (int bx = 0; bx < k.h; bx++) decode_block(k, mx * k.h + bx, my * k.v + by);
        }
      }
    }
    check_not_short();
    return end_of_segment();
  }

  // -- the whole stream ----------------------------------------------------
  // Reads markers up to the first scan (header_only) or to EOI.
  void run(bool header_only) {
    if (n < 2 || data[0] != 0xFF || data[1] != 0xD8) fail("no SOI marker at the start");
    pos = 2;
    int m = next_marker();
    for (;;) {
      if (m == 0xD9) {
        if (!any_scan) fail("EOI before any scan");
        return;
      }
      if (m >= 0xE0 && m <= 0xEF) {
        read_app(m);
      } else if (m == 0xFE) {
        pos = segment_end();
      } else if (m == 0xDB) {
        read_dqt();
      } else if (m == 0xC4) {
        read_dht();
      } else if (m == 0xDD) {
        read_dri();
      } else if (m == 0xC0 || m == 0xC1) {
        read_sof(m);
        if (header_only) return;
      } else if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE) {
        fail("a progressive frame (SOF" + std::to_string(m - 0xC0) + ")");
      } else if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF) {
        fail("a lossless frame (SOF" + std::to_string(m - 0xC0) + ")");
      } else if (m == 0xC9 || m == 0xCC || m == 0xCD) {
        fail("arithmetic coding (marker 0x" + hex(m) + ")");
      } else if (m == 0xC5) {
        fail("a hierarchical frame (SOF5)");
      } else if (m == 0xDA) {
        m = read_sos();
        continue;
      } else if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {
        // standalone markers with no segment: libjpeg passes over them
      } else {
        fail("unknown marker 0x" + hex(m) + " where a segment is due");
      }
      m = next_marker();
    }
  }

  int colour_is_rgb() const {
    if (ncomp != 3) return 0;
    if (saw_jfif) return 0;
    if (saw_adobe) return adobe_transform == 0;
    return comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66;
  }

  // -- upsampling (jdsample.c) and colour (jdcolor.c) -----------------------
  // The component's samples at full resolution, rows of `width` (at least
  // `height` rows).
  std::vector<uint8_t> upsample(const Component& k) const {
    int hx = hmax / k.h, vx = vmax / k.v;
    int stride = k.bw * 8;
    const uint8_t* p = k.plane.data();
    int ow = k.dw * hx;
    int oh = k.dh * vx;
    std::vector<uint8_t> out(static_cast<size_t>(ow) * oh);
    auto row = [&](int y) {
      y = y < 0 ? 0 : (y >= k.dh ? k.dh - 1 : y);
      return p + static_cast<size_t>(y) * stride;
    };
    const int dw = k.dw;
    if (hx == 1 && vx == 1) {
      for (int y = 0; y < oh; y++) std::memcpy(&out[static_cast<size_t>(y) * ow], row(y), ow);
    } else if (hx == 2 && vx == 1) {
      for (int y = 0; y < oh; y++) {
        const uint8_t* in = row(y);
        uint8_t* o = &out[static_cast<size_t>(y) * ow];
        if (dw > 2) {
          o[0] = in[0];
          o[1] = static_cast<uint8_t>((in[0] * 3 + in[1] + 2) >> 2);
          for (int x = 1; x < dw - 1; x++) {
            int v = in[x] * 3;
            o[2 * x] = static_cast<uint8_t>((v + in[x - 1] + 1) >> 2);
            o[2 * x + 1] = static_cast<uint8_t>((v + in[x + 1] + 2) >> 2);
          }
          o[2 * dw - 2] = static_cast<uint8_t>((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
          o[2 * dw - 1] = in[dw - 1];
        } else {
          for (int x = 0; x < dw; x++) o[2 * x] = o[2 * x + 1] = in[x];
        }
      }
    } else if (hx == 1 && vx == 2) {
      for (int y = 0; y < k.dh; y++) {
        for (int v = 0; v < 2; v++) {
          const uint8_t* in0 = row(y);
          const uint8_t* in1 = row(v == 0 ? y - 1 : y + 1);
          int bias = v == 0 ? 1 : 2;
          uint8_t* o = &out[static_cast<size_t>(2 * y + v) * ow];
          for (int x = 0; x < dw; x++) o[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
        }
      }
    } else {  // h2v2
      for (int y = 0; y < k.dh; y++) {
        for (int v = 0; v < 2; v++) {
          uint8_t* o = &out[static_cast<size_t>(2 * y + v) * ow];
          const uint8_t* in0 = row(y);
          if (dw <= 2) {
            for (int x = 0; x < dw; x++) o[2 * x] = o[2 * x + 1] = in0[x];
            continue;
          }
          const uint8_t* in1 = row(v == 0 ? y - 1 : y + 1);
          int this_s = in0[0] * 3 + in1[0];
          int next_s = in0[1] * 3 + in1[1];
          o[0] = static_cast<uint8_t>((this_s * 4 + 8) >> 4);
          o[1] = static_cast<uint8_t>((this_s * 3 + next_s + 7) >> 4);
          int last_s = this_s;
          this_s = next_s;
          for (int x = 1; x < dw - 1; x++) {
            next_s = in0[x + 1] * 3 + in1[x + 1];
            o[2 * x] = static_cast<uint8_t>((this_s * 3 + last_s + 8) >> 4);
            o[2 * x + 1] = static_cast<uint8_t>((this_s * 3 + next_s + 7) >> 4);
            last_s = this_s;
            this_s = next_s;
          }
          o[2 * dw - 2] = static_cast<uint8_t>((this_s * 3 + last_s + 8) >> 4);
          o[2 * dw - 1] = static_cast<uint8_t>((this_s * 4 + 7) >> 4);
        }
      }
    }
    return out;
  }

  void write(uint8_t* out) const {
    if (ncomp == 1) {
      const Component& k = comp[0];
      for (int y = 0; y < height; y++)
        std::memcpy(out + static_cast<size_t>(y) * width,
                    k.plane.data() + static_cast<size_t>(y) * k.bw * 8, width);
      return;
    }
    std::vector<uint8_t> up[3];
    int ow[3];
    for (int c = 0; c < 3; c++) {
      up[c] = upsample(comp[c]);
      ow[c] = comp[c].dw * (hmax / comp[c].h);
    }
    if (colour_is_rgb()) {
      for (int y = 0; y < height; y++)
        for (int x = 0; x < width; x++)
          for (int c = 0; c < 3; c++)
            out[(static_cast<size_t>(y) * width + x) * 3 + c] =
                up[c][static_cast<size_t>(y) * ow[c] + x];
      return;
    }
    // jdcolor.c build_ycc_rgb_table: SCALEBITS 16
    constexpr int SB = 16;
    constexpr int64_t HALF = int64_t{1} << (SB - 1);
    auto fix = [](double x) { return static_cast<int64_t>(x * (1L << SB) + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; i++) {
      int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + HALF) >> SB);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + HALF) >> SB);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + HALF;
    }
    auto lim = [](int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); };
    for (int y = 0; y < height; y++) {
      const uint8_t* py = &up[0][static_cast<size_t>(y) * ow[0]];
      const uint8_t* pb = &up[1][static_cast<size_t>(y) * ow[1]];
      const uint8_t* pr = &up[2][static_cast<size_t>(y) * ow[2]];
      uint8_t* o = out + static_cast<size_t>(y) * width * 3;
      for (int x = 0; x < width; x++) {
        int yy = py[x], cb = pb[x], cr = pr[x];
        o[3 * x] = lim(yy + cr_r[cr]);
        o[3 * x + 1] = lim(yy + static_cast<int>((cb_g[cb] + cr_g[cr]) >> SB));
        o[3 * x + 2] = lim(yy + cb_b[cb]);
      }
    }
  }
};

void put_error(char* err, int errlen, const std::string& msg) {
  if (!err || errlen <= 0) return;
  size_t k = msg.size() < static_cast<size_t>(errlen - 1) ? msg.size() : errlen - 1;
  std::memcpy(err, msg.data(), k);
  err[k] = 0;
}

}  // namespace

extern "C" {

// The frame header: height, width and channels (1 grey, 3 colour). 0 on
// success, else 1 with the reason in err.
int pg_jpeg_info(const uint8_t* data, int64_t n, int* height, int* width, int* channels,
                 char* err, int errlen) {
  try {
    Decoder d(data, static_cast<size_t>(n));
    d.run(true);
    if (!d.have_frame) fail("no frame header (SOF0 / SOF1) before EOI");
    *height = d.height;
    *width = d.width;
    *channels = d.ncomp;
    return 0;
  } catch (const Error& e) {
    put_error(err, errlen, e.msg);
  } catch (const std::exception& e) {
    put_error(err, errlen, e.what());
  }
  return 1;
}

// Decodes the whole stream into out: height x width x channels uint8 (the
// info call's shape; out_bytes must equal it). 0 on success, else 1 with
// the reason in err.
int pg_jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t out_bytes, char* err,
                   int errlen) {
  try {
    Decoder d(data, static_cast<size_t>(n));
    d.run(false);
    if (!d.have_frame) fail("no frame header (SOF0 / SOF1) before EOI");
    for (int c = 0; c < d.ncomp; c++)
      if (!d.comp[c].seen) fail("component " + std::to_string(c) + " is in no scan");
    if (static_cast<int64_t>(d.height) * d.width * d.ncomp != out_bytes)
      fail("output buffer of the wrong size");
    d.write(out);
    return 0;
  } catch (const Error& e) {
    put_error(err, errlen, e.msg);
  } catch (const std::exception& e) {
    put_error(err, errlen, e.what());
  }
  return 1;
}

}  // extern "C"
