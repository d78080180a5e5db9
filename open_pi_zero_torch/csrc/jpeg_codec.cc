// Baseline JPEG codec for the data pipeline, on the host, in C++17 with a
// plain C interface (bound with ctypes by data/jpeg.py). It needs no
// libjpeg: the decoder reproduces tf.io.decode_jpeg's default output bit
// for bit, and the encoder tf.io.encode_jpeg's bytes, by following the
// integer algorithms of libjpeg(-turbo) that TensorFlow runs:
//
//   decode  Huffman sequential (SOF0, SOF1), 8-bit samples, 1 or 3
//           components, sampling factors 1 or 2 per axis;
//           jidctfst.c's IFAST (AAN) inverse DCT, the dequantisation
//           premultiplied by the AAN scales as jddctmgr.c does;
//           jdsample.c's "fancy" triangle upsampling (h2v1, h2v2, h1v2),
//           with its alternating rounding bias and its context rows across
//           iMCU boundaries; jdcolor.c's fixed-point YCbCr -> RGB.
//   encode  JFIF 1.01 at 300 dpi, the IJG quantisation tables scaled as
//           jcparam.c scales them (baseline-clamped), the standard Huffman
//           tables of ITU T.81 Annex K.3; jccolor.c's RGB -> YCbCr,
//           jcsample.c's h2v2 downsampling (bias 1, 2, 1, 2, ...) with
//           edges replicated out to whole MCUs, jfdctint.c's ISLOW forward
//           DCT, jcdctmgr.c's rounded division, jccoefct.c's dummy blocks,
//           and jcmarker.c's marker order.
//
// Progressive, lossless, arithmetic-coded, 12-bit, 4-component and
// RGB-coded files are refused (status 1, "not implemented"); truncated or
// corrupt data is status 2.

#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum Status { kOk = 0, kUnsupported = 1, kCorrupt = 2, kBadArgument = 3, kNoMemory = 4 };

struct Failure {
  Status status;
  std::string message;
};

[[noreturn]] void unsupported(const std::string& what) { throw Failure{kUnsupported, what}; }
[[noreturn]] void corrupt(const std::string& what) { throw Failure{kCorrupt, what}; }

// Zigzag position -> natural (row-major) index, with 16 spare entries of
// 63 so that a corrupt run length cannot index past the block (libjpeg's
// jpeg_natural_order does the same).
const int kNaturalOrder[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

inline int clamp255(int x) { return x < 0 ? 0 : (x > 255 ? 255 : x); }
inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// --------------------------------------------------------------------------
// Decoder
// --------------------------------------------------------------------------

struct HuffTable {
  bool present = false;
  // 9-bit lookahead: the code's length (0 = longer than 9 bits) and value.
  uint8_t look_len[512];
  uint8_t look_val[512];
  int32_t maxcode[18];  // largest code of each length, -1 if none
  int32_t valoffset[18];
  uint8_t vals[256];
};

constexpr int kLookBits = 9;

void build_huffman(HuffTable& t, const uint8_t bits[17], const uint8_t* vals, int count, bool dc) {
  if (count > 256) corrupt("DHT with more than 256 symbols");
  std::memcpy(t.vals, vals, count);
  if (dc)
    for (int i = 0; i < count; ++i)
      if (vals[i] > 15) corrupt("DHT: DC symbol above 15");
  std::memset(t.look_len, 0, sizeof t.look_len);
  int code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    t.valoffset[len] = k - code;
    for (int i = 0; i < bits[len]; ++i, ++k, ++code) {
      if (code >= (1 << len)) corrupt("DHT: code lengths over-subscribed");
      if (len <= kLookBits) {
        int fill = 1 << (kLookBits - len);
        int base = code << (kLookBits - len);
        for (int j = 0; j < fill; ++j) {
          t.look_len[base + j] = static_cast<uint8_t>(len);
          t.look_val[base + j] = vals[k];
        }
      }
    }
    t.maxcode[len] = bits[len] ? code - 1 : -1;
    code <<= 1;
  }
  t.maxcode[17] = 0x7fffffff;
  t.present = true;
}

struct BitReader {
  const uint8_t* data;
  size_t len;
  size_t pos;           // next byte of the entropy-coded segment
  uint64_t acc = 0;     // the low `nbits` bits are unread, most significant first
  int nbits = 0;
  int fake_bits = 0;    // zero bits appended past a marker or the end of the data
  bool at_marker = false;

  void fill() {
    while (nbits <= 56) {
      uint32_t byte = 0;
      if (!at_marker && pos < len) {
        byte = data[pos];
        if (byte == 0xFF) {
          size_t p = pos + 1;
          while (p < len && data[p] == 0xFF) ++p;  // fill bytes before a marker
          if (p < len && data[p] == 0x00) {
            pos = p + 1;  // stuffed 0xFF
          } else {
            at_marker = true;  // pos stays on the marker's first 0xFF
            byte = 0;
            fake_bits += 8;
          }
        } else {
          ++pos;
        }
      } else {
        at_marker = true;
        fake_bits += 8;
      }
      acc = (acc << 8) | byte;
      nbits += 8;
    }
  }
  inline uint32_t peek(int n) {
    if (nbits < n) fill();
    return static_cast<uint32_t>(acc >> (nbits - n)) & ((1u << n) - 1);
  }
  inline void skip(int n) { nbits -= n; }
  inline int get(int n) {
    uint32_t v = peek(n);
    nbits -= n;
    return static_cast<int>(v);
  }
  // True when more bits were consumed than the segment held.
  bool overrun() const { return fake_bits > nbits; }
  void reset() {
    acc = 0;
    nbits = 0;
    fake_bits = 0;
    at_marker = false;
  }
};

inline int decode_symbol(BitReader& br, const HuffTable& t) {
  if (br.nbits < 16) br.fill();
  uint32_t look = br.peek(kLookBits);
  int len = t.look_len[look];
  if (len) {
    br.skip(len);
    return t.look_val[look];
  }
  for (len = kLookBits + 1; len <= 16; ++len) {
    int32_t code = static_cast<int32_t>(br.peek(len));
    if (code <= t.maxcode[len]) {
      br.skip(len);
      return t.vals[(t.valoffset[len] + code) & 0xFF];
    }
  }
  corrupt("corrupt entropy-coded data (bad Huffman code)");
}

inline int receive_extend(BitReader& br, int s) {
  if (s == 0) return 0;
  int v = br.get(s);
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

struct Component {
  int id, h, v, tq;
  int blocks_w, blocks_h;        // blocks allocated: whole MCUs
  int width_in_blocks, height_in_blocks;
  int dw, dh;                    // downsampled width and height in samples
  std::vector<int16_t> coef;     // [blocks_h][blocks_w][64], natural order
  int dc_table = 0, ac_table = 0, pred = 0;
};

struct Decoder {
  Decoder(const uint8_t* d, size_t n) : data(d), len(n) {}
  const uint8_t* data;
  size_t len;
  size_t pos = 0;
  uint16_t qt[4][64] = {};
  bool qt_present[4] = {false, false, false, false};
  HuffTable dc[4], ac[4];
  int restart_interval = 0;
  bool have_frame = false, saw_jfif = false, saw_adobe = false;
  int adobe_transform = -1;
  int width = 0, height = 0, max_h = 1, max_v = 1, mcux = 0, mcuy = 0;
  std::vector<Component> comps;
  int scans = 0;

  int u8() {
    if (pos >= len) corrupt("truncated JPEG");
    return data[pos++];
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  // Reads the next marker code, skipping fill bytes. libjpeg skips (and
  // warns about) garbage before a marker; so does this.
  int next_marker() {
    for (;;) {
      while (pos < len && data[pos] != 0xFF) ++pos;
      while (pos < len && data[pos] == 0xFF) ++pos;
      if (pos >= len) corrupt("truncated JPEG (no EOI)");
      int m = data[pos++];
      if (m != 0x00) return m;
    }
  }

  void parse_sof(int marker) {
    if (have_frame) corrupt("more than one SOF");
    int seglen = u16();
    size_t end = pos + seglen - 2;
    int precision = u8();
    height = u16();
    width = u16();
    int n = u8();
    if (precision != 8) unsupported("JPEG with " + std::to_string(precision) + "-bit samples (only 8-bit)");
    if (n == 4) unsupported("4-component (CMYK/YCCK) JPEG");
    if (n != 1 && n != 3) unsupported("JPEG with " + std::to_string(n) + " components");
    if (height == 0) unsupported("JPEG whose height comes in a DNL marker");
    if (width == 0) corrupt("JPEG of width 0");
    if (seglen != 8 + 3 * n) corrupt("bad SOF length");
    comps.resize(n);
    for (auto& c : comps) {
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) corrupt("bad SOF component");
      if (c.h > 2 || c.v > 2)
        unsupported("JPEG sampling factor " + std::to_string(c.h) + "x" + std::to_string(c.v) +
                    " (only 1 or 2 per axis)");
    }
    pos = end;
    (void)marker;
    max_h = max_v = 1;
    for (auto& c : comps) {
      if (c.h > max_h) max_h = c.h;
      if (c.v > max_v) max_v = c.v;
    }
    mcux = ceil_div(width, 8 * max_h);
    mcuy = ceil_div(height, 8 * max_v);
    for (auto& c : comps) {
      c.blocks_w = mcux * c.h;
      c.blocks_h = mcuy * c.v;
      c.dw = ceil_div(width * c.h, max_h);
      c.dh = ceil_div(height * c.v, max_v);
      c.width_in_blocks = ceil_div(c.dw, 8);
      c.height_in_blocks = ceil_div(c.dh, 8);
      c.coef.assign(static_cast<size_t>(c.blocks_w) * c.blocks_h * 64, 0);
    }
    have_frame = true;
  }

  void parse_dqt() {
    int seglen = u16();
    size_t end = pos + seglen - 2;
    if (end > len) corrupt("truncated DQT");
    while (pos < end) {
      int pq = u8();
      int id = pq & 15, prec = pq >> 4;
      if (id > 3 || prec > 1) corrupt("bad DQT");
      for (int k = 0; k < 64; ++k) qt[id][kNaturalOrder[k]] = static_cast<uint16_t>(prec ? u16() : u8());
      qt_present[id] = true;
    }
    if (pos != end) corrupt("bad DQT length");
  }

  void parse_dht() {
    int seglen = u16();
    size_t end = pos + seglen - 2;
    if (end > len) corrupt("truncated DHT");
    while (pos < end) {
      int tc = u8();
      int cls = tc >> 4, id = tc & 15;
      if (cls > 1 || id > 3) corrupt("bad DHT");
      uint8_t bits[17] = {0};
      int count = 0;
      for (int i = 1; i <= 16; ++i) count += bits[i] = static_cast<uint8_t>(u8());
      if (count > 256 || pos + count > end) corrupt("bad DHT");
      build_huffman(cls ? ac[id] : dc[id], bits, data + pos, count, cls == 0);
      pos += count;
    }
    if (pos != end) corrupt("bad DHT length");
  }

  void parse_app_or_com(int marker) {
    int seglen = u16();
    if (seglen < 2) corrupt("bad marker length");
    size_t end = pos + seglen - 2;
    if (end > len) corrupt("truncated marker segment");
    if (marker == 0xE0 && seglen >= 16 && std::memcmp(data + pos, "JFIF\0", 5) == 0) saw_jfif = true;
    if (marker == 0xEE && seglen >= 14 && std::memcmp(data + pos, "Adobe", 5) == 0) {
      saw_adobe = true;
      adobe_transform = data[pos + 11];
    }
    pos = end;
  }

  void decode_block(BitReader& br, Component& c, int16_t* block) {
    const HuffTable& dct = dc[c.dc_table];
    const HuffTable& act = ac[c.ac_table];
    int s = decode_symbol(br, dct);
    if (br.nbits < 32) br.fill();
    c.pred += receive_extend(br, s);
    block[0] = static_cast<int16_t>(c.pred);
    for (int k = 1; k < 64;) {
      int rs = decode_symbol(br, act);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (br.nbits < 32) br.fill();
        block[kNaturalOrder[k]] = static_cast<int16_t>(receive_extend(br, s));
        ++k;
      } else {
        if (r != 15) break;
        k += 16;
      }
    }
  }

  void parse_sos() {
    if (!have_frame) corrupt("SOS before SOF");
    int seglen = u16();
    int n = u8();
    if (n < 1 || n > 4 || seglen != 6 + 2 * n) corrupt("bad SOS");
    std::vector<Component*> scan;
    for (int i = 0; i < n; ++i) {
      int id = u8(), tables = u8();
      Component* found = nullptr;
      for (auto& c : comps)
        if (c.id == id) found = &c;
      if (!found) corrupt("SOS names an unknown component");
      found->dc_table = tables >> 4;
      found->ac_table = tables & 15;
      if (found->dc_table > 3 || found->ac_table > 3) corrupt("bad SOS table");
      if (!dc[found->dc_table].present || !ac[found->ac_table].present)
        corrupt("SOS uses a Huffman table that was not defined");
      if (!qt_present[found->tq]) corrupt("component uses a quantisation table that was not defined");
      scan.push_back(found);
    }
    int ss = u8(), se = u8(), a = u8();
    if (ss != 0 || se != 63 || a != 0) corrupt("sequential scan with spectral selection");
    for (auto* c : scan) c->pred = 0;

    int mcus_x, mcus_y;
    if (n == 1) {
      mcus_x = scan[0]->width_in_blocks;
      mcus_y = scan[0]->height_in_blocks;
    } else {
      int units = 0;
      for (auto* c : scan) units += c->h * c->v;
      if (units > 10) corrupt("too many blocks in an MCU");
      mcus_x = mcux;
      mcus_y = mcuy;
    }
    BitReader br{data, len, pos};
    int restarts_left = restart_interval, next_rst = 0;
    for (int my = 0; my < mcus_y; ++my) {
      for (int mx = 0; mx < mcus_x; ++mx) {
        if (restart_interval) {
          if (restarts_left == 0) {
            // Byte-align, then expect the next RSTn marker.
            size_t p = br.pos;
            if (!br.at_marker) {
              while (p < len && data[p] != 0xFF) ++p;
            }
            while (p < len && data[p] == 0xFF) ++p;
            if (p >= len) corrupt("truncated JPEG (missing restart marker)");
            if (data[p] != 0xD0 + next_rst) corrupt("corrupt JPEG (restart marker out of order)");
            br.pos = p + 1;
            br.reset();
            next_rst = (next_rst + 1) & 7;
            restarts_left = restart_interval;
            for (auto* c : scan) c->pred = 0;
          }
          --restarts_left;
        }
        if (n == 1) {
          Component& c = *scan[0];
          decode_block(br, c, &c.coef[(static_cast<size_t>(my) * c.blocks_w + mx) * 64]);
        } else {
          for (auto* c : scan)
            for (int by = 0; by < c->v; ++by)
              for (int bx = 0; bx < c->h; ++bx) {
                size_t row = static_cast<size_t>(my) * c->v + by;
                size_t col = static_cast<size_t>(mx) * c->h + bx;
                decode_block(br, *c, &c->coef[(row * c->blocks_w + col) * 64]);
              }
        }
        if (br.overrun()) {
          if (br.pos >= len) corrupt("truncated JPEG (premature end of data)");
          corrupt("corrupt JPEG (premature end of data segment)");
        }
      }
    }
    // Parsing goes on from the marker that ended the scan, or from the
    // first byte the scan did not load.
    pos = br.pos;
    ++scans;
  }

  void parse() {
    if (len < 2 || data[0] != 0xFF || data[1] != 0xD8) corrupt("not a JPEG (no SOI)");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) break;  // EOI
      switch (m) {
        case 0xC0:
        case 0xC1:
          parse_sof(m);
          break;
        case 0xC2:
          unsupported("progressive JPEG (SOF2)");
        case 0xC3:
          unsupported("lossless JPEG (SOF3)");
        case 0xC5:
        case 0xC6:
        case 0xC7:
          unsupported("hierarchical JPEG (SOF" + std::to_string(m - 0xC0) + ")");
        case 0xC9:
        case 0xCA:
        case 0xCB:
        case 0xCD:
        case 0xCE:
        case 0xCF:
          unsupported("arithmetic-coded JPEG (SOF" + std::to_string(m - 0xC0) + ")");
        case 0xCC:
          unsupported("arithmetic-coded JPEG (DAC)");
        case 0xC4:
          parse_dht();
          break;
        case 0xDB:
          parse_dqt();
          break;
        case 0xDD: {
          if (u16() != 4) corrupt("bad DRI length");
          restart_interval = u16();
          break;
        }
        case 0xDA:
          parse_sos();
          break;
        case 0xDC:
          unsupported("JPEG with a DNL marker");
        case 0xD8:
          corrupt("corrupt JPEG (second SOI)");
        default:
          if (m >= 0xD0 && m <= 0xD7) break;  // a stray RSTn: libjpeg skips it too
          if (m == 0x01) break;               // TEM has no length
          parse_app_or_com(m);                // APPn, COM and the reserved JPGn
      }
    }
    if (!have_frame || scans == 0) corrupt("JPEG without a frame or a scan");
  }

  // True when the three components hold RGB rather than YCbCr (jdapimin.c's
  // default_decompress_parms); such files are refused.
  bool rgb_colorspace() const {
    if (saw_jfif) return false;
    if (saw_adobe) return adobe_transform == 0;
    return comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B';
  }
};

// ---- jidctfst.c: IFAST inverse DCT -------------------------------------------

constexpr int kIfastConstBits = 8;
constexpr int kPass1Bits = 2;
constexpr int FIX_1_082392200 = 277;
constexpr int FIX_1_414213562 = 362;
constexpr int FIX_1_847759065 = 473;
constexpr int FIX_2_613125930 = 669;

inline int ifast_mul(int v, int c) { return (v * c) >> kIfastConstBits; }

const int16_t kAanScales[64] = {
    16384, 22725, 21407, 19266, 16384, 12873, 8867,  4520,  22725, 31521, 29692, 26722, 22725,
    17855, 12299, 6270,  21407, 29692, 27969, 25172, 21407, 16819, 11585, 5906,  19266, 26722,
    25172, 22654, 19266, 15137, 10426, 5315,  16384, 22725, 21407, 19266, 16384, 12873, 8867,
    4520,  12873, 17855, 16819, 15137, 12873, 10114, 6967,  3552,  8867,  12299, 11585, 10426,
    8867,  6967,  4799,  2446,  4520,  6270,  5906,  5315,  4520,  3552,  2446,  1247};

// idct_limit[x & 1023] for a centred IDCT output x: jdmaster.c's
// prepare_range_limit_table seen from IDCT_range_limit (x + 128, clamped,
// with libjpeg's wrap-around beyond +-512).
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
const RangeLimit kIdctLimit;

void idct_ifast(const int16_t* in, const int* mult, uint8_t* out, int stride) {
  int ws[64];
  for (int col = 0; col < 8; ++col) {
    const int16_t* ip = in + col;
    const int* q = mult + col;
    int* w = ws + col;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 && ip[48] == 0 &&
        ip[56] == 0) {
      int dcval = ip[0] * q[0];
      for (int r = 0; r < 8; ++r) w[8 * r] = dcval;
      continue;
    }
    int tmp0 = ip[0] * q[0], tmp1 = ip[16] * q[16], tmp2 = ip[32] * q[32], tmp3 = ip[48] * q[48];
    int tmp10 = tmp0 + tmp2, tmp11 = tmp0 - tmp2;
    int tmp13 = tmp1 + tmp3;
    int tmp12 = ifast_mul(tmp1 - tmp3, FIX_1_414213562) - tmp13;
    tmp0 = tmp10 + tmp13;
    tmp3 = tmp10 - tmp13;
    tmp1 = tmp11 + tmp12;
    tmp2 = tmp11 - tmp12;
    int tmp4 = ip[8] * q[8], tmp5 = ip[24] * q[24], tmp6 = ip[40] * q[40], tmp7 = ip[56] * q[56];
    int z13 = tmp6 + tmp5, z10 = tmp6 - tmp5, z11 = tmp4 + tmp7, z12 = tmp4 - tmp7;
    tmp7 = z11 + z13;
    tmp11 = ifast_mul(z11 - z13, FIX_1_414213562);
    int z5 = ifast_mul(z10 + z12, FIX_1_847759065);
    tmp10 = ifast_mul(z12, FIX_1_082392200) - z5;
    tmp12 = ifast_mul(z10, -FIX_2_613125930) + z5;
    tmp6 = tmp12 - tmp7;
    tmp5 = tmp11 - tmp6;
    tmp4 = tmp10 + tmp5;
    w[0] = tmp0 + tmp7;
    w[56] = tmp0 - tmp7;
    w[8] = tmp1 + tmp6;
    w[48] = tmp1 - tmp6;
    w[16] = tmp2 + tmp5;
    w[40] = tmp2 - tmp5;
    w[32] = tmp3 + tmp4;
    w[24] = tmp3 - tmp4;
  }
  constexpr int kShift = kPass1Bits + 3;
  for (int row = 0; row < 8; ++row) {
    const int* w = ws + 8 * row;
    uint8_t* o = out + static_cast<size_t>(row) * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 && w[6] == 0 && w[7] == 0) {
      uint8_t dcval = kIdctLimit.t[(w[0] >> kShift) & 1023];
      for (int c = 0; c < 8; ++c) o[c] = dcval;
      continue;
    }
    int tmp10 = w[0] + w[4], tmp11 = w[0] - w[4];
    int tmp13 = w[2] + w[6];
    int tmp12 = ifast_mul(w[2] - w[6], FIX_1_414213562) - tmp13;
    int tmp0 = tmp10 + tmp13, tmp3 = tmp10 - tmp13, tmp1 = tmp11 + tmp12, tmp2 = tmp11 - tmp12;
    int z13 = w[5] + w[3], z10 = w[5] - w[3], z11 = w[1] + w[7], z12 = w[1] - w[7];
    int tmp7 = z11 + z13;
    tmp11 = ifast_mul(z11 - z13, FIX_1_414213562);
    int z5 = ifast_mul(z10 + z12, FIX_1_847759065);
    tmp10 = ifast_mul(z12, FIX_1_082392200) - z5;
    tmp12 = ifast_mul(z10, -FIX_2_613125930) + z5;
    int tmp6 = tmp12 - tmp7, tmp5 = tmp11 - tmp6, tmp4 = tmp10 + tmp5;
    o[0] = kIdctLimit.t[((tmp0 + tmp7) >> kShift) & 1023];
    o[7] = kIdctLimit.t[((tmp0 - tmp7) >> kShift) & 1023];
    o[1] = kIdctLimit.t[((tmp1 + tmp6) >> kShift) & 1023];
    o[6] = kIdctLimit.t[((tmp1 - tmp6) >> kShift) & 1023];
    o[2] = kIdctLimit.t[((tmp2 + tmp5) >> kShift) & 1023];
    o[5] = kIdctLimit.t[((tmp2 - tmp5) >> kShift) & 1023];
    o[4] = kIdctLimit.t[((tmp3 + tmp4) >> kShift) & 1023];
    o[3] = kIdctLimit.t[((tmp3 - tmp4) >> kShift) & 1023];
  }
}

// One component's samples, [blocks_h * 8][blocks_w * 8].
std::vector<uint8_t> component_samples(const Decoder& d, const Component& c) {
  int mult[64];
  for (int i = 0; i < 64; ++i)  // jddctmgr.c: DESCALE(q * aanscale, 14 - 2), rounded
    mult[i] = (static_cast<int32_t>(d.qt[c.tq][i]) * kAanScales[i] + (1 << 11)) >> 12;
  int stride = c.blocks_w * 8;
  std::vector<uint8_t> plane(static_cast<size_t>(stride) * c.blocks_h * 8);
  // Only the blocks that hold samples of the image are transformed.
  for (int by = 0; by < c.height_in_blocks; ++by)
    for (int bx = 0; bx < c.width_in_blocks; ++bx)
      idct_ifast(&c.coef[(static_cast<size_t>(by) * c.blocks_w + bx) * 64], mult,
                 &plane[static_cast<size_t>(by) * 8 * stride + bx * 8], stride);
  return plane;
}

// ---- jdsample.c: upsampling to the image's full resolution ------------------

// Writes the component upsampled to width x height into out (stride width).
void upsample(const Component& c, const std::vector<uint8_t>& plane, int max_h, int max_v, int width,
              int height, uint8_t* out) {
  const int stride = c.blocks_w * 8;
  const int rh = max_h / c.h, rv = max_v / c.v;
  const int dw = c.dw, dh = c.dh;
  auto row = [&](int r) { return &plane[static_cast<size_t>(r < 0 ? 0 : (r >= dh ? dh - 1 : r)) * stride]; };
  std::vector<uint8_t> line(static_cast<size_t>(dw) * 2 + 2);
  std::vector<int> colsum(dw);
  for (int y = 0; y < height; ++y) {
    uint8_t* o = out + static_cast<size_t>(y) * width;
    if (rh == 1 && rv == 1) {
      std::memcpy(o, row(y), width);
    } else if (rh == 2 && rv == 1) {
      const uint8_t* in = row(y);
      if (dw > 2) {  // h2v1_fancy_upsample
        uint8_t* p = line.data();
        *p++ = in[0];
        *p++ = static_cast<uint8_t>((in[0] * 3 + in[1] + 2) >> 2);
        for (int j = 1; j < dw - 1; ++j) {
          int v = in[j] * 3;
          *p++ = static_cast<uint8_t>((v + in[j - 1] + 1) >> 2);
          *p++ = static_cast<uint8_t>((v + in[j + 1] + 2) >> 2);
        }
        *p++ = static_cast<uint8_t>((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
        *p++ = in[dw - 1];
      } else {  // h2v1_upsample
        for (int j = 0; j < dw; ++j) line[2 * j] = line[2 * j + 1] = in[j];
      }
      std::memcpy(o, line.data(), width);
    } else if (rh == 1 && rv == 2) {  // h1v2_fancy_upsample
      int i = y >> 1, v = y & 1;
      const uint8_t* in0 = row(i);
      const uint8_t* in1 = row(v == 0 ? i - 1 : i + 1);
      int bias = v == 0 ? 1 : 2;
      for (int j = 0; j < width; ++j) o[j] = static_cast<uint8_t>((in0[j] * 3 + in1[j] + bias) >> 2);
    } else {  // rh == 2 && rv == 2
      int i = y >> 1, v = y & 1;
      if (dw > 2) {  // h2v2_fancy_upsample
        const uint8_t* in0 = row(i);
        const uint8_t* in1 = row(v == 0 ? i - 1 : i + 1);
        for (int j = 0; j < dw; ++j) colsum[j] = in0[j] * 3 + in1[j];
        uint8_t* p = line.data();
        *p++ = static_cast<uint8_t>((colsum[0] * 4 + 8) >> 4);
        *p++ = static_cast<uint8_t>((colsum[0] * 3 + colsum[1] + 7) >> 4);
        for (int j = 1; j < dw - 1; ++j) {
          *p++ = static_cast<uint8_t>((colsum[j] * 3 + colsum[j - 1] + 8) >> 4);
          *p++ = static_cast<uint8_t>((colsum[j] * 3 + colsum[j + 1] + 7) >> 4);
        }
        *p++ = static_cast<uint8_t>((colsum[dw - 1] * 3 + colsum[dw - 2] + 8) >> 4);
        *p++ = static_cast<uint8_t>((colsum[dw - 1] * 4 + 7) >> 4);
      } else {  // h2v2_upsample
        const uint8_t* in = row(i);
        for (int j = 0; j < dw; ++j) line[2 * j] = line[2 * j + 1] = in[j];
      }
      std::memcpy(o, line.data(), width);
    }
  }
}

// ---- jdcolor.c: YCbCr -> RGB ----------------------------------------------------

struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    constexpr int kBits = 16;
    constexpr int32_t kHalf = 1 << (kBits - 1);
    auto fix = [](double x) { return static_cast<int32_t>(x * (1 << kBits) + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kBits);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kBits);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
  }
};
const YccTables kYcc;

std::vector<uint8_t> decode(const uint8_t* data, size_t len, int channels, int* h, int* w, int* c) {
  Decoder d(data, len);
  d.parse();
  const int n = static_cast<int>(d.comps.size());
  if (n == 3 && d.rgb_colorspace()) unsupported("RGB-coded JPEG (no YCbCr transform)");
  const int out_c = channels == 0 ? n : channels;
  if (out_c != 1 && out_c != 3) throw Failure{kBadArgument, "channels must be 0, 1 or 3"};
  const int W = d.width, H = d.height;
  const size_t npix = static_cast<size_t>(W) * H;
  std::vector<uint8_t> out(npix * out_c);
  auto full = [&](int ci) {
    const Component& comp = d.comps[ci];
    int rh = d.max_h / comp.h, rv = d.max_v / comp.v;
    if (d.max_h % comp.h || d.max_v % comp.v || rh > 2 || rv > 2)
      unsupported("JPEG sampling ratio other than 1 or 2 per axis");
    std::vector<uint8_t> res(npix);
    upsample(comp, component_samples(d, comp), d.max_h, d.max_v, W, H, res.data());
    return res;
  };
  if (n == 1) {
    std::vector<uint8_t> y = full(0);
    for (size_t i = 0; i < npix; ++i)
      for (int k = 0; k < out_c; ++k) out[i * out_c + k] = y[i];
  } else if (out_c == 1) {
    out = full(0);  // JCS_GRAYSCALE from YCbCr: the Y component alone
  } else {
    std::vector<uint8_t> p0 = full(0), p1 = full(1), p2 = full(2);
    for (size_t i = 0; i < npix; ++i) {
      int y = p0[i], cb = p1[i], cr = p2[i];
      out[3 * i] = static_cast<uint8_t>(clamp255(y + kYcc.cr_r[cr]));
      out[3 * i + 1] = static_cast<uint8_t>(clamp255(y + ((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16)));
      out[3 * i + 2] = static_cast<uint8_t>(clamp255(y + kYcc.cb_b[cb]));
    }
  }
  *h = H;
  *w = W;
  *c = out_c;
  return out;
}

// --------------------------------------------------------------------------
// Encoder
// --------------------------------------------------------------------------

// IJG's tables (ITU T.81 Annex K.1), natural order.
const int kStdLuminanceQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kStdChrominanceQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99, 24, 26, 56, 99, 99, 99,
    99, 99, 47, 66, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Annex K.3: bits[1..16] (index 0 unused) and values.
const uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
    0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0,
    0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
    0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
    0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5,
    0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8,
    0xf9, 0xfa};
const uint8_t kAcChromBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
    0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0,
    0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
    0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
    0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8,
    0xf9, 0xfa};

struct EncTable {
  uint16_t code[256];
  uint8_t size[256];
  EncTable(const uint8_t bits[17], const uint8_t* vals) {
    std::memset(size, 0, sizeof size);
    int c = 0, k = 0;
    for (int len = 1; len <= 16; ++len) {
      for (int i = 0; i < bits[len]; ++i, ++k, ++c) {
        code[vals[k]] = static_cast<uint16_t>(c);
        size[vals[k]] = static_cast<uint8_t>(len);
      }
      c <<= 1;
    }
  }
};

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t acc = 0;
  int nbits = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t bits, int n) {
    acc = (acc << n) | (bits & ((1u << n) - 1));
    nbits += n;
    while (nbits >= 8) {
      uint8_t b = static_cast<uint8_t>(acc >> (nbits - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0x00);
      nbits -= 8;
    }
  }
  void flush() {  // jchuff.c flush_bits: pad the last byte with ones
    if (nbits > 0) put((1u << (8 - nbits)) - 1, 8 - nbits);
  }
};

inline int nbits_of(int v) {
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

// jfdctint.c's jpeg_fdct_islow (the jpeg-6b algorithm libjpeg-turbo keeps).
void fdct_islow(int* data) {
  constexpr int kBits = 13, kPass1 = 2;
  constexpr int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                    F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                    F2562 = 20995, F3072 = 25172;
  auto descale = [](int64_t x, int n) { return static_cast<int>((x + (int64_t(1) << (n - 1))) >> n); };
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass == 0 ? 1 : 8;   // between the 8 elements of a line
    const int next = pass == 0 ? 8 : 1;   // between lines
    for (int line = 0; line < 8; ++line) {
      int* p = data + line * next;
      int64_t tmp0 = p[0 * step] + p[7 * step], tmp7 = p[0 * step] - p[7 * step];
      int64_t tmp1 = p[1 * step] + p[6 * step], tmp6 = p[1 * step] - p[6 * step];
      int64_t tmp2 = p[2 * step] + p[5 * step], tmp5 = p[2 * step] - p[5 * step];
      int64_t tmp3 = p[3 * step] + p[4 * step], tmp4 = p[3 * step] - p[4 * step];
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      const int shift = pass == 0 ? kBits - kPass1 : kBits + kPass1;
      if (pass == 0) {
        p[0] = static_cast<int>((tmp10 + tmp11) * (1 << kPass1));
        p[4 * step] = static_cast<int>((tmp10 - tmp11) * (1 << kPass1));
      } else {
        p[0] = descale(tmp10 + tmp11, kPass1);
        p[4 * step] = descale(tmp10 - tmp11, kPass1);
      }
      int64_t z1 = (tmp12 + tmp13) * F0541;
      p[2 * step] = descale(z1 + tmp13 * F0765, shift);
      p[6 * step] = descale(z1 + tmp12 * -F1847, shift);
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int64_t z5 = (z3 + z4) * F1175;
      tmp4 *= F0298;
      tmp5 *= F2053;
      tmp6 *= F3072;
      tmp7 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      p[7 * step] = descale(tmp4 + z1 + z3, shift);
      p[5 * step] = descale(tmp5 + z2 + z4, shift);
      p[3 * step] = descale(tmp6 + z2 + z3, shift);
      p[1 * step] = descale(tmp7 + z1 + z4, shift);
    }
  }
}

struct EncComponent {
  int id, h, v, tq, dc_tab, ac_tab;
  int width_in_blocks, height_in_blocks;
  int pw, ph;                    // sample plane, whole MCUs
  std::vector<uint8_t> plane;    // [ph][pw]
  int last_dc = 0;
};

void quant_table(int quality, const int* base, int* out) {
  // jcparam.c: jpeg_quality_scaling, then jpeg_add_quant_table(force_baseline).
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long t = (static_cast<long>(base[i]) * scale + 50L) / 100L;
    if (t <= 0) t = 1;
    if (t > 32767) t = 32767;
    if (t > 255) t = 255;
    out[i] = static_cast<int>(t);
  }
}

void put_u16(std::vector<uint8_t>& o, int v) {
  o.push_back(static_cast<uint8_t>(v >> 8));
  o.push_back(static_cast<uint8_t>(v & 0xFF));
}

void encode_block(BitWriter& bw, const int* coef, int& last_dc, const EncTable& dct, const EncTable& act) {
  int temp = coef[0] - last_dc, temp2 = temp;
  last_dc = coef[0];
  if (temp < 0) {
    temp = -temp;
    --temp2;
  }
  int nb = nbits_of(temp);
  bw.put(dct.code[nb], dct.size[nb]);
  if (nb) bw.put(static_cast<uint32_t>(temp2), nb);
  int r = 0;
  for (int k = 1; k < 64; ++k) {
    temp = coef[kNaturalOrder[k]];
    if (temp == 0) {
      ++r;
      continue;
    }
    while (r > 15) {
      bw.put(act.code[0xF0], act.size[0xF0]);
      r -= 16;
    }
    temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      --temp2;
    }
    nb = nbits_of(temp);
    int sym = (r << 4) + nb;
    bw.put(act.code[sym], act.size[sym]);
    bw.put(static_cast<uint32_t>(temp2), nb);
    r = 0;
  }
  if (r > 0) bw.put(act.code[0], act.size[0]);
}

std::vector<uint8_t> encode(const uint8_t* img, int H, int W, int C, int quality, bool subsample) {
  if (H < 1 || W < 1 || H > 65535 || W > 65535) throw Failure{kBadArgument, "JPEG image size out of range"};
  if (C != 1 && C != 3) throw Failure{kBadArgument, "JPEG encodes 1 or 3 channels"};
  if (quality < 0 || quality > 100) throw Failure{kBadArgument, "quality must be in [0, 100]"};
  int qtab[2][64];
  quant_table(quality, kStdLuminanceQuant, qtab[0]);
  quant_table(quality, kStdChrominanceQuant, qtab[1]);

  std::vector<EncComponent> comps(C);
  for (int i = 0; i < C; ++i) {
    EncComponent& c = comps[i];
    c.id = i + 1;
    bool luma = i == 0;
    c.h = c.v = (C == 3 && subsample && luma) ? 2 : 1;
    c.tq = c.dc_tab = c.ac_tab = luma ? 0 : 1;
  }
  const int max_h = comps[0].h, max_v = comps[0].v;
  const int mcux = ceil_div(W, 8 * max_h), mcuy = ceil_div(H, 8 * max_v);
  const size_t npix = static_cast<size_t>(W) * H;

  // jccolor.c: RGB -> YCbCr in fixed point.
  std::vector<uint8_t> full[3];
  for (int i = 0; i < C; ++i) full[i].resize(npix);
  if (C == 1) {
    std::memcpy(full[0].data(), img, npix);
  } else {
    constexpr int kBits = 16;
    constexpr int32_t kHalf = 1 << (kBits - 1), kCbCrOffset = 128 << kBits;
    auto fix = [](double x) { return static_cast<int32_t>(x * (1 << kBits) + 0.5); };
    const int32_t ry = fix(0.29900), gy = fix(0.58700), by = fix(0.11400);
    const int32_t rcb = -fix(0.16874), gcb = -fix(0.33126), bcb = fix(0.5);
    const int32_t gcr = -fix(0.41869), bcr = -fix(0.08131);
    for (size_t p = 0; p < npix; ++p) {
      int32_t r = img[3 * p], g = img[3 * p + 1], b = img[3 * p + 2];
      full[0][p] = static_cast<uint8_t>((ry * r + gy * g + by * b + kHalf) >> kBits);
      full[1][p] = static_cast<uint8_t>((rcb * r + gcb * g + bcb * b + kCbCrOffset + kHalf - 1) >> kBits);
      full[2][p] = static_cast<uint8_t>((bcb * r + gcr * g + bcr * b + kCbCrOffset + kHalf - 1) >> kBits);
    }
  }

  // Sample planes of whole MCUs. Full-resolution planes repeat the last
  // column and row (jcsample.c expand_right_edge, jcprepct.c
  // expand_bottom_edge). A 2x2 downsampled plane is made from the image
  // padded right to its output width and down to a whole row group, and is
  // then padded down by repeating its own last row.
  for (int i = 0; i < C; ++i) {
    EncComponent& c = comps[i];
    c.width_in_blocks = ceil_div(W * c.h, max_h * 8);
    c.height_in_blocks = ceil_div(H * c.v, max_v * 8);
    c.pw = mcux * c.h * 8;
    c.ph = mcuy * c.v * 8;
    c.plane.resize(static_cast<size_t>(c.pw) * c.ph);
    const std::vector<uint8_t>& src = full[i];
    if (c.h == max_h && c.v == max_v) {
      for (int y = 0; y < c.ph; ++y) {
        const uint8_t* s = &src[static_cast<size_t>(y < H ? y : H - 1) * W];
        uint8_t* d = &c.plane[static_cast<size_t>(y) * c.pw];
        std::memcpy(d, s, W < c.pw ? W : c.pw);
        for (int x = W; x < c.pw; ++x) d[x] = s[W - 1];
      }
    } else {  // h2v2_downsample
      const int out_rows = ceil_div(H, 2);
      for (int y = 0; y < c.ph; ++y) {
        uint8_t* d = &c.plane[static_cast<size_t>(y) * c.pw];
        if (y >= out_rows) {
          std::memcpy(d, &c.plane[static_cast<size_t>(out_rows - 1) * c.pw], c.pw);
          continue;
        }
        const int y0 = 2 * y, y1 = 2 * y + 1 < H ? 2 * y + 1 : H - 1;
        const uint8_t* s0 = &src[static_cast<size_t>(y0) * W];
        const uint8_t* s1 = &src[static_cast<size_t>(y1) * W];
        int bias = 1;
        for (int x = 0; x < c.pw; ++x) {
          int x0 = 2 * x < W ? 2 * x : W - 1, x1 = 2 * x + 1 < W ? 2 * x + 1 : W - 1;
          d[x] = static_cast<uint8_t>((s0[x0] + s0[x1] + s1[x0] + s1[x1] + bias) >> 2);
          bias ^= 3;
        }
      }
    }
  }

  std::vector<uint8_t> out;
  out.reserve(npix / 2 + 1024);
  const uint8_t jfif[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J',  'F',  'I',  'F',
                          0x00, 0x01, 0x01, 0x01, 0x01, 0x2C, 0x01, 0x2C, 0x00, 0x00};
  out.insert(out.end(), jfif, jfif + sizeof jfif);
  const int ntables = C == 3 ? 2 : 1;
  for (int t = 0; t < ntables; ++t) {  // DQT, one marker per table, zigzag order
    out.push_back(0xFF);
    out.push_back(0xDB);
    put_u16(out, 67);
    out.push_back(static_cast<uint8_t>(t));
    for (int k = 0; k < 64; ++k) out.push_back(static_cast<uint8_t>(qtab[t][kNaturalOrder[k]]));
  }
  out.push_back(0xFF);  // SOF0
  out.push_back(0xC0);
  put_u16(out, 8 + 3 * C);
  out.push_back(8);
  put_u16(out, H);
  put_u16(out, W);
  out.push_back(static_cast<uint8_t>(C));
  for (auto& c : comps) {
    out.push_back(static_cast<uint8_t>(c.id));
    out.push_back(static_cast<uint8_t>((c.h << 4) | c.v));
    out.push_back(static_cast<uint8_t>(c.tq));
  }
  auto dht = [&](int tc, const uint8_t* bits, const uint8_t* vals) {
    int count = 0;
    for (int i = 1; i <= 16; ++i) count += bits[i];
    out.push_back(0xFF);
    out.push_back(0xC4);
    put_u16(out, 2 + 1 + 16 + count);
    out.push_back(static_cast<uint8_t>(tc));
    out.insert(out.end(), bits + 1, bits + 17);
    out.insert(out.end(), vals, vals + count);
  };
  dht(0x00, kDcLumBits, kDcVals);
  dht(0x10, kAcLumBits, kAcLumVals);
  if (C == 3) {
    dht(0x01, kDcChromBits, kDcVals);
    dht(0x11, kAcChromBits, kAcChromVals);
  }
  out.push_back(0xFF);  // SOS
  out.push_back(0xDA);
  put_u16(out, 6 + 2 * C);
  out.push_back(static_cast<uint8_t>(C));
  for (auto& c : comps) {
    out.push_back(static_cast<uint8_t>(c.id));
    out.push_back(static_cast<uint8_t>((c.dc_tab << 4) | c.ac_tab));
  }
  out.push_back(0);
  out.push_back(63);
  out.push_back(0);

  const EncTable dc_tabs[2] = {EncTable(kDcLumBits, kDcVals), EncTable(kDcChromBits, kDcVals)};
  const EncTable ac_tabs[2] = {EncTable(kAcLumBits, kAcLumVals), EncTable(kAcChromBits, kAcChromVals)};
  BitWriter bw(out);
  int work[64], coef[64];
  auto transform = [&](const EncComponent& c, int by, int bx, int* q) {
    for (int r = 0; r < 8; ++r) {
      const uint8_t* s = &c.plane[static_cast<size_t>(by * 8 + r) * c.pw + bx * 8];
      for (int k = 0; k < 8; ++k) work[r * 8 + k] = s[k] - 128;
    }
    fdct_islow(work);
    const int* qt = qtab[c.tq];
    for (int i = 0; i < 64; ++i) {  // jcdctmgr.c: rounded division by q * 8
      int d = qt[i] << 3, t = work[i];
      q[i] = t < 0 ? -((-t + (d >> 1)) / d) : (t + (d >> 1)) / d;
    }
  };
  // One MCU's blocks per component, with jccoefct.c's dummy blocks: zero AC
  // and the DC of the block before it, right of and below the image.
  std::vector<int> mcu_blocks(static_cast<size_t>(4) * 64);
  for (int my = 0; my < mcuy; ++my) {
    for (int mx = 0; mx < mcux; ++mx) {
      for (auto& c : comps) {
        int n = c.h * c.v;
        int* blocks = mcu_blocks.data();
        int last_col_width = c.width_in_blocks % c.h ? c.width_in_blocks % c.h : c.h;
        int last_row_height = c.height_in_blocks % c.v ? c.height_in_blocks % c.v : c.v;
        int blockcnt = mx < mcux - 1 ? c.h : last_col_width;
        int blkn = 0;
        for (int yi = 0; yi < c.v; ++yi) {
          if (my < mcuy - 1 || yi < last_row_height) {
            for (int bi = 0; bi < blockcnt; ++bi) transform(c, my * c.v + yi, mx * c.h + bi, &blocks[(blkn + bi) * 64]);
            for (int bi = blockcnt; bi < c.h; ++bi) {
              std::memset(&blocks[(blkn + bi) * 64], 0, 64 * sizeof(int));
              blocks[(blkn + bi) * 64] = blocks[(blkn + bi - 1) * 64];
            }
          } else {
            for (int bi = 0; bi < c.h; ++bi) {
              std::memset(&blocks[(blkn + bi) * 64], 0, 64 * sizeof(int));
              blocks[(blkn + bi) * 64] = blocks[(blkn - 1) * 64];
            }
          }
          blkn += c.h;
        }
        for (int b = 0; b < n; ++b) {
          std::memcpy(coef, &blocks[b * 64], sizeof coef);
          encode_block(bw, coef, c.last_dc, dc_tabs[c.dc_tab], ac_tabs[c.ac_tab]);
        }
      }
    }
  }
  bw.flush();
  out.push_back(0xFF);
  out.push_back(0xD9);
  return out;
}

void report(const Failure& f, char* err, int errlen) {
  if (err && errlen > 0) {
    std::strncpy(err, f.message.c_str(), errlen - 1);
    err[errlen - 1] = 0;
  }
}

}  // namespace

extern "C" {

// Decodes a JPEG into a malloc'd buffer of h * w * c bytes (free it with
// opz_jpeg_free). channels is 0 (the file's own: 1 or 3), 1 or 3. Returns
// 0, or a status with a message in err.
int opz_jpeg_decode(const uint8_t* data, size_t len, int channels, uint8_t** out, int* h, int* w, int* c,
                    char* err, int errlen) {
  *out = nullptr;
  try {
    std::vector<uint8_t> pixels = decode(data, len, channels, h, w, c);
    *out = static_cast<uint8_t*>(std::malloc(pixels.size() ? pixels.size() : 1));
    if (!*out) throw Failure{kNoMemory, "out of memory"};
    std::memcpy(*out, pixels.data(), pixels.size());
    return kOk;
  } catch (const Failure& f) {
    report(f, err, errlen);
    return f.status;
  } catch (const std::bad_alloc&) {
    report(Failure{kNoMemory, "out of memory"}, err, errlen);
    return kNoMemory;
  }
}

// Encodes uint8 [h, w, c] (c = 1 or 3, row-major) into a malloc'd JPEG of
// *len bytes (free it with opz_jpeg_free).
int opz_jpeg_encode(const uint8_t* image, int h, int w, int c, int quality, int chroma_downsampling,
                    uint8_t** out, size_t* len, char* err, int errlen) {
  *out = nullptr;
  *len = 0;
  try {
    std::vector<uint8_t> bytes = encode(image, h, w, c, quality, chroma_downsampling != 0);
    *out = static_cast<uint8_t*>(std::malloc(bytes.size()));
    if (!*out) throw Failure{kNoMemory, "out of memory"};
    std::memcpy(*out, bytes.data(), bytes.size());
    *len = bytes.size();
    return kOk;
  } catch (const Failure& f) {
    report(f, err, errlen);
    return f.status;
  } catch (const std::bad_alloc&) {
    report(Failure{kNoMemory, "out of memory"}, err, errlen);
    return kNoMemory;
  }
}

void opz_jpeg_free(void* p) { std::free(p); }

}  // extern "C"
