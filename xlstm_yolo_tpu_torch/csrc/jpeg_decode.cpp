// JPEG decoding on the host, to the bytes cv2.imread(path) returns (IMREAD_COLOR).
//
// OpenCV reads a JPEG through libjpeg-turbo with its defaults: the integer
// "islow" inverse DCT, fancy upsampling (never the merged upsampler), block
// smoothing of progressive files, and output straight to BGR.  This file
// carries out the same arithmetic:
//
// - Huffman entropy decoding of baseline and extended sequential (SOF0/SOF1)
//   and progressive (SOF2) files at 8 bits, 1 or 3 components, sampling
//   factors 1-4, restart intervals, and Annex K's tables in place of a
//   missing table 0 or 1 (Motion-JPEG frames carry none);
// - a data segment that ends early (a truncated file) reads zero bits, and
//   the MCUs after the one that ran out stay zero, as libjpeg's
//   "insufficient data" rule does;
// - the islow IDCT as the SIMD version libjpeg-turbo runs on x86 computes it:
//   16-bit dequantisation, the first pass saturated to 16 bits, the output
//   saturated to [0, 255];
// - block smoothing of a progressive file whose first nine AC coefficients
//   are not all complete (a truncated one), libjpeg-turbo's 5x5 version;
// - libjpeg-turbo's upsamplers: h2v1 and h2v2 triangle filters (only when the
//   downsampled width exceeds 2), h1v2, replication for other integral ratios;
// - YCbCr -> BGR by jdcolor.c's 16-bit fixed-point tables; RGB files (Adobe
//   transform 0, or component ids 'R' 'G' 'B') are reordered; grey is repeated.
//
// The orientation tag of the first APP1 segment before the first scan is
// returned, read as OpenCV's ExifReader reads it; the caller rotates.
//
// Refused: 12-bit samples, arithmetic coding, lossless files and 4 components
// (CMYK/YCCK).  A file for which libjpeg stops with an error (hierarchical
// frames, 2 components, ...) is refused as corrupt.
//
// Plain C interface for ctypes:
//   int jpeg_decode(const uint8_t* data, size_t size, uint8_t** out,
//                   int* height, int* width, int* orientation, char* msg, int msg_len)
// returns 0 (ok; *out is a malloc'd H*W*3 BGR buffer for jpeg_free), 1 (corrupt
// data: cv2.imread returns None) or 2 (a feature not decoded here);
//   int jpeg_exif_orientation(const uint8_t* tiff, size_t size)
// reads the orientation of a TIFF-headed EXIF block (a PNG's eXIf chunk).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum { kOk = 0, kCorrupt = 1, kUnsupported = 2 };

struct Failure {
  int status;
  std::string what;
};

[[noreturn]] void corrupt(const std::string& what) { throw Failure{kCorrupt, what}; }
[[noreturn]] void unsupported(const std::string& what) { throw Failure{kUnsupported, what}; }

// Zigzag index -> natural index, with libjpeg's 16 extra entries that catch
// runs past the end of a corrupt block.
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// Annex K.3 tables.
const uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffSpec {
  bool defined = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
};

constexpr int kLook = 9;  // bits of the fast lookup

// jpeg_make_d_derived_tbl, with a kLook-bit lookup in front of the
// bit-serial maxcode search.
struct Huff {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint16_t look[1 << kLook];  // (length << 8) | symbol; length 0: longer code
};

void derive(const HuffSpec& s, bool dc, Huff* h) {
  uint8_t size[257];
  uint32_t code_of[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (p + s.bits[l] > 256) corrupt("bad Huffman table");
    for (int i = 0; i < s.bits[l]; ++i) size[p++] = (uint8_t)l;
  }
  size[p] = 0;
  const int nsym = p;
  uint32_t code = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code_of[p++] = code++;
    if ((int64_t)code >= ((int64_t)1 << si)) corrupt("bad Huffman table");
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (s.bits[l]) {
      h->valoffset[l] = p - (int32_t)code_of[p];
      p += s.bits[l];
      h->maxcode[l] = (int32_t)code_of[p - 1];
    } else {
      h->maxcode[l] = -1;
    }
  }
  h->valoffset[17] = 0;
  h->maxcode[17] = 0xFFFFF;
  std::memcpy(h->vals, s.vals, 256);
  if (dc)
    for (int i = 0; i < nsym; ++i)
      if (s.vals[i] > 15) corrupt("bad Huffman table");
  std::memset(h->look, 0, sizeof(h->look));
  p = 0;
  for (int l = 1; l <= kLook; ++l)
    for (int i = 0; i < s.bits[l]; ++i, ++p) {
      const uint32_t first = code_of[p] << (kLook - l);
      for (uint32_t c = 0; c < (1u << (kLook - l)); ++c)
        h->look[first + c] = (uint16_t)((l << 8) | s.vals[p]);
    }
}

// The entropy-coded bit stream of one scan.  Past a marker (or the end of
// the file, which libjpeg's stdio source turns into EOI) it reads zero bits;
// `insufficient` is set once a read needs a bit past the real data.
struct Bits {
  const uint8_t* d = nullptr;
  size_t n = 0, pos = 0;
  uint64_t acc = 0;
  int cnt = 0;      // bits in acc, from the top
  int pad = 0;      // of which the last `pad` are zeros past the data
  int marker = 0;   // the marker that ended the data, 0 while none
  bool insufficient = false;

  // `lead_d9`: the scan header ended inside a fake FF D9 pair past the end
  // of the file, so the data starts with its D9 byte.
  void start(const uint8_t* data, size_t size, size_t at, bool lead_d9) {
    d = data; n = size; pos = at; pad = 0; marker = 0; insufficient = false;
    acc = lead_d9 ? (uint64_t)0xD9 << 56 : 0;
    cnt = lead_d9 ? 8 : 0;
  }
  void fill() {
    while (cnt <= 56) {
      unsigned c = 0;
      if (marker) {
        pad += 8;
      } else {
        if (pos >= n) { marker = 0xD9; continue; }
        c = d[pos++];
        if (c == 0xFF) {
          unsigned c2;
          do { c2 = pos < n ? d[pos++] : 0x1D9; } while (c2 == 0xFF);
          if (c2 == 0x1D9) c2 = 0xD9;
          if (c2 != 0) { marker = (int)c2; continue; }
        }
      }
      acc |= (uint64_t)c << (56 - cnt);
      cnt += 8;
    }
  }
  inline unsigned peek(int k) {
    if (cnt < k) fill();
    return (unsigned)(acc >> (64 - k));
  }
  inline void skip(int k) {
    if (cnt < k) fill();
    if (k > cnt - pad) insufficient = true;
    acc <<= k;
    cnt -= k;
    if (pad > cnt) pad = cnt;
  }
  inline unsigned get(int k) {
    const unsigned v = peek(k);
    skip(k);
    return v;
  }
  inline int decode(const Huff& h) {
    const unsigned e = h.look[peek(kLook)];
    if (e >> 8) {
      skip((int)(e >> 8));
      return (int)(e & 0xFF);
    }
    const unsigned code17 = peek(17);
    for (int l = kLook + 1; l <= 16; ++l) {
      const int32_t code = (int32_t)(code17 >> (17 - l));
      if (code <= h.maxcode[l]) {
        skip(l);
        return h.vals[(code + h.valoffset[l]) & 0xFF];
      }
    }
    skip(17);  // no code of 16 bits or fewer: libjpeg warns and fakes a zero
    return 0;
  }
  void drop() { acc = 0; cnt = 0; pad = 0; }  // at a restart marker
};

inline int extend(int r, int s) { return r < (1 << (s - 1)) ? r + (int)(((unsigned)-1 << s) + 1) : r; }
inline int16_t left_shift16(int v, int al) { return (int16_t)(uint16_t)((unsigned)v << al); }

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int wib = 0, hib = 0;  // blocks that hold image samples
  int bw = 0, bh = 0;    // blocks allocated (whole MCUs)
  int dw = 0, dh = 0;    // downsampled width and height
  bool latched = false;
  uint16_t q[64] = {};
  std::vector<int16_t> coef;
  int coef_bits[64];     // libjpeg's coef_bits: the Al of each coefficient's last scan, -1 none
  int prev_bits[10];     // coef_bits[0..9] before this component's last scan
  int dc_tbl = 0, ac_tbl = 0, last_dc = 0;
};

class Decoder {
 public:
  Decoder(const uint8_t* d, size_t n) : d_(d), n_(n) {}
  void run();
  int width = 0, height = 0, orientation = 0;
  std::vector<uint8_t> out;

 private:
  const uint8_t* d_;
  size_t n_;
  size_t pos_ = 0;
  bool eof_ = false;
  HuffSpec dc_spec_[4], ac_spec_[4];
  uint16_t qt_[4][64] = {};
  bool qt_defined_[4] = {};
  int restart_interval_ = 0;
  bool saw_jfif_ = false, saw_adobe_ = false, saw_sos_ = false, saw_app1_ = false;
  int adobe_transform_ = 0;
  bool frame_ = false, progressive_ = false;
  int pending_ = 0;  // a marker the entropy decoder has already read
  int scans_ = 0;    // scans started (libjpeg's input_scan_number)
  int last_good_ = 0;  // the last iMCU row begun with data left (last_good_iMCU_row)
  int maxh_ = 1, maxv_ = 1;
  std::vector<Component> comps_;

  int byte() {
    if (pos_ < n_) return d_[pos_++];
    // libjpeg's stdio source feeds a fake EOI after the end of the file
    const int b = eof_ ? 0xD9 : 0xFF;
    eof_ = !eof_;
    return b;
  }
  int u16() {
    const int hi = byte();
    return (hi << 8) | byte();
  }
  int next_marker();
  void segment(std::vector<uint8_t>* body);
  void read_sof(const std::vector<uint8_t>& b, int marker);
  void read_dht(const std::vector<uint8_t>& b);
  void read_dqt(const std::vector<uint8_t>& b);
  void read_exif(const std::vector<uint8_t>& b);
  bool scan(const std::vector<uint8_t>& b);
  void restart(Bits& br, int* next_rst);
  void smooth_block(const Component& c, int by, int bx, int16_t* work) const;
  void finish();
};

int Decoder::next_marker() {
  for (;;) {
    int c = byte();
    while (c != 0xFF) c = byte();
    do { c = byte(); } while (c == 0xFF);
    if (c != 0) return c;
  }
}

// A marker segment's body, read as libjpeg reads it: past the end of the
// file its source feeds FF D9 pairs.
void Decoder::segment(std::vector<uint8_t>* body) {
  const int len = u16();
  if (len < 2) corrupt("bad marker segment length");
  body->resize((size_t)(len - 2));
  if (pos_ + body->size() <= n_) {
    std::memcpy(body->data(), d_ + pos_, body->size());
    pos_ += body->size();
  } else {
    for (uint8_t& b : *body) b = (uint8_t)byte();
  }
}

void Decoder::read_sof(const std::vector<uint8_t>& b, int marker) {
  if (frame_) corrupt("two frame headers");
  if (b.size() < 6) corrupt("bad frame header length");
  const int precision = b[0];
  height = (b[1] << 8) | b[2];
  width = (b[3] << 8) | b[4];
  const int nc = b[5];
  if (b.size() != (size_t)(6 + 3 * nc)) corrupt("bad frame header length");
  if (height <= 0 || width <= 0 || nc <= 0) corrupt("empty image (zero size or a DNL height)");
  if (precision != 8) unsupported(std::to_string(precision) + "-bit samples");
  if (width > 65500 || height > 65500) corrupt("image too large");
  if ((int64_t)width * height > (1 << 30)) corrupt("image too large");
  if (nc == 4) unsupported("4-component (CMYK/YCCK) JPEG");
  if (nc != 1 && nc != 3)  // no colour conversion from these in libjpeg
    corrupt(std::to_string(nc) + "-component JPEG");
  progressive_ = marker == 0xC2;
  comps_.resize(nc);
  for (int i = 0; i < nc; ++i) {
    Component& c = comps_[i];
    c.id = b[6 + 3 * i];
    c.h = b[7 + 3 * i] >> 4;
    c.v = b[7 + 3 * i] & 15;
    c.tq = b[8 + 3 * i];
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) corrupt("bad sampling factors");
    if (c.tq > 3) corrupt("bad quantization table index");
    maxh_ = std::max(maxh_, c.h);
    maxv_ = std::max(maxv_, c.v);
  }
  const int mcux = (width + 8 * maxh_ - 1) / (8 * maxh_);
  const int mcuy = (height + 8 * maxv_ - 1) / (8 * maxv_);
  for (Component& c : comps_) {
    c.wib = (int)(((int64_t)width * c.h + 8 * maxh_ - 1) / (8 * maxh_));
    c.hib = (int)(((int64_t)height * c.v + 8 * maxv_ - 1) / (8 * maxv_));
    c.dw = (int)(((int64_t)width * c.h + maxh_ - 1) / maxh_);
    c.dh = (int)(((int64_t)height * c.v + maxv_ - 1) / maxv_);
    c.bw = mcux * c.h;
    c.bh = mcuy * c.v;
    c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    for (int& k : c.coef_bits) k = -1;
    for (int& k : c.prev_bits) k = 0;
  }
  frame_ = true;
}

void Decoder::read_dht(const std::vector<uint8_t>& b) {
  size_t i = 0;
  while (b.size() - i > 16) {
    const int index = b[i];
    int count = 0;
    uint8_t bits[17] = {0};
    for (int l = 1; l <= 16; ++l) count += (bits[l] = b[i + l]);
    i += 17;
    if (count > 256 || (size_t)count > b.size() - i) corrupt("bad Huffman table");
    const int tbl = index & 0x0F;
    if ((index & ~0x10) > 3) corrupt("bad Huffman table index");
    HuffSpec& s = (index & 0x10) ? ac_spec_[tbl] : dc_spec_[tbl];
    s.defined = true;
    std::memcpy(s.bits, bits, sizeof(bits));
    std::memset(s.vals, 0, sizeof(s.vals));
    std::memcpy(s.vals, &b[i], (size_t)count);
    i += (size_t)count;
  }
  if (i != b.size()) corrupt("bad Huffman table segment length");
}

// get_dqt: a table shorter than 64 entries keeps ones in the rest.
void Decoder::read_dqt(const std::vector<uint8_t>& b) {
  int length = (int)b.size();
  size_t i = 0;
  while (length > 0) {
    --length;
    const int prec = b[i] >> 4, n = b[i] & 15;
    ++i;
    if (n > 3) corrupt("bad quantization table index");
    int count = 64;
    if (length < (prec ? 128 : 64)) {
      for (uint16_t& v : qt_[n]) v = 1;
      count = prec ? length >> 1 : length;
    }
    for (int k = 0; k < count; ++k)
      qt_[n][kNatural[k]] = prec ? (uint16_t)((b[i + 2 * k] << 8) | b[i + 2 * k + 1]) : b[i + k];
    qt_defined_[n] = true;
    i += (size_t)count * (prec ? 2 : 1);
    length -= count * (prec ? 2 : 1);
  }
  if (length != 0) corrupt("bad quantization table segment length");
}

// OpenCV's ExifReader::parseExif on a TIFF header `t` (n bytes): the
// orientation entry of IFD0, or 0 without one.  It stops at the first entry
// it cannot read (ExifParsingError), keeping what it has read.
int exif_orientation(const uint8_t* t, size_t n) {
  if (n < 2 || t[0] != t[1] || (t[0] != 'I' && t[0] != 'M')) return 0;
  const bool intel = t[0] == 'I';
  auto u16 = [&](size_t o, bool* ok) -> uint32_t {
    if (o + 1 >= n) { *ok = false; return 0; }
    return intel ? t[o] | (t[o + 1] << 8) : (t[o] << 8) | t[o + 1];
  };
  auto u32 = [&](size_t o, bool* ok) -> uint32_t {
    if (o + 3 >= n) { *ok = false; return 0; }
    return intel ? (uint32_t)t[o] | (t[o + 1] << 8) | (t[o + 2] << 16) | ((uint32_t)t[o + 3] << 24)
                 : ((uint32_t)t[o] << 24) | (t[o + 1] << 16) | (t[o + 2] << 8) | t[o + 3];
  };
  bool ok = true;
  int orientation = 0;
  if (n < 4 || u16(2, &ok) != 42 || !ok) return 0;
  size_t off = u32(4, &ok);
  const uint32_t entries = u16(off, &ok);
  if (!ok) return 0;
  off += 2;
  for (uint32_t e = 0; e < entries; ++e, off += 12) {
    const uint32_t tag = u16(off, &ok);
    if (!ok) return orientation;
    switch (tag) {
      case 0x0112: {  // orientation: the first one counts (std::map::insert)
        const uint32_t v = u16(off + 8, &ok);
        if (!ok) return orientation;
        if (!orientation) orientation = (int)v;
        break;
      }
      case 0x010E: case 0x010F: case 0x0110: case 0x0131: case 0x0132: case 0x8298: {
        // ASCII strings: a string whose bytes lie outside stops the parse
        const uint32_t count = u32(off + 4, &ok);
        if (!ok) return orientation;
        if (count > 4) {
          const uint32_t at = u32(off + 8, &ok);
          if (!ok || (uint64_t)at + count > n) return orientation;
        }
        break;
      }
      case 0x011A: case 0x011B: case 0x013E: case 0x013F: case 0x0211: case 0x0214: {
        const int rationals = tag == 0x013E ? 2 : tag == 0x0211 ? 3
                              : (tag == 0x013F || tag == 0x0214) ? 6 : 1;
        const uint32_t at = u32(off + 8, &ok);
        if (!ok || (uint64_t)at + 8 * rationals > n) return orientation;
        break;
      }
      case 0x0128: case 0x0213:
        u16(off + 8, &ok);
        if (!ok) return orientation;
        break;
      default:
        break;
    }
  }
  return orientation;
}

// The first APP1 segment, past its 6-byte "Exif\0\0" header whatever it holds.
void Decoder::read_exif(const std::vector<uint8_t>& seg) {
  if (seg.size() > 6) orientation = exif_orientation(seg.data() + 6, seg.size() - 6);
}

void Decoder::restart(Bits& br, int* next_rst) {
  br.drop();
  int marker = br.marker;
  size_t p = br.pos;
  auto scan_marker = [&]() -> int {  // next_marker from p
    for (;;) {
      int c = p < n_ ? d_[p++] : -1;
      while (c != 0xFF && c != -1) c = p < n_ ? d_[p++] : -1;
      if (c == -1) return 0xD9;
      do { c = p < n_ ? d_[p++] : -1; } while (c == 0xFF);
      if (c == -1) return 0xD9;
      if (c != 0) return c;
    }
  };
  if (marker == 0) marker = scan_marker();
  const int want = 0xD0 + *next_rst;
  if (marker == want) {
    marker = 0;
  } else {
    // jpeg_resync_to_restart
    for (;;) {
      int action;
      if (marker < 0xC0) action = 2;
      else if (marker < 0xD0 || marker > 0xD7) action = 3;
      else if (marker == 0xD0 + ((*next_rst + 1) & 7) || marker == 0xD0 + ((*next_rst + 2) & 7)) action = 3;
      else if (marker == 0xD0 + ((*next_rst - 1) & 7) || marker == 0xD0 + ((*next_rst - 2) & 7)) action = 2;
      else action = 1;
      if (action == 1) { marker = 0; break; }
      if (action == 3) break;
      marker = scan_marker();
    }
  }
  *next_rst = (*next_rst + 1) & 7;
  br.pos = p;
  br.marker = marker;
  if (marker == 0) br.insufficient = false;
}

// One scan; returns true when it reads the whole frame in one pass (a
// single-scan sequential file, after which libjpeg reads no more markers).
bool Decoder::scan(const std::vector<uint8_t>& b) {
  if (!frame_) corrupt("scan before the frame header");
  const int ns = b.empty() ? 0 : b[0];
  if (b.size() != (size_t)(ns * 2 + 4) || ns < 1 || ns > 4) corrupt("bad scan header length");
  std::vector<int> sc;
  for (int i = 0; i < ns; ++i) {
    const int id = b[1 + 2 * i], t = b[2 + 2 * i];
    int found = -1;
    for (int c = 0; c < (int)comps_.size(); ++c)
      if (comps_[c].id == id && std::find(sc.begin(), sc.end(), c) == sc.end()) { found = c; break; }
    if (found < 0) corrupt("bad component id in a scan");
    sc.push_back(found);
    comps_[found].dc_tbl = t >> 4;
    comps_[found].ac_tbl = t & 15;
  }
  const int ss = b[1 + 2 * ns], se = b[2 + 2 * ns], ah = b[3 + 2 * ns] >> 4, al = b[3 + 2 * ns] & 15;
  ++scans_;
  // latch each component's quantization table at its first scan
  for (int c : sc) {
    Component& cp = comps_[c];
    if (!cp.latched) {
      if (!qt_defined_[cp.tq]) corrupt("missing quantization table");
      std::memcpy(cp.q, qt_[cp.tq], sizeof(cp.q));
      cp.latched = true;
    }
  }
  int blocks = 0;
  for (int c : sc) blocks += ns == 1 ? 1 : comps_[c].h * comps_[c].v;
  if (blocks > 10) corrupt("too many blocks in an MCU");

  const bool dc_band = ss == 0;
  if (progressive_) {
    bool bad = dc_band ? se != 0 : (ss > se || se >= 64 || ns != 1);
    if (ah != 0 && al != ah - 1) bad = true;
    if (al > 13) bad = true;
    if (bad) corrupt("bad progression parameters");
    for (int c : sc) {
      Component& cp = comps_[c];
      for (int k = std::min(ss, 1); k <= std::max(se, 9); ++k)
        if (k < 10) cp.prev_bits[k] = scans_ > 1 ? cp.coef_bits[k] : 0;
      for (int k = ss; k <= se; ++k) cp.coef_bits[k] = al;
    }
  }

  Huff dc[4], ac[4];
  auto table = [&](bool is_dc, int t, Huff* out) {
    if (t > 3) corrupt("bad Huffman table index");
    const HuffSpec* s = is_dc ? &dc_spec_[t] : &ac_spec_[t];
    HuffSpec std_spec;
    if (!s->defined) {
      // jinit_huff_decoder installs Annex K's tables 0 and 1 for sequential
      // files only; a progressive scan without its table is an error
      if (t > 1 || progressive_) corrupt("missing Huffman table");
      const uint8_t* bits = is_dc ? (t ? kDcChromBits : kDcLumBits) : (t ? kAcChromBits : kAcLumBits);
      const uint8_t* vals = is_dc ? kDcVals : (t ? kAcChromVals : kAcLumVals);
      std::memcpy(std_spec.bits, bits, 17);
      std::memcpy(std_spec.vals, vals, is_dc ? 12 : 162);
      s = &std_spec;
    }
    derive(*s, is_dc, out);
  };
  for (int c : sc) {
    const Component& cp = comps_[c];
    if (!progressive_) {
      table(true, cp.dc_tbl, &dc[cp.dc_tbl]);
      table(false, cp.ac_tbl, &ac[cp.ac_tbl]);
    } else if (dc_band) {
      if (ah == 0) table(true, cp.dc_tbl, &dc[cp.dc_tbl]);
    } else {
      table(false, cp.ac_tbl, &ac[cp.ac_tbl]);
    }
    comps_[c].last_dc = 0;
  }

  int mcux, mcuy;
  if (ns == 1) {
    mcux = comps_[sc[0]].wib;
    mcuy = comps_[sc[0]].hib;
  } else {
    mcux = (width + 8 * maxh_ - 1) / (8 * maxh_);
    mcuy = (height + 8 * maxv_ - 1) / (8 * maxv_);
  }
  // the blocks of an MCU: (component, block row, block column) offsets
  struct Slot { int c, dy, dx; };
  std::vector<Slot> slots;
  for (int c : sc) {
    if (ns == 1) { slots.push_back({c, 0, 0}); continue; }
    for (int y = 0; y < comps_[c].v; ++y)
      for (int x = 0; x < comps_[c].h; ++x) slots.push_back({c, y, x});
  }

  Bits br;
  br.start(d_, n_, pos_, pos_ >= n_ && eof_);
  int eobrun = 0, restarts_to_go = restart_interval_, next_rst = 0;
  const int p1 = 1 << al, m1 = (int)((unsigned)-1 << al);
  const int imcu_rows = ns == 1 ? comps_[sc[0]].v : 1;  // MCU rows an iMCU row
  for (int my = 0; my < mcuy; ++my) {
    for (int mx = 0; mx < mcux; ++mx) {
      if (!br.insufficient) last_good_ = my / imcu_rows;
      if (restart_interval_) {
        if (restarts_to_go == 0) {
          restart(br, &next_rst);
          for (int c : sc) comps_[c].last_dc = 0;
          eobrun = 0;
          restarts_to_go = restart_interval_;
        }
      }
      // past the end of the data the MCU stays as it is (DC refinement reads zeros)
      if (br.insufficient && !(progressive_ && dc_band && ah != 0)) {
        --restarts_to_go;
        continue;
      }
      for (const Slot& s : slots) {
        Component& cp = comps_[s.c];
        int by, bx;
        if (ns == 1) { by = my; bx = mx; }
        else { by = my * cp.v + s.dy; bx = mx * cp.h + s.dx; }
        int16_t* blk = &cp.coef[((size_t)by * cp.bw + bx) * 64];
        if (!progressive_) {
          int t = br.decode(dc[cp.dc_tbl]);
          if (t) t = extend((int)br.get(t), t);
          cp.last_dc += t;
          blk[0] = (int16_t)cp.last_dc;
          const Huff& h = ac[cp.ac_tbl];
          for (int k = 1; k < 64; ++k) {
            int sym = br.decode(h);
            const int r = sym >> 4;
            sym &= 15;
            if (sym) {
              k += r;
              blk[kNatural[k]] = (int16_t)extend((int)br.get(sym), sym);
            } else {
              if (r != 15) break;
              k += 15;
            }
          }
        } else if (dc_band && ah == 0) {
          int t = br.decode(dc[cp.dc_tbl]);
          if (t) t = extend((int)br.get(t), t);
          cp.last_dc += t;
          blk[0] = left_shift16(cp.last_dc, al);
        } else if (dc_band) {
          if (br.get(1)) blk[0] = (int16_t)(blk[0] | p1);
        } else if (ah == 0) {
          if (eobrun > 0) { --eobrun; continue; }
          const Huff& h = ac[cp.ac_tbl];
          for (int k = ss; k <= se; ++k) {
            int sym = br.decode(h);
            int r = sym >> 4;
            sym &= 15;
            if (sym) {
              k += r;
              blk[kNatural[k]] = left_shift16(extend((int)br.get(sym), sym), al);
            } else if (r == 15) {
              k += 15;
            } else {
              eobrun = 1 << r;
              if (r) eobrun += (int)br.get(r);
              --eobrun;
              break;
            }
          }
        } else {
          const Huff& h = ac[cp.ac_tbl];
          int k = ss;
          if (eobrun == 0) {
            for (; k <= se; ++k) {
              int sym = br.decode(h);
              int r = sym >> 4;
              int s = sym & 15;
              if (s) {
                s = br.get(1) ? p1 : m1;
              } else if (r != 15) {
                eobrun = 1 << r;
                if (r) eobrun += (int)br.get(r);
                break;
              }
              do {
                int16_t* coef = blk + kNatural[k];
                if (*coef != 0) {
                  if (br.get(1) && (*coef & p1) == 0)
                    *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
                } else if (--r < 0) {
                  break;
                }
                ++k;
              } while (k <= se);
              if (s) blk[kNatural[k]] = (int16_t)s;
            }
          }
          if (eobrun > 0) {
            for (; k <= se; ++k) {
              int16_t* coef = blk + kNatural[k];
              if (*coef != 0 && br.get(1) && (*coef & p1) == 0)
                *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
            }
            --eobrun;
          }
        }
      }
      --restarts_to_go;
    }
  }
  // marker parsing resumes where the entropy decoder stopped
  pos_ = br.pos;
  pending_ = br.marker;
  return !progressive_ && ns == (int)comps_.size() && !saw_sos_;
}

// ---------------------------------------------------------------------------
// islow IDCT (jidctint.c) as jsimd_idct_islow_avx2 computes it: 16-bit
// dequantisation; in0 +- in4 and the odd part's z3 = in7 + in3, z4 = in5 + in1
// as 16-bit sums; products and the rest in 32 bits (wrapping: build with
// -fwrapv); each pass's results saturated to 16 bits; a block whose rows 1-7
// are all zero takes the first pass's shortcut, a 16-bit dc << 2.

inline int32_t wrap16(int32_t x) { return (int16_t)(uint16_t)(uint32_t)x; }
inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }
inline int16_t sat16(int32_t x) { return (int16_t)std::min(32767, std::max(-32768, x)); }

// One 8-point pass over in[0..7] (int16 values), descaled by `shift`.
inline void idct8(const int32_t* in, int shift, int32_t* out) {
  const int32_t z2 = in[2], z3e = in[6];
  const int32_t z1e = (z2 + z3e) * 4433;
  const int32_t t2e = z1e + z3e * -15137, t3e = z1e + z2 * 6270;
  const int32_t t0e = wrap16(in[0] + in[4]) << 13, t1e = wrap16(in[0] - in[4]) << 13;
  const int32_t tmp10 = t0e + t3e, tmp13 = t0e - t3e, tmp11 = t1e + t2e, tmp12 = t1e - t2e;
  int32_t tmp0 = in[7], tmp1 = in[5], tmp2 = in[3], tmp3 = in[1];
  int32_t z1 = tmp0 + tmp3, z2o = tmp1 + tmp2;
  int32_t z3 = wrap16(tmp0 + tmp2), z4 = wrap16(tmp1 + tmp3);
  const int32_t z5 = (z3 + z4) * 9633;
  tmp0 *= 2446; tmp1 *= 16819; tmp2 *= 25172; tmp3 *= 12299;
  z1 *= -7373; z2o *= -20995; z3 *= -16069; z4 *= -3196;
  z3 += z5; z4 += z5;
  tmp0 += z1 + z3; tmp1 += z2o + z4; tmp2 += z2o + z3; tmp3 += z1 + z4;
  out[0] = sat16(descale(tmp10 + tmp3, shift)); out[7] = sat16(descale(tmp10 - tmp3, shift));
  out[1] = sat16(descale(tmp11 + tmp2, shift)); out[6] = sat16(descale(tmp11 - tmp2, shift));
  out[2] = sat16(descale(tmp12 + tmp1, shift)); out[5] = sat16(descale(tmp12 - tmp1, shift));
  out[3] = sat16(descale(tmp13 + tmp0, shift)); out[4] = sat16(descale(tmp13 - tmp0, shift));
}

void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  int32_t ws[64], in[8], res[8];
  bool ac_zero = true;
  for (int i = 8; i < 64; ++i) ac_zero &= coef[i] == 0;
  for (int c = 0; c < 8; ++c) {
    const int32_t dc = wrap16((int32_t)((uint32_t)coef[c] * q[c]));
    if (ac_zero) {
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = wrap16(dc << 2);
      continue;
    }
    for (int r = 0; r < 8; ++r) in[r] = wrap16((int32_t)((uint32_t)coef[r * 8 + c] * q[r * 8 + c]));
    idct8(in, 11, res);
    for (int r = 0; r < 8; ++r) ws[r * 8 + c] = res[r];
  }
  for (int r = 0; r < 8; ++r) {
    idct8(ws + r * 8, 18, res);
    uint8_t* o = out + (size_t)r * stride;
    for (int c = 0; c < 8; ++c) o[c] = (uint8_t)(std::min(127, std::max(-128, res[c])) + 128);
  }
}

// ---------------------------------------------------------------------------
// upsampling (jdsample.c) of one component to the full width x height

void upsample(const uint8_t* in, int stride, int dw, int dh, int hr, int vr, bool fancy_h,
              int width, int height, uint8_t* out) {
  std::vector<uint8_t> row((size_t)dw * hr + 2);
  std::vector<int> sum(dw);
  for (int y = 0; y < height; ++y) {
    uint8_t* o = out + (size_t)y * width;
    if (hr == 1 && vr == 1) {
      std::memcpy(o, in + (size_t)y * stride, width);
      continue;
    }
    if (hr == 2 && vr == 1 && fancy_h) {  // h2v1 triangle filter
      const uint8_t* p = in + (size_t)y * stride;
      row[0] = p[0];
      row[1] = (uint8_t)((p[0] * 3 + p[1] + 2) >> 2);
      for (int i = 1; i < dw - 1; ++i) {
        row[2 * i] = (uint8_t)((p[i] * 3 + p[i - 1] + 1) >> 2);
        row[2 * i + 1] = (uint8_t)((p[i] * 3 + p[i + 1] + 2) >> 2);
      }
      row[2 * (dw - 1)] = (uint8_t)((p[dw - 1] * 3 + p[dw - 2] + 1) >> 2);
      row[2 * dw - 1] = p[dw - 1];
      std::memcpy(o, row.data(), width);
      continue;
    }
    if (hr == 1 && vr == 2) {  // h1v2 triangle filter
      const int j = y >> 1, nb = std::min(dh - 1, std::max(0, (y & 1) ? j + 1 : j - 1));
      const int bias = (y & 1) ? 2 : 1;
      const uint8_t* p0 = in + (size_t)j * stride;
      const uint8_t* p1 = in + (size_t)nb * stride;
      for (int x = 0; x < width; ++x) o[x] = (uint8_t)((p0[x] * 3 + p1[x] + bias) >> 2);
      continue;
    }
    if (hr == 2 && vr == 2 && fancy_h) {  // h2v2 triangle filter
      const int j = y >> 1, nb = std::min(dh - 1, std::max(0, (y & 1) ? j + 1 : j - 1));
      const uint8_t* p0 = in + (size_t)j * stride;
      const uint8_t* p1 = in + (size_t)nb * stride;
      for (int i = 0; i < dw; ++i) sum[i] = p0[i] * 3 + p1[i];
      row[0] = (uint8_t)((sum[0] * 4 + 8) >> 4);
      row[1] = (uint8_t)((sum[0] * 3 + sum[1] + 7) >> 4);
      for (int i = 1; i < dw - 1; ++i) {
        row[2 * i] = (uint8_t)((sum[i] * 3 + sum[i - 1] + 8) >> 4);
        row[2 * i + 1] = (uint8_t)((sum[i] * 3 + sum[i + 1] + 7) >> 4);
      }
      row[2 * (dw - 1)] = (uint8_t)((sum[dw - 1] * 3 + sum[dw - 2] + 8) >> 4);
      row[2 * dw - 1] = (uint8_t)((sum[dw - 1] * 4 + 7) >> 4);
      std::memcpy(o, row.data(), width);
      continue;
    }
    const uint8_t* p = in + (size_t)(y / vr) * stride;  // replication
    for (int x = 0; x < width; ++x) o[x] = p[x / hr];
  }
}

// decompress_smooth_data for one block: a copy of it with the coefficients
// 1-9 that are still zero and not known exactly predicted from the DC values
// of the 5x5 blocks around it (all nine and the DC itself when no AC data is
// known, "change_dc").  Past the last iMCU row begun with data left, the
// coefficient bits from before each component's last scan count.  The block
// rows around it are chosen as libjpeg-turbo chooses them: in a component's
// last iMCU row its index is counted in that row's real block rows, which
// clamps the rows above and below differently from the image's edges.
void Decoder::smooth_block(const Component& c, int by, int bx, int16_t* work) const {
  const int16_t* blk = &c.coef[((size_t)by * c.bw + bx) * 64];
  std::memcpy(work, blk, 64 * sizeof(int16_t));
  int bits[10];
  bits[0] = c.coef_bits[0];
  const bool incomplete = by / c.v > last_good_;
  for (int k = 1; k < 10; ++k)
    bits[k] = incomplete ? (scans_ > 1 ? c.prev_bits[k] : -1) : c.coef_bits[k];
  bool change_dc = true;
  for (int k = 1; k < 10; ++k) change_dc &= bits[k] == -1;
  const int T = (height + 8 * maxv_ - 1) / (8 * maxv_), R = by / c.v, br = by % c.v;
  const int block_rows = R < T - 1 ? c.v : (c.hib % c.v ? c.hib % c.v : c.v);
  const int ibr = R * block_rows + br, ibrs = block_rows * T;
  int rows[5];
  rows[2] = by;
  rows[1] = ibr > 0 ? by - 1 : by;
  rows[0] = ibr > 1 ? by - 2 : rows[1];
  rows[3] = ibr < ibrs - 1 ? by + 1 : by;
  rows[4] = ibr < ibrs - 2 ? by + 2 : rows[3];
  int dc[26];  // dc[1..25]: rows -2..2 (5 each), columns -2..2 clamped to the image
  for (int r = 0; r < 5; ++r)
    for (int q = -2; q <= 2; ++q) {
      const int x = std::min(std::max(bx + q, 0), c.wib - 1);
      dc[r * 5 + (q + 2) + 1] = c.coef[((size_t)rows[r] * c.bw + x) * 64];
    }
  const int64_t Q00 = c.q[0], Q01 = c.q[1], Q10 = c.q[8], Q20 = c.q[16], Q11 = c.q[9],
                Q02 = c.q[2], Q03 = c.q[3], Q12 = c.q[10], Q21 = c.q[17], Q30 = c.q[24];
  auto predict = [](int64_t num, int64_t q, int al) {
    int pred;
    if (num >= 0) {
      pred = (int)(((q << 7) + num) / (q << 8));
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    } else {
      pred = (int)(((q << 7) - num) / (q << 8));
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      pred = -pred;
    }
    return (int16_t)pred;
  };
  const int* D = dc;
  int al;
  if ((al = bits[1]) != 0 && work[1] == 0) {
    const int64_t num = Q00 * (change_dc ?
        (-D[1] - D[2] + D[4] + D[5] - 3 * D[6] + 13 * D[7] - 13 * D[9] + 3 * D[10] -
         3 * D[11] + 38 * D[12] - 38 * D[14] + 3 * D[15] - 3 * D[16] + 13 * D[17] -
         13 * D[19] + 3 * D[20] - D[21] - D[22] + D[24] + D[25]) :
        (-7 * D[11] + 50 * D[12] - 50 * D[14] + 7 * D[15]));
    work[1] = predict(num, Q01, al);
  }
  if ((al = bits[2]) != 0 && work[8] == 0) {
    const int64_t num = Q00 * (change_dc ?
        (-D[1] - 3 * D[2] - 3 * D[3] - 3 * D[4] - D[5] - D[6] + 13 * D[7] + 38 * D[8] +
         13 * D[9] - D[10] + D[16] - 13 * D[17] - 38 * D[18] - 13 * D[19] + D[20] + D[21] +
         3 * D[22] + 3 * D[23] + 3 * D[24] + D[25]) :
        (-7 * D[3] + 50 * D[8] - 50 * D[18] + 7 * D[23]));
    work[8] = predict(num, Q10, al);
  }
  if ((al = bits[3]) != 0 && work[16] == 0) {
    const int64_t num = Q00 * (change_dc ?
        (D[3] + 2 * D[7] + 7 * D[8] + 2 * D[9] - 5 * D[12] - 14 * D[13] - 5 * D[14] +
         2 * D[17] + 7 * D[18] + 2 * D[19] + D[23]) :
        (-D[3] + 13 * D[8] - 24 * D[13] + 13 * D[18] - D[23]));
    work[16] = predict(num, Q20, al);
  }
  if ((al = bits[4]) != 0 && work[9] == 0) {
    const int64_t num = Q00 * (change_dc ?
        (-D[1] + D[5] + 9 * D[7] - 9 * D[9] - 9 * D[17] + 9 * D[19] + D[21] - D[25]) :
        (D[10] + D[16] - 10 * D[17] + 10 * D[19] - D[2] - D[20] + D[22] - D[24] + D[4] -
         D[6] + 10 * D[7] - 10 * D[9]));
    work[9] = predict(num, Q11, al);
  }
  if ((al = bits[5]) != 0 && work[2] == 0) {
    const int64_t num = Q00 * (change_dc ?
        (2 * D[7] - 5 * D[8] + 2 * D[9] + D[11] + 7 * D[12] - 14 * D[13] + 7 * D[14] +
         D[15] + 2 * D[17] - 5 * D[18] + 2 * D[19]) :
        (-D[11] + 13 * D[12] - 24 * D[13] + 13 * D[14] - D[15]));
    work[2] = predict(num, Q02, al);
  }
  if (change_dc) {
    if ((al = bits[6]) != 0 && work[3] == 0)
      work[3] = predict(Q00 * (D[7] - D[9] + 2 * D[12] - 2 * D[14] + D[17] - D[19]), Q03, al);
    if ((al = bits[7]) != 0 && work[10] == 0)
      work[10] = predict(Q00 * (D[7] - 3 * D[8] + D[9] - D[17] + 3 * D[18] - D[19]), Q12, al);
    if ((al = bits[8]) != 0 && work[17] == 0)
      work[17] = predict(Q00 * (D[7] - D[9] - 3 * D[12] + 3 * D[14] + D[17] - D[19]), Q21, al);
    if ((al = bits[9]) != 0 && work[24] == 0)
      work[24] = predict(Q00 * (D[7] + 2 * D[8] + D[9] - D[17] - 2 * D[18] - D[19]), Q30, al);
    const int64_t num = Q00 * (
        -2 * D[1] - 6 * D[2] - 8 * D[3] - 6 * D[4] - 2 * D[5] - 6 * D[6] + 6 * D[7] +
        42 * D[8] + 6 * D[9] - 6 * D[10] - 8 * D[11] + 42 * D[12] + 152 * D[13] +
        42 * D[14] - 8 * D[15] - 6 * D[16] + 6 * D[17] + 42 * D[18] + 6 * D[19] -
        6 * D[20] - 2 * D[21] - 6 * D[22] - 8 * D[23] - 6 * D[24] - 2 * D[25]);
    work[0] = predict(num, Q00, 0);
  }
}

void Decoder::finish() {
  // libjpeg smooths the blocks of a progressive file whose first nine AC
  // coefficients are not all complete (smoothing_ok)
  bool smooth = progressive_;
  if (smooth) {
    static const int kQPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (const Component& c : comps_) {
      if (!c.latched || c.coef_bits[0] < 0) { smooth = false; break; }
      for (int k : kQPos) if (c.q[k] == 0) smooth = false;
      for (int k = 1; k < 10; ++k) if (c.coef_bits[k] != 0) useful = true;
    }
    smooth = smooth && useful;
  }
  const int nc = (int)comps_.size();
  std::vector<std::vector<uint8_t>> full(nc);
  for (int ci = 0; ci < nc; ++ci) {
    Component& c = comps_[ci];
    const int stride = c.wib * 8;
    std::vector<uint8_t> plane((size_t)stride * c.hib * 8);
    for (int by = 0; by < c.hib; ++by)
      for (int bx = 0; bx < c.wib; ++bx) {
        const int16_t* blk = &c.coef[((size_t)by * c.bw + bx) * 64];
        int16_t work[64];
        if (smooth) {
          smooth_block(c, by, bx, work);
          blk = work;
        }
        idct_islow(blk, c.q, &plane[(size_t)by * 8 * stride + bx * 8], stride);
      }
    const int hr = maxh_ / c.h, vr = maxv_ / c.v;
    if (maxh_ % c.h || maxv_ % c.v) corrupt("fractional sampling ratio");
    full[ci].resize((size_t)width * height);
    upsample(plane.data(), stride, c.dw, c.dh, hr, vr, c.dw > 2, width, height, full[ci].data());
  }
  out.resize((size_t)width * height * 3);
  uint8_t* o = out.data();
  const size_t npix = (size_t)width * height;
  if (nc == 1) {
    for (size_t i = 0; i < npix; ++i) o[3 * i] = o[3 * i + 1] = o[3 * i + 2] = full[0][i];
    return;
  }
  bool rgb;
  if (saw_jfif_) rgb = false;
  else if (saw_adobe_) rgb = adobe_transform_ == 0;
  else rgb = comps_[0].id == 82 && comps_[1].id == 71 && comps_[2].id == 66;
  const uint8_t *c0 = full[0].data(), *c1 = full[1].data(), *c2 = full[2].data();
  if (rgb) {
    for (size_t i = 0; i < npix; ++i) { o[3 * i] = c2[i]; o[3 * i + 1] = c1[i]; o[3 * i + 2] = c0[i]; }
    return;
  }
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  for (int i = 0; i < 256; ++i) {
    const int x = i - 128;
    cr_r[i] = (int)((91881 * (int64_t)x + 32768) >> 16);
    cb_b[i] = (int)((116130 * (int64_t)x + 32768) >> 16);
    cr_g[i] = -46802 * x;
    cb_g[i] = -22554 * x + 32768;
  }
  auto clamp = [](int v) { return (uint8_t)std::min(255, std::max(0, v)); };
  for (size_t i = 0; i < npix; ++i) {
    const int y = c0[i], cb = c1[i], cr = c2[i];
    o[3 * i + 2] = clamp(y + cr_r[cr]);
    o[3 * i + 1] = clamp(y + ((cb_g[cb] + cr_g[cr]) >> 16));
    o[3 * i] = clamp(y + cb_b[cb]);
  }
}

void Decoder::run() {
  if (n_ < 2 || d_[0] != 0xFF || d_[1] != 0xD8) corrupt("not a JPEG file (no SOI)");
  pos_ = 2;
  std::vector<uint8_t> body;
  bool multi = false;
  for (;;) {
    int m = pending_ ? pending_ : next_marker();
    pending_ = 0;
    if (m == 0xD9) {  // EOI
      if (!saw_sos_) corrupt("no image before EOI");
      break;
    }
    if (m == 0xD8) corrupt("second SOI");
    if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;  // RSTn, TEM: no parameters
    const bool sof = m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC;
    if (sof && frame_) corrupt("two frame headers");
    if (m == 0xC3 || m == 0xCB) unsupported("lossless JPEG");
    if (m == 0xC9 || m == 0xCA) unsupported("arithmetic-coded JPEG");
    if ((m >= 0xC5 && m <= 0xC8) || (m >= 0xCD && m <= 0xCF))  // libjpeg refuses these too
      corrupt("hierarchical or differential JPEG frame");
    segment(&body);
    switch (m) {
      case 0xC0: case 0xC1: case 0xC2:
        read_sof(body, m);
        break;
      case 0xC4: read_dht(body); break;
      case 0xDB: read_dqt(body); break;
      case 0xCC: break;  // DAC: arithmetic conditioning, unused by Huffman files
      case 0xDD:
        if (body.size() != 2) corrupt("bad DRI length");
        restart_interval_ = (body[0] << 8) | body[1];
        break;
      case 0xDA: {
        if (!saw_sos_ && frame_) {
          const int ns = body.empty() ? 0 : body[0];
          multi = progressive_ || ns < (int)comps_.size();
        }
        const bool first = !saw_sos_;
        const bool whole = scan(body);
        saw_sos_ = true;
        if (first && whole && !multi) { finish(); return; }
        break;
      }
      case 0xE0:
        if (body.size() >= 14 && std::memcmp(body.data(), "JFIF\0", 5) == 0) saw_jfif_ = true;
        break;
      case 0xE1:
        if (!saw_sos_ && !saw_app1_) { saw_app1_ = true; read_exif(body); }
        break;
      case 0xEE:
        if (body.size() >= 12 && std::memcmp(body.data(), "Adobe", 5) == 0) {
          saw_adobe_ = true;
          adobe_transform_ = body[11];
        }
        break;
      default:
        if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE || m == 0xDC) break;  // APPn, COM, DNL
        corrupt("unknown marker");
    }
  }
  if (!frame_) corrupt("no frame header");
  finish();
}

}  // namespace

extern "C" {

int jpeg_decode(const uint8_t* data, size_t size, uint8_t** out, int* height, int* width,
                int* orientation, char* msg, int msg_len) {
  *out = nullptr;
  try {
    Decoder dec(data, size);
    dec.run();
    uint8_t* buf = (uint8_t*)std::malloc(dec.out.size());
    if (!buf) { std::snprintf(msg, msg_len, "out of memory"); return kCorrupt; }
    std::memcpy(buf, dec.out.data(), dec.out.size());
    *out = buf;
    *height = dec.height;
    *width = dec.width;
    *orientation = dec.orientation;
    return kOk;
  } catch (const Failure& f) {
    std::snprintf(msg, msg_len, "%s", f.what.c_str());
    return f.status;
  } catch (const std::bad_alloc&) {
    std::snprintf(msg, msg_len, "out of memory");
    return kCorrupt;
  }
}

void jpeg_free(uint8_t* p) { std::free(p); }

int jpeg_exif_orientation(const uint8_t* tiff, size_t size) { return exif_orientation(tiff, size); }

}  // extern "C"
