// JPEG decoding on the host, with a plain C interface (ctypes).
//
// Part of the port's image decoder (dafne_torch/data/image_io.py and
// data/jpeg.py), which takes the place of cv2.imread(path, IMREAD_COLOR) in
// dafne_tpu/data/mapper.py::read_image.  OpenCV decodes JPEG with
// libjpeg-turbo; this file restates libjpeg-turbo's default decompression
// path so that the pixels are the same byte for byte:
//
//   - Huffman entropy decoding, sequential (SOF0, SOF1) and progressive
//     (SOF2: DC and AC first and refinement scans, EOB runs), with restart
//     intervals, byte stuffing, fill bytes, and libjpeg's handling of data
//     that runs out (the rest of the scan segment decodes as zeros) and of
//     misplaced restart markers (jpeg_resync_to_restart);
//   - dequantization and the accurate integer IDCT (jidctint.c, "islow":
//     13-bit constants, 2 extra bits in pass 1), with the 16-bit wraps and
//     saturations of libjpeg-turbo's AVX2 version, which OpenCV runs;
//   - "fancy" upsampling of subsampled components (jdsample.c: h2v1, h1v2
//     and h2v2 triangle filters with their alternating rounding biases,
//     context rows across the MCU rows, edges replicated; box upsampling
//     for components at most 2 samples wide);
//   - YCbCr to BGR through libjpeg's fixed-point tables (jdcolor.c), gray
//     replicated to three channels, and RGB (Adobe transform 0, or the
//     component ids 'R', 'G', 'B') reordered.
//
// It is host code, not a kernel: Huffman decoding is serial along the
// stream, and the IDCT, upsampling and colour conversion of one image are a
// few milliseconds of integer work next to it.
//
//   - the block smoothing of a progressive file cut off before its last
//     scans (jdcoefct.c decompress_smooth_data: coefficients estimated from
//     the DC terms of the 5 x 5 blocks around).
//
// Outside the decoder's scope, reported as unsupported: arithmetic coding,
// lossless and hierarchical processes, precisions other than 8 bits, 2 or
// 4 components (CMYK, YCCK) and sampling factors above 2.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum Status { kOk = 0, kCorrupt = 1, kUnsupported = 2 };

struct Failure {
  int status;
  std::string message;
};

[[noreturn]] void corrupt(const std::string& m) { throw Failure{kCorrupt, m}; }
[[noreturn]] void unsupported(const std::string& m) { throw Failure{kUnsupported, m}; }

// zigzag position -> natural (row-major) position, with libjpeg's 16 extra
// entries so that a corrupt run past coefficient 63 lands on 63
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

const int kLookahead = 8;

struct Huffman {
  bool defined = false;
  uint8_t bits[17] = {0};  // codes of each length 1..16
  uint8_t vals[256] = {0};
  // derived (jpeg_make_d_derived_tbl)
  bool derived = false;
  int32_t maxcode[18];
  int32_t valoffset[18];
  int16_t look_len[1 << kLookahead];  // 0: no code of <= 8 bits
  uint8_t look_sym[1 << kLookahead];

  void derive(bool dc) {
    char size[257];
    uint32_t code[257];
    int p = 0;
    for (int l = 1; l <= 16; ++l) {
      int n = bits[l];
      if (p + n > 256) corrupt("bad Huffman table");
      while (n--) size[p++] = static_cast<char>(l);
    }
    size[p] = 0;
    const int nsym = p;
    uint32_t c = 0;
    int si = size[0];
    p = 0;
    while (size[p]) {
      while (size[p] == si) code[p++] = c++;
      if (c >= (1u << si)) corrupt("bad Huffman table");
      c <<= 1;
      ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (bits[l]) {
        valoffset[l] = p - static_cast<int32_t>(code[p]);
        p += bits[l];
        maxcode[l] = static_cast<int32_t>(code[p - 1]);
      } else {
        maxcode[l] = -1;
      }
    }
    valoffset[17] = 0;
    maxcode[17] = 0xFFFFF;
    std::memset(look_len, 0, sizeof(look_len));
    p = 0;
    for (int l = 1; l <= kLookahead; ++l) {
      for (int i = 1; i <= bits[l]; ++i, ++p) {
        int look = static_cast<int>(code[p]) << (kLookahead - l);
        for (int k = 1 << (kLookahead - l); k > 0; --k, ++look) {
          look_len[look] = static_cast<int16_t>(l);
          look_sym[look] = vals[p];
        }
      }
    }
    if (dc) {
      for (int i = 0; i < nsym; ++i)
        if (vals[i] > 15) corrupt("bad Huffman table");
    }
    derived = true;
  }
};

struct Component {
  int id, h, v, tq;
  int dc_tbl = 0, ac_tbl = 0;
  int bw, bh;          // blocks holding image data
  int bw_pad, bh_pad;  // blocks of the whole MCU grid
  int dw, dh;          // samples holding image data (downsampled size)
  bool latched = false;
  uint16_t quant[64];  // natural order, latched at the component's first scan
  std::vector<int16_t> coef;
  int coef_bits[64];  // progressive: the Al of the latest scan, -1 before any
  int prev_bits[10];  // coef_bits[0..9] before the latest scan of this component
  int bits_latch[10], prev_latch[10];  // the two above as block smoothing reads them
};

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t size) : data_(data), size_(size) {}

  // jpeg_read_header: the markers up to the first SOS.
  void read_header() {
    if (size_ < 2 || data_[0] != 0xFF || data_[1] != 0xD8) corrupt("not a JPEG file (no SOI marker)");
    pos_ = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xDA) {
        if (!saw_sof_) corrupt("SOS marker before SOF");
        read_sos();
        return;
      }
      if (m == 0xD9) corrupt("no image in the JPEG file (EOI before SOS)");
      header_marker(m);
    }
  }

  int width() const { return width_; }
  int height() const { return height_; }
  int components() const { return ncomp_; }
  int sof() const { return sof_; }
  int warnings() const { return warnings_; }

  void decode(uint8_t* out) {
    // a scan that holds every component of a sequential file is the whole
    // image (libjpeg's single-pass mode): later scans are not read
    const bool multi = progressive_ || nscan_ < ncomp_;
    for (;;) {
      decode_scan();
      if (!multi) break;
      int m = next_marker();
      bool more = false;
      while (m != 0xD9) {
        if (m == 0xDA) {
          read_sos();
          more = true;
          break;
        }
        header_marker(m);
        m = next_marker();
      }
      if (!more) break;
    }
    smooth_ = progressive_ && smoothing_useful();
    render(out);
  }

 private:
  const uint8_t* data_;
  size_t size_;
  size_t pos_ = 0;
  int warnings_ = 0;

  uint16_t qt_[4][64];
  bool qt_defined_[4] = {false, false, false, false};
  Huffman dc_[4], ac_[4];
  int restart_interval_ = 0;
  bool saw_jfif_ = false, saw_adobe_ = false;
  int adobe_transform_ = 0;

  bool saw_sof_ = false, progressive_ = false;
  int sof_ = 0, width_ = 0, height_ = 0, ncomp_ = 0, hmax_ = 1, vmax_ = 1;
  int mcux_ = 0, mcuy_ = 0;
  Component comp_[4];
  int scans_ = 0;

  // the current scan
  int nscan_ = 0;
  int scan_comp_[4];
  int ss_ = 0, se_ = 63, ah_ = 0, al_ = 0;

  // entropy decoder state
  uint64_t buf_ = 0;
  int bits_ = 0;
  int marker_ = 0;  // the marker the entropy data stopped at, 0 for none
  bool insufficient_ = false;
  unsigned eobrun_ = 0;
  int last_dc_[4];
  int restarts_to_go_ = 0, next_restart_ = 0;
  int last_good_row_ = 0;  // the last iMCU row an MCU began in with data left
  bool smooth_ = false;

  // ---- bytes and markers --------------------------------------------------

  int byte() {  // the stream as libjpeg's stdio source gives it: EOF reads FF D9
    if (pos_ < size_) return data_[pos_++];
    ++pos_;
    if (pos_ > size_ + 65536) corrupt("unexpected end of the JPEG file");
    return (pos_ - size_) % 2 ? 0xFF : 0xD9;
  }

  int u16() {
    int a = byte();
    return (a << 8) | byte();
  }

  int next_marker() {  // jdmarker.c next_marker: garbage and FF 00 skipped
    if (marker_) {
      int m = marker_;
      marker_ = 0;
      return m;
    }
    for (;;) {
      int c = byte();
      while (c != 0xFF) {
        ++warnings_;
        c = byte();
      }
      do c = byte();
      while (c == 0xFF);
      if (c != 0) return c;
      ++warnings_;
    }
  }

  void skip_segment() {
    int len = u16();
    if (len < 2) corrupt("bad marker length");
    for (int i = 0; i < len - 2; ++i) byte();
  }

  void header_marker(int m) {
    switch (m) {
      case 0xC0: case 0xC1: case 0xC2:
        read_sof(m);
        break;
      case 0xC3: case 0xC5: case 0xC6: case 0xC7: case 0xC9: case 0xCA:
      case 0xCB: case 0xCD: case 0xCE: case 0xCF: {
        char msg[160];
        std::snprintf(msg, sizeof msg,
                      "JPEG process SOF%d (%s) is not ported: only Huffman baseline, extended and "
                      "progressive (SOF0-2)", m - 0xC0,
                      m >= 0xC9 ? "arithmetic coding" : m == 0xC3 ? "lossless" : "hierarchical");
        unsupported(msg);
      }
      case 0xC4: read_dht(); break;
      case 0xDB: read_dqt(); break;
      case 0xDD: {
        if (u16() != 4) corrupt("bad DRI length");
        restart_interval_ = u16();
        break;
      }
      case 0xD8: corrupt("duplicate SOI marker");
      case 0xE0: case 0xEE: read_app(m); break;
      case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4: case 0xD5: case 0xD6:
      case 0xD7: case 0x01:
        break;  // parameterless
      case 0xCC: case 0xDC: case 0xE1: case 0xE2: case 0xE3: case 0xE4: case 0xE5:
      case 0xE6: case 0xE7: case 0xE8: case 0xE9: case 0xEA: case 0xEB: case 0xEC:
      case 0xED: case 0xEF: case 0xFE:
        skip_segment();  // DAC, DNL, APPn, COM
        break;
      default: {
        char msg[64];
        std::snprintf(msg, sizeof msg, "unsupported marker 0x%02X", m);
        corrupt(msg);
      }
    }
  }

  void read_app(int m) {
    int len = u16();
    if (len < 2) corrupt("bad marker length");
    uint8_t head[14] = {0};
    const int n = std::min(len - 2, 14);
    for (int i = 0; i < n; ++i) head[i] = static_cast<uint8_t>(byte());
    for (int i = n; i < len - 2; ++i) byte();
    if (m == 0xE0 && n >= 14 && std::memcmp(head, "JFIF", 5) == 0) saw_jfif_ = true;
    if (m == 0xEE && n >= 12 && std::memcmp(head, "Adobe", 5) == 0) {
      saw_adobe_ = true;
      adobe_transform_ = head[11];
    }
  }

  void read_dqt() {
    int len = u16() - 2;
    while (len > 0) {
      int pq_tq = byte();
      int prec = pq_tq >> 4, t = pq_tq & 15;
      if (t >= 4) corrupt("bad DQT table index");
      if (len < 1 + 64 * (prec ? 2 : 1)) corrupt("bad DQT length");
      for (int i = 0; i < 64; ++i) qt_[t][kNatural[i]] = static_cast<uint16_t>(prec ? u16() : byte());
      qt_defined_[t] = true;
      len -= 1 + 64 * (prec ? 2 : 1);
    }
    if (len != 0) corrupt("bad DQT length");
  }

  void read_dht() {
    int len = u16() - 2;
    while (len > 16) {
      int index = byte();
      uint8_t bits[17] = {0};
      int count = 0;
      for (int i = 1; i <= 16; ++i) count += bits[i] = static_cast<uint8_t>(byte());
      len -= 17;
      if (count > 256 || count > len) corrupt("bad Huffman table");
      uint8_t vals[256] = {0};
      for (int i = 0; i < count; ++i) vals[i] = static_cast<uint8_t>(byte());
      len -= count;
      const bool is_ac = index & 0x10;
      index &= ~0x10;
      if (index < 0 || index >= 4) corrupt("bad DHT table index");
      Huffman& h = is_ac ? ac_[index] : dc_[index];
      std::memcpy(h.bits, bits, sizeof bits);
      std::memcpy(h.vals, vals, sizeof vals);
      h.defined = true;
      h.derived = false;
    }
    if (len != 0) corrupt("bad DHT length");
  }

  void read_sof(int m) {
    if (saw_sof_) corrupt("duplicate SOF marker");
    saw_sof_ = true;
    sof_ = m;
    progressive_ = m == 0xC2;
    int len = u16();
    int precision = byte();
    height_ = u16();
    width_ = u16();
    ncomp_ = byte();
    if (len != 8 + ncomp_ * 3) corrupt("bad SOF length");
    if (precision != 8) {
      char msg[96];
      std::snprintf(msg, sizeof msg, "%d-bit JPEG decoding is not ported (8-bit only)", precision);
      if (precision == 12 || precision == 16) unsupported(msg);
      corrupt(msg);
    }
    if (height_ <= 0 || width_ <= 0 || ncomp_ <= 0) corrupt("empty JPEG image (or a DNL marker)");
    if (width_ > 65500 || height_ > 65500) corrupt("JPEG image too big");
    if (ncomp_ != 1 && ncomp_ != 3) {
      char msg[96];
      std::snprintf(msg, sizeof msg, "JPEG decoding of %d components is not ported (1 or 3 only)",
                    ncomp_);
      unsupported(msg);
    }
    for (int i = 0; i < ncomp_; ++i) {
      Component& c = comp_[i];
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) corrupt("bad sampling factors");
      if (c.tq >= 4) corrupt("bad quantization table index");
    }
    for (int i = 0; i < ncomp_; ++i) {
      if (comp_[i].h > 2 || comp_[i].v > 2) {
        char msg[96];
        std::snprintf(msg, sizeof msg,
                      "JPEG sampling factors %dx%d are not ported (at most 2 in each direction)",
                      comp_[i].h, comp_[i].v);
        unsupported(msg);
      }
      hmax_ = std::max(hmax_, comp_[i].h);
      vmax_ = std::max(vmax_, comp_[i].v);
    }
    mcux_ = (width_ + 8 * hmax_ - 1) / (8 * hmax_);
    mcuy_ = (height_ + 8 * vmax_ - 1) / (8 * vmax_);
    for (int i = 0; i < ncomp_; ++i) {
      Component& c = comp_[i];
      c.bw = static_cast<int>((static_cast<int64_t>(width_) * c.h + 8 * hmax_ - 1) / (8 * hmax_));
      c.bh = static_cast<int>((static_cast<int64_t>(height_) * c.v + 8 * vmax_ - 1) / (8 * vmax_));
      c.dw = static_cast<int>((static_cast<int64_t>(width_) * c.h + hmax_ - 1) / hmax_);
      c.dh = static_cast<int>((static_cast<int64_t>(height_) * c.v + vmax_ - 1) / vmax_);
      c.bw_pad = mcux_ * c.h;
      c.bh_pad = mcuy_ * c.v;
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
      std::fill(c.prev_bits, c.prev_bits + 10, -1);
    }
  }

  void read_sos() {
    int len = u16();
    int n = byte();
    if (len != n * 2 + 6 || n < 1 || n > 4) corrupt("bad SOS length");
    bool taken[4] = {false, false, false, false};
    for (int i = 0; i < n; ++i) {
      int cc = byte(), t = byte();
      int ci = 0;
      while (ci < ncomp_ && !(comp_[ci].id == cc && !taken[ci])) ++ci;
      if (ci == ncomp_) corrupt("bad component id in SOS");
      taken[ci] = true;
      scan_comp_[i] = ci;
      comp_[ci].dc_tbl = t >> 4;
      comp_[ci].ac_tbl = t & 15;
    }
    nscan_ = n;
    ss_ = byte();
    se_ = byte();
    int a = byte();
    ah_ = a >> 4;
    al_ = a & 15;
    next_restart_ = 0;
    ++scans_;
    int blocks = 0;
    for (int i = 0; i < n; ++i) blocks += n == 1 ? 1 : comp_[scan_comp_[i]].h * comp_[scan_comp_[i]].v;
    if (blocks > 10) corrupt("bad MCU size");
    for (int i = 0; i < n; ++i) {  // latch_quant_tables
      Component& c = comp_[scan_comp_[i]];
      if (c.latched) continue;
      if (!qt_defined_[c.tq]) corrupt("quantization table not defined");
      std::memcpy(c.quant, qt_[c.tq], sizeof c.quant);
      c.latched = true;
    }
  }

  // ---- the entropy-coded segment ------------------------------------------

  void fill() {  // jpeg_fill_bit_buffer: stop at a marker, never past it
    while (bits_ <= 56 && !marker_) {
      int c = byte();
      if (c == 0xFF) {
        do c = byte();
        while (c == 0xFF);
        if (c == 0) {
          c = 0xFF;
        } else {
          marker_ = c;
          break;
        }
      }
      buf_ = (buf_ << 8) | static_cast<uint64_t>(c);
      bits_ += 8;
    }
  }

  void need(int n) {
    if (bits_ >= n) return;
    fill();
    if (bits_ >= n) return;
    if (!insufficient_) ++warnings_;  // "hit marker": zero bits from here on
    insufficient_ = true;
    buf_ <<= 32;
    bits_ += 32;
  }

  int get(int n) {
    need(n);
    bits_ -= n;
    return static_cast<int>((buf_ >> bits_) & ((1u << n) - 1));
  }

  int decode(Huffman& h) {
    int l = 1;
    if (bits_ < kLookahead) fill();
    if (bits_ >= kLookahead) {
      const int look = static_cast<int>((buf_ >> (bits_ - kLookahead)) & 0xFF);
      if (h.look_len[look]) {
        bits_ -= h.look_len[look];
        return h.look_sym[look];
      }
      l = kLookahead + 1;
    }
    int32_t code = get(l);
    while (code > h.maxcode[l]) {
      code = (code << 1) | get(1);
      ++l;
    }
    if (l > 16) {
      ++warnings_;  // bad Huffman code: libjpeg fakes a zero
      return 0;
    }
    return h.vals[(code + h.valoffset[l]) & 0xFF];
  }

  static int extend(int x, int s) { return x < (1 << (s - 1)) ? x + 1 - (1 << s) : x; }

  // read_restart_marker with jpeg_resync_to_restart
  void restart() {
    bits_ = 0;
    if (!marker_) marker_ = next_marker();
    if (marker_ == 0xD0 + next_restart_) {
      marker_ = 0;
    } else {
      ++warnings_;
      const int desired = next_restart_;
      for (;;) {
        const int m = marker_;
        int action;
        if (m < 0xC0) action = 2;
        else if (m < 0xD0 || m > 0xD7) action = 3;
        else if (m == 0xD0 + ((desired + 1) & 7) || m == 0xD0 + ((desired + 2) & 7)) action = 3;
        else if (m == 0xD0 + ((desired - 1) & 7) || m == 0xD0 + ((desired - 2) & 7)) action = 2;
        else action = 1;
        if (action == 1) {
          marker_ = 0;
          break;
        }
        if (action == 3) break;
        marker_ = 0;
        marker_ = next_marker();
      }
    }
    next_restart_ = (next_restart_ + 1) & 7;
    for (int i = 0; i < 4; ++i) last_dc_[i] = 0;
    eobrun_ = 0;
    restarts_to_go_ = restart_interval_;
    if (!marker_) insufficient_ = false;
  }

  Huffman& table(Huffman* set, int i, bool dc) {
    if (i < 0 || i >= 4 || !set[i].defined) corrupt("Huffman table not defined");
    if (!set[i].derived) set[i].derive(dc);
    return set[i];
  }

  int16_t* block(const Component& c, int bx, int by) {
    return const_cast<int16_t*>(c.coef.data()) + (static_cast<size_t>(by) * c.bw_pad + bx) * 64;
  }

  void decode_scan() {
    buf_ = 0;
    bits_ = 0;
    insufficient_ = false;
    eobrun_ = 0;
    for (int i = 0; i < 4; ++i) last_dc_[i] = 0;
    restarts_to_go_ = restart_interval_;
    const bool dc_band = ss_ == 0;
    if (progressive_) {  // start_pass_phuff_decoder's checks
      bool bad = dc_band ? se_ != 0 : (ss_ > se_ || se_ > 63 || nscan_ != 1);
      if (ah_ != 0 && al_ != ah_ - 1) bad = true;
      if (al_ > 13) bad = true;
      if (bad) corrupt("bad progression parameters");
      for (int i = 0; i < nscan_; ++i) {
        Component& c = comp_[scan_comp_[i]];
        if (!dc_band && c.coef_bits[0] < 0) ++warnings_;
        for (int k = std::min(ss_, 1); k <= std::max(se_, 9) && k < 10; ++k)
          c.prev_bits[k] = scans_ > 1 ? c.coef_bits[k] : 0;
        for (int k = ss_; k <= se_; ++k) {
          const int expected = c.coef_bits[k] < 0 ? 0 : c.coef_bits[k];
          if (ah_ != expected) ++warnings_;
          c.coef_bits[k] = al_;
        }
      }
    }
    for (int i = 0; i < nscan_; ++i) {  // allocated here, after the caller checked the size
      Component& c = comp_[scan_comp_[i]];
      if (c.coef.empty()) c.coef.assign(static_cast<size_t>(c.bw_pad) * c.bh_pad * 64, 0);
    }
    Huffman* dct[4] = {nullptr, nullptr, nullptr, nullptr};
    Huffman* act[4] = {nullptr, nullptr, nullptr, nullptr};
    for (int i = 0; i < nscan_; ++i) {
      const Component& c = comp_[scan_comp_[i]];
      if (!progressive_ || (dc_band && ah_ == 0)) dct[i] = &table(dc_, c.dc_tbl, true);
      if (!progressive_ || !dc_band) act[i] = &table(ac_, c.ac_tbl, false);
    }
    if (nscan_ == 1) {  // non-interleaved: one block per MCU over the component's own blocks
      const Component& c = comp_[scan_comp_[0]];
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx) {
          int16_t* blocks[1] = {block(c, bx, by)};
          int membership[1] = {0};
          mcu(blocks, membership, 1, dct, act, by / c.v);
        }
    } else {
      int16_t* blocks[10];
      int membership[10];
      for (int my = 0; my < mcuy_; ++my)
        for (int mx = 0; mx < mcux_; ++mx) {
          int n = 0;
          for (int i = 0; i < nscan_; ++i) {
            const Component& c = comp_[scan_comp_[i]];
            for (int y = 0; y < c.v; ++y)
              for (int x = 0; x < c.h; ++x) {
                blocks[n] = block(c, mx * c.h + x, my * c.v + y);
                membership[n++] = i;
              }
          }
          mcu(blocks, membership, n, dct, act, my);
        }
    }
  }

  void mcu(int16_t** blocks, const int* membership, int n, Huffman** dct, Huffman** act,
           int imcu_row) {
    if (!insufficient_) last_good_row_ = imcu_row;
    if (restart_interval_) {
      if (restarts_to_go_ == 0) restart();
      --restarts_to_go_;
    }
    if (!progressive_) {
      if (insufficient_) return;
      for (int b = 0; b < n; ++b) {
        int16_t* blk = blocks[b];
        const int ci = membership[b];
        int s = decode(*dct[ci]);
        if (s) s = extend(get(s), s);
        const int dc = static_cast<int>(static_cast<unsigned>(s) + static_cast<unsigned>(last_dc_[ci]));
        last_dc_[ci] = dc;
        blk[0] = static_cast<int16_t>(dc);
        Huffman& h = *act[ci];
        for (int k = 1; k < 64; ++k) {
          int rs = decode(h);
          int r = rs >> 4;
          s = rs & 15;
          if (s) {
            k += r;
            blk[kNatural[k]] = static_cast<int16_t>(extend(get(s), s));
          } else {
            if (r != 15) break;
            k += 15;
          }
        }
      }
      return;
    }
    if (ss_ == 0) {
      if (ah_ == 0) {
        if (insufficient_) return;
        for (int b = 0; b < n; ++b) {
          const int ci = membership[b];
          int s = decode(*dct[ci]);
          if (s) s = extend(get(s), s);
          const int64_t sum = static_cast<int64_t>(s) + last_dc_[ci];
          if (sum > INT32_MAX || sum < INT32_MIN) corrupt("bad DCT coefficient");
          last_dc_[ci] = static_cast<int>(sum);
          blocks[b][0] = static_cast<int16_t>(static_cast<uint32_t>(sum) << al_);
        }
      } else {
        for (int b = 0; b < n; ++b)
          if (get(1)) blocks[b][0] = static_cast<int16_t>(blocks[b][0] | (1 << al_));
      }
      return;
    }
    if (insufficient_) return;
    int16_t* blk = blocks[0];
    Huffman& h = *act[0];
    if (ah_ == 0) {  // AC first
      if (eobrun_ > 0) {
        --eobrun_;
        return;
      }
      for (int k = ss_; k <= se_; ++k) {
        int rs = decode(h);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          k += r;
          blk[kNatural[k]] = static_cast<int16_t>(static_cast<uint32_t>(extend(get(s), s)) << al_);
        } else if (r == 15) {
          k += 15;
        } else {
          eobrun_ = 1u << r;
          if (r) eobrun_ += get(r);
          --eobrun_;
          break;
        }
      }
      return;
    }
    // AC refinement
    const int p1 = 1 << al_, m1 = -1 * (1 << al_);
    int k = ss_;
    if (eobrun_ == 0) {
      for (; k <= se_; ++k) {
        int rs = decode(h);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          if (s != 1) ++warnings_;
          s = get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun_ = 1u << r;
          if (r) eobrun_ += get(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (get(1) && (*coef & p1) == 0) *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se_);
        if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun_ > 0) {
      for (; k <= se_; ++k) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0 && get(1) && (*coef & p1) == 0)
          *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
      }
      --eobrun_;
    }
  }

  bool smoothing_useful() {  // jdcoefct.c smoothing_ok, which latches the bits
    static const int kFirst9[9] = {1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (int i = 0; i < ncomp_; ++i) {
      Component& c = comp_[i];
      if (!c.latched || c.quant[0] == 0) return false;
      for (int q : kFirst9)
        if (c.quant[q] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      c.bits_latch[0] = c.coef_bits[0];
      for (int k = 1; k < 10; ++k) {
        c.prev_latch[k] = scans_ > 1 ? c.prev_bits[k] : -1;
        c.bits_latch[k] = c.coef_bits[k];
        if (c.coef_bits[k] != 0) useful = true;
      }
    }
    return useful;
  }

  // ---- IDCT, upsampling, colour ---------------------------------------------

  // The accurate integer IDCT (jidctint.c) as libjpeg-turbo's AVX2 version
  // computes it, which is what OpenCV runs on x86-64: the dequantized
  // coefficients, in0 +- in4, in7 + in3 and in5 + in1 wrap to 16 bits, the
  // sums wrap to 32 bits, each pass's outputs saturate to 16 bits, and the
  // samples saturate to [-128, 127] before the +128.  On valid data every
  // value stays in range and this equals the C version.
  static inline int32_t w16(uint32_t x) { return static_cast<int16_t>(static_cast<uint16_t>(x)); }
  static inline int32_t s16(int32_t x) { return std::min(32767, std::max(-32768, x)); }

  // One 1-D pass over 8 lanes at once: lane l's inputs are x[k * 8 + l]
  // (k = 0..7) and its outputs o[k * 8 + l], descaled by `shift` and
  // saturated to 16 bits.  Every step is an add, a subtract or a multiply
  // by a constant, so unsigned 32-bit arithmetic gives each sum wrapped to
  // 32 bits exactly as the SIMD version's 32-bit lanes do.
  static void idct_pass(const int32_t* x, int shift, int32_t* o) {
    const uint32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                   F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                   F2562 = 20995, F3072 = 25172;
    const uint32_t r = 1u << (shift - 1);
    for (int l = 0; l < 8; ++l) {
      const uint32_t in0 = x[l], in1 = x[8 + l], in2 = x[16 + l], in3 = x[24 + l], in4 = x[32 + l],
                     in5 = x[40 + l], in6 = x[48 + l], in7 = x[56 + l];
      const uint32_t tmp2 = in2 * F0541 + in6 * (F0541 - F1847);
      const uint32_t tmp3 = in2 * (F0541 + F0765) + in6 * F0541;
      const uint32_t tmp0 = static_cast<uint32_t>(w16(in0 + in4)) * 8192u;
      const uint32_t tmp1 = static_cast<uint32_t>(w16(in0 - in4)) * 8192u;
      const uint32_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
      const uint32_t z3 = static_cast<uint32_t>(w16(in7 + in3)), z4 = static_cast<uint32_t>(w16(in5 + in1));
      const uint32_t z3p = z3 * (F1175 - F1961) + z4 * F1175;
      const uint32_t z4p = z3 * F1175 + z4 * (F1175 - F0390);
      const uint32_t o0 = in7 * (F0298 - F0899) - in1 * F0899 + z3p;
      const uint32_t o1 = in5 * (F2053 - F2562) - in3 * F2562 + z4p;
      const uint32_t o2 = in3 * (F3072 - F2562) - in5 * F2562 + z3p;
      const uint32_t o3 = in1 * (F1501 - F0899) - in7 * F0899 + z4p;
      o[l] = s16(static_cast<int32_t>(t10 + o3 + r) >> shift);
      o[56 + l] = s16(static_cast<int32_t>(t10 - o3 + r) >> shift);
      o[8 + l] = s16(static_cast<int32_t>(t11 + o2 + r) >> shift);
      o[48 + l] = s16(static_cast<int32_t>(t11 - o2 + r) >> shift);
      o[16 + l] = s16(static_cast<int32_t>(t12 + o1 + r) >> shift);
      o[40 + l] = s16(static_cast<int32_t>(t12 - o1 + r) >> shift);
      o[24 + l] = s16(static_cast<int32_t>(t13 + o0 + r) >> shift);
      o[32 + l] = s16(static_cast<int32_t>(t13 - o0 + r) >> shift);
    }
  }

  static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
    int32_t dq[64], ws[64], wt[64], rows[64];
    bool ac_zero = true, dc_only = true;
    for (int i = 0; i < 64; ++i) {
      dq[i] = w16(static_cast<uint32_t>(in[i]) * static_cast<uint32_t>(static_cast<int16_t>(q[i])));
      ac_zero &= i < 8 || in[i] == 0;
      dc_only &= i == 0 || in[i] == 0;
    }
    if (dc_only) {  // a flat block: both passes reduce to one value
      const uint32_t v = static_cast<uint32_t>(w16(static_cast<uint32_t>(dq[0]) * 4u));
      const int32_t x = s16(static_cast<int32_t>(static_cast<uint32_t>(w16(v)) * 8192u + (1u << 17)) >> 18);
      const uint8_t flat = static_cast<uint8_t>(std::min(127, std::max(-128, x)) + 128);
      for (int r = 0; r < 8; ++r) std::memset(out + r * stride, flat, 8);
      return;
    }
    if (ac_zero) {  // every column holds only its DC term
      for (int i = 0; i < 64; ++i) ws[i] = w16(static_cast<uint32_t>(dq[i & 7]) * 4u);
    } else {
      idct_pass(dq, 11, ws);  // the columns: lane = column
    }
    for (int r = 0; r < 8; ++r)  // the rows as lanes
      for (int c = 0; c < 8; ++c) wt[c * 8 + r] = ws[r * 8 + c];
    idct_pass(wt, 18, rows);
    for (int r = 0; r < 8; ++r)
      for (int c = 0; c < 8; ++c)
        out[r * stride + c] = static_cast<uint8_t>(std::min(127, std::max(-128, rows[c * 8 + r])) + 128);
  }

  // the component's samples, [bh * 8, bw * 8]
  std::vector<uint8_t> samples(const Component& c) const {
    const int stride = c.bw * 8;
    std::vector<uint8_t> plane(static_cast<size_t>(stride) * c.bh * 8, 128);
    if (c.coef.empty()) return plane;  // a component no scan reached: all zero coefficients
    int16_t work[64];
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx) {
        const int16_t* blk = c.coef.data() + (static_cast<size_t>(by) * c.bw_pad + bx) * 64;
        if (smooth_) {
          std::memcpy(work, blk, sizeof work);
          smooth_block(c, bx, by, work);
          blk = work;
        }
        idct_islow(blk, c.quant, plane.data() + static_cast<size_t>(by) * 8 * stride + bx * 8, stride);
      }
    return plane;
  }

  // jdcoefct.c decompress_smooth_data (libjpeg-turbo 2.1 and later): the
  // first AC coefficients that are still zero and not known exactly
  // estimated from the DC terms of the 5 x 5 blocks around, and with no AC
  // data at all the DC term itself interpolated.
  void smooth_block(const Component& c, int bx, int by, int16_t* w) const {
    const int imcu = by / c.v, last_imcu = mcuy_ - 1;
    int block_rows = c.v;
    if (imcu == last_imcu) {
      block_rows = c.bh % c.v;
      if (block_rows == 0) block_rows = c.v;
    }
    const int br = by - imcu * c.v;  // the block row within its iMCU row
    const int image_block_row = imcu * block_rows + br, image_block_rows = block_rows * mcuy_;
    const int prev = image_block_row > 0 ? by - 1 : by;
    const int prev2 = image_block_row > 1 ? by - 2 : prev;
    const int next = image_block_row < image_block_rows - 1 ? by + 1 : by;
    const int next2 = image_block_row < image_block_rows - 2 ? by + 2 : next;
    const int rows[5] = {prev2, prev, by, next, next2};
    const int last_col = c.bw - 1;
    // the columns the sliding registers hold at block bx
    int cols[5];
    cols[2] = bx;
    cols[1] = bx > 0 ? bx - 1 : 0;
    cols[0] = bx > 1 ? bx - 2 : 0;
    cols[3] = bx < last_col ? bx + 1 : bx;
    cols[4] = bx + 1 < last_col ? bx + 2 : cols[3];
    auto dcat = [&](int r, int col) -> int64_t {
      return c.coef[(static_cast<size_t>(rows[r]) * c.bw_pad + cols[col]) * 64];
    };
    int64_t DC[26];
    for (int r = 0; r < 5; ++r)
      for (int k = 0; k < 5; ++k) DC[1 + 5 * r + k] = dcat(r, k);
    const int* bits = imcu > last_good_row_ ? c.prev_latch : c.bits_latch;
    bool change_dc = true;
    for (int k = 1; k < 10; ++k)
      if (bits[k] != -1) change_dc = false;
    const int64_t Q00 = c.quant[0];
    auto estimate = [&](int k, int pos, int64_t q, int64_t num) {
      const int Al = bits[k];
      if (Al == 0 || w[pos] != 0) return;
      num *= Q00;
      int64_t pred;
      if (num >= 0) {
        pred = ((q << 7) + num) / (q << 8);
        if (Al > 0 && pred >= (int64_t{1} << Al)) pred = (int64_t{1} << Al) - 1;
      } else {
        pred = ((q << 7) - num) / (q << 8);
        if (Al > 0 && pred >= (int64_t{1} << Al)) pred = (int64_t{1} << Al) - 1;
        pred = -pred;
      }
      w[pos] = static_cast<int16_t>(pred);
    };
    const int64_t* d = DC;
    estimate(1, 1, c.quant[1], change_dc
        ? -d[1] - d[2] + d[4] + d[5] - 3 * d[6] + 13 * d[7] - 13 * d[9] + 3 * d[10] - 3 * d[11] +
              38 * d[12] - 38 * d[14] + 3 * d[15] - 3 * d[16] + 13 * d[17] - 13 * d[19] + 3 * d[20] -
              d[21] - d[22] + d[24] + d[25]
        : -7 * d[11] + 50 * d[12] - 50 * d[14] + 7 * d[15]);
    estimate(2, 8, c.quant[8], change_dc
        ? -d[1] - 3 * d[2] - 3 * d[3] - 3 * d[4] - d[5] - d[6] + 13 * d[7] + 38 * d[8] + 13 * d[9] -
              d[10] + d[16] - 13 * d[17] - 38 * d[18] - 13 * d[19] + d[20] + d[21] + 3 * d[22] +
              3 * d[23] + 3 * d[24] + d[25]
        : -7 * d[3] + 50 * d[8] - 50 * d[18] + 7 * d[23]);
    estimate(3, 16, c.quant[16], change_dc
        ? d[3] + 2 * d[7] + 7 * d[8] + 2 * d[9] - 5 * d[12] - 14 * d[13] - 5 * d[14] + 2 * d[17] +
              7 * d[18] + 2 * d[19] + d[23]
        : -d[3] + 13 * d[8] - 24 * d[13] + 13 * d[18] - d[23]);
    estimate(4, 9, c.quant[9], change_dc
        ? -d[1] + d[5] + 9 * d[7] - 9 * d[9] - 9 * d[17] + 9 * d[19] + d[21] - d[25]
        : d[10] + d[16] - 10 * d[17] + 10 * d[19] - d[2] - d[20] + d[22] - d[24] + d[4] - d[6] +
              10 * d[7] - 10 * d[9]);
    estimate(5, 2, c.quant[2], change_dc
        ? 2 * d[7] - 5 * d[8] + 2 * d[9] + d[11] + 7 * d[12] - 14 * d[13] + 7 * d[14] + d[15] +
              2 * d[17] - 5 * d[18] + 2 * d[19]
        : -d[11] + 13 * d[12] - 24 * d[13] + 13 * d[14] - d[15]);
    if (!change_dc) return;
    estimate(6, 3, c.quant[3], d[7] - d[9] + 2 * d[12] - 2 * d[14] + d[17] - d[19]);
    estimate(7, 10, c.quant[10], d[7] - 3 * d[8] + d[9] - d[17] + 3 * d[18] - d[19]);
    estimate(8, 17, c.quant[17], d[7] - d[9] - 3 * d[12] + 3 * d[14] + d[17] - d[19]);
    estimate(9, 24, c.quant[24], d[7] + 2 * d[8] + d[9] - d[17] - 2 * d[18] - d[19]);
    const int64_t num = Q00 * (-2 * d[1] - 6 * d[2] - 8 * d[3] - 6 * d[4] - 2 * d[5] - 6 * d[6] +
                               6 * d[7] + 42 * d[8] + 6 * d[9] - 6 * d[10] - 8 * d[11] +
                               42 * d[12] + 152 * d[13] + 42 * d[14] - 8 * d[15] - 6 * d[16] +
                               6 * d[17] + 42 * d[18] + 6 * d[19] - 6 * d[20] - 2 * d[21] -
                               6 * d[22] - 8 * d[23] - 6 * d[24] - 2 * d[25]);
    const int64_t pred = num >= 0 ? ((Q00 << 7) + num) / (Q00 << 8) : -(((Q00 << 7) - num) / (Q00 << 8));
    w[0] = static_cast<int16_t>(pred);
  }

  struct Plane {
    std::vector<uint8_t> data;
    int stride;
    const uint8_t* row(int y) const { return data.data() + static_cast<size_t>(y) * stride; }
  };

  // the component upsampled to [height, width] (jdsample.c); a component at
  // full resolution is its sample plane as it is
  Plane upsample(const Component& c) const {
    Plane in{samples(c), c.bw * 8};
    const int rx = hmax_ / c.h, ry = vmax_ / c.v;
    if (rx == 1 && ry == 1) return in;
    const int W = width_, H = height_, dw = c.dw, dh = c.dh;
    Plane out{std::vector<uint8_t>(static_cast<size_t>(W) * H), W};
    std::vector<int> sum(static_cast<size_t>(dw));
    for (int y = 0; y < H; ++y) {
      uint8_t* o = out.data.data() + static_cast<size_t>(y) * W;
      const int r = ry == 2 ? y >> 1 : y;
      const int far = y & 1 ? std::min(r + 1, dh - 1) : std::max(r - 1, 0);
      const uint8_t* near_row = in.row(r);
      const uint8_t* far_row = in.row(far);
      if (rx == 1) {  // 1 x 2: h1v2 with its biases 1 (above) and 2 (below)
        const int bias = y & 1 ? 2 : 1;
        for (int x = 0; x < W; ++x) o[x] = static_cast<uint8_t>((3 * near_row[x] + far_row[x] + bias) >> 2);
      } else if (dw <= 2) {  // box: a component at most 2 samples wide
        for (int x = 0; x < W; ++x) o[x] = near_row[x >> 1];
      } else if (ry == 1) {  // 2 x 1: h2v1
        for (int x = 0; x < W; ++x) {
          const int i = x >> 1;
          o[x] = static_cast<uint8_t>(x & 1 ? (3 * near_row[i] + near_row[std::min(i + 1, dw - 1)] + 2) >> 2
                                            : (3 * near_row[i] + near_row[std::max(i - 1, 0)] + 1) >> 2);
        }
      } else {  // 2 x 2: h2v2 over the column sums of the nearer and farther rows
        for (int i = 0; i < dw; ++i) sum[i] = 3 * near_row[i] + far_row[i];
        for (int x = 0; x < W; ++x) {
          const int i = x >> 1;
          o[x] = static_cast<uint8_t>(x & 1 ? (3 * sum[i] + sum[std::min(i + 1, dw - 1)] + 7) >> 4
                                            : (3 * sum[i] + sum[std::max(i - 1, 0)] + 8) >> 4);
        }
      }
    }
    return out;
  }

  void render(uint8_t* out) const {
    const int W = width_, H = height_;
    if (ncomp_ == 1) {
      const Plane g = upsample(comp_[0]);
      for (int y = 0; y < H; ++y) {
        const uint8_t* a = g.row(y);
        uint8_t* o = out + static_cast<size_t>(y) * W * 3;
        for (int x = 0; x < W; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = a[x];
      }
      return;
    }
    const Plane p0 = upsample(comp_[0]), p1 = upsample(comp_[1]), p2 = upsample(comp_[2]);
    bool rgb;
    if (saw_jfif_) rgb = false;
    else if (saw_adobe_) rgb = adobe_transform_ == 0;
    else rgb = comp_[0].id == 82 && comp_[1].id == 71 && comp_[2].id == 66;
    // jdcolor.c build_ycc_rgb_table, SCALEBITS 16
    const int64_t half = int64_t{1} << 15;
    auto fix = [](double x) { return static_cast<int64_t>(x * 65536.0 + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + half) >> 16);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
    auto clamp = [](int v) { return static_cast<uint8_t>(std::min(255, std::max(0, v))); };
    for (int y = 0; y < H; ++y) {
      const uint8_t *a = p0.row(y), *b = p1.row(y), *c = p2.row(y);
      uint8_t* o = out + static_cast<size_t>(y) * W * 3;
      if (rgb) {
        for (int x = 0; x < W; ++x) {
          o[3 * x] = c[x];
          o[3 * x + 1] = b[x];
          o[3 * x + 2] = a[x];
        }
        continue;
      }
      for (int x = 0; x < W; ++x) {
        const int yy = a[x], cb = b[x], cr = c[x];
        o[3 * x] = clamp(yy + cb_b[cb]);
        o[3 * x + 1] = clamp(yy + static_cast<int>((cb_g[cb] + cr_g[cr]) >> 16));
        o[3 * x + 2] = clamp(yy + cr_r[cr]);
      }
    }
  }
};

void report(const Failure& f, char* err, int64_t errlen) {
  if (err && errlen > 0) std::snprintf(err, static_cast<size_t>(errlen), "%s", f.message.c_str());
}

}  // namespace

// The frame header of a JPEG stream: info = [width, height, components,
// SOF marker].  Returns 0, 1 for a corrupt stream or 2 for what is not
// ported, with the reason in `err`.
extern "C" int64_t jpeg_header(const uint8_t* data, int64_t size, int64_t* info, char* err,
                               int64_t errlen) {
  try {
    Decoder d(data, static_cast<size_t>(size));
    d.read_header();
    info[0] = d.width();
    info[1] = d.height();
    info[2] = d.components();
    info[3] = d.sof();
    return kOk;
  } catch (const Failure& f) {
    report(f, err, errlen);
    return f.status;
  }
}

// Decode a JPEG stream into `out`, [height, width, 3] uint8 BGR (the sizes
// of jpeg_header).  info[0] = libjpeg's warnings (data that ran out,
// garbage skipped, bad codes).  Returns as jpeg_header.
extern "C" int64_t jpeg_decode(const uint8_t* data, int64_t size, uint8_t* out, int64_t* info,
                               char* err, int64_t errlen) {
  try {
    Decoder d(data, static_cast<size_t>(size));
    d.read_header();
    d.decode(out);
    info[0] = d.warnings();
    return kOk;
  } catch (const Failure& f) {
    report(f, err, errlen);
    return f.status;
  }
}
