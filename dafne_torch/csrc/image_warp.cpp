// Bilinear resize and affine warp of uint8 HWC images on the host, with a
// plain C interface (ctypes).
//
// Part of the port's augmentation layer (dafne_torch/data/transforms.py),
// where it takes the place of cv2.resize and cv2.warpAffine with
// INTER_LINEAR in dafne_tpu/data/transforms.py (AffineAug.apply_image).
// Both functions return what OpenCV 5.0 returns, byte for byte: the
// arithmetic below is OpenCV's, step by step, and
// dafne_torch/data/image_warp.py spells the same steps out in NumPy.
//
// resize_linear (cv::resize, INTER_LINEAR, 8-bit): fixed point.  Each
// output column dx samples source column sx = floor(fx) with
// fx = (float)((dx + 0.5) * sw / dw - 0.5), clamped to [0, sw - 1] with
// weight 0 at and beyond the borders; the two weights are the float
// weights times 2^11, rounded to even.  A horizontal pass makes int rows;
// the vertical pass takes rows clip(sy) and clip(sy + 1) (no weight clamp)
// and rounds as OpenCV's SIMD pass does: ((b0 * (r0 >> 4)) >> 16) +
// ((b1 * (r1 >> 4)) >> 16), + 2, >> 2.  An exact 2x downscale, which OpenCV
// hands to INTER_AREA, gives the same bytes through this path.
//
// warp_affine_linear (cv::warpAffine, INTER_LINEAR, BORDER_CONSTANT 0): the
// forward matrix (float32, widened to double) is inverted in double as
// OpenCV inverts it, then cast to float.  Each row y takes Mx = y*M1 + M2
// and My = y*M4 + M5 in float; OpenCV's AVX2 kernel maps 16 pixels at a
// time with fma(M0, x, Mx), and a row's last (dw mod 16) pixels with the
// scalar tail, fma(x, M0, y*M1) + M2.  The four taps around
// (floor(sx), floor(sy)) are read as floats, 0 outside the source, and
// blended with fma: v0 = p00 + a (p01 - p00), v1 = p10 + a (p11 - p10),
// v = v0 + b (v1 - v0), rounded to even and saturated.
//
// The loops are bound by arithmetic on each output byte (a few integer
// operations for the resize, three fused multiply-adds for the warp); the
// source is read once per tap and the output written once.  One call
// renders one image on the calling thread: ctypes releases the GIL, so the
// loader's threads warp their images in parallel.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr int kCoefBits = 11;              // INTER_RESIZE_COEF_BITS
constexpr int kCoefScale = 1 << kCoefBits;  // INTER_RESIZE_COEF_SCALE
constexpr int64_t kWarpLanes = 16;         // pixels per AVX2 iteration of the warp

inline int16_t coef(float w) {
  // saturate_cast<short>(w * INTER_RESIZE_COEF_SCALE): round half to even
  long v = std::lrintf(w * static_cast<float>(kCoefScale));
  return static_cast<int16_t>(std::min<long>(32767, std::max<long>(-32768, v)));
}

// Source index and fraction of output index d for a dst/src size ratio, as
// cv::resize computes them: in double, cast to float, floor.
inline void source_pos(int64_t d, double scale, int64_t* s, float* f) {
  float fd = static_cast<float>((d + 0.5) * scale - 0.5);
  int64_t si = static_cast<int64_t>(std::floor(fd));
  *s = si;
  *f = fd - static_cast<float>(si);
}

inline uint8_t round_u8(float v) {
  long r = std::lrintf(v);
  return static_cast<uint8_t>(std::min<long>(255, std::max<long>(0, r)));
}

inline float tap(const uint8_t* src, int64_t sh, int64_t sw, int64_t cn, int64_t y, int64_t x,
                 int64_t c) {
  if (x < 0 || x >= sw || y < 0 || y >= sh) return 0.0f;
  return static_cast<float>(src[(y * sw + x) * cn + c]);
}

}  // namespace

// dst[dh, dw, cn] = cv2.resize(src[sh, sw, cn], (dw, dh), INTER_LINEAR).
// Returns 0, or 1 for an empty size.
extern "C" int64_t resize_linear(const uint8_t* src, int64_t sh, int64_t sw, int64_t cn,
                                 uint8_t* dst, int64_t dh, int64_t dw) {
  if (sh <= 0 || sw <= 0 || dh <= 0 || dw <= 0 || cn <= 0) return 1;
  const double scale_x = 1.0 / (static_cast<double>(dw) / static_cast<double>(sw));
  const double scale_y = 1.0 / (static_cast<double>(dh) / static_cast<double>(sh));
  std::vector<int64_t> xofs(dw), xofs1(dw);
  std::vector<int32_t> a0(dw), a1(dw);
  for (int64_t dx = 0; dx < dw; ++dx) {
    int64_t sx;
    float fx;
    source_pos(dx, scale_x, &sx, &fx);
    if (sx < 0) fx = 0.0f, sx = 0;
    if (sx >= sw - 1) fx = 0.0f, sx = sw - 1;
    xofs[dx] = sx;
    xofs1[dx] = std::min(sx + 1, sw - 1);  // read with weight 0 at the border
    a0[dx] = coef(1.0f - fx);
    a1[dx] = coef(fx);
  }
  // the horizontal pass of two source rows at a time, as OpenCV keeps them
  std::vector<int32_t> rows[2] = {std::vector<int32_t>(dw * cn), std::vector<int32_t>(dw * cn)};
  int64_t row_of[2] = {-1, -1};
  auto hrow = [&](int64_t sy) -> const int32_t* {
    for (int k = 0; k < 2; ++k)
      if (row_of[k] == sy) return rows[k].data();
    int k = row_of[0] == -1 ? 0 : (row_of[1] == -1 ? 1 : 0);
    // keep the row the next output row may share: evict the lower index
    if (row_of[0] != -1 && row_of[1] != -1) k = row_of[0] < row_of[1] ? 0 : 1;
    row_of[k] = sy;
    int32_t* out = rows[k].data();
    const uint8_t* s = src + sy * sw * cn;
    for (int64_t dx = 0; dx < dw; ++dx) {
      const uint8_t* p0 = s + xofs[dx] * cn;
      const uint8_t* p1 = s + xofs1[dx] * cn;
      for (int64_t c = 0; c < cn; ++c) out[dx * cn + c] = p0[c] * a0[dx] + p1[c] * a1[dx];
    }
    return out;
  };
  for (int64_t dy = 0; dy < dh; ++dy) {
    int64_t sy;
    float fy;
    source_pos(dy, scale_y, &sy, &fy);
    const int32_t b0 = coef(1.0f - fy), b1 = coef(fy);
    const int64_t y0 = std::min(std::max<int64_t>(sy, 0), sh - 1);
    const int64_t y1 = std::min(std::max<int64_t>(sy + 1, 0), sh - 1);
    const int32_t* r0 = hrow(y0);
    const int32_t* r1 = hrow(y1);
    uint8_t* out = dst + dy * dw * cn;
    for (int64_t i = 0; i < dw * cn; ++i) {
      int32_t v = (((b0 * (r0[i] >> 4)) >> 16) + ((b1 * (r1[i] >> 4)) >> 16) + 2) >> 2;
      out[i] = static_cast<uint8_t>(std::min(255, std::max(0, v)));
    }
  }
  return 0;
}

// dst[dh, dw, cn] = cv2.warpAffine(src[sh, sw, cn], m, (dw, dh), INTER_LINEAR),
// m the float32 [2, 3] forward matrix (destination = m . [x, y, 1]).
// Returns 0, or 1 for an empty size.
// Built twice (target_clones): with the FMA instruction where the CPU has
// it, else with the library's exact fmaf.
extern "C" __attribute__((target_clones("fma", "default"))) int64_t warp_affine_linear(
    const uint8_t* src, int64_t sh, int64_t sw, int64_t cn, uint8_t* dst, int64_t dh, int64_t dw,
    const float* m) {
  if (sh <= 0 || sw <= 0 || dh <= 0 || dw <= 0 || cn <= 0) return 1;
  double d[6];
  for (int i = 0; i < 6; ++i) d[i] = static_cast<double>(m[i]);
  // the inverse map, as cv::warpAffine computes it without WARP_INVERSE_MAP
  double det = d[0] * d[4] - d[1] * d[3];
  det = det != 0 ? 1.0 / det : 0;
  const double a11 = d[4] * det, a22 = d[0] * det;
  d[0] = a11;
  d[1] *= -det;
  d[3] *= -det;
  d[4] = a22;
  const double b1 = -d[0] * d[2] - d[1] * d[5];
  const double b2 = -d[3] * d[2] - d[4] * d[5];
  d[2] = b1;
  d[5] = b2;
  float M[6];
  for (int i = 0; i < 6; ++i) M[i] = static_cast<float>(d[i]);
  const int64_t vec_end = dw - dw % kWarpLanes;
  for (int64_t y = 0; y < dh; ++y) {
    const float fy = static_cast<float>(y);
    const float mx = fy * M[1] + M[2], my = fy * M[4] + M[5];
    const float ym1 = fy * M[1], ym4 = fy * M[4];
    uint8_t* out = dst + y * dw * cn;
    for (int64_t x = 0; x < dw; ++x) {
      const float fx = static_cast<float>(x);
      float sx, sy;
      if (x < vec_end) {
        sx = std::fma(M[0], fx, mx);
        sy = std::fma(M[3], fx, my);
      } else {
        sx = std::fma(fx, M[0], ym1) + M[2];
        sy = std::fma(fx, M[3], ym4) + M[5];
      }
      uint8_t* o = out + x * cn;
      // no tap inside the source (NaN included): the border value
      if (!(sx >= -1.0f && sx < static_cast<float>(sw) && sy >= -1.0f &&
            sy < static_cast<float>(sh))) {
        for (int64_t c = 0; c < cn; ++c) o[c] = 0;
        continue;
      }
      const float flx = std::floor(sx), fly = std::floor(sy);
      const int64_t ix = static_cast<int64_t>(flx), iy = static_cast<int64_t>(fly);
      const float a = sx - flx, b = sy - fly;
      for (int64_t c = 0; c < cn; ++c) {
        const float p00 = tap(src, sh, sw, cn, iy, ix, c), p01 = tap(src, sh, sw, cn, iy, ix + 1, c);
        const float p10 = tap(src, sh, sw, cn, iy + 1, ix, c);
        const float p11 = tap(src, sh, sw, cn, iy + 1, ix + 1, c);
        const float v0 = std::fma(a, p01 - p00, p00);
        const float v1 = std::fma(a, p11 - p10, p10);
        o[c] = round_u8(std::fma(b, v1 - v0, v0));
      }
    }
  }
  return 0;
}
