// PNG scanline unfiltering on the host, with a plain C interface (ctypes).
//
// Part of the port's image decoder (dafne_torch/data/image_io.py), which
// takes the place of cv2.imread in dafne_tpu/data/mapper.py::read_image.
// It is host code, not a kernel: Sub, Average and Paeth are serial along a
// row and Up, Average and Paeth down the rows, so the only parallelism is
// across the bytes of one pixel and a GPU has nothing to work on.  The
// loop is bound by that dependency chain (a few integer operations per
// byte); the inflated stream is read once and the image written once.
//
// Each row of the inflated stream is one filter byte followed by `rowbytes`
// filtered bytes; `bpp` is the bytes per complete pixel (1 for bit depths
// below 8).  Arithmetic is on bytes mod 256, with the left neighbour of the
// first pixel and the row above the first row taken as 0 (PNG spec, 9.2).

#include <cstdint>
#include <cstdlib>

static inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

// Unfilter `height` rows of `src` (height * (rowbytes + 1) bytes) into `dst`
// (height * rowbytes bytes).  Returns 0, or 1 + the index of the first row
// whose filter byte is not 0-4 (dst is then undefined from that row on).
extern "C" int64_t png_unfilter(const uint8_t* src, int64_t height, int64_t rowbytes,
                                int64_t bpp, uint8_t* dst) {
  const uint8_t* prior = nullptr;  // the row above, unfiltered; none for row 0
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t filter = src[0];
    const uint8_t* in = src + 1;
    uint8_t* out = dst;
    switch (filter) {
      case 0:  // None
        for (int64_t i = 0; i < rowbytes; ++i) out[i] = in[i];
        break;
      case 1:  // Sub
        for (int64_t i = 0; i < rowbytes; ++i)
          out[i] = static_cast<uint8_t>(in[i] + (i >= bpp ? out[i - bpp] : 0));
        break;
      case 2:  // Up
        for (int64_t i = 0; i < rowbytes; ++i)
          out[i] = static_cast<uint8_t>(in[i] + (prior ? prior[i] : 0));
        break;
      case 3:  // Average: (a + b) >> 1 in 9 bits
        for (int64_t i = 0; i < rowbytes; ++i) {
          int a = i >= bpp ? out[i - bpp] : 0;
          int b = prior ? prior[i] : 0;
          out[i] = static_cast<uint8_t>(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth
        for (int64_t i = 0; i < rowbytes; ++i) {
          int a = i >= bpp ? out[i - bpp] : 0;
          int b = prior ? prior[i] : 0;
          int c = (prior && i >= bpp) ? prior[i - bpp] : 0;
          out[i] = static_cast<uint8_t>(in[i] + paeth(a, b, c));
        }
        break;
      default:
        return y + 1;
    }
    prior = out;
    src += rowbytes + 1;
    dst += rowbytes;
  }
  return 0;
}
