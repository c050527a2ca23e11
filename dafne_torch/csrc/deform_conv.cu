// Deformable 3x3 sampling (im2col) for Hopper (sm_90a), forward and
// backward.  Built by dafne_torch/ops/kernels/build.py with nvcc into a
// shared library with a plain C interface, loaded with ctypes
// (dafne_torch/ops/kernels/deform_conv.py).
//
// It replaces no Pallas kernel: the JAX package samples in XLA with four
// take_along_axis gathers per tap (dafne_tpu/layers/deform_conv.py:26,
// bilinear_sample, called 9 times by DeformConv2d :76).  The reference
// DAFNe ran it as a CUDA op (detectron2's DeformConv).  The plain gather
// version writes four gathered [N, C, H, W] tensors, their products and
// sums per tap; this kernel reads x, the offsets and the mask and writes
// the columns once.
//
// dafne_deform_im2col: x [N, C, H, W] (f32, bf16 or f16), offsets
// [N, 18, H, W] f32 ((dy, dx) per tap, torchvision's order), mask
// [N, 9, H, W] in x's dtype or null -> columns [N, 9C, H, W], tap-major
// (channel k*C + c).  Two launches on the caller's stream:
//   deform_im2col_nhwc_kernel copies x channels-last into the caller's
//   scratch [N, H, W, Cp], Cp = C rounded up to 16 bytes of channels (the
//   pad zeroed), through swizzled 64 x 64 tiles in shared memory, 16 bytes
//   a thread on both sides;
//   deform_im2col_gather_kernel: a block owns 32 pixels of one row, all 9
//   taps and one slice of 128 bytes of channels (64 bf16 or f16, 32 f32).
//   Its threads first compute the 9 x 32 samples once (the two offset
//   reads, the floors, the four corner indices and in-map bits, the
//   weights rounded to the feature dtype, the mask) into shared memory.
//   Then warp k takes tap k: each of its four 8-lane groups a run of 8
//   pixels, each lane 16 bytes of the slice's channels.  For each pixel a
//   lane reads the four corners' 16 bytes from the channels-last copy (a
//   group reads each corner's 128 bytes in one coalesced line) and
//   interpolates them; it ends holding 8 pixels x its channels and writes
//   each channel's 8 pixels with one 16-byte streaming store, a warp
//   instruction filling 64 contiguous bytes of 8 channels' rows.  Channels
//   past C and pixels past W are masked.
//
// dafne_deform_im2col_backward: one thread per (image, tap, pixel) loops
// over all C channels of the column gradient.  It adds each corner's share
// into an f32 gradient of x with atomicAdd (sums in no fixed order: not
// deterministic), and reduces over C in registers the gradients of the
// offsets and of the mask, written once.  Nothing per tap is kept: the
// backward reads x, the offsets and the mask again.
//
// What bounds it on the H100 (OPS_* and *_bytes in
// ops/kernels/deform_conv.py): the forward bytes, since it writes the
// columns (9x the input) for 15 f32 operations per column element; the
// channels-last copy adds x read and written once more (2/9 of the
// columns' bytes at P3), and the corner reads come from L2.  The gather's
// writes, its corner reads and its packed arithmetic each take about a
// third to a half of its time alone and overlap only in part at 27 warps
// an SM, so it runs at under half its bound (PERF.md).  The backward
// its 27 operations per element, four of them f32 atomics, whose
// throughput, not the arithmetic, sets its time (PERF.md).
//
// Arithmetic: the op order of deform_im2col_plain in
// dafne_torch/layers/deform_conv.py (itself JAX's), each op rounded to the
// feature dtype where the plain version's op rounds (torch's bf16 and f16
// elementwise ops compute in f32 and round each result).  The forward's
// bf16 and f16 ops are the packed mul.rn / add.rn .bf16x2 and .f16x2
// instructions, one rounding of the exact result.  They equal the f32 op
// rounded to the feature dtype: a product of two bf16 (8-bit significands)
// or two f16 (11-bit) is exact in f32, or, for a bf16 product below 2^-126,
// f32's rounding cannot land on a bf16 rounding midpoint (it would need a
// 16-bit all-ones significand, 65535 = 3*5*17*257, no product of two 8-bit
// ones); a sum of two such numbers is either exact in f32 or in the normal
// range, where rounding to 24 bits and then to 8 or 11 bits is correct
// rounding (Figueroa: 24 >= 2p + 1).  The backward, and every f32 op, runs
// in f32 with -fmad=false.  So the columns are bit-equal to the plain
// version's (a NaN stays a NaN, its payload not kept).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // pixels per block of the backward
constexpr int kTileC = 64;     // the channels-last copy: tiles of 64 channels
constexpr int kTileP = 64;     // x 64 pixels
constexpr int kRun = 8;        // the forward's pixels per lane, along one row
constexpr int kRuns = 4;       // runs per tap in a block: 32 pixels of one row
constexpr int kSliceLanes = 8; // lanes per run: 128 bytes of channels, one slice
constexpr int kGatherThreads = 9 * kRuns * kSliceLanes;  // a warp per tap
constexpr int kGatherBlocks = 3;  // blocks an SM holds: at most 75 registers a thread

template <typename T>
struct Num;

template <>
struct Num<float> {
  __device__ static float load(const float* p) { return *p; }
  __device__ static float round(float v) { return v; }
  __device__ static float store(float v) { return v; }
};

template <>
struct Num<__nv_bfloat16> {
  __device__ static float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  __device__ static float round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
  __device__ static __nv_bfloat16 store(float v) { return __float2bfloat16_rn(v); }
};

template <>
struct Num<__half> {
  __device__ static float load(const __half* p) { return __half2float(*p); }
  __device__ static float round(float v) { return __half2float(__float2half_rn(v)); }
  __device__ static __half store(float v) { return __float2half_rn(v); }
};

// One tap's sampling at one pixel: the four corners' flat indices (0 where
// outside, as the plain version gathers), their 0/1 factors and the
// weights, rounded to the feature dtype as the plain version casts them.
struct Sample {
  int64_t i00, i01, i10, i11;
  float f00, f01, f10, f11;
  float wx, wy, omx, omy;  // wx, wy and 1 - wx, 1 - wy in the feature dtype
};

template <typename T>
__device__ __forceinline__ Sample make_sample(const float* off, int n, int k, int p, int h, int w) {
  const int64_t hw = (int64_t)h * w;
  const float oy = off[((int64_t)n * 18 + 2 * k) * hw + p];
  const float ox = off[((int64_t)n * 18 + 2 * k + 1) * hw + p];
  const int row = p / w;
  const int col = p - row * w;
  const float py = ((float)row + (float)(k / 3 - 1)) + oy;
  const float px = ((float)col + (float)(k % 3 - 1)) + ox;
  const float y0f = floorf(py);
  const float x0f = floorf(px);
  const float wx = px - x0f;
  const float wy = py - y0f;
  const int64_t x0 = (int64_t)x0f;
  const int64_t y0 = (int64_t)y0f;
  const int64_t x1 = x0 + 1;
  const int64_t y1 = y0 + 1;
  const bool y0in = y0 >= 0 && y0 < h, y1in = y1 >= 0 && y1 < h;
  const bool x0in = x0 >= 0 && x0 < w, x1in = x1 >= 0 && x1 < w;
  Sample s;
  s.i00 = (y0in && x0in) ? y0 * w + x0 : 0;
  s.i01 = (y0in && x1in) ? y0 * w + x1 : 0;
  s.i10 = (y1in && x0in) ? y1 * w + x0 : 0;
  s.i11 = (y1in && x1in) ? y1 * w + x1 : 0;
  s.f00 = (y0in && x0in) ? 1.0f : 0.0f;
  s.f01 = (y0in && x1in) ? 1.0f : 0.0f;
  s.f10 = (y1in && x0in) ? 1.0f : 0.0f;
  s.f11 = (y1in && x1in) ? 1.0f : 0.0f;
  s.wx = Num<T>::round(wx);
  s.wy = Num<T>::round(wy);
  s.omx = Num<T>::round(1.0f - s.wx);
  s.omy = Num<T>::round(1.0f - s.wy);
  return s;
}

// The four corner values of one channel, each times its 0/1 factor in the
// feature dtype (v * inb), as float.
struct Corners {
  float v00, v01, v10, v11;
};

template <typename T>
__device__ __forceinline__ Corners corners(const T* xc, const Sample& s) {
  Corners c;
  c.v00 = Num<T>::round(Num<T>::load(xc + s.i00) * s.f00);
  c.v01 = Num<T>::round(Num<T>::load(xc + s.i01) * s.f01);
  c.v10 = Num<T>::round(Num<T>::load(xc + s.i10) * s.f10);
  c.v11 = Num<T>::round(Num<T>::load(xc + s.i11) * s.f11);
  return c;
}

// v00 (1-wx)(1-wy) + v01 wx (1-wy) + v10 (1-wx) wy + v11 wx wy, each
// product and sum rounded to the feature dtype, in the plain version's order.
template <typename T>
__device__ __forceinline__ float interpolate(const Corners& c, const Sample& s) {
  const float t0 = Num<T>::round(Num<T>::round(c.v00 * s.omx) * s.omy);
  const float t1 = Num<T>::round(Num<T>::round(c.v01 * s.wx) * s.omy);
  const float t2 = Num<T>::round(Num<T>::round(c.v10 * s.omx) * s.wy);
  const float t3 = Num<T>::round(Num<T>::round(c.v11 * s.wx) * s.wy);
  return Num<T>::round(Num<T>::round(Num<T>::round(t0 + t1) + t2) + t3);
}

// grid (ceil(H*W / kThreads), N * 9)
template <typename T>
__global__ void deform_im2col_backward_kernel(const T* __restrict__ x,
                                              const float* __restrict__ off,
                                              const T* __restrict__ mask,
                                              const T* __restrict__ gcols, float* __restrict__ gx,
                                              float* __restrict__ goff, float* __restrict__ gmask,
                                              int c, int h, int w) {
  const int hw = h * w;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= hw) return;
  const int n = blockIdx.y / 9;
  const int k = blockIdx.y - n * 9;
  const Sample s = make_sample<T>(off, n, k, p, h, w);
  const float m = mask ? Num<T>::load(mask + ((int64_t)n * 9 + k) * hw + p) : 1.0f;
  const T* xn = x + (int64_t)n * c * hw;
  float* gxn = gx + (int64_t)n * c * hw;
  const T* g = gcols + ((int64_t)n * 9 * c + (int64_t)k * c) * hw + p;
  // each corner's weight in the sample, and its share of the gradient of x
  const float a00 = s.omx * s.omy, a01 = s.wx * s.omy, a10 = s.omx * s.wy, a11 = s.wx * s.wy;
  float g_wx = 0.0f, g_wy = 0.0f, g_m = 0.0f;
  for (int ci = 0; ci < c; ++ci) {
    const float gc = Num<T>::load(g + (int64_t)ci * hw);
    const Corners v = corners<T>(xn + (int64_t)ci * hw, s);
    if (mask) g_m += gc * interpolate<T>(v, s);
    const float gs = gc * m;  // the gradient of the unmasked sample
    g_wx += gs * ((v.v01 - v.v00) * s.omy + (v.v11 - v.v10) * s.wy);
    g_wy += gs * ((v.v10 - v.v00) * s.omx + (v.v11 - v.v01) * s.wx);
    float* gxc = gxn + (int64_t)ci * hw;
    if (s.f00 != 0.0f) atomicAdd(gxc + s.i00, gs * a00);
    if (s.f01 != 0.0f) atomicAdd(gxc + s.i01, gs * a01);
    if (s.f10 != 0.0f) atomicAdd(gxc + s.i10, gs * a10);
    if (s.f11 != 0.0f) atomicAdd(gxc + s.i11, gs * a11);
  }
  // d px / d offset_x = 1 and d py / d offset_y = 1 (floor has no gradient)
  goff[((int64_t)n * 18 + 2 * k) * hw + p] = g_wy;
  goff[((int64_t)n * 18 + 2 * k + 1) * hw + p] = g_wx;
  if (mask) gmask[((int64_t)n * 9 + k) * hw + p] = g_m;
}

template <typename T>
int launch_backward(const void* x, const float* off, const void* mask, const void* gcols,
                    float* gx, float* goff, float* gmask, int n, int c, int h, int w,
                    cudaStream_t stream) {
  const dim3 grid((h * w + kThreads - 1) / kThreads, n * 9);
  deform_im2col_backward_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), off, static_cast<const T*>(mask), static_cast<const T*>(gcols),
      gx, goff, gmask, c, h, w);
  return (int)cudaGetLastError();
}

// ---- forward: a gather over channels-last x --------------------------------

// one 32-bit word of the feature dtype: two bf16 or f16, or one f32, and
// the forward's ops on it, each rounded once to the feature dtype
template <typename T>
struct Word;

template <>
struct Word<float> {
  static constexpr int kPer = 1;
  __device__ static uint32_t splat(float v) { return __float_as_uint(v); }
  __device__ static void put(float* p, uint32_t bits) { *p = __uint_as_float(bits); }
  __device__ static uint32_t mul(uint32_t a, uint32_t b) {
    return __float_as_uint(__fmul_rn(__uint_as_float(a), __uint_as_float(b)));
  }
  __device__ static uint32_t add(uint32_t a, uint32_t b) {
    return __float_as_uint(__fadd_rn(__uint_as_float(a), __uint_as_float(b)));
  }
};

template <>
struct Word<__nv_bfloat16> {
  static constexpr int kPer = 2;
  __device__ static uint32_t splat(float v) {
    const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(v));
    return h | (h << 16);
  }
  __device__ static void put(__nv_bfloat16* p, uint32_t bits) {
    *p = __ushort_as_bfloat16((unsigned short)bits);
  }
  __device__ static uint32_t mul(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  __device__ static uint32_t add(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
};

template <>
struct Word<__half> {
  static constexpr int kPer = 2;
  __device__ static uint32_t splat(float v) {
    const uint32_t h = __half_as_ushort(__float2half_rn(v));
    return h | (h << 16);
  }
  __device__ static void put(__half* p, uint32_t bits) { *p = __ushort_as_half((unsigned short)bits); }
  __device__ static uint32_t mul(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("mul.rn.f16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  __device__ static uint32_t add(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("add.rn.f16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
};

// x [N, C, HW] -> xt [N, HW, cp], channels c .. cp - 1 zero: kTileC
// channels x kTileP pixels a block through shared memory, 16-byte reads
// along the pixels and 16-byte writes along the channels.  The tile's
// 16-byte chunks are swizzled (chunk ^ channel chunk), so both phases'
// shared accesses spread over the banks.
// grid (ceil(HW / kTileP), ceil(cp / kTileC), N), 256 threads
template <typename T>
__global__ void __launch_bounds__(256)
    deform_im2col_nhwc_kernel(const T* __restrict__ x, T* __restrict__ xt, int c, int cp, int hw) {
  constexpr int kVec = 16 / (int)sizeof(T);
  constexpr int kRowChunks = kTileP / kVec, kColChunks = kTileC / kVec;  // powers of two
  __shared__ __align__(16) T tile[kTileC * kTileP];  // [channel][pixel], chunks swizzled
  auto at = [](int ch, int px) {
    return ch * kTileP + ((px / kVec) ^ ((ch / kVec) % kRowChunks)) * kVec + px % kVec;
  };
  const int n = blockIdx.z;
  const int p0 = blockIdx.x * kTileP, c0 = blockIdx.y * kTileC;
  const T* xn = x + (int64_t)n * c * hw;
  const bool vec = hw % kVec == 0;
  for (int i = threadIdx.x; i < kTileC * kRowChunks; i += blockDim.x) {
    const int ch = i / kRowChunks, pc = (i % kRowChunks) * kVec;
    const int ci = c0 + ch, p = p0 + pc;
    T* dst = &tile[at(ch, pc)];
    if (ci < c && vec && p + kVec <= hw) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(xn + (int64_t)ci * hw + p);
    } else {
      for (int e = 0; e < kVec; ++e)
        dst[e] = (ci < c && p + e < hw) ? xn[(int64_t)ci * hw + p + e] : Num<T>::store(0.0f);
    }
  }
  __syncthreads();
  T* xtn = xt + (int64_t)n * hw * cp;
  if constexpr (sizeof(T) == 2) {
    // a thread takes two pixels x 8 channels: 8 words, two per row pair
    for (int i = threadIdx.x; i < kTileP / 2 * kColChunks; i += blockDim.x) {
      const int px = (i / kColChunks) * 2, cc = (i % kColChunks) * kVec;
      const int p = p0 + px, ci = c0 + cc;
      if (p >= hw || ci >= cp) continue;  // cp is a multiple of kVec: the chunk is whole
      uint32_t lo[4], hi[4];  // pixels px and px + 1, channel pairs
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t a = reinterpret_cast<const uint32_t&>(tile[at(cc + 2 * j, px)]);
        const uint32_t b = reinterpret_cast<const uint32_t&>(tile[at(cc + 2 * j + 1, px)]);
        lo[j] = __byte_perm(a, b, 0x5410);
        hi[j] = __byte_perm(a, b, 0x7632);
      }
      *reinterpret_cast<uint4*>(xtn + (int64_t)p * cp + ci) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      if (p + 1 < hw)
        *reinterpret_cast<uint4*>(xtn + (int64_t)(p + 1) * cp + ci) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
    }
  } else {
    for (int i = threadIdx.x; i < kTileP * kColChunks; i += blockDim.x) {
      const int px = i / kColChunks, cc = (i % kColChunks) * kVec;
      const int p = p0 + px, ci = c0 + cc;
      if (p >= hw || ci >= cp) continue;
      uint32_t word[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) word[j] = reinterpret_cast<const uint32_t&>(tile[at(cc + j, px)]);
      *reinterpret_cast<uint4*>(xtn + (int64_t)p * cp + ci) =
          make_uint4(word[0], word[1], word[2], word[3]);
    }
  }
}

// One tap's sample at one pixel, as the gather reads it: the four
// corners' pixel indices (0 where outside, as the plain version gathers)
// and in-map bits, the weights wx, 1 - wx, wy, 1 - wy and the mask, each
// rounded to the feature dtype and splat across a word.  48 bytes: the four
// runs of a warp read four samples 12 words apart, in four bank groups.
struct GatherSample {
  int idx[4];
  uint32_t wx, omx, wy, omy, m;
  uint32_t inside;  // bit q: corner q lies in the map
  uint32_t pad[2];
};

// grid (ceil(W / 32), H, N * slices): a block owns 32 pixels of one row of
// one image, all 9 taps (warp k: tap k, its four 8-lane groups four runs
// of 8 pixels) and one slice of 128 bytes of channels, so the taps'
// overlapping corner reads meet in L1, and one 16-byte store instruction
// of a warp writes 64 contiguous bytes of each of 8 channels' rows.
template <typename T>
__global__ void __launch_bounds__(kGatherThreads, kGatherBlocks)
    deform_im2col_gather_kernel(const T* __restrict__ xt, const float* __restrict__ off,
                                const T* __restrict__ mask, T* __restrict__ cols, int c, int cp,
                                int h, int w, int slices) {
  using W = Word<T>;
  constexpr int kVec = 16 / (int)sizeof(T);  // channels in a lane's 16 bytes
  constexpr int kPixels = kRuns * kRun;
  __shared__ __align__(16) GatherSample samples[9][kPixels];  // [tap][i * kRuns + run]
  const int hw = h * w;
  const int n = blockIdx.z / slices, slice = blockIdx.z - n * slices;
  const int row = blockIdx.y, col0 = blockIdx.x * kPixels;

  // the segment's samples, computed once for the slice's channels
  for (int t = threadIdx.x; t < 9 * kPixels; t += kGatherThreads) {
    const int k = t / kPixels, j = t % kPixels;
    const int col = col0 + j;
    if (col >= w) continue;
    const int p = row * w + col;
    const float oy = off[((int64_t)n * 18 + 2 * k) * hw + p];
    const float ox = off[((int64_t)n * 18 + 2 * k + 1) * hw + p];
    const float py = ((float)row + (float)(k / 3 - 1)) + oy;
    const float px = ((float)col + (float)(k % 3 - 1)) + ox;
    const float y0f = floorf(py);
    const float x0f = floorf(px);
    const float wx = Num<T>::round(px - x0f);
    const float wy = Num<T>::round(py - y0f);
    const int64_t x0 = (int64_t)x0f, y0 = (int64_t)y0f;
    const int64_t x1 = x0 + 1, y1 = y0 + 1;
    const bool y0in = y0 >= 0 && y0 < h, y1in = y1 >= 0 && y1 < h;
    const bool x0in = x0 >= 0 && x0 < w, x1in = x1 >= 0 && x1 < w;
    GatherSample smp;
    smp.idx[0] = (y0in && x0in) ? (int)(y0 * w + x0) : 0;
    smp.idx[1] = (y0in && x1in) ? (int)(y0 * w + x1) : 0;
    smp.idx[2] = (y1in && x0in) ? (int)(y1 * w + x0) : 0;
    smp.idx[3] = (y1in && x1in) ? (int)(y1 * w + x1) : 0;
    smp.inside = (y0in && x0in) | ((y0in && x1in) << 1) | ((y1in && x0in) << 2) |
                 ((y1in && x1in) << 3);
    smp.wx = W::splat(wx);
    smp.wy = W::splat(wy);
    smp.omx = W::splat(1.0f - wx);
    smp.omy = W::splat(1.0f - wy);
    smp.m = W::splat(mask ? Num<T>::load(mask + ((int64_t)n * 9 + k) * hw + p) : 1.0f);
    smp.pad[0] = smp.pad[1] = 0u;
    samples[k][(j % kRun) * kRuns + j / kRun] = smp;
  }
  __syncthreads();

  const int k = threadIdx.x / (kRuns * kSliceLanes), lane = threadIdx.x % (kRuns * kSliceLanes);
  const int g = lane / kSliceLanes;  // the run: pixels col0 + kRun g ...
  const int cb = (slice * kSliceLanes + lane % kSliceLanes) * kVec;
  const int nrun = min(kRun, w - col0 - g * kRun);
  if (nrun <= 0 || cb >= cp) return;
  const uint32_t one = W::splat(1.0f);
  const T* xn = xt + (int64_t)n * hw * cp + cb;
  uint32_t res[kRun][4];
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    if (i < nrun) {
      const GatherSample& smp = samples[k][i * kRuns + g];
      uint32_t v[4][4];  // [corner][word]
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint4 u = *reinterpret_cast<const uint4*>(xn + (int64_t)smp.idx[q] * cp);
        v[q][0] = u.x;
        v[q][1] = u.y;
        v[q][2] = u.z;
        v[q][3] = u.w;
      }
      if (smp.inside != 15u) {  // a corner off the map: times its factor 0 (the others 1)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t f = (smp.inside >> q) & 1u ? one : 0u;
#pragma unroll
          for (int e = 0; e < 4; ++e) v[q][e] = W::mul(v[q][e], f);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // v00 (1-wx)(1-wy) + v01 wx (1-wy) + v10 (1-wx) wy + v11 wx wy, in
        // the plain version's order
        const uint32_t t0 = W::mul(W::mul(v[0][e], smp.omx), smp.omy);
        const uint32_t t1 = W::mul(W::mul(v[1][e], smp.wx), smp.omy);
        const uint32_t t2 = W::mul(W::mul(v[2][e], smp.omx), smp.wy);
        const uint32_t t3 = W::mul(W::mul(v[3][e], smp.wx), smp.wy);
        uint32_t val = W::add(W::add(W::add(t0, t1), t2), t3);
        if (mask) val = W::mul(val, smp.m);
        res[i][e] = val;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) res[i][e] = 0u;
    }
  }
  // each channel's run: 16-byte streaming stores along the pixels
  T* out = cols + (((int64_t)n * 9 + k) * c + cb) * hw + (int64_t)row * w + col0 + g * kRun;
  const bool whole = nrun == kRun;
#pragma unroll
  for (int ch = 0; ch < kVec; ++ch) {
    if (cb + ch >= c) break;
    T* dst = out + (int64_t)ch * hw;
    constexpr int kWords = kRun * (int)sizeof(T) / 4;
    uint32_t run[kWords];
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      if constexpr (W::kPer == 2)  // pixels 2j, 2j + 1 of channel ch: the halves of word ch / 2
        run[j] = __byte_perm(res[2 * j][ch / 2], res[2 * j + 1][ch / 2],
                             (ch & 1) ? 0x7632 : 0x5410);
      else
        run[j] = res[j][ch];
    }
    if (whole && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
#pragma unroll
      for (int j = 0; j < kWords / 4; ++j)
        __stcs(reinterpret_cast<uint4*>(dst) + j,
               make_uint4(run[4 * j], run[4 * j + 1], run[4 * j + 2], run[4 * j + 3]));
    } else {
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
        if (i < nrun) {
          const uint32_t word = run[i * (int)sizeof(T) / 4];
          W::put(dst + i, sizeof(T) == 4 ? word : (word >> (16 * (i & 1))) & 0xffffu);
        }
      }
    }
  }
}

template <typename T>
int launch_forward(const void* x, const float* off, const void* mask, void* cols, void* x_nhwc,
                   int n, int c, int h, int w, cudaStream_t stream) {
  const int hw = h * w;
  constexpr int kVec = 16 / (int)sizeof(T);
  const int cp = (c + kVec - 1) / kVec * kVec;
  const dim3 tgrid((hw + kTileP - 1) / kTileP, (cp + kTileC - 1) / kTileC, n);
  deform_im2col_nhwc_kernel<T><<<tgrid, 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(x_nhwc), c, cp, hw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int slices = (cp / kVec + kSliceLanes - 1) / kSliceLanes;  // 128-byte channel slices
  const dim3 grid((w + kRuns * kRun - 1) / (kRuns * kRun), h, n * slices);
  deform_im2col_gather_kernel<T><<<grid, kGatherThreads, 0, stream>>>(
      static_cast<const T*>(x_nhwc), off, static_cast<const T*>(mask), static_cast<T*>(cols), c,
      cp, h, w, slices);
  return (int)cudaGetLastError();
}

}  // namespace

// x_nhwc: the caller's scratch for the channels-last copy, [N, H, W, Cp]
// in x's dtype, Cp = C rounded up to a multiple of 16 bytes.  dtype: 0
// float32, 1 bfloat16, 2 float16.  Returns the launches' cudaError_t (-1
// for an unknown dtype).
extern "C" int dafne_deform_im2col(const void* x, const float* off, const void* mask, void* cols,
                                   void* x_nhwc, int n, int c, int h, int w, int dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_forward<float>(x, off, mask, cols, x_nhwc, n, c, h, w, st);
    case 1: return launch_forward<__nv_bfloat16>(x, off, mask, cols, x_nhwc, n, c, h, w, st);
    case 2: return launch_forward<__half>(x, off, mask, cols, x_nhwc, n, c, h, w, st);
    default: return -1;
  }
}

// gx [N, C, H, W] f32, zeroed by the caller; goff [N, 18, H, W] f32; gmask
// [N, 9, H, W] f32, or null without a mask.
extern "C" int dafne_deform_im2col_backward(const void* x, const float* off, const void* mask,
                                            const void* gcols, float* gx, float* goff,
                                            float* gmask, int n, int c, int h, int w, int dtype,
                                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_backward<float>(x, off, mask, gcols, gx, goff, gmask, n, c, h, w, st);
    case 1:
      return launch_backward<__nv_bfloat16>(x, off, mask, gcols, gx, goff, gmask, n, c, h, w, st);
    case 2: return launch_backward<__half>(x, off, mask, gcols, gx, goff, gmask, n, c, h, w, st);
    default: return -1;
  }
}
