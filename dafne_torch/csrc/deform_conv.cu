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
// (channel k*C + c).  A block covers kThreads consecutive pixels of one
// (image, tap) and kChanBlock channels: each thread forms its sampling
// position and weights once, then loops over the channels, so the offsets
// are read once per (pixel, tap, channel block), the columns are written
// coalesced along the pixel axis and the four corner reads of neighbouring
// threads fall on neighbouring addresses where the offsets are smooth.
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
// backward its 27 operations per element, four of them f32 atomics, whose
// throughput, not the arithmetic, sets its time (PERF.md).
//
// Arithmetic: the op order of deform_im2col_plain in
// dafne_torch/layers/deform_conv.py (itself JAX's), each op computed in f32
// and rounded to the feature dtype where the plain version's op rounds
// (torch's bf16 and f16 elementwise ops compute in f32 and round each
// result).  The file is compiled with -fmad=false, so the columns are
// bit-equal to the plain version's.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // pixels per block
constexpr int kChanBlock = 32;  // channels per block of the forward

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

// grid (ceil(H*W / kThreads), N * 9, ceil(C / kChanBlock))
template <typename T>
__global__ void deform_im2col_kernel(const T* __restrict__ x, const float* __restrict__ off,
                                     const T* __restrict__ mask, T* __restrict__ cols, int c,
                                     int h, int w) {
  const int hw = h * w;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= hw) return;
  const int n = blockIdx.y / 9;
  const int k = blockIdx.y - n * 9;
  const int c0 = blockIdx.z * kChanBlock;
  const int c1 = min(c0 + kChanBlock, c);
  const Sample s = make_sample<T>(off, n, k, p, h, w);
  const float m = mask ? Num<T>::load(mask + ((int64_t)n * 9 + k) * hw + p) : 1.0f;
  const T* xn = x + (int64_t)n * c * hw;
  T* out = cols + ((int64_t)n * 9 * c + (int64_t)k * c) * hw + p;
  for (int ci = c0; ci < c1; ++ci) {
    const Corners v = corners<T>(xn + (int64_t)ci * hw, s);
    float val = interpolate<T>(v, s);
    if (mask) val = Num<T>::round(val * m);
    out[(int64_t)ci * hw] = Num<T>::store(val);
  }
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
int launch_forward(const void* x, const float* off, const void* mask, void* cols, int n, int c,
                   int h, int w, cudaStream_t stream) {
  const dim3 grid((h * w + kThreads - 1) / kThreads, n * 9, (c + kChanBlock - 1) / kChanBlock);
  deform_im2col_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), off, static_cast<const T*>(mask), static_cast<T*>(cols), c, h, w);
  return (int)cudaGetLastError();
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

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16.  Returns the launch's cudaError_t
// (-1 for an unknown dtype).
extern "C" int dafne_deform_im2col(const void* x, const float* off, const void* mask, void* cols,
                                   int n, int c, int h, int w, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_forward<float>(x, off, mask, cols, n, c, h, w, st);
    case 1: return launch_forward<__nv_bfloat16>(x, off, mask, cols, n, c, h, w, st);
    case 2: return launch_forward<__half>(x, off, mask, cols, n, c, h, w, st);
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
