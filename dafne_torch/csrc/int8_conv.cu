// int8 (w8a8) eval convolution for Hopper (sm_90a): the activation
// quantize and an implicit-GEMM s8 x s8 -> s32 convolution with the
// dequantize fused.  Built by dafne_torch/ops/kernels/build.py with nvcc
// into a shared library with a plain C interface, loaded with ctypes
// (dafne_torch/ops/kernels/quant.py).
//
// They replace no Pallas kernel: the JAX package leaves this work to XLA,
// the quantize at dafne_tpu/layers/quant.py:60-101 and the conv, a
// lax.conv_general_dilated on int8 with preferred_element_type=int32 and
// its f32 dequantize, at quant.py:112-134.
//
// dafne_quantize_act: x [N, C, H, W] (f32, bf16 or f16) -> x_q
// [N, H, W, C] int8 (channels innermost: they are the GEMM's depth) and
// the scale [N] f32.  Dynamic mode (scale <= 0) first reduces max|x| per
// image (a grid-stride pass, one atomicMax per block on the bit pattern of
// a non-negative float, which orders as the float does: exact), then
// scale = max(amax / 127, 1e-8); static mode takes the caller's scale.
// The second pass transposes 32 x 32 tiles through shared memory, so the
// reads are coalesced along H*W and the writes along C, and quantizes each
// value as rint(x / scale) clipped to +-127 (the divide in f32, round half
// to even), what quantize_tensor_dynamic and _static compute.  What bounds
// it on the H100: bytes (x read twice in dynamic mode, once in static
// mode, x_q written once); its design keeps each read and write coalesced.
//
// dafne_int8_conv: x_q [N, H, W, C] int8, w_q [O, KH, KW, C] int8 (the
// per-output-channel quantized weight, quantized once at eval), the
// scales x_s [N] and w_s [O] f32 and an optional bias [O] f32 -> y
// [N, O, Ho, Wo] in f32, bf16 or f16.  The GEMM is M = N*Ho*Wo output
// pixels by O output channels over K = KH*KW*C, walked tap by tap in
// 64-channel slices; a slice past C (a channel count not a multiple of 64:
// DLA's and VoVNet's) is masked to 0, and so are taps in the zero padding.
// A block of 8 warps computes a 128 x 64 tile of y: each k-tile of A (128
// pixels x 64 channels) and B (64 output channels x 64) is gathered from
// device memory into registers, stored to one of two shared-memory
// buffers (rows padded to 80 bytes: the fragment loads hit 32 distinct
// banks), and each warp runs mma.sync.m16n8k32 s8 x s8 -> s32 on its
// 32 x 32 sub-tile, the next k-tile's loads in flight meanwhile.  The
// epilogue is acc * (x_s[n] * w_s[o]) (+ bias[o]) in f32, cast to the
// output dtype, written NCHW for the rest of the port.  What bounds it on
// the H100: int8 operations at the P3 towers (2*M*O*K against 1,979
// TOPS), bytes at the narrow res2 convs; this first design is simple and
// right (no TMA, no wgmma, one sync per k-tile), and PERF.md holds its
// times against those bounds.
//
// Arithmetic: the s32 sums are exact, and the epilogue is the plain
// version's order (ops/kernels/quant.py), each op in f32; the file is
// compiled with -fmad=false, so the outputs are bit-equal to the plain
// version's.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kActScaleFloor = 1e-8f;  // layers/quant.py _ACT_SCALE_FLOOR
constexpr int kTile = 32;                // quantize: a 32 x 32 tile of (C, H*W)
constexpr int kReduceThreads = 256;

constexpr int kBM = 128;  // conv: output pixels per block
constexpr int kBN = 64;   // output channels per block
constexpr int kBK = 64;   // bytes of depth per k-tile (two mma k-steps)
constexpr int kRow = 80;  // shared-memory row stride in bytes (64 + 16)
constexpr int kConvThreads = 256;

template <typename T>
struct Num;

template <>
struct Num<float> {
  __device__ static float load(const float* p) { return *p; }
  __device__ static float store(float v) { return v; }
};

template <>
struct Num<__nv_bfloat16> {
  __device__ static float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  __device__ static __nv_bfloat16 store(float v) { return __float2bfloat16_rn(v); }
};

template <>
struct Num<__half> {
  __device__ static float load(const __half* p) { return __half2float(*p); }
  __device__ static __half store(float v) { return __float2half_rn(v); }
};

// ---- quantize -----------------------------------------------------------

template <typename T>
__global__ void quantize_act_absmax(const T* __restrict__ x, long long per_image,
                                    unsigned int* __restrict__ amax_bits) {
  const int n = blockIdx.y;
  const T* xi = x + (long long)n * per_image;
  float m = 0.f;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < per_image;
       i += (long long)gridDim.x * blockDim.x)
    m = fmaxf(m, fabsf(Num<T>::load(xi + i)));
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float warp_max[kReduceThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < blockDim.x / 32 ? warp_max[threadIdx.x] : 0.f;
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (threadIdx.x == 0) atomicMax(amax_bits + n, __float_as_uint(m));
  }
}

// grid (ceil(HW / 32), ceil(C / 32), N), block (32, 8).  `amax_bits` is
// null in static mode, where `static_scale` is the scale.
template <typename T>
__global__ void quantize_act_store(const T* __restrict__ x, int c, int hw,
                                   const unsigned int* __restrict__ amax_bits, float static_scale,
                                   int8_t* __restrict__ xq, float* __restrict__ xs) {
  __shared__ int8_t tile[kTile][kTile + 4];
  const int n = blockIdx.z;
  const int hw0 = blockIdx.x * kTile, c0 = blockIdx.y * kTile;
  const float scale = amax_bits == nullptr
                          ? static_scale
                          : fmaxf(__uint_as_float(amax_bits[n]) / 127.0f, kActScaleFloor);
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0 && threadIdx.y == 0) xs[n] = scale;
  const T* xi = x + (long long)n * c * hw;
  for (int j = threadIdx.y; j < kTile; j += blockDim.y) {
    const int ci = c0 + j, p = hw0 + threadIdx.x;
    if (ci < c && p < hw) {
      float q = rintf(Num<T>::load(xi + (long long)ci * hw + p) / scale);
      q = fminf(fmaxf(q, -127.f), 127.f);
      tile[j][threadIdx.x] = (int8_t)(int)q;
    }
  }
  __syncthreads();
  int8_t* qi = xq + (long long)n * hw * c;
  for (int j = threadIdx.y; j < kTile; j += blockDim.y) {
    const int p = hw0 + j, ci = c0 + threadIdx.x;
    if (ci < c && p < hw) qi[(long long)p * c + ci] = tile[threadIdx.x][j];
  }
}

template <typename T>
int launch_quantize(const void* x, int n, int c, int h, int w, float static_scale,
                    unsigned int* amax_bits, int8_t* xq, float* xs, cudaStream_t st) {
  const long long per_image = (long long)c * h * w;
  const int hw = h * w;
  if (static_scale <= 0.f) {
    long long blocks = (per_image + 8LL * kReduceThreads - 1) / (8LL * kReduceThreads);
    if (blocks > 1024) blocks = 1024;
    quantize_act_absmax<T><<<dim3((unsigned)blocks, n), kReduceThreads, 0, st>>>(
        static_cast<const T*>(x), per_image, amax_bits);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  } else {
    amax_bits = nullptr;
  }
  dim3 grid((hw + kTile - 1) / kTile, (c + kTile - 1) / kTile, n);
  quantize_act_store<T><<<grid, dim3(kTile, 8), 0, st>>>(static_cast<const T*>(x), c, hw,
                                                         amax_bits, static_scale, xq, xs);
  return (int)cudaGetLastError();
}

// ---- implicit-GEMM conv -------------------------------------------------

struct ConvShape {
  int n, h, w, c, o, kh, kw, sh, sw, ph, pw, dh, dw, ho, wo;
};

__device__ __forceinline__ void mma_s8(int* d, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes of channels [c0, c0 + 16) at `p` (a row of x_q or w_q), 0 past
// `c` and where `valid` is false.  One 16-byte load when the slice is whole
// and aligned (c % 16 == 0), else byte by byte.
__device__ __forceinline__ int4 load16(const int8_t* p, int c0, int c, bool valid) {
  int4 v = make_int4(0, 0, 0, 0);
  if (!valid || c0 >= c) return v;
  if ((c & 15) == 0) return *reinterpret_cast<const int4*>(p + c0);
  unsigned words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (c0 + i < c) words[i >> 2] |= (unsigned)(uint8_t)p[c0 + i] << (8 * (i & 3));
  return make_int4((int)words[0], (int)words[1], (int)words[2], (int)words[3]);
}

template <typename T>
__global__ void __launch_bounds__(kConvThreads)
    int8_conv_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                     const int8_t* __restrict__ wq, const float* __restrict__ ws,
                     const float* __restrict__ bias, T* __restrict__ y, ConvShape s) {
  __shared__ __align__(16) int8_t a_s[2][kBM * kRow];
  __shared__ __align__(16) int8_t b_s[2][kBN * kRow];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long m_total = (long long)s.n * s.ho * s.wo;
  const long long m_base = (long long)blockIdx.x * kBM;
  const int o_base = blockIdx.y * kBN;

  // A loads: each thread gathers 2 x 16 bytes of one pixel row (a half of
  // the 64-byte slice); B loads: 16 bytes of one output channel's row.
  const int a_row = tid >> 1, a_half = (tid & 1) * 32;
  const long long am = m_base + a_row;
  const bool a_in = am < m_total;
  int a_n = 0, a_hi0 = 0, a_wi0 = 0;
  if (a_in) {
    const int hw_out = s.ho * s.wo;
    a_n = (int)(am / hw_out);
    const int r = (int)(am % hw_out);
    a_hi0 = (r / s.wo) * s.sh - s.ph;
    a_wi0 = (r % s.wo) * s.sw - s.pw;
  }
  const int b_row = tid >> 2, b_part = (tid & 3) * 16;
  const int bo = o_base + b_row;
  const bool b_in = bo < s.o;

  const int slices = (s.c + kBK - 1) / kBK;
  const int k_tiles = s.kh * s.kw * slices;
  int4 a_reg[2], b_reg;

  auto load_tile = [&](int kt) {
    const int tap = kt / slices, c0 = (kt % slices) * kBK;
    const int r = tap / s.kw, q = tap % s.kw;
    const int hi = a_hi0 + r * s.dh, wi = a_wi0 + q * s.dw;
    const bool av = a_in && hi >= 0 && hi < s.h && wi >= 0 && wi < s.w;
    const int8_t* ap = xq + (((long long)a_n * s.h + (av ? hi : 0)) * s.w + (av ? wi : 0)) * s.c;
    a_reg[0] = load16(ap, c0 + a_half, s.c, av);
    a_reg[1] = load16(ap, c0 + a_half + 16, s.c, av);
    const int8_t* bp = wq + (((long long)(b_in ? bo : 0) * s.kh + r) * s.kw + q) * s.c;
    b_reg = load16(bp, c0 + b_part, s.c, b_in);
  };
  auto store_tile = [&](int buf) {
    *reinterpret_cast<int4*>(&a_s[buf][a_row * kRow + a_half]) = a_reg[0];
    *reinterpret_cast<int4*>(&a_s[buf][a_row * kRow + a_half + 16]) = a_reg[1];
    *reinterpret_cast<int4*>(&b_s[buf][b_row * kRow + b_part]) = b_reg;
  };

  // warp (wm, wn) owns rows wm*32 .. +32 and columns wn*32 .. +32 of the tile
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

  load_tile(0);
  store_tile(0);
  __syncthreads();
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < k_tiles) load_tile(kt + 1);
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      unsigned af[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* base = &a_s[buf][(wm * 32 + i * 16 + g) * kRow + ks + t * 4];
        af[i][0] = *reinterpret_cast<const unsigned*>(base);
        af[i][1] = *reinterpret_cast<const unsigned*>(base + 8 * kRow);
        af[i][2] = *reinterpret_cast<const unsigned*>(base + 16);
        af[i][3] = *reinterpret_cast<const unsigned*>(base + 8 * kRow + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* base = &b_s[buf][(wn * 32 + j * 8 + g) * kRow + ks + t * 4];
        bf[j][0] = *reinterpret_cast<const unsigned*>(base);
        bf[j][1] = *reinterpret_cast<const unsigned*>(base + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    if (kt + 1 < k_tiles) store_tile(buf ^ 1);
    __syncthreads();
  }

  // epilogue: acc * (x_s[n] * w_s[o]) (+ bias[o]) in f32, then the cast
  const int hw_out = s.ho * s.wo;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m_base + wm * 32 + i * 16 + g + half * 8;
      if (m >= m_total) continue;
      const int n = (int)(m / hw_out), pix = (int)(m % hw_out);
      const float sx = xs[n];
      T* yrow = y + (long long)n * s.o * hw_out + pix;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = o_base + wn * 32 + j * 8 + t * 2 + e;
          if (o >= s.o) continue;
          float v = (float)acc[i][j][half * 2 + e] * (sx * ws[o]);
          if (bias != nullptr) v = v + bias[o];
          yrow[(long long)o * hw_out] = Num<T>::store(v);
        }
      }
    }
  }
}

template <typename T>
int launch_conv(const int8_t* xq, const float* xs, const int8_t* wq, const float* ws,
                const float* bias, void* y, const ConvShape& s, cudaStream_t st) {
  const long long m_total = (long long)s.n * s.ho * s.wo;
  dim3 grid((unsigned)((m_total + kBM - 1) / kBM), (s.o + kBN - 1) / kBN);
  int8_conv_kernel<T><<<grid, kConvThreads, 0, st>>>(xq, xs, wq, ws, bias, static_cast<T*>(y), s);
  return (int)cudaGetLastError();
}

}  // namespace

// amax_bits: N u32, zeroed by the caller (dynamic mode), unused in static
// mode (static_scale > 0).  dtype 0 f32, 1 bf16, 2 f16.
extern "C" int dafne_quantize_act(const void* x, int n, int c, int h, int w, int dtype,
                                  float static_scale, unsigned int* amax_bits, int8_t* xq,
                                  float* xs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_quantize<float>(x, n, c, h, w, static_scale, amax_bits, xq, xs, st);
    case 1:
      return launch_quantize<__nv_bfloat16>(x, n, c, h, w, static_scale, amax_bits, xq, xs, st);
    case 2: return launch_quantize<__half>(x, n, c, h, w, static_scale, amax_bits, xq, xs, st);
    default: return -1;
  }
}

// geometry: {n, h, w, c, o, kh, kw, stride_h, stride_w, pad_h, pad_w,
// dilation_h, dilation_w, ho, wo}; bias null for none; out_dtype as above.
extern "C" int dafne_int8_conv(const int8_t* xq, const float* xs, const int8_t* wq,
                               const float* ws, const float* bias, void* y, const int* geometry,
                               int out_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ConvShape s;
  s.n = geometry[0]; s.h = geometry[1]; s.w = geometry[2]; s.c = geometry[3];
  s.o = geometry[4]; s.kh = geometry[5]; s.kw = geometry[6]; s.sh = geometry[7];
  s.sw = geometry[8]; s.ph = geometry[9]; s.pw = geometry[10]; s.dh = geometry[11];
  s.dw = geometry[12]; s.ho = geometry[13]; s.wo = geometry[14];
  switch (out_dtype) {
    case 0: return launch_conv<float>(xq, xs, wq, ws, bias, y, s, st);
    case 1: return launch_conv<__nv_bfloat16>(xq, xs, wq, ws, bias, y, s, st);
    case 2: return launch_conv<__half>(xq, xs, wq, ws, bias, y, s, st);
    default: return -1;
  }
}
