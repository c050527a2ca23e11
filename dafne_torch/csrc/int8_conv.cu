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
// channel slices.  The wrapper picks one of two kernels by shape
// (ops/kernels/quant.py::int8_conv_path) and hands its tile geometry in.
//
// int8_conv_wgmma_kernel, for C a multiple of 16 and strides 1 or 2 (every
// site of the R-50 recipes): a block computes 128 output pixels x 128
// output channels.  One producer warp keeps a ring of kWStages stages of
// TMA loads in flight on mbarriers: A, 128 pixels x 128 channels, from a
// 4-D tensor map over x_q (C, W, H, N), one box per (tap, slice) at the
// tap's shifted coordinates, its element strides the conv's strides; B,
// 128 output channels x 128 channels, from a 3-D map over w_q (C, KH*KW,
// O).  TMA fills what lies outside the maps with zeros: the conv's zero
// padding, the channels past C, the output channels past O.  The pixel
// tile is one run of an output row where Wo >= 128 (a whole row at P3),
// else as many whole rows as fit in 128; in both cases its pixels are one
// contiguous run of the NCHW output plane.  Two consumer warpgroups each
// run wgmma.mma_async m64n128k32 s32.s8.s8 on 64 of the pixels, both
// operands K-major in shared memory with the 128-byte swizzle, one
// commit group per 128-channel slice, the previous slice's stage released
// when its group completes.  The epilogue stages y's tile through shared
// memory as [channel][pixel] and stores it along pixels, 16 bytes a thread.
// Two blocks fit on an SM (about 97 KB of shared memory each), so one
// block's epilogue runs beside the other's loads.  What bounds it on the
// H100: int8 operations at the P3 towers (154.6 G at 1,979 TOPS: 0.078 ms),
// bytes at res4's 1x1s; the tile reads each A byte from L2 once for 128
// output channels.
//
// int8_conv_kernel, for the other shapes (C not a multiple of 16, as in
// some DLA and VoVNet bodies, or a stride above 2): the first design,
// implicit GEMM over 64-channel slices (a slice past C masked to 0, taps in
// the zero padding too).  A block of 8 warps computes a 128 x 64 tile of
// y: each k-tile of A and B is gathered from device memory into registers,
// stored to one of two shared buffers (rows padded to 80 bytes), and each
// warp runs mma.sync.m16n8k32 s8 x s8 -> s32 on its 32 x 32 sub-tile; one
// sync per k-tile, no TMA, no wgmma.
//
// Both epilogues compute acc * (x_s[n] * w_s[o]) (+ bias[o]) in f32, cast
// to the output dtype, written NCHW for the rest of the port.
//
// Arithmetic: the s32 sums are exact in any order, and the epilogue is the
// plain version's order (ops/kernels/quant.py), each op in f32; the file is
// compiled with -fmad=false, so the outputs are bit-equal to the plain
// version's.

#include <cuda.h>
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

// ---- the wgmma path: TMA-fed tiles, warp-specialised ----------------------

constexpr int kWTileM = 128;  // output pixels per block (two warpgroups of 64)
constexpr int kWTileN = 128;  // output channels per block
constexpr int kWTileK = 128;  // bytes of depth per stage: one 128-byte swizzle row
constexpr int kWStages = 3;
constexpr int kWStageA = kWTileM * kWTileK;              // 16 KB
constexpr int kWStage = kWStageA + kWTileN * kWTileK;    // 32 KB
constexpr int kWOut = 36 * 1024;  // one warpgroup's epilogue staging, in the freed ring
constexpr int kWThreads = 288;    // warpgroups 0-1 consume, warp 8 loads
constexpr int kWSmem = kWStages * kWStage + 2 * kWStages * 8 + 1024;  // + barriers, alignment

struct WgmmaShape {
  int o, kw, sh, sw, ph, pw, dh, dw, ho, wo;
  int bh, bw;             // the pixel tile: bh output rows of bw pixels
  int tiles_h, tiles_w;   // pixel tiles per image along Ho and Wo
  int o_tiles, slices, k_tiles;
  unsigned tx_bytes;      // bytes one stage's two boxes bring (out-of-range fill included)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// spin until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// a K-major operand in shared memory with the 128-byte swizzle: rows of
// 128 bytes, groups of 8 rows 1024 bytes apart (the stride byte offset)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// the accumulators are the asm's operands: keep the compiler from moving
// their reads and writes across a wgmma in flight
__device__ __forceinline__ void fence_acc(int* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[64 x 128] += A[64 x 32] B[128 x 32]^T, s8 x s8 -> s32, both from
// shared memory
__device__ __forceinline__ void wgmma_m64n128k32(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// 1-D grid over (pixel tile, output-channel tile), the channel tile
// fastest: the blocks that share an A tile run together.
template <typename T>
__global__ void __launch_bounds__(kWThreads, 2)
    int8_conv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                           const __grid_constant__ CUtensorMap tm_w, const float* __restrict__ xs,
                           const float* __restrict__ ws, const float* __restrict__ bias,
                           T* __restrict__ y, WgmmaShape s) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle's 1024-byte atoms
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t full = base + kWStages * kWStage;  // kWStages mbarriers, then the empty ones
  const uint32_t empty = full + 8 * kWStages;
  const int tid = threadIdx.x, warp = tid >> 5;

  const int o_tile = blockIdx.x % s.o_tiles;
  const int pix_tile = blockIdx.x / s.o_tiles;
  const int per_image = s.tiles_h * s.tiles_w;
  const int n = pix_tile / per_image;
  const int th = (pix_tile % per_image) / s.tiles_w, tw = pix_tile % s.tiles_w;
  const int ho0 = th * s.bh, wo0 = tw * s.bw;
  const int o0 = o_tile * kWTileN;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kWStages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // the producer: one thread issues every load
    if ((tid & 31) == 0) {
      const int h0 = ho0 * s.sh - s.ph, w0 = wo0 * s.sw - s.pw;
      for (int kt = 0; kt < s.k_tiles; ++kt) {
        const int st = kt % kWStages;
        if (kt >= kWStages) mbar_wait(empty + 8 * st, ((kt / kWStages) - 1) & 1);
        const int tap = kt / s.slices, c0 = (kt % s.slices) * kWTileK;
        const int r = tap / s.kw, q = tap % s.kw;
        const uint32_t bar = full + 8 * st;
        mbar_expect_tx(bar, s.tx_bytes);
        tma_load_4d(base + st * kWStage, &tm_x, bar, c0, w0 + q * s.dw, h0 + r * s.dh, n);
        tma_load_3d(base + st * kWStage + kWStageA, &tm_w, bar, c0, tap, o0);
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns pixel rows 64*wg .. 64*wg + 63
  const int wg = warp >> 2;
  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  const uint32_t a_rows = base + wg * (64 * kWTileK);
  for (int kt = 0; kt < s.k_tiles; ++kt) {
    const int st = kt % kWStages;
    mbar_wait(full + 8 * st, (kt / kWStages) & 1);
    const uint64_t da = sw128_desc(a_rows + st * kWStage);
    const uint64_t db = sw128_desc(base + st * kWStage + kWStageA);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kWTileK / 32; ++k)  // 32 bytes: 2 in the descriptor's 16-byte units
      wgmma_m64n128k32(acc, da + 2 * k, db + 2 * k);
    wgmma_commit();
    fence_acc(acc);
    wgmma_wait<1>();  // the previous slice's products are done: free its stage
    fence_acc(acc);
    if (kt > 0 && (tid & 127) == 0) mbar_arrive(empty + 8 * ((kt - 1) % kWStages));
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // epilogue: acc * (x_s[n] * w_s[o]) (+ bias[o]) in f32, then the cast,
  // staged as [channel][pixel] in the ring, which both warpgroups are done with
  named_sync(1, 256);
  constexpr int kRow = 64 + 16 / (int)sizeof(T);  // a staging row: 64 pixels + 16 bytes
  T* stage = reinterpret_cast<T*>(smem + wg * kWOut);
  const int lane = tid & 31, lw = warp & 3;
  const float sx = xs[n];
#pragma unroll
  for (int j = 0; j < kWTileN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * (lane & 3) + e;
      const int o = o0 + col;
      const float sw = o < s.o ? ws[o] : 0.0f;
      const float b = (bias != nullptr && o < s.o) ? bias[o] : 0.0f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = 16 * lw + (lane >> 2) + 8 * hh;
        float v = (float)acc[4 * j + 2 * hh + e] * (sx * sw);
        if (bias != nullptr) v = v + b;
        stage[col * kRow + row] = Num<T>::store(v);
      }
    }
  }
  named_sync(2 + wg, 128);

  // the tile's pixels are one contiguous run of the output plane
  const int valid = s.bh == 1 ? min(s.bw, s.wo - wo0) : min(s.bh, s.ho - ho0) * s.bw;
  const int valid_wg = valid - 64 * wg;
  const long long hw_out = (long long)s.ho * s.wo;
  const long long p_wg = (long long)ho0 * s.wo + wo0 + 64 * wg;
  constexpr int kVec = 16 / (int)sizeof(T), kChunks = 64 / kVec;
  for (int i = tid & 127; i < kWTileN * kChunks; i += 128) {
    const int col = i / kChunks, px = (i % kChunks) * kVec;
    const int o = o0 + col;
    if (o >= s.o || px >= valid_wg) continue;
    T* dst = y + ((long long)n * s.o + o) * hw_out + p_wg + px;
    const T* src = stage + col * kRow + px;
    if (px + kVec <= valid_wg && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < kVec && px + e < valid_wg; ++e) dst[e] = src[e];
    }
  }
}

// cuTensorMapEncodeTiled through the runtime's driver entry point: the
// library needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

constexpr int kErrNoEncoder = 10000;  // cuTensorMapEncodeTiled not found
constexpr int kErrEncode = 20000;     // + the CUresult of a refused tensor map

// g: the geometry (dafne_int8_conv below)
template <typename T>
int launch_conv_wgmma(const int8_t* xq, const float* xs, const int8_t* wq, const float* ws,
                      const float* bias, void* y, const int* g, cudaStream_t st) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncoder;
  const cuuint64_t n = g[0], h = g[1], w = g[2], c = g[3], o = g[4], taps = (cuuint64_t)g[5] * g[6];
  CUtensorMap tm_x, tm_w;
  const cuuint64_t x_dims[4] = {c, w, h, n};
  const cuuint64_t x_strides[3] = {c, w * c, h * w * c};
  const cuuint32_t x_box[4] = {(cuuint32_t)g[18], (cuuint32_t)g[19], (cuuint32_t)g[20],
                               (cuuint32_t)g[21]};
  const cuuint32_t x_elem[4] = {(cuuint32_t)g[22], (cuuint32_t)g[23], (cuuint32_t)g[24],
                                (cuuint32_t)g[25]};
  CUresult r = encode(&tm_x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<int8_t*>(xq), x_dims,
                      x_strides, x_box, x_elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kErrEncode + (int)r;
  const cuuint64_t w_dims[3] = {c, taps, o};
  const cuuint64_t w_strides[2] = {c, taps * c};
  const cuuint32_t w_box[3] = {kWTileK, 1, kWTileN};
  const cuuint32_t w_elem[3] = {1, 1, 1};
  r = encode(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<int8_t*>(wq), w_dims, w_strides,
             w_box, w_elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kErrEncode + (int)r;

  WgmmaShape s;
  s.o = g[4]; s.kw = g[6]; s.sh = g[7]; s.sw = g[8]; s.ph = g[9]; s.pw = g[10];
  s.dh = g[11]; s.dw = g[12]; s.ho = g[13]; s.wo = g[14]; s.bh = g[16]; s.bw = g[17];
  s.tiles_h = (s.ho + s.bh - 1) / s.bh;
  s.tiles_w = (s.wo + s.bw - 1) / s.bw;
  s.o_tiles = (s.o + kWTileN - 1) / kWTileN;
  s.slices = (g[3] + kWTileK - 1) / kWTileK;
  s.k_tiles = g[5] * g[6] * s.slices;
  s.tx_bytes = (unsigned)(kWTileK * s.bw * s.bh + kWTileK * kWTileN);
  const long long blocks = (long long)g[0] * s.tiles_h * s.tiles_w * s.o_tiles;
  cudaError_t err = cudaFuncSetAttribute(int8_conv_wgmma_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kWSmem);
  if (err != cudaSuccess) return (int)err;
  int8_conv_wgmma_kernel<T><<<(unsigned)blocks, kWThreads, kWSmem, st>>>(
      tm_x, tm_w, xs, ws, bias, static_cast<T*>(y), s);
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
// dilation_h, dilation_w, ho, wo, path, tile_h, tile_w, box[4],
// element_strides[4]}: path 0 is the mma.sync kernel, which reads the
// first 15; path 1 the wgmma kernel, whose pixel tile is tile_h rows of
// tile_w pixels and whose x_q tensor map has that box and those element
// strides over (C, W, H, N) (ops/kernels/quant.py::int8_conv_tiles).  bias
// null for none; out_dtype as above.  Returns a cudaError_t, or 10000 when
// the driver has no cuTensorMapEncodeTiled, or 20000 + its CUresult when it
// refuses a tensor map.
extern "C" int dafne_int8_conv(const int8_t* xq, const float* xs, const int8_t* wq,
                               const float* ws, const float* bias, void* y, const int* geometry,
                               int out_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (geometry[15] == 1) {
    switch (out_dtype) {
      case 0: return launch_conv_wgmma<float>(xq, xs, wq, ws, bias, y, geometry, st);
      case 1: return launch_conv_wgmma<__nv_bfloat16>(xq, xs, wq, ws, bias, y, geometry, st);
      case 2: return launch_conv_wgmma<__half>(xq, xs, wq, ws, bias, y, geometry, st);
      default: return -1;
    }
  }
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
