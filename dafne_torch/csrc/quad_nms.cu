// Rotated-quad NMS kernels for Hopper (sm_90a): the suppression matrix (a
// strip kernel, fast on class-major input, and a 2-D tiled one, fast on any
// score order) and the exact greedy keep-set.  Built by
// dafne_torch/ops/kernels/build.py with nvcc into a shared library with a
// plain C interface, loaded with ctypes.
//
// S leaves both suppression kernels as bit rows: bits[b, i, w] is a 32-bit
// word whose bit k is S[b, i, 32 w + k], so S of [8, 4096] takes 16.8 MB and
// not 134 MB of int8, and the greedy walk reads 8x fewer bytes.
//
// 1. dafne_suppression_bits (K1) replaces the Pallas strip kernel
//    dafne_tpu/ops/pallas/quad_nms.py:_suppress_strip_kernel (reached through
//    suppression_matrix(..., class_major=True)).
//    S[b, i, j] = 1 iff j > i, classes[b, i] == classes[b, j] >= 0 and the
//    exact quad IoU (Cyrus–Beck clipped edge integrals) > threshold.
//    What bounds it on the H100: instruction issue.  A pair costs 808 f32
//    operations (OPS_PER_PAIR) and, as compiled, more instructions than
//    that (each of its 32 IEEE divisions is a reciprocal and a correction
//    sequence), against 1/8 byte of S: the FP32 pipes, not memory, set
//    the pace, and no tensor-core path exists for this math.  The design
//    (suppression_block, shared with 2): a block is one (64-row strip,
//    128-column block) pair.  It loads the 192 classes and lists, in shared
//    memory, the slots (r, c) of the block that can be nonzero: j > i and
//    equal classes >= 0 (a block-wide scan of each thread's count).  A
//    block with none writes its zero words and exits, so the caller
//    allocates S uninitialised and no wrapper-side span computation runs.
//    A live block stages corners and areas in shared memory, and its
//    threads take the listed pairs in turn: every lane of a warp computes a
//    pair that can suppress, however the classes and the diagonal cut the
//    block (a warp per row and 32 columns would leave the lanes outside the
//    row's class run or below the diagonal idle while the warp pays for the
//    rest).  A verdict is one atomicOr into the block's words in shared
//    memory, stored once at the end.  The op order is that of the plain
//    PyTorch version and the file is compiled with -fmad=false, so the bits
//    are equal to the packed plain S.  The dead-block test is exact, so K1
//    computes S for any order; class-major order only makes most blocks
//    dead or dense.
//
// 2. dafne_suppression_bits_2d (K2) replaces the Pallas 2-D tiled kernel
//    dafne_tpu/ops/pallas/quad_nms.py:_suppress_kernel (reached through
//    suppression_matrix(..., class_major=False), impl="pallas-2d"): the same
//    S as bit rows, for candidates in any order that is score-descending
//    within a class.  What bounds it: the f32 IoU work of the same-class
//    pairs j > i, as for 1.  In score order with many classes every tile
//    on or above the diagonal is live at low density (1/15 of its slots
//    with 15 classes), where the first design (one 128 x 128 tile per
//    block, a thread per column, int8 out) paid a full IoU for every warp
//    that held one same-class lane: 0.89 of the warps on the dense mix, and
//    a zero fill and a pack of the int8 S around it.  The design runs 1's
//    block body (suppression_block) over square kTile2 x kTile2 tiles: the
//    active pairs listed so every lane computes one, one atomicOr per
//    suppressing pair, every word written.  The grid holds only the tiles
//    on or above the diagonal (a linear index, row by row), and each such
//    tile writes the zero words of its mirror below the diagonal, so no
//    block is spent on a tile that holds only j < i and S needs no fill.
//    The tile's shape was chosen by measurement (PERF.md): 64 x 64 (128
//    threads) ties 128 x 128 on the dense score-ordered mix and beats it by
//    a tenth on the grouped eval input, where a 512-wide problem has only
//    10 tiles of 128; 32 x 32 and a full 2-D grid of 128 x 128 were slower.
//
// 3. dafne_greedy_keep_bits replaces greedy_scan + _jacobi_fixed_point of
//    the same file (XLA, not Pallas): the exact greedy keep-set over the
//    bit rows of S in score order.  What bounds it: latency.  The walk is
//    sequential over rows, and the bytes it needs (each kept row's upper
//    triangle, a bit per column) take the card microseconds.  The design is
//    JAX's blocked Gauss-Seidel with a bit-serial walk in registers inside
//    the block: one block per problem, `removed` (N / 32 words, the rows
//    not in keep_init or already suppressed) in shared memory, rows in
//    chunks of 32 (one word column), one __syncthreads per chunk.  Warp 0
//    decides chunk c: each lane holds the chunk's 32 diagonal words and
//    walks the alive word through 32 dependent steps in registers, then
//    ORs the kept rows' word c + 1 into `removed` for the next decision.
//    Meanwhile the other seven warps start the cp.async copy of chunk
//    c + 2 (128 words of each of its 32 rows, from word (c + 2) & ~3) into
//    a four-slot shared ring and OR chunk c - 1's kept rows into words
//    c + 1...  So a chunk, not a row, pays the barrier and the round trip
//    to memory, and the decision does not wait for the OR step: what is
//    left per chunk is the chain and the barrier.  A slot holds 4096
//    columns; a wider row's later words are ORed from global memory (L2),
//    so shared memory is 64 KB + N / 8 bytes and N reaches 49152.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStrip = 64;    // K1: rows per block, a strip (as the Pallas kernel)
constexpr int kTile = 128;    // K1: columns per block
constexpr int kTile2 = 64;    // K2: rows and columns per block, a square tile

// Contribution of edge a->b clipped to quad q (CCW).  Same op order as
// dafne_torch/ops/kernels/quad_nms.py:_edge_integral_plain.
__device__ __forceinline__ float edge_integral(
    float ax, float ay, float bx, float by, const float* qx, const float* qy,
    float eps, bool include_boundary) {
  const float dx = bx - ax;
  const float dy = by - ay;
  float t_low = 0.0f;
  float t_high = 1.0f;
  bool alive = true;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int k1 = (k + 1) & 3;
    const float ex = qx[k1] - qx[k];
    const float ey = qy[k1] - qy[k];
    const float ry = ay - qy[k];
    const float rx = ax - qx[k];
    const float exry = ex * ry;
    const float eyrx = ey * rx;
    const float num = exry - eyrx;
    const float exdy = ex * dy;
    const float eydx = ey * dx;
    const float den = exdy - eydx;
    const float den_tol = eps * (fabsf(exdy) + fabsf(eydx));
    const float num_tol = eps * (fabsf(exry) + fabsf(eyrx));
    const bool par = fabsf(den) <= den_tol;
    const float ratio = -num / (par ? 1.0f : den);
    if (den > den_tol) t_low = fmaxf(t_low, ratio);
    if (den < -den_tol) t_high = fminf(t_high, ratio);
    bool outside = par && (num < -num_tol);
    if (!include_boundary) {
      const bool same_dir = (ex * dx + ey * dy) > 0.0f;
      outside = outside || (par && fabsf(num) <= num_tol && same_dir);
    }
    alive = alive && !outside;
  }
  const float pax = ax + t_low * dx;
  const float pay = ay + t_low * dy;
  const float pbx = ax + t_high * dx;
  const float pby = ay + t_high * dy;
  const float contrib = 0.5f * (pax * pby - pay * pbx);
  return (alive && t_low < t_high) ? contrib : 0.0f;
}

__device__ __forceinline__ float shoelace4(const float* x, const float* y) {
  float s = x[0] * y[1] - x[1] * y[0];
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    const int k1 = (k + 1) & 3;
    s = s + (x[k] * y[k1] - x[k1] * y[k]);
  }
  return 0.5f * fabsf(s);
}

// Whether row quad p suppresses column quad q: their IoU (areas pa, qa)
// exceeds the threshold.  The op order of suppression_matrix_plain.
__device__ __forceinline__ bool pair_suppresses(
    const float* px, const float* py, float pa, const float* qx, const float* qy, float qa,
    float iou_threshold, float eps) {
  float inter = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int k1 = (k + 1) & 3;
    inter = inter + edge_integral(px[k], py[k], px[k1], py[k1], qx, qy, eps, true);
    inter = inter + edge_integral(qx[k], qy[k], qx[k1], qy[k1], px, py, eps, false);
  }
  inter = fmaxf(inter, 0.0f);
  inter = fminf(inter, fminf(pa, qa));
  const float uni = pa + qa - inter;
  const float iou = (uni == 0.0f) ? (inter + 1.0f) / (uni + 1.0f) : inter / uni;
  return iou > iou_threshold;
}

// Stage quad `src` of `cor` (CCW x0 y0 .. x3 y3) at slot `t` of x, y and area.
template <int W>
__device__ __forceinline__ void stage_quad(const float* cor, int src, float (*x)[W],
                                           float (*y)[W], float* area, int t) {
  float qx[4], qy[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    qx[k] = cor[(size_t)src * 8 + 2 * k];
    qy[k] = cor[(size_t)src * 8 + 2 * k + 1];
    x[k][t] = qx[k];
    y[k][t] = qy[k];
  }
  area[t] = shoelace4(qx, qy);
}

// A kRows x kCols block of S takes kRows * kCols / 32 threads: 32 (row,
// column) slots each, so a thread's active slots fit one mask word, and one
// word of the block's bit rows each.
template <int kRows, int kCols>
struct BlockShape {
  static_assert(kRows % 32 == 0 && kCols % 32 == 0, "rows and columns in whole words");
  static_assert(kRows * kCols <= 65536, "a slot index fits 16 bits");
  static constexpr int kThreads = kRows * kCols / 32;
  static constexpr int kWords = kCols / 32;  // words of a row in the block
};

// This thread's word of the kRows x kCols block at rows r0.., columns c0..
// of one problem's bit rows `out_b` (W words a row).
template <int kRows, int kCols>
__device__ __forceinline__ uint32_t* block_word(uint32_t* out_b, int words, int r0, int c0) {
  constexpr int kWords = BlockShape<kRows, kCols>::kWords;
  return out_b + (size_t)(r0 + threadIdx.x / kWords) * words + c0 / 32 + threadIdx.x % kWords;
}

// The block body of K1 and K2: the kRows x kCols block of S at rows r0..,
// columns c0.. of problem b, every word written.  corners [B, N, 8] f32 CCW;
// classes [B, N] i32 (< 0: invalid or padding); out [B, N, N / 32] u32 bit
// rows.  The block lists its active slots (j > i, equal classes >= 0) in
// shared memory; a block with none writes zero words and loads no corner.
template <int kRows, int kCols>
__device__ __forceinline__ void suppression_block(
    const float* __restrict__ corners, const int* __restrict__ classes,
    uint32_t* __restrict__ out, int n, float iou_threshold, float eps, int r0, int c0, int b) {
  constexpr int kThreads = BlockShape<kRows, kCols>::kThreads;
  constexpr int kWords = BlockShape<kRows, kCols>::kWords;
  constexpr int kRowStep = kThreads / kCols;  // kRows / 32
  __shared__ float rx[4][kRows], ry[4][kRows], ra[kRows];
  __shared__ float cx[4][kCols], cy[4][kCols], ca[kCols];
  __shared__ int rc[kRows], cc[kCols];
  __shared__ int warp_total[kThreads / 32];
  __shared__ uint16_t pairs[kRows * kCols];  // row * kCols + column of each active pair
  __shared__ uint32_t bits[kRows][kWords];

  const int words = n / 32;
  const int* cls = classes + (size_t)b * n;
  uint32_t* out_b = out + (size_t)b * n * words;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int t = tid; t < kRows + kCols; t += kThreads) {
    if (t < kRows) {
      rc[t] = cls[r0 + t];
    } else {
      cc[t - kRows] = cls[c0 + t - kRows];
    }
  }
  bits[tid / kWords][tid % kWords] = 0u;
  __syncthreads();

  // A slot (r, c) is active iff j > i and the classes are equal and >= 0.
  // Thread tid owns column c = tid % kCols and rows tid / kCols + kRowStep k.
  const int c = tid % kCols;
  const int j = c0 + c;
  const int qc = cc[c];
  uint32_t mine = 0;
  if (qc >= 0) {
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const int r = tid / kCols + kRowStep * k;
      if (j > r0 + r && rc[r] == qc) mine |= 1u << k;
    }
  }
  // block-wide exclusive scan of the active counts
  const int count = __popc(mine);
  int incl = count;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  int offset = incl - count;
  int total = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    const int t = warp_total[w];
    offset += w < warp ? t : 0;
    total += t;
  }
  // no active pair: the block is dead (live_blocks in
  // ops/kernels/quad_nms.py is the plain form) and its words are zero
  if (total == 0) {
    *block_word<kRows, kCols>(out_b, words, r0, c0) = 0u;
    return;
  }
  for (uint32_t m = mine; m; m &= m - 1) {
    const int r = tid / kCols + kRowStep * (__ffs(m) - 1);
    pairs[offset++] = static_cast<uint16_t>(r * kCols + c);
  }
  const float* cor = corners + (size_t)b * n * 8;
  for (int t = tid; t < kRows + kCols; t += kThreads) {
    if (t < kRows) {
      stage_quad(cor, r0 + t, rx, ry, ra, t);
    } else {
      stage_quad(cor, c0 + t - kRows, cx, cy, ca, t - kRows);
    }
  }
  __syncthreads();

  // every lane takes an active pair: no lane idles on a pair that cannot
  // suppress, whatever the mix of classes and the diagonal leave in a warp
  for (int p = tid; p < total; p += kThreads) {
    const int r = pairs[p] / kCols;
    const int q = pairs[p] % kCols;
    const float px[4] = {rx[0][r], rx[1][r], rx[2][r], rx[3][r]};
    const float py[4] = {ry[0][r], ry[1][r], ry[2][r], ry[3][r]};
    const float qx[4] = {cx[0][q], cx[1][q], cx[2][q], cx[3][q]};
    const float qy[4] = {cy[0][q], cy[1][q], cy[2][q], cy[3][q]};
    if (pair_suppresses(px, py, ra[r], qx, qy, ca[q], iou_threshold, eps)) {
      atomicOr(&bits[r][q / 32], 1u << (q % 32));
    }
  }
  __syncthreads();
  *block_word<kRows, kCols>(out_b, words, r0, c0) = bits[tid / kWords][tid % kWords];
}

using K1Block = BlockShape<kStrip, kTile>;
using K2Block = BlockShape<kTile2, kTile2>;

// K1: grid (N / kTile, N / kStrip, B), block K1Block::kThreads; every block
// of S, in rows of strips.
__global__ void __launch_bounds__(K1Block::kThreads) suppression_bits_kernel(
    const float* __restrict__ corners, const int* __restrict__ classes,
    uint32_t* __restrict__ out, int n, float iou_threshold, float eps) {
  suppression_block<kStrip, kTile>(corners, classes, out, n, iou_threshold, eps,
                                   blockIdx.y * kStrip, blockIdx.x * kTile, blockIdx.z);
}

// K2: grid (T (T + 1) / 2 with T = N / kTile2, B), block K2Block::kThreads.
// blockIdx.x runs row by row over the tiles (rt, ct) on or above the
// diagonal, ct >= rt; a tile with ct > rt also writes the zero words of its
// mirror (ct, rt), which holds only j < i.  So every word of S is written
// and the tiles below the diagonal cost no block.
__global__ void __launch_bounds__(K2Block::kThreads) suppression_bits_2d_kernel(
    const float* __restrict__ corners, const int* __restrict__ classes,
    uint32_t* __restrict__ out, int n, float iou_threshold, float eps) {
  const int tiles = n / kTile2;
  int rt = 0;
  int rest = blockIdx.x;
  while (rest >= tiles - rt) {  // row rt holds tiles - rt tiles
    rest -= tiles - rt;
    ++rt;
  }
  const int ct = rt + rest;
  if (ct > rt) {
    *block_word<kTile2, kTile2>(out + (size_t)blockIdx.y * n * (n / 32), n / 32, ct * kTile2,
                                rt * kTile2) = 0u;
  }
  suppression_block<kTile2, kTile2>(corners, classes, out, n, iou_threshold, eps, rt * kTile2,
                                    ct * kTile2, blockIdx.y);
}

constexpr int kGreedyThreads = 256;
constexpr int kHelpers = kGreedyThreads - 32;  // warps 1..: copies and OR steps
constexpr int kChunk = 32;   // rows decided per step: one word column
constexpr int kStages = 4;   // chunk slots: decided, ORed, two in flight
constexpr int kRingWords = 128;  // words of a chunk's rows staged in a slot: 4096 columns
constexpr int kGreedyMaxWords = 1536;  // N <= 49152: `removed` (N / 32 words) in shared memory
constexpr int kRingBytes = kStages * kChunk * kRingWords * 4;  // 64 KB
constexpr int kGreedyMaxSmem = kRingBytes + kGreedyMaxWords * 4;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most kStages - 3 committed groups of this thread are in flight
__device__ __forceinline__ void cp_async_wait_chunk() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 3) : "memory");
}

// Words [c & ~3, staged_end(c)) of chunk c's rows sit in its ring slot.
__device__ __forceinline__ int staged_end(int c, int words) {
  return min(words, (c & ~3) + kRingWords);
}

// A helper thread's share of copying the staged words of rows 32 c ..
// 32 c + 31 into buf [kChunk][kRingWords], word c & ~3 first: helper warp h
// takes rows h - 1, h - 1 + 7, ..., its lanes the 16-byte pieces (W % 4 == 0).
__device__ __forceinline__ void stage_chunk(const uint32_t* bits_b, uint32_t* buf, int c,
                                            int words) {
  const int w0 = c & ~3;
  const int pieces = (staged_end(c, words) - w0) / 4;
  for (int r = threadIdx.x / 32 - 1; r < kChunk; r += kHelpers / 32) {
    for (int v = threadIdx.x % 32; v < pieces; v += 32) {
      cp_async16(buf + r * kRingWords + 4 * v,
                 bits_b + (size_t)(kChunk * c + r) * words + w0 + 4 * v);
    }
  }
}

// grid (B,), block kGreedyThreads, dynamic shared memory kRingBytes + 4 W.
// bits [B, N, W = N / 32] u32 (bit k of word w in row i is S[i, 32 w + k];
// only bits j > i are read); keep_init / keep [B, N] uint8 (0/1);
// N % 128 == 0, W <= kGreedyMaxWords.
//
// Iteration c: warp 0 decides chunk c while the helper warps start the copy
// of chunk c + 2 and OR chunk c - 1's kept rows into `removed` (words
// c + 1..; word c came from warp 0 at the end of iteration c - 1, so each
// decision waits for one barrier and no OR step).  One __syncthreads per
// chunk.  A slot stages kRingWords words of each row, all of them up to
// N = 4096; past that (kWide) the OR step reads a row's later words from
// global memory (L2), so shared memory grows with W and not with 32 W per
// slot.  The narrow instantiation (N <= 4096) compiles without that loop.
template <bool kWide>
__global__ void __launch_bounds__(kGreedyThreads) greedy_keep_bits_kernel(
    const uint32_t* __restrict__ bits, const uint8_t* __restrict__ keep_init,
    uint8_t* __restrict__ keep, int n) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ uint32_t kept_words[2];  // chunk c's kept rows, by c % 2
  const int words = n / 32;
  uint32_t* ring = smem;                                     // [kStages][kChunk][kRingWords]
  uint32_t* removed = smem + kStages * kChunk * kRingWords;  // [W]
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const uint32_t* bits_b = bits + (size_t)b * n * words;
  auto slot = [&](int chunk) { return ring + (chunk % kStages) * kChunk * kRingWords; };

  if (warp > 0) {
    for (int k = 0; k < kStages - 2; ++k) {
      if (k < words) stage_chunk(bits_b, slot(k), k, words);
      cp_async_commit();
    }
  }
  // a row outside keep_init counts as removed from the start
  for (int w = warp; w < words; w += kGreedyThreads / 32) {
    const uint32_t init = __ballot_sync(kFull, keep_init[(size_t)b * n + 32 * w + lane] != 0);
    if (lane == 0) removed[w] = ~init;
  }
  for (int c = 0; c < words; ++c) {
    if (warp > 0) cp_async_wait_chunk();
    __syncthreads();  // chunk c in shared memory, removed[c] final, slot of c - 2 free
    if (warp == 0) {
      // every lane walks the chunk's 32 rows on the same registers; row r
      // suppresses only its later columns of the diagonal word
      const uint32_t* buf = slot(c);
      const int d = c - (c & ~3);  // the diagonal word's place in the slot
      const uint32_t next = c + 1 < words ? buf[lane * kRingWords + d + 1] : 0u;
      uint32_t alive = ~removed[c];
      uint32_t diag[kChunk];
#pragma unroll
      for (int r = 0; r < kChunk; ++r) {
        diag[r] = buf[r * kRingWords + d] & (r == kChunk - 1 ? 0u : (kFull << (r + 1)));
      }
#pragma unroll
      for (int r = 0; r < kChunk; ++r) {
        if ((alive >> r) & 1u) alive &= ~diag[r];
      }
      keep[(size_t)b * n + kChunk * c + lane] = (alive >> lane) & 1u;
      // the kept rows' word c + 1, for the next decision
      const uint32_t v = __reduce_or_sync(kFull, next & (0u - ((alive >> lane) & 1u)));
      if (lane == 0) {
        kept_words[c & 1] = alive;
        if (v) atomicOr(&removed[c + 1], v);
      }
    } else {
      if (c + kStages - 2 < words) stage_chunk(bits_b, slot(c + kStages - 2), c + kStages - 2, words);
      cp_async_commit();  // empty near the end: the waits still count in order
      const uint32_t kept = c > 0 ? kept_words[(c - 1) & 1] : 0u;
      if (kept) {
        const uint32_t* buf = slot(c - 1);
        const int w0 = (c - 1) & ~3;
        const int staged = staged_end(c - 1, words);
        for (int w = c + 1 + tid - 32; w < staged; w += kHelpers) {
          uint32_t acc = 0;
#pragma unroll
          for (int r = 0; r < kChunk; ++r) {
            acc |= buf[r * kRingWords + w - w0] & (0u - ((kept >> r) & 1u));
          }
          if (acc) atomicOr(&removed[w], acc);
        }
        if constexpr (kWide) {
          // the words past the slot, from global memory.  Every row is
          // loaded and masked, so the 32 loads are in flight together
          const uint32_t* rows = bits_b + (size_t)kChunk * (c - 1) * words;
          for (int w = staged + tid - 32; w < words; w += kHelpers) {
            uint32_t acc = 0;
#pragma unroll
            for (int r = 0; r < kChunk; ++r) {
              acc |= __ldg(rows + (size_t)r * words + w) & (0u - ((kept >> r) & 1u));
            }
            if (acc) atomicOr(&removed[w], acc);
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" int dafne_suppression_bits(
    const float* corners, const int* classes, uint32_t* out, int batch, int n,
    float iou_threshold, float eps, void* stream) {
  const dim3 grid(n / kTile, n / kStrip, batch);
  suppression_bits_kernel<<<grid, K1Block::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      corners, classes, out, n, iou_threshold, eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dafne_suppression_bits_2d(
    const float* corners, const int* classes, uint32_t* out, int batch, int n,
    float iou_threshold, float eps, void* stream) {
  const int tiles = n / kTile2;
  const dim3 grid(tiles * (tiles + 1) / 2, batch);
  suppression_bits_2d_kernel<<<grid, K2Block::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      corners, classes, out, n, iou_threshold, eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dafne_greedy_keep_bits(
    const uint32_t* bits, const uint8_t* keep_init, uint8_t* keep, int batch, int n,
    void* stream) {
  // above 48 KB of dynamic shared memory needs an opt-in, a per-device
  // attribute of each kernel: set it once per device, for the largest N
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted_in[dev]) {
    const void* kernels[] = {reinterpret_cast<const void*>(greedy_keep_bits_kernel<false>),
                             reinterpret_cast<const void*>(greedy_keep_bits_kernel<true>)};
    for (const void* k : kernels) {
      err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kGreedyMaxSmem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    opted_in[dev] = true;
  }
  const int smem = kRingBytes + (n / 32) * static_cast<int>(sizeof(uint32_t));
  const auto kernel =
      n / 32 > kRingWords ? greedy_keep_bits_kernel<true> : greedy_keep_bits_kernel<false>;
  kernel<<<batch, kGreedyThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      bits, keep_init, keep, n);
  return static_cast<int>(cudaGetLastError());
}
