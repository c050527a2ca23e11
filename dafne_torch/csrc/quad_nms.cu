// Rotated-quad NMS kernels for Hopper (sm_90a): the suppression matrix (a
// strip kernel for class-major input, a 2-D tiled one for any score order)
// and the exact greedy keep-set.  Built by dafne_torch/ops/kernels/build.py with
// nvcc into a shared library with a plain C interface, loaded with ctypes.
//
// 1. dafne_suppression_matrix replaces the Pallas strip kernel
//    dafne_tpu/ops/pallas/quad_nms.py:_suppress_strip_kernel (reached through
//    suppression_matrix(..., class_major=True)).
//    S[b, i, j] = 1 iff j > i, classes[b, i] == classes[b, j] >= 0 and the
//    exact quad IoU (Cyrus–Beck clipped edge integrals) > threshold.
//    What bounds it on the H100: f32 arithmetic.  Each visited pair costs
//    ~1.2k f32 operations (8 clipped edge integrals) against 8 bytes of S
//    traffic, far above the card's ~20 f32 operations per byte, so the
//    kernel is bound by the FP32 pipes, not memory.  This first design does
//    only the pairs that can be nonzero: candidates arrive class-major, so
//    each 64-row strip's same-class columns form one span (computed by the
//    wrapper); a block is one (strip, 128-column block) pair and blocks
//    outside the strip's span exit at once, leaving the zeros the wrapper
//    allocated.  Corners, classes and areas are staged in shared memory; one
//    thread computes 32 pairs.  No tensor-core path exists for this math.
//    The op order is that of the plain PyTorch version and the file is
//    compiled with -fmad=false, so S is bit-equal to it.
//
// 2. dafne_suppression_matrix_2d replaces the Pallas 2-D tiled kernel
//    dafne_tpu/ops/pallas/quad_nms.py:_suppress_kernel (reached through
//    suppression_matrix(..., class_major=False), impl="pallas-2d"): the same
//    S over a grid of 128 x 128 tiles, for candidates in any order that is
//    score-descending within a class.  What bounds it: the f32 IoU work of
//    the pairs it visits, as for 1.  A tile below the diagonal returns before
//    it loads anything; a tile whose row and column class sets do not
//    intersect (classes >= 0 only: the port pads rows and columns alike with
//    -1) returns after loading 2 x 128 classes; an interacting tile runs the
//    pair test of 1 on every pair, and the IoU on the same-class pairs j > i
//    (pair_suppresses, shared with 1, so S is bit-equal to the plain version
//    too).  So the IoU work equals 1's, and what the score order costs is the
//    warps whose 32 columns hold a same-class pair for some lanes only (a
//    warp pays for its slowest lane).  Zeros are the wrapper's, as for 1.
//
// 3. dafne_greedy_keep replaces greedy_scan + _jacobi_fixed_point of the same
//    file (XLA, not Pallas): the exact greedy keep-set over S in score
//    order.  What bounds it: latency.  The walk is sequential over rows; a
//    kept row reads its (N - i - 1) upper-triangle bytes of S and pays one
//    __syncthreads(), a suppressed row costs one shared-memory read.  This
//    first design is the poly_nms_gpu-style walk: one block of 1024 threads
//    per image, alive flags in shared memory, rows in order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStrip = 64;    // rows per strip (as the Pallas kernel)
constexpr int kTile = 128;    // columns per block
constexpr int kThreads = 256;

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

// grid (N / kTile, N / kStrip, B), block kThreads.
// corners [B, N, 8] f32 CCW; classes [B, N] i32 (< 0: invalid or padding);
// span [B, N / kStrip, 2] i32 = [lo, hi) column-block range of each strip;
// out [B, N, N] int8, zero-filled by the caller.
__global__ void __launch_bounds__(kThreads) suppression_kernel(
    const float* __restrict__ corners, const int* __restrict__ classes,
    const int* __restrict__ span, int8_t* __restrict__ out, int n,
    float iou_threshold, float eps) {
  const int cb = blockIdx.x;
  const int strip = blockIdx.y;
  const int b = blockIdx.z;
  const int n_strips = n / kStrip;
  const int lo = span[(b * n_strips + strip) * 2];
  const int hi = span[(b * n_strips + strip) * 2 + 1];
  if (cb < lo || cb >= hi) return;

  __shared__ float rx[4][kStrip], ry[4][kStrip], ra[kStrip];
  __shared__ float cx[4][kTile], cy[4][kTile], ca[kTile];
  __shared__ int rc[kStrip], cc[kTile];

  const int r0 = strip * kStrip;
  const int c0 = cb * kTile;
  const float* cor = corners + (size_t)b * n * 8;
  const int* cls = classes + (size_t)b * n;
  const int tid = threadIdx.x;
  if (tid < kStrip) {
    stage_quad(cor, r0 + tid, rx, ry, ra, tid);
    rc[tid] = cls[r0 + tid];
  } else if (tid < kStrip + kTile) {
    const int t = tid - kStrip;
    stage_quad(cor, c0 + t, cx, cy, ca, t);
    cc[t] = cls[c0 + t];
  }
  __syncthreads();

  const int c = tid % kTile;
  const float qx[4] = {cx[0][c], cx[1][c], cx[2][c], cx[3][c]};
  const float qy[4] = {cy[0][c], cy[1][c], cy[2][c], cy[3][c]};
  const float qa = ca[c];
  const int qc = cc[c];
  int8_t* out_b = out + (size_t)b * n * n;
  for (int r = tid / kTile; r < kStrip; r += kThreads / kTile) {
    const int i = r0 + r;
    const int j = c0 + c;
    int8_t s = 0;
    if (j > i && qc >= 0 && rc[r] == qc) {
      const float px[4] = {rx[0][r], rx[1][r], rx[2][r], rx[3][r]};
      const float py[4] = {ry[0][r], ry[1][r], ry[2][r], ry[3][r]};
      s = pair_suppresses(px, py, ra[r], qx, qy, qa, iou_threshold, eps) ? 1 : 0;
    }
    if (s) out_b[(size_t)i * n + j] = 1;
  }
}

// grid (N / kTile column tiles, N / kTile row tiles, B), block kThreads.
// corners [B, N, 8] f32 CCW; classes [B, N] i32 (< 0: invalid or padding);
// out [B, N, N] int8, zero-filled by the caller.
__global__ void __launch_bounds__(kThreads) suppression_2d_kernel(
    const float* __restrict__ corners, const int* __restrict__ classes,
    int8_t* __restrict__ out, int n, float iou_threshold, float eps) {
  const int ct = blockIdx.x;
  const int rt = blockIdx.y;
  const int b = blockIdx.z;
  if (ct < rt) return;  // below the diagonal only j < i: S is zero

  __shared__ float rx[4][kTile], ry[4][kTile], ra[kTile];
  __shared__ float cx[4][kTile], cy[4][kTile], ca[kTile];
  __shared__ int rc[kTile], cc[kTile];

  const int r0 = rt * kTile;
  const int c0 = ct * kTile;
  const int* cls = classes + (size_t)b * n;
  const int tid = threadIdx.x;
  if (tid < kTile) {
    rc[tid] = cls[r0 + tid];
  } else {
    cc[tid - kTile] = cls[c0 + tid - kTile];
  }
  __syncthreads();

  // the tile interacts iff some valid row class equals some column class
  const int c = tid % kTile;
  const int qc = cc[c];
  bool hit = false;
  if (qc >= 0) {
    for (int r = tid / kTile; r < kTile; r += kThreads / kTile) hit = hit || rc[r] == qc;
  }
  if (!__syncthreads_or(hit)) return;

  const float* cor = corners + (size_t)b * n * 8;
  if (tid < kTile) {
    stage_quad(cor, r0 + tid, rx, ry, ra, tid);
  } else {
    stage_quad(cor, c0 + tid - kTile, cx, cy, ca, tid - kTile);
  }
  __syncthreads();

  const float qx[4] = {cx[0][c], cx[1][c], cx[2][c], cx[3][c]};
  const float qy[4] = {cy[0][c], cy[1][c], cy[2][c], cy[3][c]};
  const float qa = ca[c];
  int8_t* out_b = out + (size_t)b * n * n;
  for (int r = tid / kTile; r < kTile; r += kThreads / kTile) {
    const int i = r0 + r;
    const int j = c0 + c;
    if (j > i && qc >= 0 && rc[r] == qc) {
      const float px[4] = {rx[0][r], rx[1][r], rx[2][r], rx[3][r]};
      const float py[4] = {ry[0][r], ry[1][r], ry[2][r], ry[3][r]};
      if (pair_suppresses(px, py, ra[r], qx, qy, qa, iou_threshold, eps)) {
        out_b[(size_t)i * n + j] = 1;
      }
    }
  }
}

constexpr int kGreedyThreads = 1024;

// grid (B,), block kGreedyThreads, dynamic shared memory n bytes.
// s [B, N, N] int8; keep_init / keep [B, N] uint8 (0/1).
__global__ void __launch_bounds__(kGreedyThreads) greedy_keep_kernel(
    const int8_t* __restrict__ s, const uint8_t* __restrict__ keep_init,
    uint8_t* __restrict__ keep, int n) {
  extern __shared__ uint8_t alive[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int8_t* sb = s + (size_t)b * n * n;
  for (int j = tid; j < n; j += kGreedyThreads) alive[j] = keep_init[(size_t)b * n + j];
  __syncthreads();
  for (int i = 0; i < n; ++i) {
    // every thread reads the same flag: nothing writes alive[i] after the
    // barrier that closed the last kept row before i
    if (!alive[i]) continue;
    const int8_t* row = sb + (size_t)i * n;
    for (int j = i + 1 + tid; j < n; j += kGreedyThreads) {
      if (row[j]) alive[j] = 0;
    }
    __syncthreads();
  }
  for (int j = tid; j < n; j += kGreedyThreads) keep[(size_t)b * n + j] = alive[j];
}

}  // namespace

extern "C" int dafne_suppression_matrix(
    const float* corners, const int* classes, const int* span, int8_t* out,
    int batch, int n, float iou_threshold, float eps, void* stream) {
  const dim3 grid(n / kTile, n / kStrip, batch);
  suppression_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      corners, classes, span, out, n, iou_threshold, eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dafne_suppression_matrix_2d(
    const float* corners, const int* classes, int8_t* out, int batch, int n,
    float iou_threshold, float eps, void* stream) {
  const dim3 grid(n / kTile, n / kTile, batch);
  suppression_2d_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      corners, classes, out, n, iou_threshold, eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dafne_greedy_keep(
    const int8_t* s, const uint8_t* keep_init, uint8_t* keep, int batch, int n,
    void* stream) {
  greedy_keep_kernel<<<batch, kGreedyThreads, n, static_cast<cudaStream_t>(stream)>>>(
      s, keep_init, keep, n);
  return static_cast<int>(cudaGetLastError());
}
