// Target-assignment argmin for Hopper (sm_90a).  Built by
// dafne_torch/ops/kernels/build.py with nvcc into a shared library with a
// plain C interface, loaded with ctypes.
//
// dafne_assign_argmin replaces the Pallas kernel
// dafne_tpu/ops/pallas/assign.py:_assign_kernel (reached through
// assign_argmin, called by ops/targets.py when impl="pallas").  For every
// location k of every image b and every gt m it forms the gt's area, or INF
// where the gt is invalid, fails center sampling / point-in-quad, or lies
// outside the location's FPN size range; it writes the smallest value and
// the first m that reaches it (index 0 when every value is INF).
//
// What bounds it on the H100: f32 arithmetic, not memory.  A valid
// (location, gt) pair needs ~55 f32 operations (OPS_PER_PAIR in
// ops/kernels/assign.py), while the bytes are 20 per location and 53 per gt,
// each read once, and 8 written per location, so at the training shape
// (21 824 locations x up to 256 gts x 8 images) the operations dominate.  This first design is simple: one thread per location, a
// grid over (location tiles, images), the image's gts staged through shared
// memory in tiles of kGtTile, and a running minimum over m ascending with
// strict <, which keeps the first index on ties.  Invalid gt slots are
// skipped (their INF can never beat the running minimum); the loop over m
// is uniform across the block, so the skip does not diverge.
//
// The op order is that of assign_argmin_plain in
// dafne_torch/ops/kernels/assign.py (itself the Pallas kernel's) and the
// file is compiled with -fmad=false, so min_area and argmin are bit-equal
// to the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // locations per block
constexpr int kGtTile = 256;   // gts staged in shared memory at a time
constexpr float kInf = 100000000.0f;

enum Flags : int {
  kCenterSample = 1,
  kCenterSampleOnly = 2,
  kCombineCenterSample = 4,
  kInBoxCheck = 8,
  kLevelFilter = 16,
};

// grid (ceil(K / kThreads), B), block kThreads.
// locations [K, 2], strides [K], ranges [K, 2] f32 (shared by the images);
// corners [B, M, 8], hbox [B, M, 4], area [B, M] f32; valid [B, M] uint8;
// min_area [B, K] f32, argmin [B, K] i32.
__global__ void __launch_bounds__(kThreads) assign_argmin_kernel(
    const float* __restrict__ locations, const float* __restrict__ strides,
    const float* __restrict__ ranges, const float* __restrict__ corners,
    const float* __restrict__ hbox, const float* __restrict__ area,
    const uint8_t* __restrict__ valid, float* __restrict__ min_area,
    int* __restrict__ argmin, int n_loc, int n_gt, float radius, float eps,
    int flags) {
  __shared__ float s_cor[8][kGtTile];
  __shared__ float s_hb[4][kGtTile];
  __shared__ float s_area[kGtTile];
  __shared__ uint8_t s_valid[kGtTile];

  const int b = blockIdx.y;
  const int k = blockIdx.x * kThreads + threadIdx.x;
  const bool live = k < n_loc;  // the tail threads stage gts but write nothing
  const int kk = live ? k : 0;
  const float x = locations[2 * kk];
  const float y = locations[2 * kk + 1];
  const float st = strides[kk];
  const float lo = ranges[2 * kk];
  const float hi = ranges[2 * kk + 1];
  const float rad = st * radius;

  const bool center_sample = flags & kCenterSample;
  const bool center_only = flags & kCenterSampleOnly;
  const bool combine = flags & kCombineCenterSample;
  const bool in_box_check = flags & kInBoxCheck;
  const bool level_filter = flags & kLevelFilter;

  const float* cor_b = corners + (size_t)b * n_gt * 8;
  const float* hb_b = hbox + (size_t)b * n_gt * 4;
  const float* area_b = area + (size_t)b * n_gt;
  const uint8_t* valid_b = valid + (size_t)b * n_gt;

  float best = kInf;
  int best_idx = 0;
  for (int m0 = 0; m0 < n_gt; m0 += kGtTile) {
    const int tile = min(kGtTile, n_gt - m0);
    __syncthreads();  // the previous tile is no longer read
    for (int t = threadIdx.x; t < tile; t += kThreads) {
      const int m = m0 + t;
#pragma unroll
      for (int c = 0; c < 8; ++c) s_cor[c][t] = cor_b[(size_t)m * 8 + c];
#pragma unroll
      for (int c = 0; c < 4; ++c) s_hb[c][t] = hb_b[(size_t)m * 4 + c];
      s_area[t] = area_b[m];
      s_valid[t] = valid_b[m];
    }
    __syncthreads();
    for (int t = 0; t < tile; ++t) {
      if (!s_valid[t]) continue;
      const float hb0 = s_hb[0][t], hb1 = s_hb[1][t];
      const float hb2 = s_hb[2][t], hb3 = s_hb[3][t];
      const float l = x - hb0;
      const float tt = y - hb1;
      const float r = hb2 - x;
      const float bb = hb3 - y;
      const float max_ltrb = fmaxf(fmaxf(l, r), fmaxf(tt, bb));

      bool in_center;
      if (center_sample) {
        const float cx = 0.5f * (hb0 + hb2);
        const float cy = 0.5f * (hb1 + hb3);
        const float xmin = fmaxf(cx - rad, hb0);
        const float ymin = fmaxf(cy - rad, hb1);
        const float xmax = fminf(cx + rad, hb2);
        const float ymax = fminf(cy + rad, hb3);
        in_center = fminf(fminf(x - xmin, xmax - x), fminf(y - ymin, ymax - y)) > 0.0f;
      } else {
        in_center = fminf(fminf(l, r), fminf(tt, bb)) > 0.0f;
      }

      bool is_in;
      if (center_only) {
        is_in = in_center;
      } else {
        float tri_sum = 0.0f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int c1 = (c + 1) & 3;
          const float ax = s_cor[2 * c][t], ay = s_cor[2 * c + 1][t];
          const float bx = s_cor[2 * c1][t], by = s_cor[2 * c1 + 1][t];
          tri_sum = tri_sum + 0.5f * fabsf((ax - x) * (by - y) - (ay - y) * (bx - x));
        }
        const bool in_quad = !(tri_sum > s_area[t] + eps);
        is_in = combine ? (in_center && in_quad) : in_quad;
      }

      float val = s_area[t];
      if (in_box_check && !is_in) val = kInf;
      if (level_filter && !(max_ltrb >= lo && max_ltrb <= hi)) val = kInf;
      if (val < best) {
        best = val;
        best_idx = m0 + t;
      }
    }
  }
  if (live) {
    min_area[(size_t)b * n_loc + k] = best;
    argmin[(size_t)b * n_loc + k] = best_idx;
  }
}

}  // namespace

extern "C" int dafne_assign_argmin(
    const float* locations, const float* strides, const float* ranges,
    const float* corners, const float* hbox, const float* area,
    const uint8_t* valid, float* min_area, int* argmin, int batch, int n_loc,
    int n_gt, float radius, float eps, int flags, void* stream) {
  const dim3 grid((n_loc + kThreads - 1) / kThreads, batch);
  assign_argmin_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      locations, strides, ranges, corners, hbox, area, valid, min_area, argmin,
      n_loc, n_gt, radius, eps, flags);
  return static_cast<int>(cudaGetLastError());
}
