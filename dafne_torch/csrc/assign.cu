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
// What bounds it on the H100: f32 arithmetic, not memory.  A (location, gt)
// pair whose value can be finite needs ~55 f32 operations (OPS_PER_PAIR in
// ops/kernels/assign.py), while the bytes are 20 per location and 53 per
// gt, each read once, and 8 written per location.  But with the recipe's
// flags (center sampling combined with point-in-quad, the in-box check on)
// a pair can only win where the location lies strictly inside the gt's
// hbox clipped to its center +- POS_RADIUS x stride, a few strides wide:
// a block of 128 consecutive locations (a row of P3, a 1024 x 8 px band at
// 1024^2) meets a few of an image's gts.  And there the location lies
// inside the hbox, so its max-ltrb is at most the hbox's extent: with the
// level filter on, a gt smaller than the block's lowest size range wins
// nowhere in it (the coarse levels' blocks, whose boxes span the image,
// keep only the large gts).  The first design (one thread per location,
// every valid gt of the image in turn) paid the full pair body for all of
// them, and its time went to the longest serial loop.
//
// The design: one thread per location, a grid over (location blocks,
// images), 128 locations a block (against 256: 2-12% less device time,
// PERF.md).  A block first reduces the bounding box of its live locations,
// their largest radius (stride x radius) and their lowest size range.
// Then, kThreads gt slots at a time, each thread tests one slot: valid,
// and, where the flags make in_center necessary, its clipped center box,
// formed with the pair body's own f32 expressions at the block's largest
// radius, meets the block's box strictly, and (with the level filter) its
// hbox's extent reaches the block's lowest range.  A block-wide scan lists
// the kept slots in shared memory in ascending m, with their corners, hbox
// and area, and every thread runs the pair body over the list with a
// strict < running minimum, which keeps the first index on ties.
//
// Why the cull is exact: for finite floats x - xmin > 0 iff x > xmin, and a
// smaller radius only shrinks the clipped box (cx - rad and cx + rad are
// monotone in rad under rounding), so a gt whose box misses the block's box
// fails in_center at every location of the block; its value is INF, which
// never beats the running minimum.  (A NaN in a box keeps the gt: the test
// is written as the negation of "misses".)  Without center sampling
// in_center is "strictly inside the hbox", the same test with the hbox.
// Either way in_center puts x strictly between hb0 and hb2, so x - hb0 and
// hb2 - x round to at most hb2 - hb0 (rounding is monotone), and the same
// in y: max-ltrb <= max(hb2 - hb0, hb3 - hb1), and a gt whose extent is
// below every lo of the block fails the level filter at each location.
// Under flags where in_center does not decide (the in-box check off, or
// point-in-quad alone) every valid gt is listed: the same kernel, uncut.
//
// The op order is that of assign_argmin_plain in
// dafne_torch/ops/kernels/assign.py (itself the Pallas kernel's) and the
// file is compiled with -fmad=false, so min_area and argmin are bit-equal
// to the plain version.  gt_lists in the same file is the plain form of the
// cull.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // locations per block, and gt slots tested per pass
constexpr int kWarps = kThreads / 32;
constexpr float kInf = 100000000.0f;
constexpr unsigned kFull = 0xffffffffu;

enum Flags : int {
  kCenterSample = 1,
  kCenterSampleOnly = 2,
  kCombineCenterSample = 4,
  kInBoxCheck = 8,
  kLevelFilter = 16,
};

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

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
  __shared__ float s_cor[8][kThreads];
  __shared__ float s_hb[4][kThreads];
  __shared__ float s_area[kThreads];
  __shared__ int s_idx[kThreads];
  __shared__ float s_box[6][kWarps];
  __shared__ int warp_total[kWarps];

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int k = blockIdx.x * kThreads + tid;
  const bool live = k < n_loc;  // the tail threads test and stage gts but write nothing
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
  // a pair can be finite only where in_center holds
  const bool cull = in_box_check && (center_only || combine);

  // the block's box: the extremes of its live locations, its largest
  // radius and its lowest size range
  const float inf = __int_as_float(0x7f800000);
  const float box[6] = {warp_min(live ? x : inf), warp_max(live ? x : -inf),
                        warp_min(live ? y : inf), warp_max(live ? y : -inf),
                        warp_max(live ? rad : -inf), warp_min(live ? lo : inf)};
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 6; ++c) s_box[c][warp] = box[c];
  }
  __syncthreads();
  float x_lo = inf, x_hi = -inf, y_lo = inf, y_hi = -inf, rad_hi = -inf, lo_min = inf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    x_lo = fminf(x_lo, s_box[0][w]);
    x_hi = fmaxf(x_hi, s_box[1][w]);
    y_lo = fminf(y_lo, s_box[2][w]);
    y_hi = fmaxf(y_hi, s_box[3][w]);
    rad_hi = fmaxf(rad_hi, s_box[4][w]);
    lo_min = fminf(lo_min, s_box[5][w]);
  }

  const float* cor_b = corners + (size_t)b * n_gt * 8;
  const float* hb_b = hbox + (size_t)b * n_gt * 4;
  const float* area_b = area + (size_t)b * n_gt;
  const uint8_t* valid_b = valid + (size_t)b * n_gt;

  float best = kInf;
  int best_idx = 0;
  for (int m0 = 0; m0 < n_gt; m0 += kThreads) {
    // test slot m: valid, and its clipped center box meets the block's box
    const int m = m0 + tid;
    bool keep = m < n_gt && valid_b[m];
    float hb[4];
    if (keep) {
#pragma unroll
      for (int c = 0; c < 4; ++c) hb[c] = hb_b[(size_t)m * 4 + c];
      if (cull) {
        float xmin = hb[0], ymin = hb[1], xmax = hb[2], ymax = hb[3];
        if (center_sample) {  // the pair body's expressions, at rad_hi
          const float cx = 0.5f * (hb[0] + hb[2]);
          const float cy = 0.5f * (hb[1] + hb[3]);
          xmin = fmaxf(cx - rad_hi, hb[0]);
          ymin = fmaxf(cy - rad_hi, hb[1]);
          xmax = fminf(cx + rad_hi, hb[2]);
          ymax = fminf(cy + rad_hi, hb[3]);
        }
        keep = !(xmin >= x_hi || xmax <= x_lo || ymin >= y_hi || ymax <= y_lo);
        if (level_filter) keep = keep && !(fmaxf(hb[2] - hb[0], hb[3] - hb[1]) < lo_min);
      }
    }
    // block-wide exclusive scan of the kept slots, in ascending m
    const unsigned kept = __ballot_sync(kFull, keep);
    __syncthreads();  // the previous pass's list is no longer read
    if (lane == 0) warp_total[warp] = __popc(kept);
    __syncthreads();
    int offset = __popc(kept & ((1u << lane) - 1u));
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int t = warp_total[w];
      offset += w < warp ? t : 0;
      total += t;
    }
    if (keep) {
#pragma unroll
      for (int c = 0; c < 8; ++c) s_cor[c][offset] = cor_b[(size_t)m * 8 + c];
#pragma unroll
      for (int c = 0; c < 4; ++c) s_hb[c][offset] = hb[c];
      s_area[offset] = area_b[m];
      s_idx[offset] = m;
    }
    __syncthreads();
    for (int t = 0; t < total; ++t) {
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
        best_idx = s_idx[t];
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
