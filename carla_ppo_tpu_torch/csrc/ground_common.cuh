// Shared body of the camera's two ground-pass kernels (ground_pass.cu,
// ground_pass_pose.cu): the 13-class road ladder and the per-pixel
// nearest-waypoint loop over one env's camera-rotated window, staged in
// shared memory by the including kernel.
//
// Port of carla_ppo_tpu/ops/rasterizer_pallas.py: _classify_block and the
// stripe loop of _make_kernel_v5 / _make_kernel_v6. Both kernels are built
// with -fmad=false, so every multiply and add rounds on its own, as the
// plain PyTorch version (one operation per launch) does on the card.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace ground {

constexpr int kMaxWindow = 256;
constexpr int kMaxStripes = 64;
constexpr int kThreads = 256;

struct RoadStyle {
  float edge_half;        // edge_line_width / 2
  float center_half;      // center_line_half_width
  float dash_period;      // center_dash_period
  float dash_len;         // center_dash_period * center_dash_duty
  float shoulder;         // shoulder_width
  float sidewalk;         // sidewalk_width
  float sidewalk_outer;   // shoulder_width + sidewalk_width
  float corridor_margin;  // 25 m beyond the widest band
};

// One env's rotated window in shared memory: x, y and the 7 payload rows
// (fx, fy, c_lat, c_along, kidx, lw, rw), plus the stripe plan.
struct Window {
  float wx[kMaxWindow];
  float wy[kMaxWindow];
  float pay[7][kMaxWindow];
  int stripe[kMaxStripes * 3];
};

// Python-style modulo (result takes the divisor's sign), as jnp.mod and
// torch.remainder compute it.
__device__ __forceinline__ float py_mod(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m += b;
  return m;
}

__device__ __forceinline__ int classify(float lat, float s, float dist, float lw,
                                        float rw, const RoadStyle& st) {
  const bool on_road = (lat >= -rw) && (lat <= lw);
  const bool edge_line =
      (fabsf(lat - lw) <= st.edge_half) || (fabsf(lat + rw) <= st.edge_half);
  const bool dash_on = py_mod(s, st.dash_period) < st.dash_len;
  const float road_center = (lw - rw) / 2.0f;
  const bool center_line = (fabsf(lat - road_center) <= st.center_half) && dash_on;
  const float off = fmaxf(lat - lw, -rw - lat);
  const bool shoulder = (off > 0.0f) && (off <= st.shoulder);
  const bool sidewalk = (off > st.shoulder) && (off <= st.sidewalk_outer);
  const float widest = fmaxf(lw, rw);
  const bool corridor =
      dist <= ((widest + st.shoulder) + st.sidewalk) + st.corridor_margin;
  int cls = 9;                           // VEGETATION
  if (sidewalk) cls = 8;                 // SIDEWALKS
  if (shoulder) cls = 3;                 // OTHER
  if (on_road) cls = 7;                  // ROADS
  if (on_road && center_line) cls = 6;   // ROADLINES
  if (edge_line) cls = 6;                // ROADLINES
  if (!corridor) cls = 9;                // VEGETATION
  return cls;
}

// Copy the stripe plan (K, offset, P rows) into shared memory.
__device__ __forceinline__ void stage_stripes(Window& w, const int* stripes,
                                              int n_stripes) {
  for (int i = threadIdx.x; i < n_stripes * 3; i += blockDim.x) {
    w.stripe[i] = stripes[i];
  }
}

// Every pixel of one env's frame, after __syncthreads(): the sky prefix is
// class 0; a ground pixel scans the K waypoints of its row stripe with a
// strict `<` (the first-match argmin), fetches the winner's payload and
// runs the ladder. dst: the env's [hw] output row.
__device__ __forceinline__ void shade_pixels(const Window& w, int n_stripes,
                                             const float* __restrict__ slab,
                                             int sky_px, int ground_px, int hw,
                                             const RoadStyle& st,
                                             int* __restrict__ dst) {
  for (int q = threadIdx.x; q < hw; q += blockDim.x) {
    if (q < sky_px) {
      dst[q] = 0;  // SegClass.NONE
      continue;
    }
    const int p = q - sky_px;
    // Stripe rows are (K, offset, P), offsets ascending.
    int K = w.stripe[0];
    for (int si = 1; si < n_stripes; ++si) {
      if (p >= w.stripe[si * 3 + 1]) K = w.stripe[si * 3];
    }
    const float a = slab[p];
    const float bb = slab[ground_px + p];
    float dx = a - w.wx[0];
    float dy = bb - w.wy[0];
    float best = dx * dx + dy * dy;
    int bi = 0;
    for (int k = 1; k < K; ++k) {
      dx = a - w.wx[k];
      dy = bb - w.wy[k];
      const float d2 = dx * dx + dy * dy;
      if (d2 < best) {
        best = d2;
        bi = k;
      }
    }
    const float fx = w.pay[0][bi];
    const float fy = w.pay[1][bi];
    const float lat = bb * fx - a * fy + w.pay[2][bi];
    const float s = w.pay[4][bi] + a * fx + bb * fy + w.pay[3][bi];
    const float dist = sqrtf(fmaxf(best, 0.0f));
    dst[q] = classify(lat, s, dist, w.pay[5][bi], w.pay[6][bi], st);
  }
}

}  // namespace ground
