// Shared body of the camera's two ground-pass kernels (ground_pass.cu,
// ground_pass_pose.cu): the 13-class road ladder and the nearest-waypoint
// scan over one env's camera-rotated window, staged in shared memory by
// the including kernel.
//
// Port of carla_ppo_tpu/ops/rasterizer_pallas.py: _classify_block and the
// stripe loop of _make_kernel_v5 / _make_kernel_v6. Both kernels are built
// with -fmad=false, so every multiply and add rounds on its own, as the
// plain PyTorch version (one operation per launch) does on the card. The
// one explicit fmaf (py_mod) is there for exactness, not speed: it makes a
// remainder exact, as fmodf's is.
//
// What bounds it: instruction issue. A distance evaluation is 5 float
// operations (sub, sub, mul, mul, add) and its share of the argmin; a
// strict-`<` running argmin spends a compare and two selects on each. The
// design cuts both:
// - Register tiles. A warp owns a tile of 32 x kPixelsPerThread
//   consecutive pixels of ONE stripe (no warp runs two values of K, no
//   pixel looks its stripe up); each thread keeps its pixels' rays and
//   minima in registers, and one broadcast 8-byte shared load of an
//   interleaved (x, y) waypoint feeds all its pixels. Tiles are dealt to
//   warps round-robin in stripe order.
// - Row-shared rays. On a rigid camera a pixel's forward ray component is
//   its row's depth, so a thread's 4 pixels of one row share dx * dx: 3
//   float operations per evaluation instead of 5. Taken when every lane's
//   pixels share it (checked on the data, bit for bit), else the general
//   scan.
// - Grouped argmin. The running minimum is taken over groups of 4
//   waypoints (3 fminf), with one compare and two selects per group, and
//   the first match inside the winning group is recovered at the end.
// - The ladder's Python modulo without fmodf's reduction loop (py_mod).
// The sky prefix is a separate 16-byte zero store.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ground {

constexpr int kMaxWindow = 256;
constexpr int kMaxStripes = 64;
constexpr int kThreads = 256;
constexpr int kPixelsPerThread = 4;
constexpr int kTilePx = 32 * kPixelsPerThread;

struct RoadStyle {
  float edge_half;        // edge_line_width / 2
  float center_half;      // center_line_half_width
  float dash_period;      // center_dash_period
  float dash_len;         // center_dash_period * center_dash_duty
  float shoulder;         // shoulder_width
  float sidewalk;         // sidewalk_width
  float sidewalk_outer;   // shoulder_width + sidewalk_width
  float corridor_margin;  // 25 m beyond the widest band
  float inv_dash_period;  // 1 / dash_period, rounded once on the host
};

// One env's rotated window in shared memory: interleaved (x, y) and the 7
// payload rows (fx, fy, c_lat, c_along, kidx, lw, rw), plus the stripe plan.
struct Window {
  float2 xy[kMaxWindow];
  float pay[7][kMaxWindow];
  int stripe[kMaxStripes * 3];
};

// Python-style modulo (result takes the divisor's sign), as jnp.mod and
// torch.remainder compute it: fmodf, then + b where the signs differ.
// fmodf is exact but runs a reduction loop on the card. For b > 0 and
// |a| < 2^22 b, the truncated quotient is taken from a * inv_b (1 / b
// rounded; off by at most one), corrected by the sign of the remainder
// fmaf(-q, b, a), and the remainder of the right quotient is exact: fmodf's
// value (up to the sign of a zero, which the caller's compare ignores).
__device__ __forceinline__ float py_mod(float a, float b, float inv_b) {
  float m;
  if (b > 0.0f && fabsf(a) < 4194304.0f * b) {
    const float dir = a >= 0.0f ? 1.0f : -1.0f;  // the sign m must take
    float q = truncf(a * inv_b);
    m = fmaf(-q, b, a);
    if (m * dir < 0.0f) {
      q -= dir;
      m = fmaf(-q, b, a);
    } else if (m * dir >= b) {
      q += dir;
      m = fmaf(-q, b, a);
    }
  } else {
    m = fmodf(a, b);
  }
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m += b;
  return m;
}

__device__ __forceinline__ int classify(float lat, float s, float dist, float lw,
                                        float rw, const RoadStyle& st) {
  const bool on_road = (lat >= -rw) && (lat <= lw);
  const bool edge_line =
      (fabsf(lat - lw) <= st.edge_half) || (fabsf(lat + rw) <= st.edge_half);
  const bool dash_on = py_mod(s, st.dash_period, st.inv_dash_period) < st.dash_len;
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

// Class 0 (SegClass.NONE) over dst[0, sky_px): 16-byte stores over the
// aligned middle, scalar stores at the edges.
__device__ __forceinline__ void zero_sky(int* __restrict__ dst, int sky_px) {
  const int head =
      min(sky_px, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) / 4);
  const int n4 = (sky_px - head) / 4;
  int4* dst4 = reinterpret_cast<int4*>(dst + head);
  for (int i = threadIdx.x; i < n4; i += blockDim.x) dst4[i] = make_int4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < head; i += blockDim.x) dst[i] = 0;
  for (int i = head + 4 * n4 + threadIdx.x; i < sky_px; i += blockDim.x) dst[i] = 0;
}

// Squared distance from the ray (a, b) to waypoint wk, rounded operation by
// operation as the plain version's dx * dx + dy * dy; dxx stands in for
// dx * dx when kRowShared.
template <bool kRowShared>
__device__ __forceinline__ float dist2(float a, float b, float2 wk, float dxx) {
  const float dx = a - wk.x;
  const float dy = b - wk.y;
  return (kRowShared ? dxx : dx * dx) + dy * dy;
}

// Nearest waypoint of each of a thread's pixels (rays a, bb) among the
// first K of the window, and its d2: the first k whose d2 equals the
// minimum (the plain version's first-match argmin). The scan takes the
// waypoints in groups of 4: a group's minimum (fminf returns one of its
// inputs, so it is an exact d2) replaces the running minimum only when it
// is strictly smaller, so the group kept is the first that holds the
// minimum; the first k in it whose recomputed d2 equals the minimum is the
// pick. That is one compare and two selects per 4 waypoints where a
// running argmin spends them on every waypoint. The last K % 4 waypoints
// are groups of one. kRowShared: all a[i] are equal (pixels of one row),
// so dx * dx is one value per waypoint for the thread, computed once.
template <bool kRowShared>
__device__ __forceinline__ void nearest(const Window& w, int K,
                                        const float (&a)[kPixelsPerThread],
                                        const float (&bb)[kPixelsPerThread],
                                        float (&best)[kPixelsPerThread],
                                        int (&bi)[kPixelsPerThread]) {
  int grp[kPixelsPerThread];  // first k of the group that holds the minimum
#pragma unroll
  for (int i = 0; i < kPixelsPerThread; ++i) {
    best[i] = INFINITY;
    grp[i] = 0;
  }
  const int K4 = K & ~3;
  for (int k = 0; k < K4; k += 4) {
    float2 wk[4];
    float dxx[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wk[j] = w.xy[k + j];
      const float dx = a[0] - wk[j].x;
      dxx[j] = dx * dx;
    }
#pragma unroll
    for (int i = 0; i < kPixelsPerThread; ++i) {
      const float m = fminf(fminf(dist2<kRowShared>(a[i], bb[i], wk[0], dxx[0]),
                                  dist2<kRowShared>(a[i], bb[i], wk[1], dxx[1])),
                            fminf(dist2<kRowShared>(a[i], bb[i], wk[2], dxx[2]),
                                  dist2<kRowShared>(a[i], bb[i], wk[3], dxx[3])));
      if (m < best[i]) {
        best[i] = m;
        grp[i] = k;
      }
    }
  }
  for (int k = K4; k < K; ++k) {
    const float2 wk = w.xy[k];
    const float dx = a[0] - wk.x;
    const float dxx = dx * dx;
#pragma unroll
    for (int i = 0; i < kPixelsPerThread; ++i) {
      const float d2 = dist2<kRowShared>(a[i], bb[i], wk, dxx);
      if (d2 < best[i]) {
        best[i] = d2;
        grp[i] = k;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPixelsPerThread; ++i) {
    const int size = grp[i] < K4 ? 4 : 1;
    int pick = grp[i];
#pragma unroll
    for (int j = 3; j >= 0; --j) {
      if (j < size) {
        const float2 wk = w.xy[grp[i] + j];
        const float dx = a[i] - wk.x;
        if (dist2<kRowShared>(a[i], bb[i], wk, dx * dx) == best[i]) pick = grp[i] + j;
      }
    }
    bi[i] = pick;
  }
}

// One warp's tile: ground pixels p0 + kPixelsPerThread * lane + i of a
// stripe that ends at p_end, scanned over the stripe's K waypoints; then
// each pixel's payload fetch and ladder. Lanes past p_end scan the
// stripe's last pixel and store nothing. A thread's pixels are
// consecutive, so on a rigid camera (a = the row's depth) they share a;
// the warp takes the row-shared scan when every lane's pixels do.
__device__ __forceinline__ void shade_tile(const Window& w, int K, int p0, int p_end,
                                           const float* __restrict__ slab, int ground_px,
                                           const RoadStyle& st, int* __restrict__ dst) {
  const int q0 = p0 + kPixelsPerThread * (threadIdx.x & 31);
  float a[kPixelsPerThread], bb[kPixelsPerThread], best[kPixelsPerThread];
  int bi[kPixelsPerThread];
  bool row_shared = true;
#pragma unroll
  for (int i = 0; i < kPixelsPerThread; ++i) {
    const int p = min(q0 + i, p_end - 1);
    a[i] = slab[p];
    bb[i] = slab[ground_px + p];
    row_shared = row_shared && __float_as_int(a[i]) == __float_as_int(a[0]);
  }
  if (__all_sync(0xffffffffu, row_shared)) {
    nearest<true>(w, K, a, bb, best, bi);
  } else {
    nearest<false>(w, K, a, bb, best, bi);
  }
#pragma unroll
  for (int i = 0; i < kPixelsPerThread; ++i) {
    const int p = q0 + i;
    if (p < p_end) {
      const int k = bi[i];
      const float fx = w.pay[0][k];
      const float fy = w.pay[1][k];
      const float lat = bb[i] * fx - a[i] * fy + w.pay[2][k];
      const float s = w.pay[4][k] + a[i] * fx + bb[i] * fy + w.pay[3][k];
      const float dist = sqrtf(fmaxf(best[i], 0.0f));
      dst[p] = classify(lat, s, dist, w.pay[5][k], w.pay[6][k], st);
    }
  }
}

// Every pixel of one env's frame, after __syncthreads(): the sky prefix is
// class 0; the ground pixels of each stripe (plan rows (K, offset, P),
// offsets ascending) are cut into tiles of kTilePx, numbered over all
// stripes in order, and warp j shades tiles j, j + n_warps, ...
// dst: the env's [sky_px + ground_px] output row.
__device__ __forceinline__ void shade_pixels(const Window& w, int n_stripes,
                                             const float* __restrict__ slab,
                                             int sky_px, int ground_px,
                                             const RoadStyle& st,
                                             int* __restrict__ dst) {
  zero_sky(dst, sky_px);
  const int n_warps = blockDim.x >> 5;
  int t = threadIdx.x >> 5;  // this warp's next tile
  int first = 0;             // the current stripe's first tile
  for (int si = 0; si < n_stripes; ++si) {
    const int K = w.stripe[si * 3];
    const int off = w.stripe[si * 3 + 1];
    const int P = w.stripe[si * 3 + 2];
    const int n_tiles = (P + kTilePx - 1) / kTilePx;
    for (; t < first + n_tiles; t += n_warps) {
      shade_tile(w, K, off + (t - first) * kTilePx, off + P, slab, ground_px, st,
                 dst + sky_px);
    }
    first += n_tiles;
  }
}

}  // namespace ground
