// Ground pass of the semantic camera: nearest-centerline Frenet search and
// the 13-class road ladder.
//
// Replaces: carla_ppo_tpu/ops/rasterizer_pallas.py:render_batch_pallas_v5
// (kernel body _make_kernel_v5, layout _stripe_layout_v5, prep
// _prep_windows). Same inputs and output contract: per-env camera-rotated
// window columns win_cols [B, K0, 8] (x, y in columns 0, 1), the payload
// [B, 8, K0] (fx, fy, c_lat, c_along, kidx, lw, rw, 0), the static ray slab
// [2, ground_px] and the stripe plan; output [B, H*W] int32 class ids in
// natural pixel order, sky prefix = 0 (SegClass.NONE).
//
// What bounds it on an H100: arithmetic. Each ground pixel scans the K
// (24..128) waypoints of its row stripe: 327,680 squared distances per
// 80x160 env. The pixels of a row share the forward ray, so dx * dx is one
// value per (row, waypoint) and each distance needs a sub, mul, add and a
// min: ~1.6 G float instructions per 1024-env frame batch with the tail,
// against 61 MB of input and int32 output, so instruction issue binds
// before HBM (3.35 TB/s). Under -fmad=false the compiler fuses no multiply
// and add (the one explicit fmaf, in py_mod, makes a remainder exact): one
// instruction per lane-cycle, half the data sheet's 67 TFLOP/s, ~33.5 T/s
// (~0.048 ms).
//
// Design: one block per env; the env's window (interleaved x, y and the 7
// payload rows, ~10 KB) is staged once in shared memory. The scan is the
// register-tiled loop of ground_common.cuh: a warp owns 32 x 4 pixels of
// one stripe, each broadcast 8-byte waypoint load feeds 4 distance
// evaluations, and nothing in the k loop touches global memory. The
// running minimum uses a strict `<` in ascending k, which is the
// first-match argmin tie-break of the TPU kernel's
// min(where(d2 == d2_min, k, K)). The payload is fetched by direct indexed
// load (exact f32; the TPU kernel's one-hot product must be exact too).
// Built with -fmad=false so every multiply-add rounds as two operations,
// exactly as the plain PyTorch version (one op per kernel) does on the card.
//
// The same kernel also stands in for the TPU package's other ground-pass
// variants, which compute this function under other Mosaic layouts:
// render_batch_pallas_v4 (stripe-packed output, any camera),
// render_batch_pallas_v3d (all stripes in one call, per-env banked tracks)
// and render_batch_pallas_v3c (one call per stripe, any batch size). One
// block per env over all H*W pixels takes any stripe plan, any camera and
// any B, and only the prep reads the (shared or banked) track.
#include "ground_common.cuh"

namespace {

using ground::kMaxStripes;
using ground::kMaxWindow;
using ground::kThreads;

__global__ void __launch_bounds__(kThreads)
ground_pass_kernel(const float* __restrict__ win_cols,
                   const float* __restrict__ payload,
                   const float* __restrict__ slab,
                   const int* __restrict__ stripes, int n_stripes, int sky_px,
                   int ground_px, int hw, int K0, ground::RoadStyle st,
                   int* __restrict__ out) {
  __shared__ ground::Window w;

  const int b = blockIdx.x;
  const float* win = win_cols + static_cast<size_t>(b) * K0 * 8;
  const float* pay = payload + static_cast<size_t>(b) * 8 * K0;
  for (int i = threadIdx.x; i < K0; i += blockDim.x) {
    w.xy[i] = make_float2(win[i * 8 + 0], win[i * 8 + 1]);
#pragma unroll
    for (int c = 0; c < 7; ++c) w.pay[c][i] = pay[c * K0 + i];
  }
  ground::stage_stripes(w, stripes, n_stripes);
  __syncthreads();
  ground::shade_pixels(w, n_stripes, slab, sky_px, ground_px, st,
                       out + static_cast<size_t>(b) * hw);
}

}  // namespace

extern "C" int launch_ground_pass(const void* win_cols, const void* payload,
                                  const void* slab, const void* stripes,
                                  int n_stripes, int sky_px, int ground_px,
                                  int hw, int batch, int K0, float edge_half,
                                  float center_half, float dash_period,
                                  float dash_len, float shoulder, float sidewalk,
                                  float sidewalk_outer, float corridor_margin,
                                  void* out, void* stream) {
  if (K0 < 1 || K0 > kMaxWindow || n_stripes > kMaxStripes || n_stripes < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  const ground::RoadStyle st{edge_half, center_half,    dash_period,
                             dash_len,  shoulder,       sidewalk,
                             sidewalk_outer, corridor_margin, 1.0f / dash_period};
  ground_pass_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(win_cols), static_cast<const float*>(payload),
      static_cast<const float*>(slab), static_cast<const int*>(stripes),
      n_stripes, sky_px, ground_px, hw, K0, st, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
