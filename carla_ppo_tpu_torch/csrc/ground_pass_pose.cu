// Pose-fed ground pass of the semantic camera: ground_pass.cu's function
// with the per-env window fetch and the camera rotation moved into the
// kernel.
//
// Replaces: carla_ppo_tpu/ops/rasterizer_pallas.py:render_batch_pallas_v6
// (kernel body _make_kernel_v6, prep _prep_pose_v6). Inputs: the
// wrap-baked waypoint table [M, 8] (x, y, fx, fy, lw, rw, 0, 0; row r holds
// waypoint r - window_behind, wrapped on loops and clamped on open tracks),
// each env's first table row starts [B] int32 and its pose [B, 8] (cos yaw,
// sin yaw, cam_x, cam_y, waypoint_idx - window_behind, 0, 0, 0); the static
// ray slab and stripe plan as in ground_pass.cu. Output: [B, H*W] int32,
// ground_pass.cu's output on prep_windows' windows bit for bit (the
// rotation below is prep_windows' torch arithmetic, operation by operation,
// and -fmad=false keeps each multiply and add rounded on its own).
//
// What bounds it on an H100: the same arithmetic as ground_pass.cu (the
// rotation adds ~20 float operations per window row, ~2.6 k per env, next
// to ~2 M in the pixel loop); its bytes drop from the prepped windows'
// 8 KB per env to the 4 KB of table rows it reads.
//
// Design: one block per env; the block reads its K0 table rows (no 8-row
// quantisation and no sentinel rows: those were the TPU's tiling
// constraints), rotates them into the camera frame straight into shared
// memory, and runs the pixel loop of ground_common.cuh.
#include "ground_common.cuh"

namespace {

using ground::kMaxStripes;
using ground::kMaxWindow;
using ground::kThreads;

__global__ void __launch_bounds__(kThreads)
ground_pass_pose_kernel(const int* __restrict__ starts,
                        const float* __restrict__ table, int table_rows,
                        const float* __restrict__ pose, int K0,
                        const float* __restrict__ slab,
                        const int* __restrict__ stripes, int n_stripes,
                        int sky_px, int ground_px, int hw, ground::RoadStyle st,
                        int* __restrict__ out) {
  __shared__ ground::Window w;

  const int b = blockIdx.x;
  const float* ps = pose + static_cast<size_t>(b) * 8;
  const float cy = ps[0];
  const float sy = ps[1];
  const float cam_x = ps[2];
  const float cam_y = ps[3];
  const float idx0 = ps[4];
  const int start = starts[b];
  for (int i = threadIdx.x; i < K0; i += blockDim.x) {
    const int row = min(max(start + i, 0), table_rows - 1);
    const float* t = table + static_cast<size_t>(row) * 8;
    const float wlx = t[0] - cam_x;
    const float wly = t[1] - cam_y;
    const float wpx = cy * wlx + sy * wly;
    const float wpy = -sy * wlx + cy * wly;
    const float fpx = cy * t[2] + sy * t[3];
    const float fpy = -sy * t[2] + cy * t[3];
    w.xy[i] = make_float2(wpx, wpy);
    w.pay[0][i] = fpx;
    w.pay[1][i] = fpy;
    w.pay[2][i] = fpy * wpx - fpx * wpy;
    w.pay[3][i] = -(wpx * fpx + wpy * fpy);
    w.pay[4][i] = idx0 + static_cast<float>(i);
    w.pay[5][i] = t[4];
    w.pay[6][i] = t[5];
  }
  ground::stage_stripes(w, stripes, n_stripes);
  __syncthreads();
  ground::shade_pixels(w, n_stripes, slab, sky_px, ground_px, st,
                       out + static_cast<size_t>(b) * hw);
}

}  // namespace

extern "C" int launch_ground_pass_pose(
    const void* starts, const void* table, int table_rows, const void* pose,
    int K0, const void* slab, const void* stripes, int n_stripes, int sky_px,
    int ground_px, int hw, int batch, float edge_half, float center_half,
    float dash_period, float dash_len, float shoulder, float sidewalk,
    float sidewalk_outer, float corridor_margin, void* out, void* stream) {
  if (K0 < 1 || K0 > kMaxWindow || n_stripes > kMaxStripes || n_stripes < 1 ||
      table_rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  const ground::RoadStyle st{edge_half, center_half,    dash_period,
                             dash_len,  shoulder,       sidewalk,
                             sidewalk_outer, corridor_margin, 1.0f / dash_period};
  ground_pass_pose_kernel<<<batch, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(starts), static_cast<const float*>(table),
      table_rows, static_cast<const float*>(pose), K0,
      static_cast<const float*>(slab), static_cast<const int*>(stripes),
      n_stripes, sky_px, ground_px, hw, st, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
