// Billboard composite of the semantic camera: nearest roadside prop / NPC
// billboard per pixel, depth-tested against the row-static ground depth.
//
// Replaces: carla_ppo_tpu/ops/rasterizer_pallas.py:composite_billboards_pallas
// (kernel body _make_composite_kernel, prep _prep_candidates), the same
// function as the XLA _composite_billboards_flat (rasterizer.py) that JAX
// production runs. Contract: candidates rows [B, N, 8] f32 =
// (u_c, hw_pix, key bits, valid, v_top, v_bot, 0, 0), ground depth per row
// [H] f32 (inf on sky rows), ground classes [B, H*W] int32 ->
// [B, H*W] int32.
//   U[n, c] = key_n if valid_n and |c + .5 - u_c| <= hw_pix else INT_MAX
//   V[n, r] = INT_MIN if v_top <= r + .5 <= v_bot else INT_MAX
//   best    = min_n max(U[n, c], V[n, r])
// The key is a positive f32 depth with the class id in its low 4 bits, so
// one int32 min picks the nearest candidate and its class together.
//
// What bounds it on an H100: the INT32 pipe. The 72-candidate loop is one
// int32 max and one min per candidate-pixel, 1.9 G ops per 1024 envs on the
// 64 INT32 lanes of each SM (~16.7 T ops/s, ~0.11 ms), against 107 MB of
// frames and tables read and written (~0.03 ms at 3.35 TB/s).
//
// Design: one block per env; the env's candidates (at most 128 x 6 words)
// are staged once in shared memory and read as broadcasts; each thread
// walks pixels with a block-wide stride, so consecutive lanes read and
// write consecutive ground words (coalesced). int32 min/max is exact and
// associative, so the result is bit-identical to any reduction order.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kMaxCandidates = 128;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
composite_kernel(const float* __restrict__ rows, const float* __restrict__ depth,
                 const int* __restrict__ ground, int N, int H, int W,
                 int* __restrict__ out) {
  __shared__ float s_uc[kMaxCandidates];
  __shared__ float s_hw[kMaxCandidates];
  __shared__ float s_vt[kMaxCandidates];
  __shared__ float s_vb[kMaxCandidates];
  __shared__ int s_key[kMaxCandidates];
  __shared__ int s_ok[kMaxCandidates];

  const int b = blockIdx.x;
  const float* cand = rows + static_cast<size_t>(b) * N * 8;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    s_uc[n] = cand[n * 8 + 0];
    s_hw[n] = cand[n * 8 + 1];
    s_key[n] = __float_as_int(cand[n * 8 + 2]);
    s_ok[n] = cand[n * 8 + 3] > 0.0f;
    s_vt[n] = cand[n * 8 + 4];
    s_vb[n] = cand[n * 8 + 5];
  }
  __syncthreads();

  const int hw_px = H * W;
  const int* src = ground + static_cast<size_t>(b) * hw_px;
  int* dst = out + static_cast<size_t>(b) * hw_px;
  for (int q = threadIdx.x; q < hw_px; q += blockDim.x) {
    const int r = q / W;
    const int c = q - r * W;
    const float u = static_cast<float>(c) + 0.5f;
    const float v = static_cast<float>(r) + 0.5f;
    int best = INT_MAX;
    for (int n = 0; n < N; ++n) {
      const int U = (s_ok[n] && fabsf(u - s_uc[n]) <= s_hw[n]) ? s_key[n] : INT_MAX;
      const int V = (v >= s_vt[n] && v <= s_vb[n]) ? INT_MIN : INT_MAX;
      best = min(best, max(U, V));
    }
    const float best_d = __int_as_float(best & ~15);
    dst[q] = (best_d < depth[r]) ? (best & 15) : src[q];
  }
}

}  // namespace

extern "C" int launch_composite(const void* rows, const void* depth,
                                const void* ground, int batch, int N, int H,
                                int W, void* out, void* stream) {
  if (N > kMaxCandidates || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  composite_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const float*>(depth),
      static_cast<const int*>(ground), N, H, W, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
