// One recurrent step of the Mamba-2 state-space mixer, for every env and
// head of one layer (the rollout's and the greedy evaluation's step).
//
// Replaces: no TPU kernel. The JAX package has no recurrent policy; this
// kernel was added with the hybrid Mamba-2 / attention policy
// (models/hybrid_policy.py), whose step form carries a [B, H, P, N] state
// from one env step to the next. Its plain version is
// ops/ssm.py:ssm_step_plain. Per env b and head h, with the state S of
// [P, N] floats:
//   S  = first_b ? 0 : exp(dt_bh * A_h) * S      (episode start: reset)
//   S += (dt_bh * x_bhp) * B_bn                   (rank-1 update)
//   y_bhp = sum_n S_pn * C_bn + D_h * x_bhp
// and S is written back in place unless `commit` is 0 (the bootstrap
// value reads the last observation without advancing the memory).
//
// What bounds it on an H100: bytes. The state is read and written once,
// 2 x P x N x 4 bytes per env and head: 2 x 2 MiB per env of the published
// layer (H 64, P 64, N 128), 4.3 GB for 1024 envs, 1.28 ms at 3.35 TB/s.
// The arithmetic is 5 float operations per state element (the -fmad=false
// build keeps each multiply and add apart, so that an element rounds as the
// plain version's elementwise ops do): 2.7 G operations for 1024 envs,
// 0.08 ms at 33.5 T operations a second, far below the bytes.
//
// Design: one block of 128 threads per (env, head). The N state columns
// of a row are N / 4 lanes of one 16-byte load each (consecutive lanes on
// consecutive addresses), so a row of 128 columns is one warp's 512-byte
// load; a pass covers 128 / (N / 4) rows, and kUnroll passes are loaded
// before any is computed, so each thread keeps four 16-byte loads in
// flight. B and C are the env's, loaded once per thread as the same
// 16-byte pieces. The row's dot product with C is a shuffle reduction
// inside the row's lanes, and its first lane writes y. An env that starts
// an episode reads no state.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 4;

template <int kLanes>
__global__ void __launch_bounds__(kThreads)
ssm_step_kernel(float* __restrict__ state, const float* __restrict__ x, int sx,
                const float* __restrict__ dt, const float* __restrict__ A,
                const float* __restrict__ Bm, int sb, const float* __restrict__ Cm, int sc,
                const float* __restrict__ D, const uint8_t* __restrict__ first, int H, int P,
                int commit, float* __restrict__ y) {
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int lane = threadIdx.x % kLanes;
  const int row0 = threadIdx.x / kLanes;
  constexpr int kRowsPerPass = kThreads / kLanes;
  const bool reset = first[b] != 0;
  const float dtv = dt[bh];
  const float decay = expf(dtv * A[h]);
  const float dv = D[h];
  const float4 bv = reinterpret_cast<const float4*>(Bm + static_cast<size_t>(b) * sb)[lane];
  const float4 cv = reinterpret_cast<const float4*>(Cm + static_cast<size_t>(b) * sc)[lane];
  float4* S = reinterpret_cast<float4*>(state + static_cast<size_t>(bh) * P * (kLanes * 4));
  const float* xr = x + static_cast<size_t>(b) * sx + static_cast<size_t>(h) * P;
  float* yr = y + static_cast<size_t>(bh) * P;

  for (int base = 0; base < P; base += kRowsPerPass * kUnroll) {
    float4 s[kUnroll];
    float xv[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int p = base + k * kRowsPerPass + row0;
      const bool live = p < P;
      s[k] = (live && !reset) ? S[p * kLanes + lane] : make_float4(0.f, 0.f, 0.f, 0.f);
      xv[k] = live ? xr[p] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int p = base + k * kRowsPerPass + row0;
      const bool live = p < P;
      const float u = dtv * xv[k];
      float4 v = s[k];
      if (!reset) {
        v.x = v.x * decay;
        v.y = v.y * decay;
        v.z = v.z * decay;
        v.w = v.w * decay;
      }
      v.x = v.x + u * bv.x;
      v.y = v.y + u * bv.y;
      v.z = v.z + u * bv.z;
      v.w = v.w + u * bv.w;
      if (live && commit) S[p * kLanes + lane] = v;
      float part = v.x * cv.x + v.y * cv.y + v.z * cv.z + v.w * cv.w;
#pragma unroll
      for (int off = kLanes / 2; off > 0; off /= 2) {
        part += __shfl_xor_sync(0xffffffffu, part, off, kLanes);
      }
      if (live && lane == 0) yr[p] = part + dv * xv[k];
    }
  }
}

}  // namespace

// state [batch, H, P, N] f32 (in place), x rows of stride sx holding
// [H, P] f32, dt [batch, H] f32, A and D [H] f32, B and C rows of
// strides sb and sc holding [N] f32 (16-byte aligned), first [batch] u8,
// y [batch, H, P] f32. N must be 128 (the published layer's) or 8 or 4
// (the tests' small layers).
extern "C" int launch_ssm_step(void* state, const void* x, int sx, const void* dt,
                               const void* A, const void* Bm, int sb, const void* Cm, int sc,
                               const void* D, const void* first, int batch, int H, int P,
                               int N, int commit, void* y, void* stream) {
  if (H < 1 || P < 1 || sb % 4 != 0 || sc % 4 != 0 ||
      (reinterpret_cast<uintptr_t>(Bm) % 16) != 0 || (reinterpret_cast<uintptr_t>(Cm) % 16) != 0 ||
      (reinterpret_cast<uintptr_t>(state) % 16) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  const dim3 grid(static_cast<unsigned>(batch) * static_cast<unsigned>(H));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(state);
  const float* xp = static_cast<const float*>(x);
  const float* dtp = static_cast<const float*>(dt);
  const float* Ap = static_cast<const float*>(A);
  const float* Bp = static_cast<const float*>(Bm);
  const float* Cp = static_cast<const float*>(Cm);
  const float* Dp = static_cast<const float*>(D);
  const uint8_t* fp = static_cast<const uint8_t*>(first);
  float* yp = static_cast<float*>(y);
  switch (N) {
#define SSM_CASE(n)                                                                       \
  case n:                                                                                 \
    ssm_step_kernel<n / 4><<<grid, kThreads, 0, s>>>(st, xp, sx, dtp, Ap, Bp, sb, Cp, sc, \
                                                     Dp, fp, H, P, commit, yp);           \
    break;
    SSM_CASE(4)
    SSM_CASE(8)
    SSM_CASE(128)
#undef SSM_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
