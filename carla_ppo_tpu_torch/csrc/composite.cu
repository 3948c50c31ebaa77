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
// What bounds it on an H100: bytes. The pass reads the ground frames and
// writes the composited frames, 2 x 52.4 MB per 1024 80x160 envs, plus
// 2.4 MB of candidate rows: ~0.032 ms at 3.35 TB/s. The work the inputs
// need is N x (W + H) predicate evaluations per env (17 k at N = 72) and
// one int32 min per (candidate, covered pixel) pair (~3.2 k covered pixels
// per env), far below the bytes.
//
// Design: a billboard is an axis-aligned rectangle, so its coverage is
// separable: U depends only on the column and V only on the row. One block
// per env builds two bitmask tables in shared memory, 4 words of 32
// candidates each (N <= 128): colmask[w][c] (bit n: valid_n and the column
// test) and rowmask[r][w] (bit n: the row test), with warp ballots whose
// lanes are candidates and with the float expressions above, so every
// predicate rounds as the plain version's does. best = min over the set
// bits of rowmask[r] & colmask[c] of key_n (INT_MAX where none is set);
// max(key, INT_MIN) = key and max(key, INT_MAX) = INT_MAX, so this is
// min_n max(U, V) bit for bit, and int32 min is exact in any order. The
// pixel pass then streams the frame: each of the block's 512 threads takes
// 4 pixels of one row as one 16-byte load and one 16-byte store
// (consecutive threads on consecutive addresses), and a row whose mask is
// empty is a straight copy. The column masks are stored word-major, so a thread's 4 columns
// are one conflict-free 16-byte shared load per word. Widths that are not
// a multiple of 4, or unaligned frames, take a scalar pixel loop.
//
// A second entry, launch_composite_depth_sky, is the same kernel with the
// template flag kDepthSky set: beside the classes it writes what the RGB
// camera shades with, as the XLA _composite_billboards_flat(...,
// return_depth_sky=True) (rasterizer.py) computes it on the TPU (the Pallas
// composite is class-only):
//   depth [B, H*W] f32  = best_d where the billboard is visible, else the
//                         row's ground depth (inf on sky rows);
//   sky   [B, H*W] u8   = 1 on a sky row (ground depth inf) where no
//                         billboard is visible.
// best_d is the key's high bits, exactly as the class test reads them, so
// classes, depth bits and sky equal the plain version's. It moves 13 bytes
// per pixel (read 4, write 4 + 4 + 1): 170.4 MB per 1024 80x160 envs,
// 0.0509 ms at 3.35 TB/s, bound by bytes like the class-only entry. The
// class-only instantiation stores none of it (if constexpr), so the
// compiler drops it.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxCandidates = 128;
constexpr int kWords = kMaxCandidates / 32;
constexpr int kThreads = 512;

// min over the set bits n of `m` (word w) of key[32 w + n].
__device__ __forceinline__ int min_key(int best, uint32_t m, const int* key) {
  while (m) {
    best = min(best, key[__ffs(m) - 1]);
    m &= m - 1;
  }
  return best;
}

// One composited pixel: its class, and for the depth-and-sky mode its depth
// and sky flag (the class-only mode computes and discards them).
struct Pixel {
  int cls;
  float depth;
  uint32_t sky;  // 0 or 1
};

// The pixel whose ground class is g, ground depth `depth` and candidates
// rm & cm. Returned by value: outputs through pointers into the callers'
// vector registers put them on the stack.
__device__ __forceinline__ Pixel shade(int g, const uint4& rm, uint32_t c0, uint32_t c1,
                                       uint32_t c2, uint32_t c3, float depth, const int* key) {
  int best = INT_MAX;
  best = min_key(best, rm.x & c0, key);
  best = min_key(best, rm.y & c1, key + 32);
  best = min_key(best, rm.z & c2, key + 64);
  best = min_key(best, rm.w & c3, key + 96);
  const float best_d = __int_as_float(best & ~15);
  const bool visible = best_d < depth;
  Pixel p;
  p.cls = visible ? (best & 15) : g;
  p.depth = visible ? best_d : depth;
  p.sky = (isinf(depth) && !visible) ? 1 : 0;
  return p;
}

template <bool kVector, bool kDepthSky>
__global__ void __launch_bounds__(kThreads)
composite_kernel(const float* __restrict__ rows, const float* __restrict__ depth,
                 const int* __restrict__ ground, int N, int H, int W,
                 int* __restrict__ out, float* __restrict__ out_depth,
                 uint8_t* __restrict__ out_sky) {
  // Dynamic shared memory: rowmask [H] uint4, then colmask [kWords][W] words.
  extern __shared__ uint4 s_dyn[];
  __shared__ int s_key[kMaxCandidates];
  uint4* s_row = s_dyn;
  uint32_t* s_col = reinterpret_cast<uint32_t*>(s_dyn + H);

  const int b = blockIdx.x;
  const float* cand = rows + static_cast<size_t>(b) * N * 8;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    s_key[n] = __float_as_int(cand[n * 8 + 2]);
  }

  // Lane l holds candidate 32 w + l of every word w in registers.
  const int lane = threadIdx.x & 31;
  const int n_words = (N + 31) / 32;
  float uc[kWords], hw[kWords], vt[kWords], vb[kWords];
  bool ok[kWords], in[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    const int n = 32 * w + lane;
    in[w] = n < N;
    const float* c = cand + (in[w] ? n : 0) * 8;
    uc[w] = c[0];
    hw[w] = c[1];
    ok[w] = in[w] && c[3] > 0.0f;
    vt[w] = c[4];
    vb[w] = c[5];
  }
  const int n_warps = blockDim.x >> 5;
  for (int p = threadIdx.x >> 5; p < W + H; p += n_warps) {
    uint32_t m[kWords];
    if (p < W) {
      const float u = static_cast<float>(p) + 0.5f;
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        m[w] = w < n_words ? __ballot_sync(0xffffffffu, ok[w] && fabsf(u - uc[w]) <= hw[w]) : 0u;
      }
      if (lane == 0) {
#pragma unroll
        for (int w = 0; w < kWords; ++w) s_col[w * W + p] = m[w];
      }
    } else {
      const float v = static_cast<float>(p - W) + 0.5f;
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        m[w] = w < n_words ? __ballot_sync(0xffffffffu, in[w] && v >= vt[w] && v <= vb[w]) : 0u;
      }
      if (lane == 0) s_row[p - W] = make_uint4(m[0], m[1], m[2], m[3]);
    }
  }
  __syncthreads();

  const int hw_px = H * W;
  const int* src = ground + static_cast<size_t>(b) * hw_px;
  int* dst = out + static_cast<size_t>(b) * hw_px;
  if (kVector) {
    // W % 4 == 0: a thread's 4 pixels share one row.
    const int4* src4 = reinterpret_cast<const int4*>(src);
    int4* dst4 = reinterpret_cast<int4*>(dst);
    for (int g = threadIdx.x; g < hw_px / 4; g += blockDim.x) {
      const int q = 4 * g;
      const int r = q / W;
      const int c = q - r * W;
      int4 px = src4[g];
      const uint4 rm = s_row[r];
      const float d = depth[r];
      // Rows no candidate covers keep the ground's class, depth and sky;
      // the 4 sky bytes are packed into one word for a 4-byte store.
      float4 dd = make_float4(d, d, d, d);
      uint32_t ss = isinf(d) ? 0x01010101u : 0u;
      if (rm.x | rm.y | rm.z | rm.w) {
        uint4 cm[kWords];
#pragma unroll
        for (int w = 0; w < kWords; ++w) {
          cm[w] = w < n_words ? *reinterpret_cast<const uint4*>(s_col + w * W + c)
                              : make_uint4(0u, 0u, 0u, 0u);
        }
        const Pixel p0 = shade(px.x, rm, cm[0].x, cm[1].x, cm[2].x, cm[3].x, d, s_key);
        const Pixel p1 = shade(px.y, rm, cm[0].y, cm[1].y, cm[2].y, cm[3].y, d, s_key);
        const Pixel p2 = shade(px.z, rm, cm[0].z, cm[1].z, cm[2].z, cm[3].z, d, s_key);
        const Pixel p3 = shade(px.w, rm, cm[0].w, cm[1].w, cm[2].w, cm[3].w, d, s_key);
        px = make_int4(p0.cls, p1.cls, p2.cls, p3.cls);
        dd = make_float4(p0.depth, p1.depth, p2.depth, p3.depth);
        ss = p0.sky | (p1.sky << 8) | (p2.sky << 16) | (p3.sky << 24);
      }
      if constexpr (kDepthSky) {
        reinterpret_cast<float4*>(out_depth + static_cast<size_t>(b) * hw_px)[g] = dd;
        reinterpret_cast<uint32_t*>(out_sky + static_cast<size_t>(b) * hw_px)[g] = ss;
      }
      dst4[g] = px;
    }
  } else {
    for (int q = threadIdx.x; q < hw_px; q += blockDim.x) {
      const int r = q / W;
      const int c = q - r * W;
      const uint4 rm = s_row[r];
      int px = src[q];
      const float d = depth[r];
      float dq = d;
      uint32_t sq = isinf(d) ? 1u : 0u;
      if (rm.x | rm.y | rm.z | rm.w) {
        const Pixel p = shade(px, rm, s_col[c], s_col[W + c], s_col[2 * W + c], s_col[3 * W + c],
                              d, s_key);
        px = p.cls;
        dq = p.depth;
        sq = p.sky;
      }
      if constexpr (kDepthSky) {
        out_depth[static_cast<size_t>(b) * hw_px + q] = dq;
        out_sky[static_cast<size_t>(b) * hw_px + q] = static_cast<uint8_t>(sq);
      }
      dst[q] = px;
    }
  }
}

template <bool kDepthSky>
int launch(const void* rows, const void* depth, const void* ground, int batch, int N,
           int H, int W, void* out, void* out_depth, void* out_sky, void* stream) {
  if (N > kMaxCandidates || N < 1 || H < 1 || W < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  const size_t smem = static_cast<size_t>(H) * sizeof(uint4) +
                      static_cast<size_t>(kWords) * W * sizeof(uint32_t);
  bool vector = W % 4 == 0 &&
                (reinterpret_cast<uintptr_t>(ground) % 16) == 0 &&
                (reinterpret_cast<uintptr_t>(out) % 16) == 0;
  if (kDepthSky) {
    vector = vector && (reinterpret_cast<uintptr_t>(out_depth) % 16) == 0 &&
             (reinterpret_cast<uintptr_t>(out_sky) % 4) == 0;
  }
  auto kernel = vector ? composite_kernel<true, kDepthSky> : composite_kernel<false, kDepthSky>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const float*>(depth),
      static_cast<const int*>(ground), N, H, W, static_cast<int*>(out),
      static_cast<float*>(out_depth), static_cast<uint8_t*>(out_sky));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int launch_composite(const void* rows, const void* depth,
                                const void* ground, int batch, int N, int H,
                                int W, void* out, void* stream) {
  return launch<false>(rows, depth, ground, batch, N, H, W, out, nullptr, nullptr, stream);
}

extern "C" int launch_composite_depth_sky(const void* rows, const void* depth,
                                          const void* ground, int batch, int N, int H,
                                          int W, void* out, void* out_depth,
                                          void* out_sky, void* stream) {
  return launch<true>(rows, depth, ground, batch, N, H, W, out, out_depth, out_sky, stream);
}
