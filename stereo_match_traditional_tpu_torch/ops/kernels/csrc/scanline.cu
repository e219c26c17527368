// The four SGM directional passes of the 4-path scanline optimizer, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package runs the recurrence as a
// lax.scan (stereo_match_traditional_tpu/ops/scanline.py:377
// scanline_optimize, step :73 _make_step, pass :164 _directional_pass).
// The port's plain version loops over the path steps in Python, about ten
// small launches per step and 2W + 2H steps per call.
//
//   L(p, d) = C(p, d) + min(L(p-1, d), L(p-1, d-1) + P1, L(p-1, d+1) + P1,
//                           m(p-1) + P2(p)) - m(p-1),    m = min_d L
//   P2(p) = max(P1, P2_init / (|I(p) - I(ref)| + 1))
//
// with +inf at d = -1 and d = D, I(ref) the previous pixel of the path (or,
// for the reference's vertical quirk, the path's first pixel), and the
// d-1 term replaced by L(p-1, d) + P1 on vertical paths when
// vert_dm1 = 0.  The output is (lr + rl) + (ud + du), pixel-major.
//
// What bounds it: the path is sequential, so each step's latency (its
// cost load, a warp min and a shared-memory exchange) times the longest
// path, max(W, H) steps, as the four directions run at once.  Design: one
// warp per path line, all four directions in one launch (blockIdx.y),
// lane l holding d = l + 32k in registers (K = ceil(D / 32) rounded to a
// power of two, D <= 1024).  The volume comes in pixel-major, [H, W, D],
// so a step's D costs are one coalesced read and its D results one
// coalesced write, and the next step's costs are loaded a step ahead.  The
// previous step's row sits in shared memory with the two +inf pads, so
// d +- 1 is one load.  A second kernel adds the four directional volumes.
//
// Numerics: the float operations and their order are the plain version's
// (and the JAX package's): c + min(min(l1, l2), min(l3, l4)) - m, then
// (lr + rl) + (ud + du), IEEE division for P2, no fast-math and no
// multiply to contract, so the result matches the plain version bit for
// bit.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int WARPS = 4;  // path lines per block

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

template <int K>
__global__ void __launch_bounds__(32 * WARPS)
scanline_pass_kernel(const float* __restrict__ cost, const float* __restrict__ gray,
                     float* __restrict__ dirs, int d_range, int h, int w, float p1,
                     float p2_init, int vert_dm1, int vert_first) {
  extern __shared__ float smem[];
  const int dir = blockIdx.y;  // 0 left-right, 1 right-left, 2 up-down, 3 down-up
  const bool horiz = dir < 2;
  const bool rev = (dir & 1) != 0;
  const int lines = horiz ? h : w;
  const int steps = horiz ? w : h;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int line = blockIdx.x * WARPS + warp;
  if (line >= lines) return;  // whole warps leave; no block barrier follows
  const bool dm1 = horiz || vert_dm1 != 0;
  const bool first_ref = !horiz && vert_first != 0;
  float* out = dirs + (size_t)dir * d_range * h * w;
  float* prev = smem + warp * (d_range + 2);  // prev[d + 1] = L(p-1, d)

  // pixel index of path step t
  auto pix = [&](int t) -> size_t {
    const int s = rev ? steps - 1 - t : t;
    return horiz ? (size_t)line * w + s : (size_t)s * w + line;
  };

  if (lane == 0) {
    prev[0] = CUDART_INF_F;
    prev[d_range + 1] = CUDART_INF_F;
  }
  size_t p = pix(0);
  float m = CUDART_INF_F;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = lane + 32 * k;
    if (d < d_range) {
      const float v = cost[p * d_range + d];
      out[p * d_range + d] = v;
      prev[d + 1] = v;
      m = fminf(m, v);
    }
  }
  m = warp_min(m);
  float g_ref = gray[p];

  // step t + 1's costs and gray value, loaded while step t computes
  float next[K];
  float g_next = 0.0f;
  if (steps > 1) {
    const size_t pn = pix(1);
    g_next = gray[pn];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = lane + 32 * k;
      next[k] = d < d_range ? cost[pn * d_range + d] : 0.0f;
    }
  }
  for (int t = 1; t < steps; ++t) {
    p = pix(t);
    float c[K];
#pragma unroll
    for (int k = 0; k < K; ++k) c[k] = next[k];
    const float g = g_next;
    if (t + 1 < steps) {
      const size_t pn = pix(t + 1);
      g_next = gray[pn];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int d = lane + 32 * k;
        next[k] = d < d_range ? cost[pn * d_range + d] : 0.0f;
      }
    }
    const float p2 = fmaxf(p1, p2_init / (fabsf(g - g_ref) + 1.0f));
    if (!first_ref) g_ref = g;
    const float l4 = m + p2;
    __syncwarp();  // the previous step's prev[] is written
    float v[K];
    float m_new = CUDART_INF_F;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = lane + 32 * k;
      if (d < d_range) {
        const float l1 = prev[d + 1];
        const float l2 = (dm1 ? prev[d] : l1) + p1;
        const float l3 = prev[d + 2] + p1;
        v[k] = (c[k] + fminf(fminf(l1, l2), fminf(l3, l4))) - m;
        m_new = fminf(m_new, v[k]);
        out[p * d_range + d] = v[k];
      }
    }
    __syncwarp();  // every lane has read prev[] before it is overwritten
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = lane + 32 * k;
      if (d < d_range) prev[d + 1] = v[k];
    }
    m = warp_min(m_new);
  }
}

__global__ void combine_kernel(const float* __restrict__ dirs, float* __restrict__ out,
                               size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    out[i] = (dirs[i] + dirs[n + i]) + (dirs[2 * n + i] + dirs[3 * n + i]);
  }
}

template <int K>
cudaError_t launch_passes(const float* cost, const float* gray, float* dirs, int d_range,
                          int h, int w, float p1, float p2, int vert_dm1, int vert_first,
                          cudaStream_t s) {
  const int lines = h > w ? h : w;
  const dim3 grid((lines + WARPS - 1) / WARPS, 4);
  const size_t smem = sizeof(float) * WARPS * (d_range + 2);
  scanline_pass_kernel<K><<<grid, 32 * WARPS, smem, s>>>(
      cost, gray, dirs, d_range, h, w, p1, p2, vert_dm1, vert_first);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`.  cost: float32 [h, w, d_range] (pixel-major); gray:
// float32 [h, w]; dirs: float32 scratch [4, h, w, d_range]; out: float32
// [h, w, d_range]; all contiguous on the current device;
// 1 <= d_range <= 1024.  p1, p2 are
// the effective penalties.  Returns cudaGetLastError() after the launches
// (0 = launched), cudaErrorInvalidValue for d_range outside the range.
extern "C" int scanline_optimize_f32(const void* cost, const void* gray, void* dirs,
                                     void* out, int d_range, int h, int w, float p1,
                                     float p2, int vert_dm1, int vert_first,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* c = (const float*)cost;
  const float* g = (const float*)gray;
  float* t = (float*)dirs;
  cudaError_t err;
  const int k = (d_range + 31) / 32;
  if (d_range < 1 || k > 32) return (int)cudaErrorInvalidValue;
  if (k <= 1) err = launch_passes<1>(c, g, t, d_range, h, w, p1, p2, vert_dm1, vert_first, s);
  else if (k <= 2) err = launch_passes<2>(c, g, t, d_range, h, w, p1, p2, vert_dm1, vert_first, s);
  else if (k <= 4) err = launch_passes<4>(c, g, t, d_range, h, w, p1, p2, vert_dm1, vert_first, s);
  else if (k <= 8) err = launch_passes<8>(c, g, t, d_range, h, w, p1, p2, vert_dm1, vert_first, s);
  else if (k <= 16) err = launch_passes<16>(c, g, t, d_range, h, w, p1, p2, vert_dm1, vert_first, s);
  else err = launch_passes<32>(c, g, t, d_range, h, w, p1, p2, vert_dm1, vert_first, s);
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)d_range * h * w;
  combine_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(t, (float*)out, n);
  return (int)cudaGetLastError();
}
