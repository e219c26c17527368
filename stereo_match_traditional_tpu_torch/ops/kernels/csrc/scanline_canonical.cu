// The canonical AD-Census 4-path scanline optimizer of one view (four SGM
// directional passes with tso-scheduled penalties, and their mean), for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package runs the recurrence as a
// lax.scan (stereo_match_traditional_tpu/ops/scanline.py:326
// scanline_optimize_canonical, step :222 _make_canonical_step, pass :298
// _canonical_pass).  The port's plain version loops over the path steps in
// Python, about ten small launches a step and 2W + 2H steps a view.
//
//   L(p, d) = (C(p, d) + min(L(p-1, d), L(p-1, d-1) + P1s, L(p-1, d+1) + P1s,
//                            m(p-1) + P2s)) - m(p-1),     m = min_d L
//   P1s = P1 * s, P2s = P2 * s,  s = 1, 0.25 or 0.1 as neither, one or both of
//   |g1(p) - g1(p-1)| and |g2(p, d) - g2(p-1, d)| reach tso
//
// with +inf at d = -1 and d = D; g1 is the view's own gray image, g2 the
// other one at column clamp(x - d) (left view) or clamp(x + d) (right view),
// read from the image, never stacked.  p-1 is the path's previous pixel (x+1
// or y+1 on the reversed passes); a path's first step is the cost itself.
// The output is ((lr + rl) + (ud + du)) * 0.25, d-major [D, H, W] like the
// input, contiguous.
//
// What bounds it: bytes.  The function reads the volume once and writes it
// once (2V, V = 4 D H W bytes: 0.024 ms a view at Teddy 375x450, D=60, and
// 0.282 ms at 720x1280, D=128, at 3.35 TB/s); the arithmetic, ~15
// operations a value and direction, is far below the float32 peak.  What
// sets the time of a simple design is the access pattern: a path step needs
// the D values of one pixel, which lie a plane apart in the d-major volume.
// This version is simple, not tuned:
//
// * One launch runs the four passes side by side (blockIdx.y is the
//   direction), one warp a path line: lane l holds d = l K .. l K + K - 1
//   (K = 1, 2, 4 or 8, the power of two at or above D / 32), d +- 1 by two
//   shuffles, min_d by a tree in registers and one integer warp reduction
//   on the order-preserving image of the float.
// * The costs reach the walking warp through shared memory, in tiles of
//   TS path steps (K TS = 32) double-buffered with 4-byte cp.async, and the
//   results leave through the same tile:
//   - horizontal passes: a warp's own tile of one row, [D] x [TS columns];
//     each access of the warp covers runs of consecutive columns;
//   - vertical passes: a block of 8 warps walks 8 neighbouring columns; the
//     block stages [TS rows] x [D] x [8 columns] together (32-byte runs).
//   Rows of the tiles are padded (33 and 9 words) so that neither the copies
//   nor the walkers conflict on banks.
// * lr goes to the output, rl, ud and du to scratch; a second launch
//   combines them in place: 13 V of traffic where 2 V is the bound.
//
// D <= 256 (K <= 8), offsets in 64 bits.  The gray images are read as they
// come, uint8 or float32 (a template argument), and turned into float32 in
// registers, as the plain version turns them.
//
// Numerics: the plain version's float operations in its order, each by an
// __f*_rn intrinsic so that nvcc contracts no multiply and add into an FMA:
// P1s = P1 * s, l2 = L(p-1, d-1) + P1s, l4 = m + P2s,
// out = (C + min(min(l1, l2), min(l3, l4))) - m, then (lr + rl) + (ud + du),
// times 0.25.  s = 0.1 is the float32 0.1f.  min is exact in any order.  The
// result matches the plain version bit for bit.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;    // path lines a block
constexpr int THREADS = WARPS * 32;
constexpr int VCOLS = 8;    // columns of a vertical block, one a warp

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {  // all groups but the newest
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// float <-> int whose signed order is the float order (an involution)
__device__ __forceinline__ int ordered(int i) { return i ^ ((i >> 31) & 0x7fffffff); }

__device__ __forceinline__ float warp_min(float v) {
  const int r = __reduce_min_sync(FULL, ordered(__float_as_int(v)));
  return __int_as_float(ordered(r));
}

// a pixel of a gray image, u8 or float32, as the plain version's float32
__device__ __forceinline__ float pixel(const float* p) { return __ldg(p); }
__device__ __forceinline__ float pixel(const unsigned char* p) { return (float)__ldg(p); }

struct Outs {
  float* dir[4];  // lr, rl, ud, du
};

template <typename T>
struct Args {
  const float* cost;
  const T* base;
  const T* match;
  Outs outs;
  int D, H, W;
  float p1, p2, tso;
  int right_view;
};

// The walk state of one path line: L(p-1, d) of this lane's K disparities,
// m(p-1), and the previous step's images.
template <int K, typename T>
struct Walker {
  float prev[K];
  float g2_prev[K];
  float m;
  float g1_prev;

  // One path step at pixel (y, x): c[k] holds the costs on entry and the
  // step's values on return.  `first`: the path starts here.
  __device__ __forceinline__ void step(float (&c)[K], const Args<T>& a, int y, int x,
                                       bool first, int lane) {
    const int d0 = lane * K;
    const T* row = a.match + (size_t)y * a.W;
    const float g1 = pixel(a.base + (size_t)y * a.W + x);
    float g2[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = d0 + k < a.D ? d0 + k : a.D - 1;
      g2[k] = pixel(row + (a.right_view ? min(x + d, a.W - 1) : max(x - d, 0)));
    }
    if (!first) {
      const bool over1 = fabsf(__fsub_rn(g1, g1_prev)) >= a.tso;
      float below = __shfl_up_sync(FULL, prev[K - 1], 1);  // L(p-1, d-1) for k = 0
      float above = __shfl_down_sync(FULL, prev[0], 1);    // L(p-1, d+1) for k = K-1
      if (lane == 0) below = CUDART_INF_F;
      if (lane == 31) above = CUDART_INF_F;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const bool over2 = fabsf(__fsub_rn(g2[k], g2_prev[k])) >= a.tso;
        const float s = (over1 && over2) ? 0.1f : ((over1 || over2) ? 0.25f : 1.0f);
        const float p1s = __fmul_rn(a.p1, s);
        const float p2s = __fmul_rn(a.p2, s);
        const float l2 = __fadd_rn(k > 0 ? prev[k > 0 ? k - 1 : 0] : below, p1s);
        const float l3 = __fadd_rn(k + 1 < K ? prev[k + 1 < K ? k + 1 : k] : above, p1s);
        const float l4 = __fadd_rn(m, p2s);
        const float best = fminf(fminf(prev[k], l2), fminf(l3, l4));
        c[k] = __fsub_rn(__fadd_rn(c[k], best), m);
      }
    }
    float lane_min = CUDART_INF_F;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      prev[k] = c[k];
      g2_prev[k] = g2[k];
      lane_min = fminf(lane_min, c[k]);
    }
    g1_prev = g1;
    m = warp_min(lane_min);
  }
};

// Horizontal passes (dir 0: left-right, 1: right-left): warp w of the block
// walks row blockIdx.x * WARPS + w.  Its tile t holds path steps t TS ..
// t TS + TS - 1 as tile[(k TS + j) 33 + l] for d = l K + k (+inf past D and
// the row).  Lane e of a copy takes d = e / TS, step j = e % TS.
template <int K, typename T>
__device__ void horizontal(const Args<T>& a, int dir, float* smem) {
  constexpr int TS = 32 / K;
  constexpr int TILE = K * TS * 33;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int y = blockIdx.x * WARPS + warp;
  if (y >= a.H) return;  // the whole warp; no block barrier below
  const bool forward = dir == 0;
  float* tiles = smem + warp * 2 * TILE;
  float* __restrict__ out = a.outs.dir[dir];
  const size_t plane = (size_t)a.H * a.W, row = (size_t)y * a.W;
  const int steps = a.W, ntiles = (steps + TS - 1) / TS;
  auto col = [&](int t) { return forward ? t : a.W - 1 - t; };
  auto slot = [&](int e) {  // (d, j) of copy element e and its place in a tile
    const int d = e / TS, j = e % TS;
    return (d % K * TS + j) * 33 + d / K;
  };
  auto fetch = [&](int tile) {
    float* buf = tiles + (tile & 1) * TILE;
#pragma unroll 4
    for (int e = lane; e < 32 * K * TS; e += 32) {
      const int d = e / TS, t = tile * TS + e % TS;
      if (d < a.D && t < steps) {
        cp_async4(buf + slot(e), a.cost + d * plane + row + col(t));
      } else {
        buf[slot(e)] = CUDART_INF_F;
      }
    }
    cp_async_commit();
  };
  Walker<K, T> w;
  fetch(0);
  for (int tile = 0; tile < ntiles; ++tile) {
    fetch(tile + 1);  // an empty group past the end
    cp_async_wait_one();
    __syncwarp();
    float* buf = tiles + (tile & 1) * TILE;
    for (int j = 0; j < TS; ++j) {
      const int t = tile * TS + j;
      if (t >= steps) break;
      float c[K];
#pragma unroll
      for (int k = 0; k < K; ++k) c[k] = buf[(k * TS + j) * 33 + lane];
      w.step(c, a, y, col(t), t == 0, lane);
#pragma unroll
      for (int k = 0; k < K; ++k) buf[(k * TS + j) * 33 + lane] = c[k];
    }
    __syncwarp();
#pragma unroll 4
    for (int e = lane; e < 32 * K * TS; e += 32) {
      const int d = e / TS, t = tile * TS + e % TS;
      if (d < a.D && t < steps) out[d * plane + row + col(t)] = buf[slot(e)];
    }
  }
}

// Vertical passes (dir 2: top-down, 3: bottom-up): the block takes columns
// x0 .. x0 + 7, warp w walks column x0 + w.  Tile t holds path steps t TS ..
// t TS + TS - 1 as tile[((j K + k) 32 + l) 9 + c] for d = l K + k, column
// x0 + c (+inf past D, H and W).  Thread e of a copy takes c = e % 8,
// d = e / 8 % DP, step j = e / 8 / DP: each warp access is four 32-byte runs.
template <int K, typename T>
__device__ void vertical(const Args<T>& a, int dir, float* smem) {
  constexpr int TS = 32 / K;
  constexpr int DP = 32 * K;
  constexpr int TILE = TS * DP * 9;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x0 = blockIdx.x * VCOLS;
  if (x0 >= a.W) return;  // the whole block
  const int x = x0 + warp;
  const bool forward = dir == 2;
  float* __restrict__ out = a.outs.dir[dir];
  const size_t plane = (size_t)a.H * a.W;
  const int steps = a.H, ntiles = (steps + TS - 1) / TS;
  auto rowof = [&](int t) { return forward ? t : a.H - 1 - t; };
  auto slot = [&](int e) {
    const int c = e % VCOLS, d = e / VCOLS % DP, j = e / VCOLS / DP;
    return ((j * K + d % K) * 32 + d / K) * 9 + c;
  };
  auto fetch = [&](int tile) {
    float* buf = smem + (tile & 1) * TILE;
#pragma unroll 4
    for (int e = threadIdx.x; e < TS * DP * VCOLS; e += THREADS) {
      const int c = e % VCOLS, d = e / VCOLS % DP, t = tile * TS + e / VCOLS / DP;
      if (d < a.D && t < steps && x0 + c < a.W) {
        cp_async4(buf + slot(e), a.cost + d * plane + (size_t)rowof(t) * a.W + x0 + c);
      } else {
        buf[slot(e)] = CUDART_INF_F;
      }
    }
    cp_async_commit();
  };
  Walker<K, T> w;
  fetch(0);
  for (int tile = 0; tile < ntiles; ++tile) {
    fetch(tile + 1);
    cp_async_wait_one();
    __syncthreads();
    float* buf = smem + (tile & 1) * TILE;
    if (x < a.W) {
      for (int j = 0; j < TS; ++j) {
        const int t = tile * TS + j;
        if (t >= steps) break;
        float c[K];
#pragma unroll
        for (int k = 0; k < K; ++k) c[k] = buf[((j * K + k) * 32 + lane) * 9 + warp];
        w.step(c, a, rowof(t), x, t == 0, lane);
#pragma unroll
        for (int k = 0; k < K; ++k) buf[((j * K + k) * 32 + lane) * 9 + warp] = c[k];
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int e = threadIdx.x; e < TS * DP * VCOLS; e += THREADS) {
      const int c = e % VCOLS, d = e / VCOLS % DP, t = tile * TS + e / VCOLS / DP;
      if (d < a.D && t < steps && x0 + c < a.W) {
        out[d * plane + (size_t)rowof(t) * a.W + x0 + c] = buf[slot(e)];
      }
    }
  }
}

template <int K>
constexpr int smem_bytes() {
  constexpr int h = WARPS * 2 * K * (32 / K) * 33;  // horizontal: two tiles a warp
  constexpr int v = 2 * (32 / K) * 32 * K * 9;      // vertical: two tiles a block
  return 4 * (h > v ? h : v);
}

template <int K, typename T>
__global__ void __launch_bounds__(THREADS) canonical_pass_kernel(Args<T> a) {
  extern __shared__ float smem[];
  const int dir = blockIdx.y;
  if (dir < 2) {
    horizontal<K>(a, dir, smem);
  } else {
    vertical<K>(a, dir, smem);
  }
}

// out = ((out + rl) + (ud + du)) * 0.25, out holding lr
__global__ void combine_kernel(float* __restrict__ out, const float* __restrict__ rl,
                               const float* __restrict__ ud, const float* __restrict__ du,
                               size_t n) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    out[i] = __fmul_rn(__fadd_rn(__fadd_rn(out[i], rl[i]), __fadd_rn(ud[i], du[i])), 0.25f);
  }
}

template <int K, typename T>
cudaError_t launch_passes(const Args<T>& a, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<K>();
  // set on every launch: the grant belongs to the current device
  cudaError_t err = cudaFuncSetAttribute(canonical_pass_kernel<K, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int hb = (a.H + WARPS - 1) / WARPS, vb = (a.W + VCOLS - 1) / VCOLS;
  const dim3 grid((unsigned)(hb > vb ? hb : vb), 4);
  canonical_pass_kernel<K, T><<<grid, THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const float* cost, const void* left, const void* right, float* scratch,
                   float* out, int D, int H, int W, float p1, float p2, float tso, int right_view,
                   cudaStream_t stream) {
  const size_t n = (size_t)D * H * W;
  const T* l = static_cast<const T*>(left);
  const T* r = static_cast<const T*>(right);
  const Args<T> a{cost, right_view ? r : l, right_view ? l : r,
                  Outs{{out, scratch, scratch + n, scratch + 2 * n}},
                  D, H, W, p1, p2, tso, right_view};
  cudaError_t err;
  if (D <= 32) {
    err = launch_passes<1>(a, stream);
  } else if (D <= 64) {
    err = launch_passes<2>(a, stream);
  } else if (D <= 128) {
    err = launch_passes<4>(a, stream);
  } else {
    err = launch_passes<8>(a, stream);
  }
  if (err != cudaSuccess) return err;
  const size_t blocks = (n + 255) / 256;
  combine_kernel<<<(unsigned)(blocks < 132 * 16 ? blocks : 132 * 16), 256, 0, stream>>>(
      out, a.outs.dir[1], a.outs.dir[2], a.outs.dir[3], n);
  return cudaGetLastError();
}

}  // namespace

// The canonical scanline of one view.  cost: d-major [D, H, W] float32;
// left, right: [H, W] gray images, uint8 when u8 is 1, else float32;
// scratch: [3, D, H, W] float32 (rl, ud, du); out: [D, H, W] float32.
// right_view = 0 takes left as the base image and right as the match image,
// 1 the other way round.  Returns a cudaError_t.
extern "C" int scanline_canonical_f32(const float* cost, const void* left, const void* right,
                                      int u8, float* scratch, float* out, int D, int H, int W,
                                      float p1, float p2, float tso, int right_view,
                                      void* stream_ptr) {
  if (D < 1 || D > 256 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = (cudaStream_t)stream_ptr;
  return (int)(u8 ? launch<unsigned char>(cost, left, right, scratch, out, D, H, W, p1, p2, tso,
                                          right_view, stream)
                  : launch<float>(cost, left, right, scratch, out, D, H, W, p1, p2, tso,
                                  right_view, stream));
}
