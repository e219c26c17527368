// The 4-path scanline optimizer (four SGM directional passes and their
// sum), for Hopper (sm_90a).
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
// vert_dm1 = 0.  The output is (lr + rl) + (ud + du), d-major [D, H, W]
// like the input.
//
// What bounds it: bytes.  The function reads the volume once and writes it
// once (2V, V = 4 D H W bytes: 0.28 ms at 720x1280, D=128 and 3.35 TB/s);
// the arithmetic is ~8 operations per value and direction.  What sets the
// time of an implementation is the path: every step waits for the one
// before, and a direction's results do not fit on the chip, so three of the
// four go through device memory once.  Design:
//
// * d-major in and out, no transposed copy, 11 volume trips in three
//   launches: top-down (cost -> ud, on a second stream) beside left-right
//   and right-left (cost -> lr in `out`, rl in scratch; blockIdx.y is the
//   direction); then bottom-up, whose write-out stores
//   (lr + rl) + (ud + du) over lr, so no combine pass exists.
// * The volumes the kernel writes (lr / the result, rl, ud) have rows `wp`
//   apart, W rounded up to a multiple of 4, so that every 4-column piece of
//   them is one aligned 16-byte access whatever W is; only the cost volume,
//   which the caller owns, is read by narrower copies when W is no multiple
//   of 4.  The caller takes columns 0 .. W-1 of the result.
// * A walker warp holds the D values of a path line: lane l has
//   d = l K .. l K + K - 1 in registers (K = ceil(D / 32) rounded to a power
//   of two), so d +- 1 is two shuffles a step and the min over d one
//   integer warp reduction (redux.sync on the order-preserving integer
//   image of the float).  A walker takes the costs of four steps from
//   shared memory at once, walks them from registers, and puts the four
//   results back in their place: the chain from one step to the next is
//   arithmetic, two shuffles and the reduction, and touches no memory.  P2
//   is computed for 32 steps at a time, one lane a step, off that chain.
// * d-major rows do not hand a walker its D values of a step side by side,
//   so mover warps of the same block stage tiles through shared memory with
//   cp.async, several tiles ahead of the walker, and write the walked tiles
//   out again.  Tiles are indexed by path step, so the right-left and
//   bottom-up passes walk the same way as the others and only the movers
//   mirror.  The movers' code is straight-line with offsets computed once:
//   they, not the walkers or the memory, set the time at the reference size.
//   - Horizontal: block = one (row, direction), one walker and three mover
//     warps; a tile is [32 K disparities] x [32 steps], cut at multiples of
//     32 columns, each row of it one 128-byte run of the volume, copied in
//     by 4-byte cp.async (one lane a step) and written out as 16-byte
//     chunks.  The chunks of a row are XOR-swizzled by the owning lane so
//     that the walker's 128-bit accesses (32 rows, one chunk) and the
//     movers' are both free of bank conflicts.
//   - Vertical: block = 16 neighbouring columns (64-byte runs), or 8 where
//     blocks of 8 all fit the card at once (W <= 8 SMs: the movers of 450 /
//     16 = 29 blocks set the time at the reference size); walker warps of
//     four columns each (one 16-byte chunk; their four chains interleave)
//     and eight mover warps; a tile is 4 or 8 image rows of [32 K] x
//     [columns].  A mover warp's access covers every row and column of one
//     or two d, since each d of a large volume lies in another page.  The
//     bottom-up movers also stage lr, rl and ud of a tile (16-byte cp.async
//     past L1) and store the sum.
// * Each block barriers once a tile; rows d >= D of every stage hold +inf
//   and are never copied over.
//
// D <= 256 (K <= 8: registers of a walker, shared memory of a stage), and
// D H wp below 2^32 (the vertical movers keep 32-bit offsets).
//
// Numerics: the float operations and their order are the plain version's
// (and the JAX package's): c + min(min(l1, l2), min(l3, l4)) - m, then
// (lr + rl) + (ud + du), IEEE division for P2, no fast-math and no
// multiply to contract; min is exact in any order, and rounding is
// monotone, so min_d (u_d - m) = (min_d u_d) - m.  The result matches the
// plain version bit for bit.
//
// The tiles' machinery (copies, the ring of stages, the layouts, the
// movers) lives in scanline_tiles.cuh, shared with scanline_canonical.cu.
//
// A second entry, scanline_horizontal_band_f32, runs the horizontal kernel
// alone on a band of rows of the streamed executor
// (stereo_match_traditional_tpu_torch/parallel/streamed.py), where the JAX
// package runs _directional_pass on the transposed band
// (stereo_match_traditional_tpu/parallel/streamed.py:594-597): a band's
// horizontal passes are row-local, so each of its rows is a whole path.  The
// band is read in place through its plane and row strides.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <atomic>
#include <cstdint>
#include <mutex>

#include "scanline_tiles.cuh"

namespace {

// G steps of a walker warp that walks NC lines at once (their chains are
// independent, so their instructions interleave).  c[n][j] holds the costs of
// step j of line n on entry and the step's values on return; prev and m carry
// the paths' state.  p2_lane[n] holds P2 of step j in lane j0 + j.  `first`:
// step `start` starts the paths, the steps before it lie outside the image.
template <int K, int NC, int G>
__device__ __forceinline__ void walk_group(float (&c)[NC][G][K], float (&prev)[NC][K],
                                           float (&m)[NC], float p1,
                                           const float (&p2_lane)[NC], int j0, bool dm1,
                                           bool first, int start, int lane) {
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (first && j < start) continue;  // before the paths
    if (first && j == start) {
#pragma unroll
      for (int n = 0; n < NC; ++n) {
#pragma unroll
        for (int k = 0; k < K; ++k) prev[n][k] = c[n][j][k];
        m[n] = warp_min(tree_min<K>(prev[n]));
      }
      continue;
    }
    float u[NC][K], u_min[NC];
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const float p2 = __shfl_sync(FULL, p2_lane[n], j0 + j);
      float q[K];  // L(p-1, d) + P1
#pragma unroll
      for (int k = 0; k < K; ++k) q[k] = prev[n][k] + p1;
      float below = __shfl_up_sync(FULL, q[K - 1], 1);   // of d - 1 for k = 0
      float above = __shfl_down_sync(FULL, q[0], 1);     // of d + 1 for k = K - 1
      if (lane == 0) below = CUDART_INF_F;
      if (lane == 31) above = CUDART_INF_F;
      const float l4 = m[n] + p2;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float l2 = dm1 ? (k > 0 ? q[k > 0 ? k - 1 : 0] : below) : q[k];
        const float l3 = k + 1 < K ? q[k + 1 < K ? k + 1 : k] : above;
        const float rest = fminf(fminf(prev[n][k], l2), l3);  // ready before m is
        u[n][k] = c[n][j][k] + fminf(rest, l4);
      }
      u_min[n] = tree_min<K>(u[n]);
    }
#pragma unroll
    for (int n = 0; n < NC; ++n) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        prev[n][k] = u[n][k] - m[n];
        c[n][j][k] = prev[n][k];
      }
      m[n] = warp_min(u_min[n]) - m[n];
    }
  }
}

__device__ __forceinline__ float adaptive_p2(float p1, float p2_init, float g, float g_ref) {
  return fmaxf(p1, __fdiv_rn(p2_init, fabsf(g - g_ref) + 1.0f));
}

// ---------------------------------------------------------------------------
// Horizontal: block = (image row, direction); warp 0 walks, warps 1-3 move.
// ---------------------------------------------------------------------------

template <int K>
__global__ void __launch_bounds__(32 + HMOVERS)
scanline_horizontal_kernel(const float* __restrict__ cost, size_t cost_plane,
                           size_t cost_row_stride, const float* __restrict__ gray,
                           float* __restrict__ lr, float* __restrict__ rl, int d_range, int h,
                           int w, int wp, float p1, float p2_init) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const HorizontalBlock<K> hb(cost, cost_plane, cost_row_stride, lr, rl, d_range, h, w, wp);
  constexpr int TILE = HorizontalBlock<K>::TILE;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const bool rev = hb.rev;
  const int ntiles = hb.ntiles, head = hb.head;  // steps before head lie beyond the image

  // rows d >= D stay so
  for (int i = tid; i < HS * TILE; i += 32 + HMOVERS) smem[i] = CUDART_INF_F;
  __syncthreads();

  auto fetch = [&](int in) { hb.fetch(smem, in, [](int) {}); };
  auto write_out = [&](int done) { hb.write_out(smem4, done); };

  // P2 of the 32 steps of a tile, one lane a step; the gray values of the
  // next tile are loaded while this one is walked.
  const float* grow = gray + (size_t)blockIdx.x * w;
  float ga = 0.f, gb = 0.f;
  auto gray_pair = [&](int ti) {
    const int x = hb.column(ti, lane), x_ref = rev ? x + 1 : x - 1;
    const bool ok = ti < ntiles && x < w && x_ref >= 0 && x_ref < w;
    ga = ok ? grow[x] : 0.f;
    gb = ok ? grow[x_ref] : 0.f;
  };
  float prev[1][K];
  float m[1] = {0.f};
  float p2_next = 0.f;
  if (tid < 32) {
    gray_pair(0);
    p2_next = adaptive_p2(p1, p2_init, ga, gb);
  }
  auto walk = [&](int ti) {
    const float p2_lane[1] = {p2_next};
    gray_pair(ti + 1);
    // the lane's rows d = lane K + k are K consecutive rows of the stage
    float4* rows = smem4 + ((ti % HS) * TILE + lane * K * HT) / 4;
    const int sw = lane & 7;
    const int g_first = ti == 0 ? head / GS : 0;
    float4 cur[K], nxt[K];
#pragma unroll
    for (int k = 0; k < K; ++k) cur[k] = rows[k * (HT / 4) + (g_first ^ sw)];
#pragma unroll 1
    for (int g = g_first; g < HT / GS; ++g) {
      if (g + 1 < HT / GS) {
#pragma unroll
        for (int k = 0; k < K; ++k) nxt[k] = rows[k * (HT / 4) + ((g + 1) ^ sw)];
      }
      float c[1][GS][K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        c[0][0][k] = cur[k].x; c[0][1][k] = cur[k].y; c[0][2][k] = cur[k].z; c[0][3][k] = cur[k].w;
      }
      walk_group<K, 1, GS>(c, prev, m, p1, p2_lane, g * GS, true, ti == 0 && g == g_first,
                           head % GS, lane);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        rows[k * (HT / 4) + (g ^ sw)] =
            make_float4(c[0][0][k], c[0][1][k], c[0][2][k], c[0][3][k]);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) cur[k] = nxt[k];
    }
    p2_next = adaptive_p2(p1, p2_init, ga, gb);
  };
  run_tiles<HS, false>(tid < 32, ntiles, fetch, [](int) {}, write_out, walk);
}

// ---------------------------------------------------------------------------
// Vertical: block = XC neighbouring columns; warp n of the first XC / 4 walks
// columns 4 n .. 4 n + 3 (one 16-byte chunk), the others move tiles of
// [VT image rows][32 K][XC].  SECOND = the bottom-up pass, whose movers store
// (lr + rl) + (ud + du) over lr.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float4 sum4(float4 a, float4 b, float4 u, float4 v) {
  return make_float4((a.x + b.x) + (u.x + v.x), (a.y + b.y) + (u.y + v.y),
                     (a.z + b.z) + (u.z + v.z), (a.w + b.w) + (u.w + v.w));
}

template <int K, bool SECOND, int XC>
__global__ void __launch_bounds__(VTHREADS<XC>, 1)
scanline_vertical_kernel(const float* __restrict__ cost, const float* __restrict__ gray,
                         float* lr, const float* __restrict__ rl, float* ud, int d_range,
                         int h, int w, int wp, int cost_width, float p1, float p2_init,
                         int vert_dm1, int vert_first) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  using V = Vertical<K, SECOND, XC>;
  using Y = Layout<XC>;
  constexpr int VT = V::VT, G = V::G, NS = V::NS, ROW = V::ROW, TILE = V::TILE;
  constexpr bool SIDES = V::SIDES;
  const VerticalMovers<K, SECOND, XC> mv(cost, lr, rl, ud, smem, d_range, h, w, wp);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int x0 = mv.x0, ntiles = mv.ntiles;
  const bool dm1 = vert_dm1 != 0, first_ref = vert_first != 0;

  // rows d >= D stay so
  for (int i = tid; i < NS * TILE; i += VTHREADS<XC>) smem[i] = CUDART_INF_F;
  __syncthreads();

  auto fetch = [&](int in) { mv.fetch(in, cost_width, [](int) {}); };
  auto fetch_sides = [&](int in) { mv.fetch_sides(in); };
  auto write_out = [&](int done) {
    mv.write_out(done, [](float4 a, float4 b, float4 u, float4 v) { return sum4(a, b, u, v); });
  };

  // Walker warp `wq` owns columns x0 + 4 wq .. + 3.  P2 of 32 steps at a time,
  // one lane a step; the gray values of the next 32 are loaded at the start
  // of a span of 32 and used at its end.
  const int wq = tid / 32;
  const bool walks = x0 + NC * wq < w;
  float ga[NC] = {0.f, 0.f, 0.f, 0.f}, gb[NC] = {0.f, 0.f, 0.f, 0.f};
  auto gray_pairs = [&](int span) {
    const int s = span * 32 + lane;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int x = x0 + NC * wq + n;
      const bool ok = walks && x < w && s >= 1 && s < h;
      ga[n] = ok ? gray[(size_t)mv.image_row(s) * w + x] : 0.f;
      gb[n] = ok ? gray[(size_t)mv.image_row(first_ref ? 0 : s - 1) * w + x] : 0.f;
    }
  };
  int at[K];  // the lane's 16-byte chunks in row 0 of a tile
#pragma unroll
  for (int k = 0; k < K; ++k) at[k] = Y::word(k * 32 + lane, NC * (wq % (XC / NC))) / 4;
  float prev[NC][K];
  float m[NC] = {0.f, 0.f, 0.f, 0.f};
  float p2_lane[NC] = {0.f, 0.f, 0.f, 0.f}, p2_next[NC];
  if (tid < 32 * (XC / NC)) gray_pairs(0);
#pragma unroll
  for (int n = 0; n < NC; ++n) p2_next[n] = adaptive_p2(p1, p2_init, ga[n], gb[n]);
  constexpr int TILES_PER_SPAN = 32 / VT;
  auto walk = [&](int ti) {
    if (!walks) return;
    const int phase = ti % TILES_PER_SPAN;
    if (phase == 0) {
#pragma unroll
      for (int n = 0; n < NC; ++n) p2_lane[n] = p2_next[n];
      gray_pairs(ti / TILES_PER_SPAN + 1);
    }
    float4* stage = smem4 + (ti % NS) * (TILE / 4);
    auto chunk_at = [&](int r, int k) {  // the lane's chunk k in tile row r
      return r * (ROW / 4) + (at[k] ^ (Y::row_swizzle(r) * Y::PP));
    };
#pragma unroll
    for (int g = 0; g < VT / G; ++g) {
      float c[NC][G][K];
#pragma unroll
      for (int j = 0; j < G; ++j) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float4 t = stage[chunk_at(g * G + j, k)];
          c[0][j][k] = t.x; c[1][j][k] = t.y; c[2][j][k] = t.z; c[3][j][k] = t.w;
        }
      }
      walk_group<K, NC, G>(c, prev, m, p1, p2_lane, phase * VT + g * G, dm1,
                           ti == 0 && g == 0, 0, lane);
#pragma unroll
      for (int j = 0; j < G; ++j) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          stage[chunk_at(g * G + j, k)] =
              make_float4(c[0][j][k], c[1][j][k], c[2][j][k], c[3][j][k]);
        }
      }
    }
    if (phase == TILES_PER_SPAN - 1) {
#pragma unroll
      for (int n = 0; n < NC; ++n) p2_next[n] = adaptive_p2(p1, p2_init, ga[n], gb[n]);
    }
  };
  run_tiles<NS, SIDES>(tid < 32 * (XC / NC), ntiles, fetch, fetch_sides, write_out, walk);
}

// A second stream per device (and the device's number of SMs), so that the
// top-down pass runs beside the horizontal passes: all three need nothing but
// the costs.  The fork and the join are events that the caller's stream
// records or waits for, so the call as a whole stays ordered on it.  All
// caller streams and host threads share a device's one side stream and event
// pair: the entry point holds `launch_mutex` from the lazy set-up here to its
// last launch, so a second caller records the events only after the first
// has enqueued its waits on them (a wait takes the event as recorded when
// the wait is enqueued).
std::mutex launch_mutex;

struct SideStream {
  cudaStream_t stream = nullptr;
  cudaEvent_t fork = nullptr, join = nullptr;
  int device = 0;
  int sm_count = 0;
};

cudaError_t side_stream(SideStream** out) {
  static SideStream sides[MAX_DEVICES];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  SideStream& side = sides[device];
  side.device = device;
  if (side.stream == nullptr) {
    err = cudaStreamCreateWithFlags(&side.stream, cudaStreamNonBlocking);
    if (err == cudaSuccess) err = cudaEventCreateWithFlags(&side.fork, cudaEventDisableTiming);
    if (err == cudaSuccess) err = cudaEventCreateWithFlags(&side.join, cudaEventDisableTiming);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&side.sm_count, cudaDevAttrMultiProcessorCount, device);
    }
    if (err != cudaSuccess) return err;
  }
  *out = &side;
  return cudaSuccess;
}

template <int K, bool SECOND, int XC>
cudaError_t launch_vertical(const float* cost, const float* gray, float* lr, float* rl, float* ud,
                            int d_range, int h, int w, int wp, int cost_width, float p1,
                            float p2, int vert_dm1, int vert_first, int device,
                            cudaStream_t s) {
  const size_t bytes = Vertical<K, SECOND, XC>::BYTES;
  static std::atomic<bool> sized[MAX_DEVICES];  // per instance and device, false at first
  const cudaError_t err =
      allow_shared_bytes(sized[device], scanline_vertical_kernel<K, SECOND, XC>, bytes);
  if (err != cudaSuccess) return err;
  scanline_vertical_kernel<K, SECOND, XC><<<(w + XC - 1) / XC, VTHREADS<XC>, bytes, s>>>(
      cost, gray, lr, rl, ud, d_range, h, w, wp, cost_width, p1, p2, vert_dm1, vert_first);
  return cudaGetLastError();
}

// Both horizontal passes of the h rows of `cost` (planes `cost_plane` and
// rows `cost_row_stride` floats apart) into lr and rl, [D, h, wp]: one block
// a (row, direction).
template <int K>
cudaError_t launch_horizontal(const float* cost, size_t cost_plane, size_t cost_row_stride,
                              const float* gray, float* lr, float* rl, int d_range, int h,
                              int w, int wp, float p1, float p2, int device, cudaStream_t s) {
  const size_t bytes = sizeof(float) * HS * 32 * K * HT;
  static std::atomic<bool> sized[MAX_DEVICES];  // per K and device, false at first
  const cudaError_t err = allow_shared_bytes(sized[device], scanline_horizontal_kernel<K>, bytes);
  if (err != cudaSuccess) return err;
  scanline_horizontal_kernel<K><<<dim3(h, 2), 32 + HMOVERS, bytes, s>>>(
      cost, cost_plane, cost_row_stride, gray, lr, rl, d_range, h, w, wp, p1, p2);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch(const float* cost, const float* gray, float* lr, float* rl, float* ud,
                   int d_range, int h, int w, int wp, float p1, float p2, int vert_dm1,
                   int vert_first, cudaStream_t s) {
  // the widest copy that every row of the cost volume allows, in floats
  const int cost_width = (w % 4 == 0 && (uintptr_t)cost % 16 == 0)  ? 4
                         : (w % 2 == 0 && (uintptr_t)cost % 8 == 0) ? 2
                                                                    : 1;
  SideStream* side = nullptr;
  cudaError_t err = side_stream(&side);
  if (err != cudaSuccess) return err;
  // top-down (side stream) beside the horizontal passes, then bottom-up
  if ((err = cudaEventRecord(side->fork, s)) != cudaSuccess) return err;
  if ((err = cudaStreamWaitEvent(side->stream, side->fork, 0)) != cudaSuccess) return err;
  const bool narrow = (w + 7) / 8 <= side->sm_count;  // blocks of 8 columns all fit the card
  err = narrow ? launch_vertical<K, false, 8>(cost, gray, lr, rl, ud, d_range, h, w, wp,
                                              cost_width, p1, p2, vert_dm1, vert_first,
                                              side->device, side->stream)
               : launch_vertical<K, false, 16>(cost, gray, lr, rl, ud, d_range, h, w, wp,
                                               cost_width, p1, p2, vert_dm1, vert_first,
                                               side->device, side->stream);
  if (err != cudaSuccess) return err;
  if ((err = cudaEventRecord(side->join, side->stream)) != cudaSuccess) return err;
  err = launch_horizontal<K>(cost, (size_t)h * w, w, gray, lr, rl, d_range, h, w, wp, p1, p2,
                             side->device, s);
  if (err != cudaSuccess) return err;
  if ((err = cudaStreamWaitEvent(s, side->join, 0)) != cudaSuccess) return err;
  return narrow ? launch_vertical<K, true, 8>(cost, gray, lr, rl, ud, d_range, h, w, wp,
                                              cost_width, p1, p2, vert_dm1, vert_first,
                                              side->device, s)
                : launch_vertical<K, true, 16>(cost, gray, lr, rl, ud, d_range, h, w, wp,
                                               cost_width, p1, p2, vert_dm1, vert_first,
                                               side->device, s);
}

}  // namespace

// Launch on `stream`.  cost: float32 [d_range, h, w]; gray: float32 [h, w];
// scratch: float32 [2, d_range, h, wp]; out: float32 [d_range, h, wp] with
// wp = w rounded up to a multiple of 4 (columns w .. wp - 1 of out hold no
// meaning); all contiguous and 16-byte aligned on the current device;
// 1 <= d_range <= 256.  p1, p2 are the effective penalties.  Returns
// cudaGetLastError() after the launches (0 = launched),
// cudaErrorInvalidValue for a size outside the range or a misaligned buffer.
extern "C" int scanline_optimize_f32(const void* cost, const void* gray, void* scratch,
                                     void* out, int d_range, int h, int w, float p1,
                                     float p2, int vert_dm1, int vert_first,
                                     void* stream) {
  const int wp = (w + 3) / 4 * 4;
  // the vertical movers keep offsets into the volumes in 32 bits
  if (d_range < 1 || d_range > 256 || h < 1 || w < 1 ||
      (unsigned long long)d_range * h * wp > 0xffffffffull ||
      ((uintptr_t)scratch | (uintptr_t)out) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const std::lock_guard<std::mutex> lock(launch_mutex);  // see SideStream
  cudaStream_t s = (cudaStream_t)stream;
  const float* c = (const float*)cost;
  const float* g = (const float*)gray;
  float* lr = (float*)out;  // left-right, then the sum
  float* rl = (float*)scratch;
  float* ud = rl + (size_t)d_range * h * wp;
#define SCANLINE_LAUNCH(K) \
  return (int)launch<K>(c, g, lr, rl, ud, d_range, h, w, wp, p1, p2, vert_dm1, vert_first, s);
  if (d_range <= 32) SCANLINE_LAUNCH(1)
  if (d_range <= 64) SCANLINE_LAUNCH(2)
  if (d_range <= 128) SCANLINE_LAUNCH(4)
  SCANLINE_LAUNCH(8)
#undef SCANLINE_LAUNCH
}

// Both horizontal passes of a band of the streamed executor, on `stream`, in
// one launch (blocks (row, direction)): cost: float32 [d_range, t, w] with
// d-planes `cost_plane` and rows `cost_row_stride` floats apart and its
// columns contiguous (a band that is a row range of a taller volume is read
// in place); gray: float32 [t, w], contiguous, the band's rows of the image
// that drives P2; lr, rl: float32 [d_range, t, wp], wp = w rounded up to a
// multiple of 4, 16-byte aligned (columns w .. wp - 1 hold no meaning).
// 1 <= d_range <= 256.  Each row is a whole path, as in
// scanline_optimize_f32.  Returns cudaGetLastError() after the launch,
// cudaErrorInvalidValue for a size outside the range or a misaligned output.
extern "C" int scanline_horizontal_band_f32(const void* cost, long long cost_plane,
                                            long long cost_row_stride, const void* gray,
                                            void* lr, void* rl, int d_range, int t, int w,
                                            float p1, float p2_init, void* stream) {
  const int wp = (w + 3) / 4 * 4;
  if (d_range < 1 || d_range > 256 || t < 1 || w < 1 || cost_plane < 0 ||
      cost_row_stride < 0 || ((uintptr_t)lr | (uintptr_t)rl) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  int device = 0, sm_count = 0;
  const cudaError_t err = current_device(&device, &sm_count);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* c = (const float*)cost;
  const float* g = (const float*)gray;
  float* l = (float*)lr;
  float* r = (float*)rl;
#define HORIZONTAL_LAUNCH(K)                                                                  \
  return (int)launch_horizontal<K>(c, (size_t)cost_plane, (size_t)cost_row_stride, g, l, r, \
                                   d_range, t, w, wp, p1, p2_init, device, s);
  if (d_range <= 32) HORIZONTAL_LAUNCH(1)
  if (d_range <= 64) HORIZONTAL_LAUNCH(2)
  if (d_range <= 128) HORIZONTAL_LAUNCH(4)
  HORIZONTAL_LAUNCH(8)
#undef HORIZONTAL_LAUNCH
}
