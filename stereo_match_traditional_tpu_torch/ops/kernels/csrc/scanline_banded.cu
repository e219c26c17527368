// Banded scanline passes for Hopper (sm_90a): one directional pass of the
// 4-path scanline over a band of path steps, continued from a carry that the
// neighbouring band handed over (the streamed executor,
// stereo_match_traditional_tpu_torch/parallel/streamed.py, and the vertical
// passes of the tiled one, parallel/scan_carry.py).
//
// Replaces no Pallas kernel: the JAX package runs these passes with lax.scan
// (stereo_match_traditional_tpu/ops/scanline.py:126 directional_pass_banded,
// :266 canonical_pass_banded).  The plain versions are the port's
// ops/scanline.py functions of the same names.  Two kernels, each with two C
// entries: scanline_banded_f32 / scanline_banded_canonical_f32 (the walker /
// mover kernel below) and scanline_banded_wide_f32 /
// scanline_banded_wide_canonical_f32 (the wide kernel, any D and any
// strides); the legacy family takes a penalty p2 a (step, lane), the
// canonical family a penalty scale a (step, disparity, lane).
//
//   out(t, d) = c(t, d) + min(prev(d), prev(d-1) + P1, prev(d+1) + P1,
//                             prev_min + P2) - prev_min
//
// with +inf at d = -1 and d = D; legacy: P1 = p1, P2 = p2(t, m), and with
// dm1 = 0 the reference's vertical quirk l2 = prev(d) + P1; canonical:
// P1 = p1_base * s(t, d, m), P2 = p2_base * s(t, d, m).  The operations are
// the plain version's, in its order, each rounded once (__fadd_rn, __fsub_rn,
// __fmul_rn: nvcc contracts no FMA through them), and a minimum is exact in
// any order; rounding is monotone, so min_d (u_d - m) = (min_d u_d) - m.  Both
// kernels equal the plain version bit for bit.
//
// Layout.  cost, the penalties and out are read and written through three
// strides each (step, disparity, lane; in floats), so one entry runs the
// vertical pass of a [D, t, W] band (steps along rows, lanes along columns)
// without a transposed copy.  A negative step stride, from a base at the
// path's first step, runs a path backwards.  The carry (prev [D, M],
// prev_min [M]) is read at the start and written at the end; reset is the one
// path step before which the carry is zero (-1: none); out may be null (only
// the carry is wanted).
//
// The walker / mover kernel (D <= 256, lanes contiguous: the vertical passes
// of both executors) is the direct kernels' vertical design (scanline.cu's
// header; the ring of stages, the layouts and the mover shares of
// scanline_tiles.cuh).  A block takes XC = 8 or 16 neighbouring lanes; each
// walker warp holds the D values of NW = 2 lanes in registers (lane l has
// d = l K .. l K + K - 1, K = ceil(D / 32) rounded to a power of two), steps
// from registers with two shuffles and one redux.sync on the
// order-preserving integer image of the minimum, and meets the block at one
// barrier a tile of VT steps (8, 4, then 2 or 1 as K grows), not on every
// step.
// Eight mover warps stage the tiles ([VT steps][32 K slots][XC lanes];
// canonical: the scales' tile beside it; legacy: the tile's [VT][XC]
// penalties) with cp.async several tiles ahead and write the walked tiles
// out.  Copies are 16 bytes wide where the tensor's base, step and
// disparity strides and M allow, else 8 or 4, chosen a tensor per launch
// inside the same kernel; every offset is 64-bit.  One block a SM: XC = 8
// where the blocks of 8 lanes all fit the card at once, else 16.
//
// What bounds it: bytes.  The pass reads the band (and, canonical, its
// scales) once and writes it once; ~10 operations a value.  A block's step
// takes ~0.34 us on an NVIDIA H100 80GB HBM3 at 700 W (its walkers' step
// chain and its movers' copies), so a band of few lanes (a rank's column
// slab) takes about its path length times that; a wide one is moved at the
// rate its blocks' copies reach.
//
// The wide kernel (any D up to 7232, any strides: D > 256, the strided
// horizontal layout, the whole-image passes of the direct entries and both
// horizontal passes of the band entries above 256 disparities, read from the
// d-major volume as it lies) carries the same design to wide D.  For D <=
// 1024 one walker warp holds one lane's D values in registers (K = ceil(D /
// 32) a thread, rounded up to 1, 2, 4, 8 or a multiple of 4) and steps with
// walk_steps; the block meets at one barrier a tile.  Four mover warps stage
// tiles of [steps][lanes][32 K slots] (canonical: the scales' tile beside it;
// legacy: [steps][lanes] penalties) through a ring of 4 stages (run_tiles),
// cut into chunks of up to 4 neighbours along the cost's contiguous
// dimension: along the lanes for a vertical pass (8 lanes a block: 32-byte
// runs of a row), along the steps for a horizontal one (a lane a block, up
// to 32 steps a tile: 128-byte runs; a reversed path's chunk is copied in
// memory order and read mirrored).  A mover copies a chunk whole, 16 or 8
// bytes where copy_width allows, else value by value (any strides); a warp
// of movers covers all chunks of a few slots, so each copy instruction
// touches a few d-planes of the volume.  Walkers read a vertical tile one
// value a slot (4-way bank conflicts), a horizontal one a chunk of 4 steps a
// slot (one 16-byte load, the steps walked from registers).  The tile takes
// the most steps whose ring fits a SM's shared memory.  Above 1024
// disparities the shared-memory kernel runs instead: prev of WL = 8 lanes in
// shared memory ([D][8], updated in place), each of WG = 32 thread groups a
// run of ceil(D / 32) disparities, two barriers a step; 32 D + 1 KB of
// shared memory, so D <= 7232 (227 KB).
//
// What bounds the wide kernel: bytes, as above.  Its movers reach ~13 GB/s
// a SM (NVIDIA H100 80GB HBM3 at 700 W, tools/wide_variants.py with the
// walkers off), half the card's share, so a pass of the full-size
// Middlebury volume takes about twice its bound; a horizontal pass (a
// walker warp a SM) is bound as much by the walkers' step chain.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <atomic>
#include <cstdint>

#include "scanline_tiles.cuh"

namespace {

// ---------------------------------------------------------------------------
// The walker / mover kernel.
// ---------------------------------------------------------------------------

template <int K, bool CANON, int XC>
struct Banded {
  static constexpr int NW = 2;                      // lanes a walker warp walks
  static constexpr int THREADS = 32 * (XC / NW) + VMOVERS;
  static constexpr int VT = K >= 8 ? (CANON ? 2 : 1) : (K >= 4 ? 4 : 8);  // steps of a tile
  static constexpr int G = K >= 4 ? 1 : 4 / K;      // steps a walker takes at once
  static constexpr int ROW = 32 * K * XC;           // words of one step of a tile
  static constexpr int TILE = ROW * VT;
  static constexpr int PEN = CANON ? TILE : VT * XC;  // words of a stage's penalties
  static constexpr size_t STAGE = sizeof(float) * (TILE + PEN);
  static constexpr size_t BUDGET = 200 * 1024;      // one block a SM
  static constexpr int NS = BUDGET / STAGE >= 6 ? 6 : (BUDGET / STAGE >= 3 ? BUDGET / STAGE : 3);
  static constexpr size_t BYTES = NS * STAGE;
  static_assert(BYTES <= 227 * 1024, "a stage ring fits the SM's shared memory");
  static_assert(VT % G == 0, "a tile is whole groups of steps");
};

// The widest copy (in floats) that a tensor allows at every piece: its base
// 4 w bytes aligned, its step and disparity strides and the lanes multiples
// of w.
inline int copy_width(const void* base, long long st, long long sd, int m_lanes) {
  const auto ok = [&](int w) {
    return (uintptr_t)base % (4 * w) == 0 && st % w == 0 && sd % w == 0 && m_lanes % w == 0;
  };
  return ok(4) ? 4 : ok(2) ? 2 : 1;
}

// A 16-byte copy, past L1, to a shared-memory address.
__device__ __forceinline__ void cp_async16_at(unsigned dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

// Four lanes of an output row, of which the first n lie in the band, as
// stores of WIDTH floats.
template <int WIDTH>
__device__ __forceinline__ void store_piece(float* dst, float4 v, int n) {
  if (WIDTH == 4) {
    *reinterpret_cast<float4*>(dst) = v;
  } else if (WIDTH == 2) {  // M is even, so n is 2 or 4
    *reinterpret_cast<float2*>(dst) = make_float2(v.x, v.y);
    if (n >= 4) *reinterpret_cast<float2*>(dst + 2) = make_float2(v.z, v.w);
  } else {
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < n) dst[i] = e[i];
    }
  }
}

// A block's movers (the 256 threads after its walker warps).  Mover `mt`
// carries, of tile step r = (mt / PP) % VT and lanes 4 (mt % PP) .. + 3 of
// the block, the slots slot0 + STRIDE i (Share in scanline_tiles.cuh), whose
// disparities are d0 + off(i).  Legacy: movers 0 .. VT XC - 1 also copy one
// penalty each of a tile.
template <int K, bool CANON, int XC>
struct BandedMovers {
  using B = Banded<K, CANON, XC>;
  using Y = Layout<XC>;
  using S = Share<K, B::VT, XC>;
  static constexpr int VT = B::VT, NS = B::NS, TILE = B::TILE;
  // Slot s holds d = (s % 32) K + s / 32, and slot0 < STRIDE: the slots
  // slot0 + STRIDE i hold d0 + off(i), d0 = (slot0 % 32) K + slot0 / 32.
  static constexpr int Q = S::STRIDE < 32 ? 32 / S::STRIDE : 1;    // pieces a lap of 32 slots
  static constexpr int LAP = S::STRIDE > 32 ? S::STRIDE / 32 : 1;  // laps a piece
  static __device__ __forceinline__ constexpr int off(int i) {
    return (i % Q) * S::STRIDE * K + (i / Q) * LAP;
  }

  const float* cost;
  long long cs_t, cs_d;
  const float* pen;
  long long ps_t, ps_d, ps_m;
  float* out;
  long long os_t, os_d;
  float* smem;  // NS cost stages, then NS penalty stages
  unsigned smem_at;  // its shared-memory address, for 16-byte copies
  int n_steps, d_range, m_lanes, x0, ntiles, mt, mx, mr, word0, d0, n;
  bool in_lanes;

  __device__ __forceinline__ BandedMovers(const float* cost_, long long cs_t_, long long cs_d_,
                                          const float* pen_, long long ps_t_, long long ps_d_,
                                          long long ps_m_, float* out_, long long os_t_,
                                          long long os_d_, float* smem_, int n_steps_,
                                          int d_range_, int m_lanes_)
      : cost(cost_), cs_t(cs_t_), cs_d(cs_d_), pen(pen_), ps_t(ps_t_), ps_d(ps_d_),
        ps_m(ps_m_), out(out_), os_t(os_t_), os_d(os_d_), smem(smem_), n_steps(n_steps_),
        d_range(d_range_), m_lanes(m_lanes_), x0(blockIdx.x * XC),
        ntiles((n_steps_ + VT - 1) / VT) {
    mt = (int)threadIdx.x - 32 * (XC / B::NW);
    mx = (mt % S::PP) * 4;
    mr = (mt / S::PP) % VT;
    const int slot0 = mt / (S::PP * VT);
    word0 = mr * B::ROW + Y::word(slot0 ^ Y::row_swizzle(mr), mx);
    d0 = (slot0 % 32) * K + slot0 / 32;
    n = m_lanes - x0 - mx;
    in_lanes = n > 0;
    smem_at = (unsigned)__cvta_generic_to_shared(smem);
  }

  // Words from smem to a tile's stage of costs, and of penalties
  __device__ __forceinline__ int cost_stage(int tile) const { return (tile % NS) * TILE; }
  __device__ __forceinline__ int pen_stage(int tile) const { return NS * TILE + (tile % NS) * B::PEN; }

  // The mover's pieces of path step t of `vol` into the stage `stage` words
  // from smem; the 16-byte copies take their shared address from smem_at
  // (no address conversion a copy).
  template <int WIDTH>
  __device__ __forceinline__ void fetch_as(const float* vol, long long st, long long sd,
                                           int stage, int t) const {
    const float* src = vol + (long long)t * st + (long long)d0 * sd + x0 + mx;
    const int d_left = d_range - d0;
#pragma unroll
    for (int i = 0; i < S::NP; ++i) {
      if (off(i) < d_left) {
        const int word = stage + word0 + S::STRIDE * XC * i;
        if (WIDTH == 4) {
          cp_async16_at(smem_at + 4u * word, src + (long long)off(i) * sd);
        } else {
          copy_cost_piece<WIDTH>(smem + word, src + (long long)off(i) * sd, n);
        }
      }
    }
  }

  __device__ __forceinline__ void fetch_volume(const float* vol, long long st, long long sd,
                                               int width, int stage, int t) const {
    if (width == 4) fetch_as<4>(vol, st, sd, stage, t);
    else if (width == 2) fetch_as<2>(vol, st, sd, stage, t);
    else fetch_as<1>(vol, st, sd, stage, t);
  }

  // Commits one cp.async group: tile `in`'s costs and penalties (nothing
  // past the last tile).
  __device__ __forceinline__ void fetch(int in, int cost_width, int pen_width) const {
    if (in < ntiles) {
      const int t = in * VT + mr;
      if (in_lanes && t < n_steps) {
        fetch_volume(cost, cs_t, cs_d, cost_width, cost_stage(in), t);
        if (CANON) fetch_volume(pen, ps_t, ps_d, pen_width, pen_stage(in), t);
      }
      if (!CANON && mt < VT * XC) {
        const int r = mt / XC, x = mt % XC, tr = in * VT + r;
        if (tr < n_steps && x0 + x < m_lanes) {
          cp_async4(smem + pen_stage(in) + r * XC + x,
                    pen + (long long)tr * ps_t + (long long)(x0 + x) * ps_m);
        }
      }
    }
    cp_async_commit();
  }

  template <int WIDTH>
  __device__ __forceinline__ void write_as(int done) const {
    const float* stage = smem + cost_stage(done) + word0;
    float* dst = out + (long long)(done * VT + mr) * os_t + (long long)d0 * os_d + x0 + mx;
    const int d_left = d_range - d0;
#pragma unroll
    for (int i = 0; i < S::NP; ++i) {
      if (off(i) < d_left) {
        store_piece<WIDTH>(dst + (long long)off(i) * os_d,
                           *reinterpret_cast<const float4*>(stage + S::STRIDE * XC * i), n);
      }
    }
  }

  // Stores the walked tile `done` (nothing without an output).
  __device__ __forceinline__ void write_out(int done, int out_width) const {
    if (out == nullptr || !in_lanes || done * VT + mr >= n_steps) return;
    if (out_width == 4) write_as<4>(done);
    else if (out_width == 2) write_as<2>(done);
    else write_as<1>(done);
  }
};

// G steps of a walker warp over its NW lanes (their chains interleave),
// from path step step0.  c[n][j] holds the costs of step j of lane n on entry
// and the step's values on return; s the canonical scales, p2 the legacy
// penalties; prev and m carry the paths' state.  Steps from n_steps on are
// not walked; at step `reset` the carry is zero.
template <int K, int NW, int G, bool CANON>
__device__ __forceinline__ void walk_steps(float (&c)[NW][G][K], const float (&s)[NW][G][K],
                                           const float (&p2)[G][NW], float (&prev)[NW][K],
                                           float (&m)[NW], float p1, float p2_base, bool dm1,
                                           int step0, int n_steps, int reset, int d_range,
                                           int lane) {
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (step0 + j >= n_steps) break;
    if (step0 + j == reset) {
#pragma unroll
      for (int n = 0; n < NW; ++n) {
#pragma unroll
        for (int k = 0; k < K; ++k) prev[n][k] = lane * K + k < d_range ? 0.f : CUDART_INF_F;
        m[n] = 0.f;
      }
    }
    float u[NW][K], u_min[NW];
#pragma unroll
    for (int n = 0; n < NW; ++n) {
      if (CANON) {
        float below = __shfl_up_sync(FULL, prev[n][K - 1], 1);  // prev(d - 1) for k = 0
        float above = __shfl_down_sync(FULL, prev[n][0], 1);    // prev(d + 1) for k = K - 1
        if (lane == 0) below = CUDART_INF_F;
        if (lane == 31) above = CUDART_INF_F;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float p1s = __fmul_rn(p1, s[n][j][k]), p2s = __fmul_rn(p2_base, s[n][j][k]);
          const float l2 = __fadd_rn(k > 0 ? prev[n][k > 0 ? k - 1 : 0] : below, p1s);
          const float l3 = __fadd_rn(k + 1 < K ? prev[n][k + 1 < K ? k + 1 : k] : above, p1s);
          const float rest = fminf(fminf(prev[n][k], l2), l3);  // ready before m is
          u[n][k] = __fadd_rn(c[n][j][k], fminf(rest, __fadd_rn(m[n], p2s)));
        }
      } else {
        float q[K];  // prev(d) + P1
#pragma unroll
        for (int k = 0; k < K; ++k) q[k] = __fadd_rn(prev[n][k], p1);
        float below = __shfl_up_sync(FULL, q[K - 1], 1);
        float above = __shfl_down_sync(FULL, q[0], 1);
        if (lane == 0) below = CUDART_INF_F;
        if (lane == 31) above = CUDART_INF_F;
        const float l4 = __fadd_rn(m[n], p2[j][n]);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float l2 = dm1 ? (k > 0 ? q[k > 0 ? k - 1 : 0] : below) : q[k];
          const float l3 = k + 1 < K ? q[k + 1 < K ? k + 1 : k] : above;
          const float rest = fminf(fminf(prev[n][k], l2), l3);
          u[n][k] = __fadd_rn(c[n][j][k], fminf(rest, l4));
        }
      }
      u_min[n] = tree_min<K>(u[n]);
    }
#pragma unroll
    for (int n = 0; n < NW; ++n) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        prev[n][k] = __fsub_rn(u[n][k], m[n]);
        c[n][j][k] = prev[n][k];
      }
      m[n] = __fsub_rn(warp_min(u_min[n]), m[n]);
    }
  }
}

// NW floats of shared memory (8- or 16-byte aligned) and back
template <int NW>
__device__ __forceinline__ void load_lanes(const float* p, float (&v)[NW]) {
  if constexpr (NW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  }
}
template <int NW>
__device__ __forceinline__ void store_lanes(float* p, const float (&v)[NW]) {
  if constexpr (NW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}

template <int K, bool CANON, int XC>
__global__ void __launch_bounds__(Banded<K, CANON, XC>::THREADS, 1)
banded_walker_kernel(const float* __restrict__ cost, long long cs_t, long long cs_d,
                     const float* __restrict__ pen, long long ps_t, long long ps_d, long long ps_m,
                     float* out, long long os_t, long long os_d,
                     const float* __restrict__ cin, const float* __restrict__ cin_min,
                     float* cout, float* cout_min, int n_steps, int d_range, int m_lanes,
                     float p1, float p2, int reset, int dm1, int cost_width, int pen_width,
                     int out_width) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  using B = Banded<K, CANON, XC>;
  using Y = Layout<XC>;
  constexpr int VT = B::VT, G = B::G, NS = B::NS, ROW = B::ROW, TILE = B::TILE, NW = B::NW;
  const BandedMovers<K, CANON, XC> mv(cost, cs_t, cs_d, pen, ps_t, ps_d, ps_m, out, os_t, os_d,
                                      smem, n_steps, d_range, m_lanes);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int x0 = mv.x0;

  // slots d >= D stay so: +inf costs, unit scales
  for (int i = tid; i < NS * TILE; i += B::THREADS) smem[i] = CUDART_INF_F;
  if (CANON) {
    for (int i = tid; i < NS * TILE; i += B::THREADS) smem[NS * TILE + i] = 1.f;
  }

  // Walker warp `wq` owns lanes x0 + NW wq .., from the incoming carry.
  const int wq = tid / 32;
  const bool walker = tid < 32 * (XC / NW);
  const bool walks = walker && x0 + NW * wq < m_lanes;
  float prev[NW][K];
  float m[NW];
#pragma unroll
  for (int n = 0; n < NW; ++n) {
    const int x = x0 + NW * wq + n;
    const bool ok = walks && x < m_lanes;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = lane * K + k;
      prev[n][k] = ok && d < d_range ? cin[(size_t)d * m_lanes + x] : CUDART_INF_F;
    }
    m[n] = ok ? cin_min[x] : 0.f;
  }
  int at[K];  // the word of the lane's value k at its first lane in step 0 of a tile
#pragma unroll
  for (int k = 0; k < K; ++k) at[k] = Y::word(k * 32 + lane, NW * (wq % (XC / NW)));
  __syncthreads();

  auto fetch = [&](int in) { mv.fetch(in, cost_width, pen_width); };
  auto write_out = [&](int done) { mv.write_out(done, out_width); };
  const bool dm1b = dm1 != 0;
  auto walk = [&](int ti) {
    if (!walks) return;
    float* stage = smem + mv.cost_stage(ti);
    const float* pstage = smem + mv.pen_stage(ti);
    auto word_at = [&](int r, int k) {  // the lane's value k in tile step r
      return r * ROW + (at[k] ^ (Y::row_swizzle(r) * XC));
    };
    // a group's costs (canonical: and scales; legacy: penalties) in registers
    struct Group {
      float c[NW][G][K], s[NW][G][K], p2[G][NW];
    };
    auto load = [&](Group& grp, int g) {
#pragma unroll
      for (int j = 0; j < G; ++j) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float v[NW];
          load_lanes<NW>(stage + word_at(g * G + j, k), v);
#pragma unroll
          for (int n = 0; n < NW; ++n) grp.c[n][j][k] = v[n];
          if (CANON) {
            load_lanes<NW>(pstage + word_at(g * G + j, k), v);
#pragma unroll
            for (int n = 0; n < NW; ++n) grp.s[n][j][k] = v[n];
          }
        }
        if (!CANON) load_lanes<NW>(pstage + (g * G + j) * XC + NW * wq, grp.p2[j]);
      }
    };
    // the next group is loaded before this one is walked and stored back
    Group cur, nxt;
    load(cur, 0);
#pragma unroll
    for (int g = 0; g < VT / G; ++g) {
      const int step0 = ti * VT + g * G;
      if (step0 >= n_steps) break;
      if (g + 1 < VT / G) load(nxt, g + 1);
      walk_steps<K, NW, G, CANON>(cur.c, cur.s, cur.p2, prev, m, p1, p2, dm1b, step0, n_steps,
                                  reset, d_range, lane);
#pragma unroll
      for (int j = 0; j < G; ++j) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float v[NW];
#pragma unroll
          for (int n = 0; n < NW; ++n) v[n] = cur.c[n][j][k];
          store_lanes<NW>(stage + word_at(g * G + j, k), v);
        }
      }
      cur = nxt;
    }
  };
  run_tiles<NS, false>(walker, mv.ntiles, fetch, [](int) {}, write_out, walk);

  if (!walks) return;
#pragma unroll
  for (int n = 0; n < NW; ++n) {
    const int x = x0 + NW * wq + n;
    if (x >= m_lanes) continue;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = lane * K + k;
      if (d < d_range) cout[(size_t)d * m_lanes + x] = prev[n][k];
    }
    if (lane == 0) cout_min[x] = m[n];
  }
}

struct Pass {
  const float* cost;
  long long cs_t, cs_d, cs_m;
  const float* pen;
  long long ps_t, ps_d, ps_m;
  float* out;
  long long os_t, os_d, os_m;
  const float *cin, *cin_min;
  float *cout, *cout_min;
  int n_steps, d_range, m_lanes;
  float p1, p2;
  int reset, dm1;
};

template <int K, bool CANON, int XC>
cudaError_t launch_walker(const Pass& a, int device, cudaStream_t s) {
  using B = Banded<K, CANON, XC>;
  static std::atomic<bool> sized[MAX_DEVICES];  // per instance and device, false at first
  const cudaError_t err =
      allow_shared_bytes(sized[device], banded_walker_kernel<K, CANON, XC>, B::BYTES);
  if (err != cudaSuccess) return err;
  const int cw = copy_width(a.cost, a.cs_t, a.cs_d, a.m_lanes);
  const int pw = CANON ? copy_width(a.pen, a.ps_t, a.ps_d, a.m_lanes) : 1;
  const int ow = a.out != nullptr ? copy_width(a.out, a.os_t, a.os_d, a.m_lanes) : 1;
  banded_walker_kernel<K, CANON, XC><<<(a.m_lanes + XC - 1) / XC, B::THREADS, B::BYTES, s>>>(
      a.cost, a.cs_t, a.cs_d, a.pen, a.ps_t, a.ps_d, a.ps_m, a.out, a.os_t, a.os_d, a.cin,
      a.cin_min, a.cout, a.cout_min, a.n_steps, a.d_range, a.m_lanes, a.p1, a.p2, a.reset,
      a.dm1, cw, pw, ow);
  return cudaGetLastError();
}

template <int K, bool CANON>
cudaError_t launch_walker_k(const Pass& a, int device, int sm_count, cudaStream_t s) {
  // blocks of 8 lanes where they all fit the card at once
  if ((a.m_lanes + 7) / 8 <= sm_count) return launch_walker<K, CANON, 8>(a, device, s);
  return launch_walker<K, CANON, 16>(a, device, s);
}

template <bool CANON>
int run_walker(const Pass& a, void* stream) {
  if (a.n_steps < 1 || a.d_range < 1 || a.d_range > 256 || a.m_lanes < 1 ||
      (a.cs_m != 1 && a.m_lanes > 1) || (a.out != nullptr && a.os_m != 1 && a.m_lanes > 1) ||
      (CANON && a.ps_m != 1 && a.m_lanes > 1)) {
    return (int)cudaErrorInvalidValue;
  }
  int device = 0, sm_count = 0;
  const cudaError_t err = current_device(&device, &sm_count);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (a.d_range <= 32) return (int)launch_walker_k<1, CANON>(a, device, sm_count, s);
  if (a.d_range <= 64) return (int)launch_walker_k<2, CANON>(a, device, sm_count, s);
  if (a.d_range <= 128) return (int)launch_walker_k<4, CANON>(a, device, sm_count, s);
  return (int)launch_walker_k<8, CANON>(a, device, sm_count, s);
}

// ---------------------------------------------------------------------------
// The wide kernel: any D, any strides.
// ---------------------------------------------------------------------------

constexpr int WMOVERS = 128;         // mover threads a block (4 warps)
constexpr int WIDE_LANES = 8;        // the most lanes a block, one walker warp each
constexpr int WIDE_NS = 4;           // stages of the ring: two tiles on their way
constexpr int WIDE_REG_MAX_DISP = 1024;  // the walker / mover route: K <= 32
constexpr int WIDE_MAX_DISP = 7232;  // the shared-memory route: 32 D + 1 KB <= 227 KB

// A launch's tiles: 1 << lb lanes a block, 1 << vb steps a tile, P of them.
// A tile is cut into chunks of C = min(4, NI) neighbours along its inner
// dimension, the one the cost is contiguous along (`lanes_inner`: the lanes,
// a vertical pass; else the steps, a horizontal pass on a d-major band; NI
// its extent, NO the other's): chunk (o, ci) of slot s (slot k 32 + l holds
// d = l K + k, walker lane l's value k) lies at o os + ci cs + s C, so that a
// mover copies a chunk whole (16, 8 or 4 bytes) and a warp of movers covers
// all chunks of 32 / PPS slots (PPS = NO NC chunks a slot), a few d, each in
// its own stretch of the d-major volume.  cs = C (32 K + u), os = NC cs, u =
// max(1, 32 / P): the movers' copies are free of bank conflicts; a walker
// reading 32 slots of one chunk position meets C-way conflicts (lanes
// inner), or reads whole chunks, 32 of them side by side (steps inner).
struct WideTile {
  int lb, vb, lanes_inner;
  int rev;            // steps inner on a reversed path: a chunk holds its steps mirrored
  int cl, lnc, lpps;  // log2 of C, of the chunks along the inner dimension, of PPS
  int cs, os, tile, stage;  // words; stage: cost (+ scales) + legacy penalties
};

template <int K, bool CANON>
WideTile wide_tile(int lb, int vb, int lanes_inner, int rev) {
  WideTile g{lb, vb, lanes_inner, rev, 0, 0, 0, 0, 0, 0, 0};
  const int ni = lanes_inner ? lb : vb, no = lanes_inner ? vb : lb;
  g.cl = ni < 2 ? ni : 2;
  g.lnc = ni - g.cl;
  g.lpps = no + g.lnc;
  const int u = lb + vb < 5 ? 32 >> (lb + vb) : 1;
  g.cs = (32 * K + u) << g.cl;
  g.os = g.cs << g.lnc;
  g.tile = g.os << no;
  g.stage = CANON ? 2 * g.tile : g.tile + (((1 << (lb + vb)) + 3) & ~3);
  return g;
}

// How a wide block's movers copy one tensor: w floats a copy along the
// tile's inner dimension (4 or 2: that dimension contiguous in the path's
// direction and every chunk 4 w bytes aligned, as copy_width finds; a
// reversed path's chunk is copied in memory order, its steps mirrored), or
// w = 1: each value alone at stride `is` along it (any strides).
struct WideCopy {
  int w;
  long long is;
};

// One tensor of a wide block's movers: a volume [T, D, M] (cost, scales,
// out) at its strides.  Mover mt carries chunk (o, ci) = the tile's piece
// mt % PPS of slots mt / PPS + 128 / PPS i; f(word, address, n) for each
// chunk in the band (its first n <= C values, d < D).  Every offset is
// 64-bit.
template <int K>
struct WideVolume {
  static constexpr int SLOTS = 32 * K;
  const float* base;
  long long st, sd, sm;

  template <typename F>
  __device__ __forceinline__ void pieces(const WideTile& g, int mt, int ti, int x0, int n_steps,
                                         int d_range, int m_lanes, F f) const {
    const int oc = mt & ((1 << g.lpps) - 1);
    const int o = oc >> g.lnc, ci = oc & ((1 << g.lnc) - 1), c = 1 << g.cl;
    int t, x, n;
    if (g.lanes_inner) {
      t = ti * (1 << g.vb) + o;
      x = x0 + (ci << g.cl);
      n = t < n_steps ? min(c, m_lanes - x) : 0;
    } else {
      t = ti * (1 << g.vb) + (ci << g.cl);
      x = x0 + o;
      n = x < m_lanes ? min(c, n_steps - t) : 0;
    }
    if (n <= 0) return;
    const float* row = base + (long long)t * st + (long long)x * sm;
    const int word = o * g.os + ci * g.cs;
    for (int slot = mt >> g.lpps; slot < SLOTS; slot += WMOVERS >> g.lpps) {
      const int d = (slot & 31) * K + (slot >> 5);
      if (d < d_range) f(word + (slot << g.cl), row + (long long)d * sd, n);
    }
  }
};

// K values a walker lane (a power of two up to 8, then multiples of 4 up to
// 32: D <= 1024) for d_range disparities
inline int wide_k(int d_range) {
  const int k = (d_range + 31) / 32;
  return k <= 2 ? k : (k <= 4 ? 4 : (k <= 8 ? 8 : (k + 3) / 4 * 4));
}

// G neighbouring floats of shared memory (aligned to G), reversed when
// `rev`, and back
template <int G>
__device__ __forceinline__ void load_run(const float* p, bool rev, float (&v)[G]) {
  if constexpr (G == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    if (rev) { v[0] = t.w; v[1] = t.z; v[2] = t.y; v[3] = t.x; }
    else { v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w; }
  } else if constexpr (G == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    if (rev) { v[0] = t.y; v[1] = t.x; }
    else { v[0] = t.x; v[1] = t.y; }
  } else {
    v[0] = *p;
  }
}
template <int G>
__device__ __forceinline__ void store_run(float* p, bool rev, const float (&v)[G]) {
  if constexpr (G == 4) {
    *reinterpret_cast<float4*>(p) = rev ? make_float4(v[3], v[2], v[1], v[0])
                                        : make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (G == 2) {
    *reinterpret_cast<float2*>(p) = rev ? make_float2(v[1], v[0]) : make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// A walker's tile where the steps are inner: G steps at a time from the
// runs of its slots' chunks (one 4 G-byte load a slot, conflict-free),
// walked from registers (walk_steps), stored back over the costs when there
// is an output.
template <int K, int G, bool CANON>
__device__ __forceinline__ void walk_runs(float* stage, const WideTile& g, int ti, int b,
                                          int lane, float (&prev)[1][K], float (&m)[1],
                                          float p1, float p2_base, bool dm1, int n_steps,
                                          int reset, int d_range, bool store) {
  const int c = 1 << g.cl, vt = 1 << g.vb;
  const float* pens = stage + g.tile + b;
  for (int j = 0; j < vt; j += G) {
    const int t = ti * vt + j;
    if (t >= n_steps) break;
    const int at = g.rev ? c - G - (j & (c - 1)) : j & (c - 1);
    float* run = stage + b * g.os + (j >> g.cl) * g.cs + at + lane * c;
    float cv[1][G][K], s[1][G][K], p2[G][1];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float v[G];
      load_run<G>(run + 32 * k * c, g.rev, v);
#pragma unroll
      for (int e = 0; e < G; ++e) cv[0][e][k] = v[e];
      if (CANON) {
        load_run<G>(run + g.tile + 32 * k * c, g.rev, v);
#pragma unroll
        for (int e = 0; e < G; ++e) s[0][e][k] = v[e];
      }
    }
#pragma unroll
    for (int e = 0; e < G; ++e) p2[e][0] = CANON ? 0.f : pens[(j + e) << g.lb];
    walk_steps<K, 1, G, CANON>(cv, s, p2, prev, m, p1, p2_base, dm1, t, n_steps, reset,
                               d_range, lane);
    if (store) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float v[G];
#pragma unroll
        for (int e = 0; e < G; ++e) v[e] = cv[0][e][k];
        store_run<G>(run + 32 * k * c, g.rev, v);
      }
    }
  }
}

// Steps a walker takes from registers where they are inner: as many as a
// chunk holds, fewer where the values of 4 steps (and scales) would crowd
// the registers
template <int K, bool CANON>
constexpr int WIDE_RUN = (CANON ? 8 : 4) * K <= 96 ? 4 : ((CANON ? 4 : 2) * K <= 96 ? 2 : 1);

template <int K, bool CANON>
__global__ void __launch_bounds__(32 * WIDE_LANES + WMOVERS)
banded_wide_kernel(Pass a, WideTile g, WideCopy cost_copy, WideCopy pen_copy,
                   WideCopy out_copy) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31;
  const int lanes = 1 << g.lb, vt = 1 << g.vb;
  const int x0 = blockIdx.x * lanes;
  const int ntiles = (a.n_steps + vt - 1) / vt;
  const bool walker = tid < 32 * lanes;
  const int mt = tid - 32 * lanes;
  const WideVolume<K> cost{a.cost, a.cs_t, a.cs_d, a.cs_m};
  const WideVolume<K> scale{a.pen, a.ps_t, a.ps_d, a.ps_m};
  const WideVolume<K> out{a.out, a.os_t, a.os_d, a.os_m};

  // costs of slots d >= D stay +inf (and their values with them), scales 1
  for (int i = tid; i < WIDE_NS * g.stage; i += blockDim.x) {
    smem[i] = i % g.stage < g.tile ? CUDART_INF_F : 1.f;
  }

  // Walker warp b walks lane x0 + b from the incoming carry.
  const int b = tid >> 5, x = x0 + b;
  const bool walks = walker && x < a.m_lanes;
  float prev[1][K], m[1];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = lane * K + k;
    prev[0][k] = walks && d < a.d_range ? a.cin[(size_t)d * a.m_lanes + x] : CUDART_INF_F;
  }
  m[0] = walks ? a.cin_min[x] : 0.f;
  __syncthreads();

  auto fetch = [&](int in) {
    if (in < ntiles) {
      float* stage = smem + (in % WIDE_NS) * g.stage;
      const auto copy = [rev = g.rev, c = 1 << g.cl](float* dst, WideCopy cp) {
        return [dst, cp, rev, c](int word, const float* row, int n) {
          if (cp.w > 1) {  // n values from the lowest address, n % w == 0
            float* to = dst + word + (rev ? c - n : 0);
            const float* from = rev ? row - (n - 1) : row;
            if (cp.w == 4) {
              cp_async16(to, from);
            } else {
              cp_async8(to, from);
              if (n > 2) cp_async8(to + 2, from + 2);
            }
          } else {
            for (int e = 0; e < n; ++e) {
              cp_async4(dst + word + (rev ? c - 1 - e : e), row + e * cp.is);
            }
          }
        };
      };
      cost.pieces(g, mt, in, x0, a.n_steps, a.d_range, a.m_lanes, copy(stage, cost_copy));
      if (CANON) {
        scale.pieces(g, mt, in, x0, a.n_steps, a.d_range, a.m_lanes,
                     copy(stage + g.tile, pen_copy));
      } else {  // the tile's [vt][lanes] penalties
        for (int q = mt; q < lanes * vt; q += WMOVERS) {
          const int j = q >> g.lb, xb = x0 + (q & (lanes - 1)), t = in * vt + j;
          if (t < a.n_steps && xb < a.m_lanes) {
            cp_async4(stage + g.tile + q, a.pen + (long long)t * a.ps_t + (long long)xb * a.ps_m);
          }
        }
      }
    }
    cp_async_commit();
  };
  auto write_out = [&](int done) {
    if (a.out == nullptr) return;
    const float* stage = smem + (done % WIDE_NS) * g.stage;
    const WideCopy cp = out_copy;
    out.pieces(g, mt, done, x0, a.n_steps, a.d_range, a.m_lanes,
               [stage, cp, rev = g.rev, c = 1 << g.cl](int word, const float* at, int n) {
                 float* row = const_cast<float*>(at);
                 if (cp.w > 1) {  // n values to the lowest address, n % w == 0
                   const float* from = stage + word + (rev ? c - n : 0);
                   float* to = rev ? row - (n - 1) : row;
                   if (cp.w == 4) {
                     *reinterpret_cast<float4*>(to) = *reinterpret_cast<const float4*>(from);
                   } else {
                     *reinterpret_cast<float2*>(to) = *reinterpret_cast<const float2*>(from);
                     if (n > 2) {
                       *reinterpret_cast<float2*>(to + 2) =
                           *reinterpret_cast<const float2*>(from + 2);
                     }
                   }
                 } else {
                   for (int e = 0; e < n; ++e) row[e * cp.is] = stage[word + (rev ? c - 1 - e : e)];
                 }
               });
  };
  const bool dm1 = a.dm1 != 0;
  auto walk = [&](int ti) {
    if (!walks) return;
    const int c = 1 << g.cl;
    float* stage = smem + (ti % WIDE_NS) * g.stage;
    if (!g.lanes_inner) {  // runs of G steps
      constexpr int R = WIDE_RUN<K, CANON>;
      const bool store = a.out != nullptr;
      if (R >= 4 && c >= 4) {
        walk_runs<K, (R >= 4 ? 4 : 1), CANON>(stage, g, ti, b, lane, prev, m, a.p1, a.p2, dm1,
                                               a.n_steps, a.reset, a.d_range, store);
      } else if (R >= 2 && c >= 2) {
        walk_runs<K, (R >= 2 ? 2 : 1), CANON>(stage, g, ti, b, lane, prev, m, a.p1, a.p2, dm1,
                                               a.n_steps, a.reset, a.d_range, store);
      } else {
        walk_runs<K, 1, CANON>(stage, g, ti, b, lane, prev, m, a.p1, a.p2, dm1, a.n_steps,
                               a.reset, a.d_range, store);
      }
      return;
    }
    // lanes inner: one step at a time, lane b's position in its chunks
    const float* pens = stage + g.tile + b;
    for (int j = 0; j < vt; ++j) {
      const int t = ti * vt + j;
      if (t >= a.n_steps) break;
      float* vals = stage + j * g.os + (b >> g.cl) * g.cs + (b & (c - 1)) + lane * c;
      float cv[1][1][K], s[1][1][K], p2[1][1];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        cv[0][0][k] = vals[32 * k * c];
        s[0][0][k] = CANON ? vals[g.tile + 32 * k * c] : 0.f;
      }
      p2[0][0] = CANON ? 0.f : pens[j << g.lb];
      walk_steps<K, 1, 1, CANON>(cv, s, p2, prev, m, a.p1, a.p2, dm1, t, a.n_steps, a.reset,
                                 a.d_range, lane);
      if (a.out != nullptr) {
#pragma unroll
        for (int k = 0; k < K; ++k) vals[32 * k * c] = cv[0][0][k];
      }
    }
  };
  run_tiles<WIDE_NS, false>(walker, ntiles, fetch, [](int) {}, write_out, walk);

  if (!walks) return;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = lane * K + k;
    if (d < a.d_range) a.cout[(size_t)d * a.m_lanes + x] = prev[0][k];
  }
  if (lane == 0) a.cout_min[x] = m[0];
}

// The tile of 1 << lb lanes with the most steps (up to 32) whose ring fits
// `budget` bytes; vb = -1 where not even one step fits.
template <int K, bool CANON>
WideTile fit_tile(int lb, int lanes_inner, int rev, size_t budget) {
  for (int vb = 5; vb >= 0; --vb) {
    const WideTile g = wide_tile<K, CANON>(lb, vb, lanes_inner, rev);
    if (sizeof(float) * WIDE_NS * (size_t)g.stage <= budget) return g;
  }
  WideTile g = wide_tile<K, CANON>(lb, 0, lanes_inner, rev);
  g.vb = -1;
  return g;
}

// How the movers copy a tensor at strides (st, sd, sm) from `base` (its
// path's first step) in tile g: along the inner dimension in pieces of
// copy_width floats where it runs contiguous there in the path's direction,
// else value by value.
inline WideCopy wide_copy(const WideTile& g, const float* base, long long st, long long sd,
                          long long sm, int n_steps, int m_lanes) {
  const long long is = g.lanes_inner ? sm : st;
  int w = 1;
  if (g.lanes_inner && is == 1) {
    w = copy_width(base, st, sd, m_lanes);
  } else if (!g.lanes_inner && is == (g.rev ? -1 : 1)) {
    // a chunk's lowest address: its first step, or its last on a reversed path
    const int c = 1 << g.cl;
    w = copy_width(g.rev ? base - (c - 1) : base, sm, sd, n_steps);
  }
  return WideCopy{w < (1 << g.cl) ? w : 1 << g.cl, is};
}

template <int K, bool CANON>
cudaError_t launch_wide(const Pass& a, int device, int sm_count, cudaStream_t s) {
  static std::atomic<bool> sized[MAX_DEVICES];  // per instance and device, false at first
  constexpr size_t BUDGET = 227 * 1024 - 2048;  // one block a SM
  const cudaError_t err = allow_shared_bytes(sized[device], banded_wide_kernel<K, CANON>, BUDGET);
  if (err != cudaSuccess) return err;
  // The cost's contiguous dimension: its steps (a step stride of +-1), else
  // its lanes.  Along the lanes a block takes 8 (32-byte runs of a row),
  // fewer where not one step of 8 fits; along the steps one.  Then the most
  // steps (up to 32: 128-byte runs along the steps) whose ring fits a SM.
  const int lanes_inner = a.cs_t == 1 || a.cs_t == -1 ? 0 : 1;
  const int rev = !lanes_inner && a.cs_t < 0;
  int lb = lanes_inner ? 3 : 0;
  WideTile g = fit_tile<K, CANON>(lb, lanes_inner, rev, BUDGET);
  while (lb > 0 && g.vb < 0) g = fit_tile<K, CANON>(--lb, lanes_inner, rev, BUDGET);
  if (g.vb < 0) return cudaErrorInvalidValue;  // not reached: one lane's step fits at D <= 1024
  const WideCopy cc = wide_copy(g, a.cost, a.cs_t, a.cs_d, a.cs_m, a.n_steps, a.m_lanes);
  const WideCopy pc = wide_copy(g, a.pen, a.ps_t, a.ps_d, a.ps_m, a.n_steps, a.m_lanes);
  const WideCopy oc = a.out != nullptr
                          ? wide_copy(g, a.out, a.os_t, a.os_d, a.os_m, a.n_steps, a.m_lanes)
                          : WideCopy{1, 0};
  const int blocks = (a.m_lanes + (1 << lb) - 1) >> lb, threads = 32 * (1 << lb) + WMOVERS;
  const size_t bytes = sizeof(float) * WIDE_NS * g.stage;
  banded_wide_kernel<K, CANON><<<blocks, threads, bytes, s>>>(a, g, cc, pc, oc);
  return cudaGetLastError();
}

// The shared-memory route, for 1024 < D <= 7232: prev of WL = 8 lanes in
// shared memory ([D][8], updated in place), each of WG = 32 thread groups a
// run of ceil(D / 32) disparities; a step is two barriers: the neighbours'
// edge values are read, then the runs are updated upward in place and their
// minima reduced.
constexpr int WL = 8;    // lanes a block
constexpr int WG = 32;   // disparity groups a block

template <bool CANON>
__global__ void __launch_bounds__(WL * WG)
banded_wide_smem_kernel(const float* __restrict__ cost, long long cs_t, long long cs_d,
                        long long cs_m, const float* __restrict__ pen, long long ps_t,
                        long long ps_d, long long ps_m, float* __restrict__ out, long long os_t,
                        long long os_d, long long os_m, const float* __restrict__ cin,
                        const float* __restrict__ cin_min, float* cout, float* cout_min,
                        int n_steps, int d_range, int m_lanes, float p1, float p2, int reset,
                        int dm1) {
  extern __shared__ float wide_smem[];
  float* P = wide_smem;                   // [D][WL]: prev of the block's lanes
  float* part = wide_smem + d_range * WL;  // [WG][WL]: a group's minimum of the step
  const float INF = CUDART_INF_F;
  const int x = threadIdx.x, g = threadIdx.y;
  const int m = blockIdx.x * WL + x;
  const bool live = m < m_lanes;
  const int run = (d_range + WG - 1) / WG;
  const int d0 = g * run, d1 = min(d0 + run, d_range);   // the group's disparities
  for (int d = d0; d < d1; ++d) P[d * WL + x] = live ? cin[(size_t)d * m_lanes + m] : 0.f;
  float pm = live ? cin_min[m] : 0.f;
  __syncthreads();
  for (int k = 0; k < n_steps; ++k) {
    const bool zero = k == reset;  // the path restarts: a zero carry
    float left = d0 > 0 && d0 < d_range ? (zero ? 0.f : P[(d0 - 1) * WL + x]) : INF;
    const float right = d1 < d_range ? (zero ? 0.f : P[d1 * WL + x]) : INF;
    if (zero) pm = 0.f;
    __syncthreads();  // every edge is read before any group writes
    const long long ct = (long long)k * cs_t + (long long)m * cs_m;
    const long long pt = (long long)k * ps_t + (long long)m * ps_m;
    const long long ot = (long long)k * os_t + (long long)m * os_m;
    const float p2c_legacy = !CANON && live ? pen[pt] : 0.f;
    float lmin = INF;
#pragma unroll 4
    for (int d = d0; d < d1; ++d) {
      const float cur = zero ? 0.f : P[d * WL + x];
      const float hi = d + 1 < d1 ? (zero ? 0.f : P[(d + 1) * WL + x]) : right;
      const float c = live ? cost[ct + (long long)d * cs_d] : 0.f;
      float l2, l3, l4;
      if (CANON) {
        const float sc = live ? pen[pt + (long long)d * ps_d] : 0.f;
        const float p1c = __fmul_rn(p1, sc), p2c = __fmul_rn(p2, sc);
        l2 = __fadd_rn(left, p1c);
        l3 = __fadd_rn(hi, p1c);
        l4 = __fadd_rn(pm, p2c);
      } else {
        l2 = __fadd_rn(dm1 ? left : cur, p1);
        l3 = __fadd_rn(hi, p1);
        l4 = __fadd_rn(pm, p2c_legacy);
      }
      const float o = __fsub_rn(__fadd_rn(c, fminf(fminf(cur, l2), fminf(l3, l4))), pm);
      P[d * WL + x] = o;
      left = cur;
      lmin = fminf(lmin, o);
      if (out != nullptr && live) out[ot + (long long)d * os_d] = o;
    }
    part[g * WL + x] = lmin;
    __syncthreads();  // every run is updated and its minimum in place
    float mn = part[x];
#pragma unroll 8
    for (int j = 1; j < WG; ++j) mn = fminf(mn, part[j * WL + x]);
    pm = mn;
  }
  if (!live) return;
  for (int d = d0; d < d1; ++d) cout[(size_t)d * m_lanes + m] = P[d * WL + x];
  if (g == 0) cout_min[m] = pm;
}

template <bool CANON>
cudaError_t launch_wide_smem(const Pass& a, int device, cudaStream_t s) {
  static std::atomic<bool> sized[MAX_DEVICES];  // per family and device, false at first
  const cudaError_t err = allow_shared_bytes(sized[device], banded_wide_smem_kernel<CANON>,
                                             sizeof(float) * (WIDE_MAX_DISP * WL + WG * WL));
  if (err != cudaSuccess) return err;
  const size_t bytes = sizeof(float) * ((size_t)a.d_range * WL + WG * WL);
  banded_wide_smem_kernel<CANON><<<(a.m_lanes + WL - 1) / WL, dim3(WL, WG), bytes, s>>>(
      a.cost, a.cs_t, a.cs_d, a.cs_m, a.pen, a.ps_t, a.ps_d, a.ps_m, a.out, a.os_t, a.os_d,
      a.os_m, a.cin, a.cin_min, a.cout, a.cout_min, a.n_steps, a.d_range, a.m_lanes, a.p1, a.p2,
      a.reset, a.dm1);
  return cudaGetLastError();
}

template <bool CANON>
int run_wide(const Pass& a, void* stream) {
  if (a.n_steps < 1 || a.d_range < 1 || a.d_range > WIDE_MAX_DISP || a.m_lanes < 1) {
    return (int)cudaErrorInvalidValue;
  }
  int device = 0, sm_count = 0;
  const cudaError_t err = current_device(&device, &sm_count);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (a.d_range > WIDE_REG_MAX_DISP) return (int)launch_wide_smem<CANON>(a, device, s);
  switch (wide_k(a.d_range)) {
    case 1: return (int)launch_wide<1, CANON>(a, device, sm_count, s);
    case 2: return (int)launch_wide<2, CANON>(a, device, sm_count, s);
    case 4: return (int)launch_wide<4, CANON>(a, device, sm_count, s);
    case 8: return (int)launch_wide<8, CANON>(a, device, sm_count, s);
    case 12: return (int)launch_wide<12, CANON>(a, device, sm_count, s);
    case 16: return (int)launch_wide<16, CANON>(a, device, sm_count, s);
    case 20: return (int)launch_wide<20, CANON>(a, device, sm_count, s);
    case 24: return (int)launch_wide<24, CANON>(a, device, sm_count, s);
    case 28: return (int)launch_wide<28, CANON>(a, device, sm_count, s);
    default: return (int)launch_wide<32, CANON>(a, device, sm_count, s);
  }
}

Pass legacy_pass(const void* cost, long long cs_t, long long cs_d, long long cs_m, const void* p2,
                 long long p2_t, long long p2_m, void* out, long long os_t, long long os_d,
                 long long os_m, const void* carry, const void* carry_min, void* carry_out,
                 void* carry_min_out, int n_steps, int d_range, int m_lanes, float p1, int reset,
                 int dm1) {
  return Pass{(const float*)cost, cs_t, cs_d, cs_m, (const float*)p2, p2_t, 0, p2_m, (float*)out,
              os_t, os_d, os_m, (const float*)carry, (const float*)carry_min, (float*)carry_out,
              (float*)carry_min_out, n_steps, d_range, m_lanes, p1, 0.0f, reset, dm1};
}

Pass canonical_pass(const void* cost, long long cs_t, long long cs_d, long long cs_m,
                    const void* scale, long long sc_t, long long sc_d, long long sc_m, void* out,
                    long long os_t, long long os_d, long long os_m, const void* carry,
                    const void* carry_min, void* carry_out, void* carry_min_out, int n_steps,
                    int d_range, int m_lanes, float p1_base, float p2_base, int reset) {
  return Pass{(const float*)cost, cs_t, cs_d, cs_m, (const float*)scale, sc_t, sc_d, sc_m,
              (float*)out, os_t, os_d, os_m, (const float*)carry, (const float*)carry_min,
              (float*)carry_out, (float*)carry_min_out, n_steps, d_range, m_lanes, p1_base,
              p2_base, reset, 1};
}

}  // namespace

// Launch on `stream`.  cost and out: [n_steps, d_range, m_lanes] float32 at the
// given strides (in floats; a step stride may be negative, from a base at the
// path's first step; the lane strides 1); out may be null (only the carry is
// wanted).  p2: the penalty a (step, lane), at strides (p2_t, p2_m).  carry /
// carry_min: the incoming prev [d_range, m_lanes] and prev_min [m_lanes],
// contiguous; carry_out / carry_min_out receive the outgoing ones (they may
// be the same memory).  reset: the path step before which the carry is zero,
// or -1.  dm1 = 0 is the reference's vertical quirk (l2 = prev(d) + p1).
// 1 <= d_range <= 256.  Returns cudaGetLastError() after the launch,
// cudaErrorInvalidValue for a size or a lane stride outside the range.
extern "C" int scanline_banded_f32(const void* cost, long long cs_t, long long cs_d,
                                   long long cs_m, const void* p2, long long p2_t, long long p2_m,
                                   void* out, long long os_t, long long os_d, long long os_m,
                                   const void* carry, const void* carry_min, void* carry_out,
                                   void* carry_min_out, int n_steps, int d_range, int m_lanes,
                                   float p1, int reset, int dm1, void* stream) {
  return run_walker<false>(
      legacy_pass(cost, cs_t, cs_d, cs_m, p2, p2_t, p2_m, out, os_t, os_d, os_m, carry, carry_min,
                  carry_out, carry_min_out, n_steps, d_range, m_lanes, p1, reset, dm1),
      stream);
}

// The canonical family: scale, the penalty scale a (step, disparity, lane),
// at strides (sc_t, sc_d, sc_m); P1 = p1_base * scale, P2 = p2_base * scale.
// The rest as scanline_banded_f32's (l2 reads prev(d - 1)).
extern "C" int scanline_banded_canonical_f32(
    const void* cost, long long cs_t, long long cs_d, long long cs_m, const void* scale,
    long long sc_t, long long sc_d, long long sc_m, void* out, long long os_t, long long os_d,
    long long os_m, const void* carry, const void* carry_min, void* carry_out,
    void* carry_min_out, int n_steps, int d_range, int m_lanes, float p1_base, float p2_base,
    int reset, void* stream) {
  return run_walker<true>(
      canonical_pass(cost, cs_t, cs_d, cs_m, scale, sc_t, sc_d, sc_m, out, os_t, os_d, os_m,
                     carry, carry_min, carry_out, carry_min_out, n_steps, d_range, m_lanes,
                     p1_base, p2_base, reset),
      stream);
}

// scanline_banded_f32 by the wide kernel: any strides, 1 <= d_range <= 7232.
extern "C" int scanline_banded_wide_f32(const void* cost, long long cs_t, long long cs_d,
                                        long long cs_m, const void* p2, long long p2_t,
                                        long long p2_m, void* out, long long os_t, long long os_d,
                                        long long os_m, const void* carry, const void* carry_min,
                                        void* carry_out, void* carry_min_out, int n_steps,
                                        int d_range, int m_lanes, float p1, int reset, int dm1,
                                        void* stream) {
  return run_wide<false>(
      legacy_pass(cost, cs_t, cs_d, cs_m, p2, p2_t, p2_m, out, os_t, os_d, os_m, carry, carry_min,
                  carry_out, carry_min_out, n_steps, d_range, m_lanes, p1, reset, dm1),
      stream);
}

// scanline_banded_canonical_f32 by the wide kernel: any strides,
// 1 <= d_range <= 7232.
extern "C" int scanline_banded_wide_canonical_f32(
    const void* cost, long long cs_t, long long cs_d, long long cs_m, const void* scale,
    long long sc_t, long long sc_d, long long sc_m, void* out, long long os_t, long long os_d,
    long long os_m, const void* carry, const void* carry_min, void* carry_out,
    void* carry_min_out, int n_steps, int d_range, int m_lanes, float p1_base, float p2_base,
    int reset, void* stream) {
  return run_wide<true>(
      canonical_pass(cost, cs_t, cs_d, cs_m, scale, sc_t, sc_d, sc_m, out, os_t, os_d, os_m,
                     carry, carry_min, carry_out, carry_min_out, n_steps, d_range, m_lanes,
                     p1_base, p2_base, reset),
      stream);
}
