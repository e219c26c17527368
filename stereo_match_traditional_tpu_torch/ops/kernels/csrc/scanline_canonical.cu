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
// other one at column clamp(x - d) (left view) or clamp(x + d) (right view).
// p-1 is the path's previous pixel (x+1 or y+1 on the reversed passes); a
// path's first step is the cost itself.  The output is
// ((lr + rl) + (ud + du)) * 0.25, d-major [D, H, W] like the input.
//
// What bounds it: bytes.  The function reads the volume once and writes it
// once (2V, V = 4 D H W bytes: 0.024 ms a view at Teddy 375x450, D=60, and
// 0.282 ms at 720x1280, D=128, at 3.35 TB/s); the arithmetic, ~15
// operations a value and direction, is far below the float32 peak.  The
// design is scanline.cu's, whose header describes it, with the machinery
// both share in scanline_tiles.cuh:
//
// * 11 volume trips in four launches on the caller's stream, no combine
//   pass: a prologue writes the edge bits (below); top-down (cost -> ud);
//   left-right and right-left (cost -> lr in `out`, rl in scratch); then
//   bottom-up, whose movers stage lr, rl and ud of a tile beside its costs
//   and store the mean over lr.  (Top-down on a second stream beside the
//   horizontal passes, as scanline.cu runs it, took longer.)  The volumes it
//   writes have rows `wp` apart (W rounded up to a multiple of 4), so every
//   16-byte chunk of them is one aligned access; the caller takes columns
//   0 .. W-1.
// * Walker warps hold a path line's D values in registers (lane l has
//   d = l K .. l K + K - 1) and walk four steps (one on vertical paths when
//   K = 8) from registers between their shared-memory accesses: the chain
//   from one step to the next is two shuffles of L(p-1), each lane adding
//   its own P1s, and one redux.sync.  Mover warps stage the costs in tiles
//   with cp.async (4-byte copies one lane a step on horizontal paths, 16-byte
//   copies past L1 on vertical ones where W % 4 == 0) several tiles ahead,
//   and write the walked tiles out in 16-byte chunks.
// * The tso schedule as edge bits, computed once a call: a path step reads
//   no image pixel.  Four bit planes of [H][RW] 32-bit words, RW = (W + 640)
//   / 32 rounded up, bit b of word i of a row standing for the column
//   c = 32 i + b - 256 (PAD):
//     0 base h:  |g1(y, c) - g1(y, c - 1)| >= tso for 1 <= c < W, else 0 >= tso
//     1 base v:  |g1(y, c') - g1(y - 1, c')| >= tso, c' = clamp(c, 0, W-1), y >= 1
//     2, 3:      the same of the match image g2
//   (|a - b| = |b - a| exactly, so a reversed pass reads the same bits.)
//   The step across columns (P-1, P) of row y reads base-h bit P and, for d,
//   match-h bit P - d (left view) or P + d (right view): where both match
//   columns clamp to one pixel that bit is the plane's padding, 0 >= tso, as
//   the plain version's |g - g| >= tso.  The step across rows (Q-1, Q) of
//   column x reads base-v bit x and match-v bit x -+ d of row Q: clamped
//   columns read the edge column's bit, as the plain version does.  The
//   padding is wide enough that the K disparities of a lane are K
//   consecutive bits (reversed for the left view), and the four columns of a
//   vertical walker with them: each step is one funnel shift of two words of
//   a bit row that the movers staged with the tile's costs.  P1s and P2s of
//   the three scales are formed once (__fmul_rn) and picked by the two bits.
//
// D <= 256 (K <= 8: registers of a walker, shared memory of a stage), and
// D H wp below 2^32 (the vertical movers keep 32-bit offsets).  The gray
// images are read as they come, uint8 or float32 (a template argument of
// the prologue), and turned into float32 as the plain version turns them.
//
// Numerics: the plain version's float operations in its order, each by an
// __f*_rn intrinsic so that nvcc contracts no multiply and add into an FMA:
// P1s = P1 * s, l2 = L(p-1, d-1) + P1s, l4 = m + P2s,
// out = (C + min(min(l1, l2), min(l3, l4))) - m, then (lr + rl) + (ud + du),
// times 0.25.  s = 0.1 is the float32 0.1f; the edge bits are the plain
// version's float32 comparisons on the same values.  min is exact in any
// order and rounding is monotone, so min_d (u_d - m) = (min_d u_d) - m.  The
// result matches the plain version bit for bit.
//
// A second entry, scanline_canonical_horizontal_band_f32, runs the edge-bit
// prologue (its two horizontal planes) and the horizontal kernel alone on a
// band of rows of the streamed executor: a band's horizontal passes are
// row-local, so each of its rows is a whole path.  The band is read in place
// through its plane and row strides.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <atomic>
#include <cstdint>

#include "scanline_tiles.cuh"

namespace {

constexpr int PAD = 256;  // bits of a plane row before column 0

// 32-bit words of a plane row: PAD bits, the W columns, and room for the
// widest window past column W - 1 (a vertical block's columns and 256 d)
inline int row_words(int w) { return (w + 640 + 31) / 32; }

// the planes, in the order of the header
constexpr int BASE_H = 0, BASE_V = 1, MATCH_H = 2, MATCH_V = 3;

__device__ __forceinline__ float pixel(const float* p) { return __ldg(p); }
__device__ __forceinline__ float pixel(const unsigned char* p) { return (float)__ldg(p); }

// The bit planes of one call, one word a thread: all four (plane_step 1),
// or only the horizontal ones, BASE_H and MATCH_H (plane_step 2).
template <typename T>
__global__ void edge_bits_kernel(const T* __restrict__ base, const T* __restrict__ match,
                                 unsigned* __restrict__ bits, int h, int w, int rw, float tso,
                                 int plane_step) {
  const size_t plane_words = (size_t)h * rw;
  const size_t n = (size_t)(4 / plane_step) * plane_words;
  const bool zero = 0.f >= tso;  // |g - g| of a clamped pair
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int plane = (int)(i / plane_words) * plane_step;
    const int y = (int)(i / rw % h), word = (int)(i % rw);
    const T* row = (plane < MATCH_H ? base : match) + (size_t)y * w;
    const bool vertical = plane == BASE_V || plane == MATCH_V;
    unsigned v = 0;
    for (int b = 0; b < 32; ++b) {
      const int c = word * 32 + b - PAD;
      bool bit;
      if (!vertical) {
        bit = c >= 1 && c < w ? fabsf(__fsub_rn(pixel(row + c), pixel(row + c - 1))) >= tso
                              : zero;
      } else {
        const int cc = min(max(c, 0), w - 1);
        bit = y >= 1 && fabsf(__fsub_rn(pixel(row + cc), pixel(row - w + cc))) >= tso;
      }
      v |= (unsigned)bit << b;
    }
    bits[(size_t)plane * plane_words + i % plane_words] = v;
  }
}

// P1 s and P2 s for s = 1, 0.25 and 0.1f: neither, one or both bits set
struct Penalties {
  float p1[3], p2[3];
  __device__ __forceinline__ Penalties(float p1_base, float p2_base) {
    const float s[3] = {1.0f, 0.25f, 0.1f};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      p1[i] = __fmul_rn(p1_base, s[i]);
      p2[i] = __fmul_rn(p2_base, s[i]);
    }
  }
};

// The bit of d = lane K + k in a lane's window of match bits: the left
// view's match columns fall as d rises
template <int K, bool RIGHT>
__device__ __forceinline__ int koff(int k) { return RIGHT ? k : K - 1 - k; }

// G steps of a walker warp that walks NL lines at once (their chains are
// independent, so their instructions interleave).  c[n][j] holds the costs
// of step j of line n on entry and the step's values on return; prev and m
// carry the paths' state.  Bit n of o1[j] is the base image's edge bit of
// line n at step j, bit n + koff(k) of o2[j] the match image's for
// d = lane K + k.  `first`: step `start` starts the paths, the steps before
// it lie outside the image.
template <int K, int NL, int G, bool RIGHT>
__device__ __forceinline__ void walk_canonical(float (&c)[NL][G][K], float (&prev)[NL][K],
                                               float (&m)[NL], const Penalties& pen,
                                               const unsigned (&o1)[G],
                                               const unsigned (&o2)[G], bool first, int start,
                                               int lane) {
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (first && j < start) continue;  // before the paths
    if (first && j == start) {
#pragma unroll
      for (int n = 0; n < NL; ++n) {
#pragma unroll
        for (int k = 0; k < K; ++k) prev[n][k] = c[n][j][k];
        m[n] = warp_min(tree_min<K>(prev[n]));
      }
      continue;
    }
    float u[NL][K], u_min[NL];
#pragma unroll
    for (int n = 0; n < NL; ++n) {
      // the pair of scales the match bit picks from, by the base bit; the
      // picks wait for no step, only the adds below wait for m
      const bool b1 = (o1[j] >> n) & 1u;
      const float p1a = b1 ? pen.p1[1] : pen.p1[0], p1b = b1 ? pen.p1[2] : pen.p1[1];
      const float p2a = b1 ? pen.p2[1] : pen.p2[0], p2b = b1 ? pen.p2[2] : pen.p2[1];
      float below = __shfl_up_sync(FULL, prev[n][K - 1], 1);  // L(p-1, d-1) for k = 0
      float above = __shfl_down_sync(FULL, prev[n][0], 1);    // L(p-1, d+1) for k = K-1
      if (lane == 0) below = CUDART_INF_F;
      if (lane == 31) above = CUDART_INF_F;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const bool b2 = (o2[j] >> (n + koff<K, RIGHT>(k))) & 1u;
        const float p1s = b2 ? p1b : p1a, p2s = b2 ? p2b : p2a;
        const float l2 = __fadd_rn(k > 0 ? prev[n][k > 0 ? k - 1 : 0] : below, p1s);
        const float l3 = __fadd_rn(k + 1 < K ? prev[n][k + 1 < K ? k + 1 : k] : above, p1s);
        const float rest = fminf(fminf(prev[n][k], l2), l3);  // ready before m is
        u[n][k] = __fadd_rn(c[n][j][k], fminf(rest, __fadd_rn(m[n], p2s)));
      }
      u_min[n] = tree_min<K>(u[n]);
    }
#pragma unroll
    for (int n = 0; n < NL; ++n) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        prev[n][k] = __fsub_rn(u[n][k], m[n]);
        c[n][j][k] = prev[n][k];
      }
      m[n] = __fsub_rn(warp_min(u_min[n]), m[n]);
    }
  }
}

__device__ __forceinline__ float mean_of(float lr, float rl, float ud, float du) {
  return __fmul_rn(__fadd_rn(__fadd_rn(lr, rl), __fadd_rn(ud, du)), 0.25f);
}

__device__ __forceinline__ float4 mean4(float4 a, float4 b, float4 u, float4 v) {
  return make_float4(mean_of(a.x, b.x, u.x, v.x), mean_of(a.y, b.y, u.y, v.y),
                     mean_of(a.z, b.z, u.z, v.z), mean_of(a.w, b.w, u.w, v.w));
}

// ---------------------------------------------------------------------------
// Horizontal: block = (image row, direction); warp 0 walks, warps 1-3 move.
// A tile's bit row: MB words of the match-h row from word (x0 + PAD) / 32 - K
// (left view) or (x0 + PAD) / 32 (right view), then two base-h words from
// (x0 + PAD) / 32, x0 the tile's first column.
// ---------------------------------------------------------------------------

template <int K>
struct CanonicalHorizontal {
  static constexpr int TILE = HorizontalBlock<K>::TILE;
  static constexpr int MB = K + 4, BW = MB + 2;  // match words, all words of a tile's bit row
  static constexpr size_t BYTES = sizeof(float) * HS * TILE + sizeof(unsigned) * HS * BW;
};

template <int K, bool RIGHT>
__global__ void __launch_bounds__(32 + HMOVERS)
canonical_horizontal_kernel(const float* __restrict__ cost, size_t cost_plane,
                            size_t cost_row_stride, const unsigned* __restrict__ bits,
                            float* __restrict__ lr, float* __restrict__ rl, int d_range, int h,
                            int w, int wp, int rw, float p1, float p2) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  using C = CanonicalHorizontal<K>;
  constexpr int TILE = C::TILE, MB = C::MB, BW = C::BW;
  unsigned* bit_rows = reinterpret_cast<unsigned*>(smem + HS * TILE);  // [HS][BW]
  const HorizontalBlock<K> hb(cost, cost_plane, cost_row_stride, lr, rl, d_range, h, w, wp);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const bool rev = hb.rev;
  const int head = hb.head;  // steps before head lie beyond the image

  // rows d >= D stay so
  for (int i = tid; i < HS * TILE; i += 32 + HMOVERS) smem[i] = CUDART_INF_F;
  __syncthreads();

  // Lanes 0 .. BW - 1 of mover warp 0 also copy the tile's bit row.
  const unsigned* base_bits = bits + ((size_t)BASE_H * h + blockIdx.x) * rw;
  const unsigned* match_bits = bits + ((size_t)MATCH_H * h + blockIdx.x) * rw;
  auto copy_bits = [&](int in) {
    if (hb.mw == 0 && lane < BW) {
      const int w0 = (hb.tile_x0(in) + PAD) / 32;
      const unsigned* src = lane < MB ? match_bits + w0 - (RIGHT ? 0 : K) + lane
                                      : base_bits + w0 + lane - MB;
      cp_async4(reinterpret_cast<float*>(bit_rows + (in % HS) * BW + lane),
                reinterpret_cast<const float*>(src));
    }
  };
  auto fetch = [&](int in) { hb.fetch(smem, in, copy_bits); };
  auto write_out = [&](int done) { hb.write_out(smem4, done); };

  // Step j of a tile crosses the columns (P - 1, P) with P - x0 = j
  // (left-right) or HT - j (right-left).  The lane's window of match bits
  // starts at bit (P - x0) + lane_bit of the tile's bit row.
  const Penalties pen(p1, p2);
  const int lane_bit = RIGHT ? lane * K : 32 * K - lane * K - (K - 1);
  float prev[1][K];
  float m[1] = {0.f};
  auto walk = [&](int ti) {
    const unsigned* row = bit_rows + (ti % HS) * BW;
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
      const int p0 = rev ? HT - GS * g : GS * g;   // P - x0 of the group's step 0
      const int plo = rev ? p0 - (GS - 1) : p0;    // and the lowest of its four
      const unsigned b1 = __funnelshift_r(row[MB + (plo >> 5)], row[MB + (plo >> 5) + 1],
                                          plo & 31);
      unsigned o1[GS], o2[GS];
#pragma unroll
      for (int j = 0; j < GS; ++j) {
        o1[j] = b1 >> (rev ? GS - 1 - j : j);
        const int b = (rev ? p0 - j : p0 + j) + lane_bit;
        o2[j] = __funnelshift_r(row[b >> 5], row[(b >> 5) + 1], b & 31);
      }
      walk_canonical<K, 1, GS, RIGHT>(c, prev, m, pen, o1, o2, ti == 0 && g == g_first,
                                      head % GS, lane);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        rows[k * (HT / 4) + (g ^ sw)] =
            make_float4(c[0][0][k], c[0][1][k], c[0][2][k], c[0][3][k]);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) cur[k] = nxt[k];
    }
  };
  run_tiles<HS, false>(tid < 32, hb.ntiles, fetch, [](int) {}, write_out, walk);
}

// ---------------------------------------------------------------------------
// Vertical: block = XC neighbouring columns x0 ..; warp n of the first XC / 4
// walks columns 4 n .. 4 n + 3, the others move.  SECOND = the bottom-up
// pass, whose movers store the mean of the four directions over lr.  A tile
// row's bit row: MB words of the match-v row from word mo (the block's
// lowest match column's), then the base-v word of columns x0 ...; path step
// s crosses the rows (Q - 1, Q) with Q = s (top-down) or H - s (bottom-up).
// ---------------------------------------------------------------------------

template <int K, bool SECOND, int XC>
struct CanonicalVertical {
  using V = Vertical<K, SECOND, XC>;
  static constexpr int MB = K + 4, BR = MB + 1;  // match words, all words of a bit row
  static constexpr size_t BYTES = V::BYTES + sizeof(unsigned) * V::NS * V::VT * BR;
};

template <int K, bool SECOND, int XC, bool RIGHT>
__global__ void __launch_bounds__(VTHREADS<XC>, 1)
canonical_vertical_kernel(const float* __restrict__ cost, const unsigned* __restrict__ bits,
                          float* lr, const float* __restrict__ rl, float* ud, int d_range,
                          int h, int w, int wp, int cost_width, int rw, float p1, float p2) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  using V = Vertical<K, SECOND, XC>;
  using Y = Layout<XC>;
  constexpr int VT = V::VT, G = V::G, NS = V::NS, ROW = V::ROW, TILE = V::TILE;
  constexpr bool SIDES = V::SIDES;
  constexpr int MB = CanonicalVertical<K, SECOND, XC>::MB;
  constexpr int BR = CanonicalVertical<K, SECOND, XC>::BR;
  unsigned* bit_rows = reinterpret_cast<unsigned*>(smem + (NS + (SIDES ? 3 : 0)) * TILE);
  const VerticalMovers<K, SECOND, XC> mv(cost, lr, rl, ud, smem, d_range, h, w, wp);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int x0 = mv.x0;

  // rows d >= D stay so
  for (int i = tid; i < NS * TILE; i += VTHREADS<XC>) smem[i] = CUDART_INF_F;
  __syncthreads();

  // Movers 0 .. VT BR - 1 also copy one word each of the tile's bit rows.
  const int mo = (x0 + PAD - (RIGHT ? 0 : 32 * K - 1)) >> 5, bo = (x0 + PAD) >> 5;
  const int mt = mv.mt, bit_r = mt / BR, bit_i = mt % BR;  // the bit word a mover copies
  const unsigned* bit_src = bits + ((size_t)(bit_i < MB ? MATCH_V : BASE_V) * h) * rw +
                            (bit_i < MB ? mo + bit_i : bo);
  auto copy_bits = [&](int in) {
    const int s = in * VT + bit_r, q = SECOND ? h - s : s;
    if (mt < VT * BR && q >= 1 && q < h) {
      cp_async4(reinterpret_cast<float*>(bit_rows + ((in % NS) * VT + bit_r) * BR + bit_i),
                reinterpret_cast<const float*>(bit_src + (size_t)q * rw));
    }
  };
  auto fetch = [&](int in) { mv.fetch(in, cost_width, copy_bits); };
  auto fetch_sides = [&](int in) { mv.fetch_sides(in); };
  auto write_out = [&](int done) {
    mv.write_out(done, [](float4 a, float4 b, float4 u, float4 v) { return mean4(a, b, u, v); });
  };

  // Walker warp `wq` owns columns xc = x0 + 4 wq .. + 3.  Its lane's window
  // of match bits starts at bit `match_bit` of a bit row, its four base bits
  // at bit `base_bit` of the base word.
  const int wq = tid / 32;
  const int xc = x0 + NC * wq;
  const bool walks = xc < w;
  const int match_bit = xc + PAD + (RIGHT ? lane * K : -lane * K - (K - 1)) - 32 * mo;
  const int base_bit = ((x0 + PAD) & 31) + NC * wq;
  const Penalties pen(p1, p2);
  int at[K];  // the lane's 16-byte chunks in row 0 of a tile
#pragma unroll
  for (int k = 0; k < K; ++k) at[k] = Y::word(k * 32 + lane, NC * (wq % (XC / NC))) / 4;
  float prev[NC][K];
  float m[NC] = {0.f, 0.f, 0.f, 0.f};
  auto walk = [&](int ti) {
    if (!walks) return;
    float4* stage = smem4 + (ti % NS) * (TILE / 4);
    const unsigned* tile_bits = bit_rows + (ti % NS) * VT * BR;
    auto chunk_at = [&](int r, int k) {  // the lane's chunk k in tile row r
      return r * (ROW / 4) + (at[k] ^ (Y::row_swizzle(r) * Y::PP));
    };
#pragma unroll
    for (int g = 0; g < VT / G; ++g) {
      float c[NC][G][K];
      unsigned o1[G], o2[G];
#pragma unroll
      for (int j = 0; j < G; ++j) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float4 t = stage[chunk_at(g * G + j, k)];
          c[0][j][k] = t.x; c[1][j][k] = t.y; c[2][j][k] = t.z; c[3][j][k] = t.w;
        }
        const unsigned* row = tile_bits + (g * G + j) * BR;
        o1[j] = row[MB] >> base_bit;
        o2[j] = __funnelshift_r(row[match_bit >> 5], row[(match_bit >> 5) + 1], match_bit & 31);
      }
      walk_canonical<K, NC, G, RIGHT>(c, prev, m, pen, o1, o2, ti == 0 && g == 0, 0, lane);
#pragma unroll
      for (int j = 0; j < G; ++j) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          stage[chunk_at(g * G + j, k)] =
              make_float4(c[0][j][k], c[1][j][k], c[2][j][k], c[3][j][k]);
        }
      }
    }
  };
  run_tiles<NS, SIDES>(tid < 32 * (XC / NC), mv.ntiles, fetch, fetch_sides, write_out, walk);
}

template <int K, bool SECOND, int XC, bool RIGHT>
cudaError_t launch_vertical(const float* cost, const unsigned* bits, float* lr, float* rl,
                            float* ud, int d_range, int h, int w, int wp, int cost_width, int rw,
                            float p1, float p2, int device, cudaStream_t s) {
  const size_t bytes = CanonicalVertical<K, SECOND, XC>::BYTES;
  static std::atomic<bool> sized[MAX_DEVICES];  // per instance and device, false at first
  const cudaError_t err =
      allow_shared_bytes(sized[device], canonical_vertical_kernel<K, SECOND, XC, RIGHT>, bytes);
  if (err != cudaSuccess) return err;
  canonical_vertical_kernel<K, SECOND, XC, RIGHT><<<(w + XC - 1) / XC, VTHREADS<XC>, bytes, s>>>(
      cost, bits, lr, rl, ud, d_range, h, w, wp, cost_width, rw, p1, p2);
  return cudaGetLastError();
}

// The edge-bit planes that plane_step picks (see edge_bits_kernel).
template <typename T>
cudaError_t launch_edge_bits(const T* base, const T* match, unsigned* bits, int h, int w, int rw,
                             float tso, int plane_step, int sm_count, cudaStream_t s) {
  const size_t words = (size_t)(4 / plane_step) * h * rw;
  const size_t blocks = (words + 255) / 256;
  const size_t most = (size_t)sm_count * 8;
  edge_bits_kernel<T><<<(unsigned)(blocks < most ? blocks : most), 256, 0, s>>>(
      base, match, bits, h, w, rw, tso, plane_step);
  return cudaGetLastError();
}

// Both horizontal passes of the h rows of `cost` (planes `cost_plane` and
// rows `cost_row_stride` floats apart) into lr and rl, [D, h, wp], from the
// horizontal bit planes: one block a (row, direction).
template <int K, bool RIGHT>
cudaError_t launch_horizontal(const float* cost, size_t cost_plane, size_t cost_row_stride,
                              const unsigned* bits, float* lr, float* rl, int d_range, int h,
                              int w, int wp, int rw, float p1, float p2, int device,
                              cudaStream_t s) {
  const size_t bytes = CanonicalHorizontal<K>::BYTES;
  static std::atomic<bool> sized[MAX_DEVICES];  // per instance and device, false at first
  const cudaError_t err =
      allow_shared_bytes(sized[device], canonical_horizontal_kernel<K, RIGHT>, bytes);
  if (err != cudaSuccess) return err;
  canonical_horizontal_kernel<K, RIGHT><<<dim3(h, 2), 32 + HMOVERS, bytes, s>>>(
      cost, cost_plane, cost_row_stride, bits, lr, rl, d_range, h, w, wp, rw, p1, p2);
  return cudaGetLastError();
}

template <int K, bool RIGHT, typename T>
cudaError_t launch(const float* cost, const T* base, const T* match, unsigned* bits, float* lr,
                   float* rl, float* ud, int d_range, int h, int w, int wp, float p1, float p2,
                   float tso, cudaStream_t s) {
  // the widest copy that every row of the cost volume allows, in floats
  const int cost_width = (w % 4 == 0 && (uintptr_t)cost % 16 == 0)  ? 4
                         : (w % 2 == 0 && (uintptr_t)cost % 8 == 0) ? 2
                                                                    : 1;
  const int rw = row_words(w);
  int device = 0, sm_count = 0;
  cudaError_t err = current_device(&device, &sm_count);
  if (err != cudaSuccess) return err;
  // the edge bits, top-down, the horizontal passes, then bottom-up, all on
  // one stream (top-down on a second stream beside the horizontal passes,
  // as scanline.cu runs it, took longer here)
  err = launch_edge_bits<T>(base, match, bits, h, w, rw, tso, 1, sm_count, s);
  if (err != cudaSuccess) return err;
  const bool narrow = (w + 7) / 8 <= sm_count;  // blocks of 8 columns all fit the card
  err = narrow ? launch_vertical<K, false, 8, RIGHT>(cost, bits, lr, rl, ud, d_range, h, w, wp,
                                                     cost_width, rw, p1, p2, device, s)
               : launch_vertical<K, false, 16, RIGHT>(cost, bits, lr, rl, ud, d_range, h, w, wp,
                                                      cost_width, rw, p1, p2, device, s);
  if (err != cudaSuccess) return err;
  err = launch_horizontal<K, RIGHT>(cost, (size_t)h * w, w, bits, lr, rl, d_range, h, w, wp, rw,
                                    p1, p2, device, s);
  if (err != cudaSuccess) return err;
  return narrow ? launch_vertical<K, true, 8, RIGHT>(cost, bits, lr, rl, ud, d_range, h, w, wp,
                                                     cost_width, rw, p1, p2, device, s)
                : launch_vertical<K, true, 16, RIGHT>(cost, bits, lr, rl, ud, d_range, h, w, wp,
                                                      cost_width, rw, p1, p2, device, s);
}

template <bool RIGHT, typename T>
cudaError_t launch_view(const float* cost, const T* base, const T* match, unsigned* bits,
                        float* lr, float* rl, float* ud, int d_range, int h, int w, int wp,
                        float p1, float p2, float tso, cudaStream_t s) {
#define CANONICAL_LAUNCH(K) \
  return launch<K, RIGHT, T>(cost, base, match, bits, lr, rl, ud, d_range, h, w, wp, p1, p2, \
                             tso, s);
  if (d_range <= 32) CANONICAL_LAUNCH(1)
  if (d_range <= 64) CANONICAL_LAUNCH(2)
  if (d_range <= 128) CANONICAL_LAUNCH(4)
  CANONICAL_LAUNCH(8)
#undef CANONICAL_LAUNCH
}

template <typename T>
cudaError_t launch_images(const float* cost, const void* left, const void* right,
                          float* scratch, float* out, int d_range, int h, int w, int wp,
                          float p1, float p2, float tso, int right_view, cudaStream_t s) {
  const T* l = static_cast<const T*>(left);
  const T* r = static_cast<const T*>(right);
  float* rl = scratch;
  float* ud = rl + (size_t)d_range * h * wp;
  unsigned* bits = reinterpret_cast<unsigned*>(ud + (size_t)d_range * h * wp);
  return right_view ? launch_view<true, T>(cost, r, l, bits, out, rl, ud, d_range, h, w, wp, p1,
                                           p2, tso, s)
                    : launch_view<false, T>(cost, l, r, bits, out, rl, ud, d_range, h, w, wp,
                                            p1, p2, tso, s);
}

}  // namespace

// The canonical scanline of one view, on `stream_ptr`.  cost: d-major
// [D, H, W] float32; left, right: [H, W] gray images, uint8 when u8 is 1,
// else float32; scratch: float32 [2, D, H, wp] (rl, ud) followed by the
// edge bits, 4 H RW 32-bit words, RW = (W + 640 + 31) / 32; out: float32
// [D, H, wp], wp = W rounded up to a multiple of 4 (columns W .. wp - 1 hold
// no meaning); all contiguous, scratch and out 16-byte aligned, on the
// current device; 1 <= D <= 256 and D H wp < 2^32.  right_view = 0 takes
// left as the base image and right as the match image, 1 the other way
// round.  Returns cudaGetLastError() after the launches (0 = launched),
// cudaErrorInvalidValue for a size outside the range or a misaligned buffer.
extern "C" int scanline_canonical_f32(const float* cost, const void* left, const void* right,
                                      int u8, float* scratch, float* out, int D, int H, int W,
                                      float p1, float p2, float tso, int right_view,
                                      void* stream_ptr) {
  const int wp = (W + 3) / 4 * 4;
  // the vertical movers keep offsets into the volumes in 32 bits
  if (D < 1 || D > 256 || H < 1 || W < 1 || (unsigned long long)D * H * wp > 0xffffffffull ||
      ((uintptr_t)scratch | (uintptr_t)out) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream_ptr;
  return (int)(u8 ? launch_images<unsigned char>(cost, left, right, scratch, out, D, H, W, wp,
                                                 p1, p2, tso, right_view, s)
                  : launch_images<float>(cost, left, right, scratch, out, D, H, W, wp, p1, p2,
                                         tso, right_view, s));
}

namespace {

// The band entry's edge bits (the horizontal planes) and both horizontal
// passes of one view.
template <int K, bool RIGHT, typename T>
cudaError_t launch_band(const float* cost, size_t cost_plane, size_t cost_row_stride,
                        const T* base, const T* match, unsigned* bits, float* lr, float* rl,
                        int d_range, int t, int w, int wp, float p1, float p2, float tso,
                        cudaStream_t s) {
  const int rw = row_words(w);
  int device = 0, sm_count = 0;
  cudaError_t err = current_device(&device, &sm_count);
  if (err != cudaSuccess) return err;
  err = launch_edge_bits<T>(base, match, bits, t, w, rw, tso, 2, sm_count, s);
  if (err != cudaSuccess) return err;
  return launch_horizontal<K, RIGHT>(cost, cost_plane, cost_row_stride, bits, lr, rl, d_range, t,
                                     w, wp, rw, p1, p2, device, s);
}

template <bool RIGHT, typename T>
cudaError_t launch_band_view(const float* cost, size_t cost_plane, size_t cost_row_stride,
                             const void* base, const void* match, unsigned* bits, float* lr,
                             float* rl, int d_range, int t, int w, int wp, float p1, float p2,
                             float tso, cudaStream_t s) {
  const T* b = static_cast<const T*>(base);
  const T* m = static_cast<const T*>(match);
#define BAND_LAUNCH(K)                                                                       \
  return launch_band<K, RIGHT, T>(cost, cost_plane, cost_row_stride, b, m, bits, lr, rl,     \
                                  d_range, t, w, wp, p1, p2, tso, s);
  if (d_range <= 32) BAND_LAUNCH(1)
  if (d_range <= 64) BAND_LAUNCH(2)
  if (d_range <= 128) BAND_LAUNCH(4)
  BAND_LAUNCH(8)
#undef BAND_LAUNCH
}

}  // namespace

// Both horizontal passes of one view over a band of the streamed executor
// (stereo_match_traditional_tpu_torch/parallel/streamed.py), on
// `stream_ptr`: the edge-bit prologue over the band's rows (the two
// horizontal planes only), then one launch of blocks (row, direction); each
// row of the band is a whole path, as in scanline_canonical_f32, where the
// JAX package runs _canonical_pass on the transposed band
// (stereo_match_traditional_tpu/parallel/streamed.py:435-445).
// cost: float32 [D, T, W] with d-planes `cost_plane` and rows
// `cost_row_stride` floats apart and its columns contiguous (a band that is
// a row range of a taller volume is read in place); base, match: the
// band's [T, W] rows of the view's own gray image and of the other one,
// contiguous, uint8 when u8 is 1, else float32; bits: 4 T RW 32-bit words
// of scratch, RW = (W + 640 + 31) / 32 (planes 1 and 3 are left unwritten);
// lr, rl: float32 [D, T, wp], wp = W rounded up to a multiple of 4, 16-byte
// aligned (columns W .. wp - 1 hold no meaning); 1 <= D <= 256.
// right_view = 1 reads the match image at x + d, 0 at x - d.  Returns
// cudaGetLastError() after the launches (0 = launched),
// cudaErrorInvalidValue for a size outside the range or a misaligned output.
extern "C" int scanline_canonical_horizontal_band_f32(
    const float* cost, long long cost_plane, long long cost_row_stride, const void* base,
    const void* match, int u8, void* bits, float* lr, float* rl, int D, int T, int W, float p1,
    float p2, float tso, int right_view, void* stream_ptr) {
  const int wp = (W + 3) / 4 * 4;
  if (D < 1 || D > 256 || T < 1 || W < 1 || cost_plane < 0 || cost_row_stride < 0 ||
      ((uintptr_t)lr | (uintptr_t)rl) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream_ptr;
  unsigned* b = static_cast<unsigned*>(bits);
  const size_t cp = (size_t)cost_plane, cr = (size_t)cost_row_stride;
  cudaError_t err;
  if (u8) {
    err = right_view ? launch_band_view<true, unsigned char>(cost, cp, cr, base, match, b, lr,
                                                             rl, D, T, W, wp, p1, p2, tso, s)
                     : launch_band_view<false, unsigned char>(cost, cp, cr, base, match, b, lr,
                                                              rl, D, T, W, wp, p1, p2, tso, s);
  } else {
    err = right_view ? launch_band_view<true, float>(cost, cp, cr, base, match, b, lr, rl, D, T,
                                                     W, wp, p1, p2, tso, s)
                     : launch_band_view<false, float>(cost, cp, cr, base, match, b, lr, rl, D,
                                                      T, W, wp, p1, p2, tso, s);
  }
  return (int)err;
}
