// What the two 4-path scanline kernels (scanline.cu, the classic recurrence,
// and scanline_canonical.cu, the canonical tso-scheduled one) share: the
// cp.async copies, the warp minimum, the ring of tile stages that mover and
// walker warps turn together, the horizontal word swizzle, the vertical
// layout and the movers of both kinds of block; the launch state comes from
// device.cuh.  The design they serve is described at the top of scanline.cu.
//
// Everything here lies in an unnamed namespace: each source that includes
// the header has its own copy.
#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>

#include "device.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int GS = 4;  // steps a walker takes from registers between its shared-memory accesses

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// float <-> int whose signed order is the float order (an involution)
__device__ __forceinline__ int ordered(int i) { return i ^ ((i >> 31) & 0x7fffffff); }

__device__ __forceinline__ float warp_min(float v) {
  const int r = __reduce_min_sync(FULL, ordered(__float_as_int(v)));
  return __int_as_float(ordered(r));
}

// The minimum of K values by halving (any K: an odd count keeps its middle
// value for the next round)
template <int K>
__device__ __forceinline__ float tree_min(const float (&v)[K]) {
  float t[K];
#pragma unroll
  for (int k = 0; k < K; ++k) t[k] = v[k];
#pragma unroll
  for (int n = K; n > 1; n = (n + 1) / 2) {
#pragma unroll
    for (int k = 0; k < n / 2; ++k) t[k] = fminf(t[k], t[k + (n + 1) / 2]);
  }
  return t[0];
}

// The loop both kernels run, one iteration a tile, over a ring of NS stages.
// The movers start the copies of tile ti + NS - 2 (`fetch` commits one
// cp.async group, empty past the end) into the stage that was written out
// an iteration ago, and write tile ti - 1 out; the walkers walk tile ti; at
// the iteration's end tile ti + 1 has landed.  The last iteration only
// writes tile ntiles - 1 out.
template <int NS, bool SIDES, typename Fetch, typename FetchSides, typename WriteOut,
          typename Walk>
__device__ __forceinline__ void run_tiles(bool walker, int ntiles, Fetch fetch,
                                          FetchSides fetch_sides, WriteOut write_out,
                                          Walk walk) {
  constexpr int AHEAD = NS - 2;
  // cp.async groups younger than tile ti + 1's when iteration ti ends: the
  // tiles ti + 2 .. ti + AHEAD and, with SIDES, a side group after each tile
  constexpr int YOUNGER = SIDES ? 2 * AHEAD - 1 : AHEAD - 1;
  if (!walker) {
    for (int ti = 0; ti < AHEAD; ++ti) {
      fetch(ti);
      if (SIDES) cp_async_commit();  // an empty group where a side group will follow a tile
    }
    cp_async_wait<YOUNGER>();  // tile 0
  }
  __syncthreads();
  for (int ti = 0; ti <= ntiles; ++ti) {
    if (!walker) {
      fetch(ti + AHEAD);
      if (SIDES) cp_async_wait<1>();  // the side inputs of tile ti - 1 (this thread's own)
      if (ti > 0) write_out(ti - 1);
      if (SIDES) fetch_sides(ti);     // over the ones just used; one group as well
      cp_async_wait<YOUNGER>();       // tile ti + 1
    } else if (ti < ntiles) {
      walk(ti);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Horizontal: block = (image row, direction); warp 0 walks, warps 1-3 move.
// ---------------------------------------------------------------------------

constexpr int HT = 32;       // steps of a tile: one lane a step for the movers
constexpr int HS = 4;        // stages: written out, walked, landed, on its way
constexpr int HMOVERS = 96;  // mover threads (3 warps)

// Word of (d, step j) in a tile: row d, its 16-byte chunks swizzled by the
// lane d / K that owns the row.
template <int K>
__device__ __forceinline__ int h_word(int d, int j) {
  return d * HT + ((((j >> 2) ^ ((d / K) & 7)) << 2) | (j & 3));
}

// A horizontal block's row and direction, and its movers.  Tiles are cut at
// multiples of HT columns, so that the 16-byte chunks of a tile are 16-byte
// chunks of the output's rows; path tile ti is image tile ntiles - 1 - ti
// when walking right to left, and its step j the column HT - 1 - j of that
// tile.  The steps before `head` of the first tile of a right-left path lie
// beyond the image.  Mover warp mw carries rows d = mw, mw + 3, ..; its lane
// the step.  The cost volume's d-planes lie `cost_plane` floats apart and its
// rows `cost_row_stride` (h w and w for a whole volume; a band that is a view
// of a taller volume has planes further apart), its columns next to each
// other; the output is a whole [D, h, wp] volume.
template <int K>
struct HorizontalBlock {
  static constexpr int TILE = 32 * K * HT;
  const float* cost_row;
  float* out_row;
  size_t plane, plane_out;
  int d_range, w, ntiles, head, mw, lane;
  bool rev;

  __device__ __forceinline__ HorizontalBlock(const float* cost, size_t cost_plane,
                                             size_t cost_row_stride, float* lr, float* rl,
                                             int d_range_, int h, int w_, int wp)
      : cost_row(cost + (size_t)blockIdx.x * cost_row_stride),
        out_row((blockIdx.y != 0 ? rl : lr) + (size_t)blockIdx.x * wp),
        plane(cost_plane),
        plane_out((size_t)h * wp),
        d_range(d_range_),
        w(w_),
        ntiles((w_ + HT - 1) / HT),
        head(blockIdx.y != 0 ? ntiles * HT - w_ : 0),
        mw((int)threadIdx.x / 32 - 1),
        lane(threadIdx.x & 31),
        rev(blockIdx.y != 0) {}

  __device__ __forceinline__ int tile_x0(int ti) const { return (rev ? ntiles - 1 - ti : ti) * HT; }
  __device__ __forceinline__ int column(int ti, int j) const {
    return tile_x0(ti) + (rev ? HT - 1 - j : j);
  }

  // Commits one cp.async group: the costs of tile `in` into its stage, and
  // whatever `extra(in)` copies with them (nothing past the last tile).
  template <typename Extra>
  __device__ __forceinline__ void fetch(float* smem, int in, Extra extra) const {
    if (in < ntiles) {
      if (column(in, lane) < w) {
        float* stage = smem + (in % HS) * TILE;
        const float* src = cost_row + column(in, lane) + (size_t)mw * plane;
#pragma unroll 4
        for (int d = mw; d < d_range; d += HMOVERS / 32, src += (HMOVERS / 32) * plane) {
          cp_async4(stage + h_word<K>(d, lane), src);
        }
      }
      extra(in);
    }
    cp_async_commit();
  }

  // Write-out: a lane carries the four steps of one 16-byte chunk, a warp four
  // rows.  The output's rows are `wp` apart, a multiple of 4, so a chunk is
  // one aligned store; columns w .. wp - 1 receive whatever the stage held.
  __device__ __forceinline__ void write_out(const float4* smem4, int done) const {
    const int chunk = lane & 7;
    const int x = rev ? column(done, chunk * 4 + 3) : column(done, chunk * 4);  // lowest column
    if (x >= w) return;
    const float4* stage = smem4 + (done % HS) * (TILE / 4);
    constexpr int ROWS = HMOVERS / 8;  // rows a round of the movers carries
    float* dst = out_row + x + (size_t)(mw * 4 + lane / 8) * plane_out;
#pragma unroll 4
    for (int d = mw * 4 + lane / 8; d < d_range; d += ROWS, dst += ROWS * plane_out) {
      float4 v = stage[d * (HT / 4) + (chunk ^ ((d / K) & 7))];
      if (rev) v = make_float4(v.w, v.z, v.y, v.x);
      *reinterpret_cast<float4*>(dst) = v;
    }
  }
};

// ---------------------------------------------------------------------------
// Vertical: block = XC neighbouring columns; warp n of the first XC / 4 walks
// columns 4 n .. 4 n + 3 (one 16-byte chunk), the others move tiles of
// [VT image rows][32 K][XC].  SECOND = the bottom-up pass, whose movers store
// the combination of the four directions over lr.
// ---------------------------------------------------------------------------

// XC, the columns of a block, is 16 (64-byte runs) or, where that would
// leave most of the card without a block, 8.
constexpr int NC = 4;          // columns of a walker warp
constexpr int VMOVERS = 256;   // mover threads (8 warps)
template <int XC> constexpr int VTHREADS = 32 * (XC / NC) + VMOVERS;

// The bottom-up pass stages lr, rl and ud of one tile behind its ring where
// they fit (K <= 4); for K = 8 its movers load them as they write out.
template <int K, bool SECOND, int XC> struct Vertical {
  static constexpr int VT = K >= 4 ? 4 : 8;   // image rows of a tile
  static constexpr int G = K >= 8 ? 1 : 4;    // rows a walker takes at once
  static constexpr bool SIDES = SECOND && K <= 4;
  static constexpr int NS = K >= 8 ? 3 : (SIDES ? 4 : 6);  // stages
  static constexpr int ROW = 32 * K * XC;     // words of one image row of a tile
  static constexpr int TILE = ROW * VT;
  static constexpr size_t BYTES = sizeof(float) * (NS + (SIDES ? 3 : 0)) * TILE;
};

// Word of (slot, column x) in an image row of a tile.  Slot k 32 + l holds
// d = l K + k, the k-th value of walker lane l, as XC columns.  SPAN slots
// fill the 32 banks; the 16-byte chunks of a slot are XOR-swizzled by
// l / SPAN, and tile row r exchanges the slots of a span (slot ^ (r % SPAN)),
// so that a walker's 128-bit access (32 slots of one k, one chunk, one row)
// and a mover's (one slot, whole, SPAN or more rows) are free of bank
// conflicts.
template <int XC> struct Layout {
  static constexpr int PP = XC / 4;    // chunks of a slot
  static constexpr int SPAN = 8 / PP;
  static __device__ __forceinline__ int word(int slot, int x) {
    return slot * XC + ((((x >> 2) ^ (slot / SPAN)) & (PP - 1)) << 2) + (x & 3);
  }
  static __device__ __forceinline__ int row_swizzle(int r) { return r & (SPAN - 1); }
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {  // past L1
  const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async8(float* dst, const float* src) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(a), "l"(src) : "memory");
}

// Four columns of a cost row, of which the first n lie in the image, as
// copies of WIDTH floats (the widest that every row of the volume allows).
template <int WIDTH>
__device__ __forceinline__ void copy_cost_piece(float* dst, const float* src, int n) {
  if (WIDTH == 4) {
    cp_async16(dst, src);
  } else if (WIDTH == 2) {  // w is even, so n is 2 or 4
    cp_async8(dst, src);
    if (n >= 4) cp_async8(dst + 2, src + 2);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (e < n) cp_async4(dst + e, src + e);
    }
  }
}

// A mover's share of a tile: 16-byte pieces (four columns of one d and tile
// row).  Mover `mt` carries, of tile row r = (mt / PP) % VT and columns
// 4 (mt % PP) .. + 3 of the block, the slots s0 + STRIDE i.  A warp's access
// thus covers all rows and columns of one or two d: device memory is
// d-major, and every d of a large volume lies in another page.
template <int K, int VT, int XC> struct Share {
  static constexpr int PP = XC / 4;                   // pieces of a slot's row
  static constexpr int SLOTS = 32 * K;
  static constexpr int STRIDE = VMOVERS / (PP * VT);  // slots between a mover's pieces
  static constexpr int NP = SLOTS / STRIDE;           // pieces a mover carries
  static_assert(VMOVERS % (PP * VT) == 0 && SLOTS % STRIDE == 0 && STRIDE % 8 == 0,
                "movers tile a stage exactly, and a mover's pieces share their swizzle");
};

// A vertical block's movers.  A piece is in the image if its first column
// is; lr, rl and ud have rows `wp` apart, a multiple of 4, so their pieces
// are aligned and whole, and columns w .. wp - 1 of them hold no meaning.
// The offsets of a mover's d are computed once, in 32 bits.
template <int K, bool SECOND, int XC>
struct VerticalMovers {
  using V = Vertical<K, SECOND, XC>;
  using Y = Layout<XC>;
  using S = Share<K, V::VT, XC>;
  static constexpr int VT = V::VT, NS = V::NS, TILE = V::TILE;
  const float* cost;
  float* lr;
  const float* rl;
  float* ud;
  float* smem;  // the NS stages, then [lr, rl, ud][TILE] where V::SIDES
  int h, w, wp, x0, ntiles, mt, mx, mr, word0;
  bool in_image;
  unsigned cost_d[S::NP], out_d[S::NP];  // d * plane of piece i, or ~0 for d >= D

  __device__ __forceinline__ VerticalMovers(const float* cost_, float* lr_, const float* rl_,
                                            float* ud_, float* smem_, int d_range, int h_,
                                            int w_, int wp_)
      : cost(cost_), lr(lr_), rl(rl_), ud(ud_), smem(smem_), h(h_), w(w_), wp(wp_),
        x0(blockIdx.x * XC), ntiles((h_ + VT - 1) / VT) {
    mt = (int)threadIdx.x - 32 * (XC / NC);
    mx = (mt % S::PP) * 4;
    mr = (mt / S::PP) % VT;
    const int slot0 = mt / (S::PP * VT);
    word0 = mr * V::ROW + Y::word(slot0 ^ Y::row_swizzle(mr), mx);  // piece i: STRIDE XC i on
    in_image = x0 + mx < w;
    const size_t plane = (size_t)h * w, plane_out = (size_t)h * wp;
#pragma unroll
    for (int i = 0; i < S::NP; ++i) {
      const int slot = slot0 + S::STRIDE * i;
      const int d = (slot & 31) * K + slot / 32;
      cost_d[i] = d < d_range ? (unsigned)(d * plane) : ~0u;
      out_d[i] = d < d_range ? (unsigned)(d * plane_out) : ~0u;
    }
  }

  __device__ __forceinline__ int image_row(int s) const { return SECOND ? h - 1 - s : s; }
  __device__ __forceinline__ bool row_in_image(int tile) const {
    return in_image && tile * VT + mr < h;
  }
  __device__ __forceinline__ size_t out_row(int tile) const {
    return (size_t)image_row(tile * VT + mr) * wp + x0 + mx;
  }

  template <int WIDTH>
  __device__ __forceinline__ void fetch_as(int in) const {
    float* dst = smem + (in % NS) * TILE + word0;
    const float* src = cost + (size_t)image_row(in * VT + mr) * w + x0 + mx;
    const int n = w - x0 - mx;
#pragma unroll
    for (int i = 0; i < S::NP; ++i) {
      if (cost_d[i] != ~0u) copy_cost_piece<WIDTH>(dst + S::STRIDE * XC * i, src + cost_d[i], n);
    }
  }

  // Commits one cp.async group: the costs of tile `in` into its stage, by
  // copies of cost_width floats, and whatever `extra(in)` copies with them
  // (nothing past the last tile).
  template <typename Extra>
  __device__ __forceinline__ void fetch(int in, int cost_width, Extra extra) const {
    if (in < ntiles) {
      if (row_in_image(in)) {
        if (cost_width == 4) fetch_as<4>(in);
        else if (cost_width == 2) fetch_as<2>(in);
        else fetch_as<1>(in);
      }
      extra(in);
    }
    cp_async_commit();
  }

  // The bottom-up pass's lr, rl and ud of tile `in`, behind the stages; one
  // group as well.
  __device__ __forceinline__ void fetch_sides(int in) const {
    if (in < ntiles && row_in_image(in)) {
      float* dst = smem + NS * TILE + word0;
      const size_t o = out_row(in);
#pragma unroll
      for (int i = 0; i < S::NP; ++i) {
        if (out_d[i] != ~0u) {
          cp_async16(dst + S::STRIDE * XC * i, lr + o + out_d[i]);
          cp_async16(dst + S::STRIDE * XC * i + TILE, rl + o + out_d[i]);
          cp_async16(dst + S::STRIDE * XC * i + 2 * TILE, ud + o + out_d[i]);
        }
      }
    }
    cp_async_commit();
  }

  // Stores tile `done`: over ud on the top-down pass; on the bottom-up one
  // combine(lr, rl, ud, du) over lr, lr, rl and ud staged beside the tile
  // where V::SIDES, else loaded here.
  template <typename Combine>
  __device__ __forceinline__ void write_out(int done, Combine combine) const {
    if (!row_in_image(done)) return;
    const float* stage = smem + (done % NS) * TILE + word0;
    const float* side = smem + NS * TILE + word0;
    const size_t o = out_row(done);
#pragma unroll
    for (int i = 0; i < S::NP; ++i) {
      if (out_d[i] == ~0u) continue;
      const int at = S::STRIDE * XC * i;
      float4 v = *reinterpret_cast<const float4*>(stage + at);
      if (V::SIDES) {
        v = combine(*reinterpret_cast<const float4*>(side + at),
                    *reinterpret_cast<const float4*>(side + at + TILE),
                    *reinterpret_cast<const float4*>(side + at + 2 * TILE), v);
      } else if (SECOND) {
        v = combine(*reinterpret_cast<const float4*>(lr + o + out_d[i]),
                    *reinterpret_cast<const float4*>(rl + o + out_d[i]),
                    *reinterpret_cast<const float4*>(ud + o + out_d[i]), v);
      }
      *reinterpret_cast<float4*>((SECOND ? lr : ud) + o + out_d[i]) = v;
    }
  }
};

}  // namespace
