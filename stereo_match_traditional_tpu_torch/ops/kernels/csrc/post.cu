// The post chain's 8-direction hole fill and speckle removal, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves both to XLA
// (`stereo_match_traditional_tpu/ops/post.py:580` `directional_candidates`,
// `:629` `_fill_from_candidates`, `:658` `fill_holes_8dir`; `:169`
// `remove_speckles`).  The port's plain versions (`ops/post.py`
// `_fill_holes_8dir_plain`, `_remove_speckles_plain`) run them as scans of
// sheared images, an [8, H, W] sort a pass, and label sweeps that stop on
// a host check of the fixpoint after each sweep.
//
// fill_pass_f32 / fill_holes_8dir_f32: a pass of the fill is two kernels
// (the target counts zeroed by a memset a call).  The first
// design's walks (a thread a pixel stepping along each ray to the first
// finite value, each load waiting on the branch before it, a warp as slow
// as its longest ray, most of its lanes idle: few pixels are targets)
// become searches of bitsets by the targets alone:
//   * fill_bits_kernel: one bit a pixel, finite in the pass's input, along
//     each of the four line families, a word 32 positions of a line: rows
//     (line i, position j), columns (line j, position i), diagonals (line j
//     - i + h - 1, position i) and anti-diagonals (line i + j, position i),
//     the last three word-major (word q of every line, then word q + 1) so
//     that neighbouring pixels read neighbouring words.  A block ballots
//     the flags of 32 rows x 96 columns into shared memory and writes every
//     word of its 32 x 32 tile and of the lines through its top row, each
//     word of the bitsets once (~0.16 bytes a pixel, all of it in L2).  It
//     also writes its tile's pixels that are no target as they stay and
//     lists the targets (one global atomic a block);
//   * fill_pass_kernel, a thread a listed target: it finds each ray's first
//     set bit within the ray's cap (axis rays cap_axis steps, diagonal rays
//     cap_diag, a step a position along the line) by __ffs / __clz over the
//     line's words from its own position outwards, the bits beyond the cap
//     masked, all rays' word loads of a round issued together; then the <=
//     8 found values, loaded together, and the one of rank second (second
//     != 0; the smallest where only one was found) or count / 2 in ray
//     order (E, W, S, N, SE, NW, SW, NE) for ties; a target whose rays found
//     nothing keeps its value.  An uncapped ray costs at most w / 32 words.
// Bit-exact: a pure selection.  Each pass rebuilds the bits from its own
// input (the passes fill pixels that later passes' rays must see).  The
// three passes are one call of fill_holes_8dir_f32 (a pass a call of
// fill_pass_f32 for the sharded post), each reading the last one's output;
// the first maps invalid_value to +inf as it reads (raw != 0), the last
// writes invalid_value for what stays non-finite (finalize != 0).  Bound:
// bytes, the map and the masks in and the map out (~1 us at Teddy).
//
// remove_speckles_f32: connected components of the valid pixels (finite
// and != invalid_value) whose neighbours (left, up, and with 8-connectivity
// up-right and up-left) differ by <= diff_insame in float32; pixels of
// components smaller than min_area, and with a background value holding a
// member that is not background, become invalid_value.  Only the areas
// reach the output, so the result is the plain version's bit for bit
// whatever order the links take.  Four kernels a call, no memset, no host
// round trip:
//   * tile: a block labels its 32 x 32 tile by union-find in shared memory
//     (a root hooked under the smaller root by a shared atomicMin, the hook
//     retried from the value it returns, Playne and Hawick's linking), so a
//     label is the smallest index of its tile-local component; it writes
//     each pixel's label as a global index, each tile root's area and
//     foreground count (summed a warp at a time by __match_any_sync, one
//     shared atomic a warp and root) and zeroes the totals;
//   * merge: a thread a pixel of a tile's top row and first and last
//     columns unites, by the same linking on the global labels, only the
//     pairs that cross a tile border; each walk to a root halves the path
//     it takes, as ECL-CC's do;
//   * tally: each tile root adds its area and foreground count to its
//     global root's totals, one 64-bit atomic (area low, count high);
//   * kill: each valid pixel walks to its root and reads the totals.
// The first design linked every pixel pair in global memory and counted each
// pixel by an atomic on its root: the areas of a plane of 10^4-10^5 pixels
// queued on one address.  Bound: bytes, the map in and out (~1.4 us at
// Teddy); the per-pixel work is now shared-memory atomics and the global
// work ~1/8 of the pixels' links and one atomic a tile-local component.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float fill_value(const float* __restrict__ in, long long q, int raw,
                                            float invalid) {
  const float v = __ldg(in + q);
  return (raw && v == invalid) ? INFINITY : v;
}

// The bitsets of one pass's input map: rows[i * nw + q] (nw = ceil(w / 32)
// words a row), and the word-major families cols[q * w + j], diag[q * nd +
// k] (k = j - i + h - 1), anti[q * nd + k] (k = i + j), nd = h + w - 1, q in
// [0, nh), nh = ceil(h / 32); bit b of word q is position 32 q + b, 0 where
// that position is outside the map.  A diagonal or anti-diagonal word whose
// 32 positions hold no pixel of the map is never written: the searches stay
// inside each line's pixels.
struct FillBits {
  uint32_t* rows;
  uint32_t* cols;
  uint32_t* diag;
  uint32_t* anti;
  int nw, nh, nd;
};

__host__ __device__ inline FillBits fill_bits(void* scratch, int h, int w) {
  FillBits b;
  b.nw = (w + 31) / 32;
  b.nh = (h + 31) / 32;
  b.nd = h + w - 1;
  b.rows = (uint32_t*)scratch;
  b.cols = b.rows + (size_t)h * b.nw;
  b.diag = b.cols + (size_t)b.nh * w;
  b.anti = b.diag + (size_t)b.nh * b.nd;
  return b;
}

// Block (blockIdx.x - 1, blockIdx.y) of 32 x 8 threads: the 32 rows [i0, i0 +
// 32) and the 32 columns [j0, j0 + 32), j0 = 32 (blockIdx.x - 1) (blocks -1
// and nw reach only lines that enter or leave the map there).  Its warps
// ballot the finite flags of the rows' columns [j0 - 32, j0 + 64) into three
// words a row in shared memory; then each warp writes, a ballot a word, the
// tile's row words, its column words (bit b of column c: bit c of row b's
// word), and the diagonal and anti-diagonal words of the lines through (i0,
// j0 + s), s < 32 (bit b: the flag at (i0 + b, j0 + s +- b), inside the 96
// columns).  Each word of the bitsets is written by one block, once.  The
// tile's own pixels (the middle 32 columns) are sorted on the way: a pixel
// that is no target is written out as it will stay, a target's index is
// appended to `targets` (each row's targets placed by a shared atomic, the
// block's by one atomic on *count).
__global__ void __launch_bounds__(256)
fill_bits_kernel(const float* __restrict__ in, const uint8_t* __restrict__ mask,
                 float* __restrict__ out, int h, int w, int raw, float invalid,
                 int need_nonfinite, int finalize, FillBits bits, int* __restrict__ targets,
                 int* __restrict__ count) {
  __shared__ unsigned flags[32][3];
  __shared__ int block_targets, block_base;
  const int lane = threadIdx.x, wy = threadIdx.y;
  const int tc = (int)blockIdx.x - 1, q = blockIdx.y;
  const int i0 = q * 32, j0 = tc * 32;
  const bool tile = tc >= 0 && tc < bits.nw;
  if (lane == 0 && wy == 0) block_targets = 0;
  __syncthreads();
  unsigned who[4];  // the targets of the warp's rows wy + 8 m, and their place
  int at[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int r = wy + 8 * m, i = i0 + r;
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      const int j = j0 - 32 + 32 * x + lane;
      const bool in_map = i < h && j >= 0 && j < w;
      const long long p = (long long)i * w + j;
      const float v = in_map ? fill_value(in, p, raw, invalid) : 0.0f;
      const unsigned word = __ballot_sync(0xffffffffu, in_map && isfinite(v));
      if (lane == 0) flags[r][x] = word;
      if (x == 1) {
        const bool target = tile && in_map && (mask == nullptr || __ldg(mask + p) != 0) &&
                            (!need_nonfinite || !isfinite(v));
        if (tile && in_map && !target) out[p] = (finalize && !isfinite(v)) ? invalid : v;
        who[m] = __ballot_sync(0xffffffffu, target);
        at[m] = lane == 0 && who[m] ? atomicAdd(&block_targets, __popc(who[m])) : 0;
      }
    }
  }
  __syncthreads();
  if (lane == 0 && wy == 0 && block_targets) block_base = atomicAdd(count, block_targets);
  __syncthreads();
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int place = __shfl_sync(0xffffffffu, at[m], 0);
    if ((who[m] >> lane) & 1u)
      targets[block_base + place + __popc(who[m] & ((1u << lane) - 1u))] =
          (i0 + wy + 8 * m) * w + j0 + lane;
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int s = wy + 8 * m;
    if (tile && lane == 0 && i0 + s < h)
      bits.rows[(long long)(i0 + s) * bits.nw + tc] = flags[s][1];
    const unsigned col = __ballot_sync(0xffffffffu, (flags[lane][1] >> s) & 1u);
    if (tile && lane == 0 && j0 + s < w) bits.cols[(long long)q * w + j0 + s] = col;
    // the lines through (i0, j0 + s): written where they hold a pixel of
    // rows [i0, i0 + 32)
    const int js = j0 + s;
    int c = 32 + s + lane;
    const unsigned diag = __ballot_sync(0xffffffffu, (flags[lane][c >> 5] >> (c & 31)) & 1u);
    const int kd = js - i0 + h - 1;
    if (lane == 0 && js >= -31 && js <= w - 1 && kd >= 0)
      bits.diag[(long long)q * bits.nd + kd] = diag;
    c = 32 + s - lane;
    const unsigned anti = __ballot_sync(0xffffffffu, (flags[lane][c >> 5] >> (c & 31)) & 1u);
    const int ka = i0 + js;
    if (lane == 0 && js >= 0 && js <= w + 30 && ka <= bits.nd - 1)
      bits.anti[(long long)q * bits.nd + ka] = anti;
  }
}

// A thread a target of the list (grid-stride): it searches its 8 rays (E,
// W along the row, S, N along the column, SE, NW along the diagonal, SW, NE
// along the anti-diagonal; forward rays towards higher positions) over
// positions [lo, hi]: within the cap and within the line's pixels.  Every
// ray's first word is loaded before any is tested; rays with no set bit in
// it load their next words a round at a time, all such rays together.  The
// found pixels' values are then loaded together, and the one of rank `pick`
// (second smallest, or count / 2) is chosen by counting, for each
// candidate, the candidates below it, ties in ray order: the order of the
// first design's insertion sort, in registers.  The list holds only the
// targets, so a warp's lanes all search.
__global__ void __launch_bounds__(256)
fill_pass_kernel(const float* __restrict__ in, float* __restrict__ out,
                 const int* __restrict__ targets, const int* __restrict__ count, int h, int w,
                 int raw, float invalid, int second, int cap_axis, int cap_diag, int finalize,
                 FillBits bits) {
  const int n = *count;
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < n; t += gridDim.x * blockDim.x) {
    const int p = __ldg(targets + t);
    const int i = p / w, j = p - i * w;
    float res = fill_value(in, p, raw, invalid);
    const int kd = j - i + h - 1, ka = i + j;
    const uint32_t* line[4] = {bits.rows + (long long)i * bits.nw, bits.cols + j,
                               bits.diag + kd, bits.anti + ka};
    const long long stride[4] = {1, w, bits.nd, bits.nd};
    // each family's positions that hold a pixel of the map
    const int pmin[4] = {0, 0, max(0, i - j), max(0, i - (w - 1 - j))};
    const int pmax[4] = {w - 1, h - 1, min(h - 1, i + w - 1 - j), min(h - 1, i + j)};
    int lo[8], hi[8], q[8], found[8];
    unsigned m[8];
    bool pending[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int f = r >> 1, pos = r < 2 ? j : i, cap = r < 4 ? cap_axis : cap_diag;
      const bool fwd = (r & 1) == 0;
      lo[r] = fwd ? pos + 1 : max(pos - cap, pmin[f]);
      hi[r] = fwd ? (int)min((long long)pos + cap, (long long)pmax[f]) : pos - 1;
      q[r] = (fwd ? lo[r] : hi[r]) >> 5;
      m[r] = lo[r] <= hi[r] ? __ldg(line[f] + q[r] * stride[f]) : 0u;
      found[r] = -1;
      pending[r] = lo[r] <= hi[r];
    }
    for (bool any = true; any;) {
      any = false;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (!pending[r]) continue;
        const bool fwd = (r & 1) == 0;
        unsigned word = m[r];
        if (q[r] == lo[r] >> 5) word &= ~0u << (lo[r] & 31);
        if (q[r] == hi[r] >> 5) word &= 0xffffffffu >> (31 - (hi[r] & 31));
        if (word) {
          found[r] = q[r] * 32 + (fwd ? __ffs(word) - 1 : 31 - __clz(word));
          pending[r] = false;
        } else if (q[r] == (fwd ? hi[r] : lo[r]) >> 5) {
          pending[r] = false;
        } else {
          q[r] += fwd ? 1 : -1;
          any = true;
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
        if (any && pending[r]) m[r] = __ldg(line[r >> 1] + q[r] * stride[r >> 1]);
    }
    // the found pixels: (i, f) on the row, (f, j) on the column, (f, j +
    // (f - i)) on the diagonal, (f, j - (f - i)) on the anti-diagonal; a bit
    // says the pixel is finite (and not invalid_value in a raw pass)
    float cand[8];
    int k = 0;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int f = found[r];
      const long long at = r < 2 ? (long long)i * w + f
                           : r < 4 ? (long long)f * w + j
                           : r < 6 ? (long long)f * w + j + (f - i)
                                   : (long long)f * w + j - (f - i);
      cand[r] = f >= 0 ? __ldg(in + at) : 0.0f;
      k += f >= 0;
    }
    const int pick = second ? (k > 1 ? 1 : 0) : k / 2;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      int rank = 0;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        rank += found[u] >= 0 && (cand[u] < cand[r] || (cand[u] == cand[r] && u < r));
      if (found[r] >= 0 && rank == pick) res = cand[r];
    }
    out[p] = (finalize && !isfinite(res)) ? invalid : res;
  }
}

// ---- speckles ---------------------------------------------------------------

constexpr int TILE = 32;       // a speckle tile's side (a warp a tile row)
constexpr int TILE_ROWS = 8;   // thread rows of a tile block: 4 pixel rows each
constexpr unsigned FULL = 0xffffffffu;

// The root of x's tree, in shared or global memory.  A label is never above
// its pixel's index and a root labels itself, so the walk stops at the
// first label that does not fall; on the way each visited pixel is pointed
// at its grandparent (path halving: an ancestor, so every tree stays a tree
// of its component).  Reads and writes go past the L1 cache: other threads
// hook roots with atomics.
__device__ __forceinline__ int find_root(int* labels, int x) {
  volatile int* l = labels;
  int curr = l[x];
  if (curr != x) {
    int prev = x, next;
    while (curr > (next = l[curr])) {
      l[prev] = next;
      prev = curr;
      curr = next;
    }
  }
  return curr;
}

__device__ void unite(int* labels, int a, int b) {
  while (true) {
    a = find_root(labels, a);
    b = find_root(labels, b);
    if (a == b) return;
    if (a < b) {
      const int old = atomicMin(labels + b, a);
      if (old == b) return;
      b = old;
    } else {
      const int old = atomicMin(labels + a, b);
      if (old == a) return;
      a = old;
    }
  }
}

__device__ __forceinline__ bool speckle_valid(float v, float invalid) {
  return isfinite(v) && v != invalid;
}

// Whether the pixels of values v and u are linked (both valid, close).
__device__ __forceinline__ bool linked(float v, float u, float invalid, float diff) {
  return speckle_valid(v, invalid) && speckle_valid(u, invalid) && fabsf(v - u) <= diff;
}

// Which of the links of pixel p to its up, up-left and up-right neighbours
// must be united: a link whose union another link already gives is left
// out (a run is united along its left links first).  With a, b the up-left
// and up neighbours' values, c the up-right's, l the left's, and
// left_b / left_c the up and up-right neighbours' own left links:
//   up (p, b): implied by the left links of p and b and the up link of
//     p's left neighbour (l, a);
//   up-left (p, a): implied by p's left link and (l, a), or by (p, b) and
//     b's left link;
//   up-right (p, c): implied by (p, b) and c's left link.
// Every implication rests on links to the left or straight up, so none
// rests on a link left out in its turn: the unions stay those of all links.
struct UpLinks {
  bool up, up_left, up_right;
};
__device__ __forceinline__ UpLinks up_links(float v, float l, float a, float b, float c,
                                            bool left_p, bool left_b, bool left_c, bool has_l,
                                            bool has_r, int conn8, float invalid, float diff) {
  const bool lb = linked(v, b, invalid, diff);
  const bool la = conn8 && has_l && linked(v, a, invalid, diff);
  const bool lc = conn8 && has_r && linked(v, c, invalid, diff);
  const bool l_a = has_l && linked(l, a, invalid, diff);
  UpLinks u;
  u.up = lb && !(left_p && left_b && l_a);
  u.up_left = la && !((left_p && l_a) || (lb && left_b));
  u.up_right = lc && !(lb && left_c);
  return u;
}

// Block (tx, ty) of TILE x TILE_ROWS threads labels tile (blockIdx.y,
// blockIdx.x); thread (tx, ty) holds pixels (ty + TILE_ROWS * q, tx), so a
// warp holds a tile row.  Each run of left links in a row is labelled with
// its first pixel by a ballot (no atomics); then the up, up-left and
// up-right links inside the tile that no other link implies unite the
// runs' roots (up_links).  labels[p] = the global index of p's tile root (p
// for an invalid pixel); local[p] = a tile root's area | foreground count
// << 16 (0 elsewhere); total[p] = 0.
__global__ void __launch_bounds__(TILE * TILE_ROWS)
speckle_tile_kernel(const float* __restrict__ d, int h, int w, float invalid, float diff,
                    int conn8, int has_bg, float bg, int* __restrict__ labels,
                    int* __restrict__ local, unsigned long long* __restrict__ total) {
  __shared__ float val[TILE][TILE];
  __shared__ unsigned lefts[TILE];  // bit tx of row r: pixel (r, tx) links to its left
  __shared__ int lab[TILE * TILE];
  __shared__ int stats[TILE * TILE];
  constexpr int Q = TILE / TILE_ROWS;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ti0 = blockIdx.y * TILE, tj0 = blockIdx.x * TILE;
  const int j = tj0 + tx;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int r = ty + TILE_ROWS * q, i = ti0 + r;
    val[r][tx] = i < h && j < w ? __ldg(d + (long long)i * w + j) : invalid;
    stats[r * TILE + tx] = 0;
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int r = ty + TILE_ROWS * q;
    const bool left = tx > 0 && linked(val[r][tx], val[r][tx - 1], invalid, diff);
    const unsigned mask = __ballot_sync(FULL, left);
    // the run's first pixel: the last pixel at or before tx with no left link
    const unsigned starts = ~mask & (tx == 31 ? FULL : (2u << tx) - 1u);
    lab[r * TILE + tx] = r * TILE + 31 - __clz(starts);
    if (tx == 0) lefts[r] = mask;
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int r = ty + TILE_ROWS * q, l = r * TILE + tx;
    const float v = val[r][tx];
    if (r == 0 || !speckle_valid(v, invalid)) continue;
    const bool has_l = tx > 0, has_r = tx + 1 < TILE;
    const unsigned above = lefts[r - 1];
    const UpLinks u = up_links(
        v, has_l ? val[r][tx - 1] : invalid, has_l ? val[r - 1][tx - 1] : invalid,
        val[r - 1][tx], has_r ? val[r - 1][tx + 1] : invalid, (lefts[r] >> tx) & 1u,
        (above >> tx) & 1u, has_r && ((above >> (tx + 1)) & 1u), has_l, has_r, conn8, invalid,
        diff);
    if (u.up) unite(lab, l, l - TILE);
    if (u.up_left) unite(lab, l, l - TILE - 1);
    if (u.up_right) unite(lab, l, l - TILE + 1);
  }
  __syncthreads();
  // each pixel's tile root; areas and foreground counts summed a warp (a
  // tile row) at a time, one shared atomic a root
  int root[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int r = ty + TILE_ROWS * q, l = r * TILE + tx;
    const float v = val[r][tx];
    const bool valid = speckle_valid(v, invalid);
    int x = l;
    if (valid)
      while (lab[x] != x) x = lab[x];
    root[q] = valid ? x : -1;
    const unsigned peers = __match_any_sync(FULL, root[q]);
    const unsigned fg = __ballot_sync(FULL, valid && has_bg && v != bg);
    if (valid && tx == __ffs(peers) - 1)
      atomicAdd(&stats[x], __popc(peers) | (__popc(peers & fg) << 16));
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int r = ty + TILE_ROWS * q, i = ti0 + r, l = r * TILE + tx;
    if (i >= h || j >= w) continue;
    const long long p = (long long)i * w + j;
    const int x = root[q];
    labels[p] = x < 0 ? (int)p : (ti0 + x / TILE) * w + tj0 + x % TILE;
    local[p] = x == l ? stats[l] : 0;
    total[p] = 0ull;
  }
}

// The links that cross a tile border, by the global labels: block (tx, ty)
// of TILE x 3 threads for tile (blockIdx.y, blockIdx.x); ty = 0 the top row
// (up, and up-right / up-left with 8-connectivity), ty = 1 the first column
// (left; up-left below the top row), ty = 2 the last column (up-right below
// the top row).  The links up_links finds implied are left out: each
// implication rests on links inside a tile (united by the tile kernel) or
// on crossing left links (always united here).
__global__ void __launch_bounds__(TILE * 3)
speckle_merge_kernel(const float* __restrict__ d, int* labels, int h, int w, float invalid,
                     float diff, int conn8) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ti0 = blockIdx.y * TILE, tj0 = blockIdx.x * TILE;
  const int i = ty == 0 ? ti0 : ti0 + tx;
  const int j = ty == 0 ? tj0 + tx : ty == 1 ? tj0 : tj0 + TILE - 1;
  if (i >= h || j >= w || (ty > 0 && tx == 0)) {
    // the top-left and top-right pixels' up links are the top row's; the
    // top-left pixel's left link is still the first column's
    if (!(ty == 1 && tx == 0 && i < h && j < w)) return;
  }
  const int p = i * w + j;
  const float v = __ldg(d + p);
  if (!speckle_valid(v, invalid)) return;
  const auto at = [&](int ii, int jj) {
    return ii < 0 || jj < 0 || jj >= w ? invalid : __ldg(d + ii * w + jj);
  };
  const float l = at(i, j - 1);
  if (ty == 1 && linked(v, l, invalid, diff)) unite(labels, p, p - 1);
  if (i == 0 || (ty == 1 && tx == 0)) return;
  const bool has_l = j > 0, has_r = j + 1 < w;
  const float a = at(i - 1, j - 1), b = at(i - 1, j), c = at(i - 1, j + 1);
  const UpLinks u = up_links(v, l, a, b, c, linked(v, l, invalid, diff),
                             linked(b, a, invalid, diff), linked(c, b, invalid, diff), has_l,
                             has_r, conn8, invalid, diff);
  if (ty == 0) {  // every up link of the top row crosses
    if (u.up) unite(labels, p, p - w);
    if (u.up_left) unite(labels, p, p - w - 1);
    if (u.up_right) unite(labels, p, p - w + 1);
  } else if (ty == 1) {
    if (u.up_left) unite(labels, p, p - w - 1);
  } else if (u.up_right && has_r) {
    unite(labels, p, p - w + 1);
  }
}

// Each tile root's area and foreground count added to its global root's.
__global__ void __launch_bounds__(256)
speckle_tally_kernel(int* labels, const int* __restrict__ local,
                     unsigned long long* __restrict__ total, int n) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int stats = __ldg(local + p);
  if (stats == 0) return;
  const int r = find_root(labels, p);
  atomicAdd(total + r, ((unsigned long long)(stats >> 16) << 32) | (unsigned)(stats & 0xffff));
}

__global__ void __launch_bounds__(256)
speckle_kill_kernel(const float* __restrict__ d, const int* __restrict__ labels,
                    const unsigned long long* __restrict__ total, float* __restrict__ out, int n,
                    float invalid, int min_area, int has_bg) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const float v = __ldg(d + p);
  bool kill = false;
  if (speckle_valid(v, invalid)) {
    int r = p;  // the trees no longer change: a plain walk, halved above
    while (labels[r] != r) r = labels[r];
    const unsigned long long t = total[r];
    const int area = (int)(t & 0xffffffffull), foreground = (int)(t >> 32);
    kill = area < min_area && (!has_bg || foreground > 0);
  }
  out[p] = kill ? invalid : v;
}

}  // namespace

namespace {

// One pass on `s`: the tile kernel, then the search kernel; *count zeroed
// before.
cudaError_t fill_pass(const float* in, const uint8_t* mask, float* out, const FillBits& b,
                      int* count, int* targets, int h, int w, int raw, float invalid,
                      int need_nonfinite, int second, int cap_axis, int cap_diag, int finalize,
                      cudaStream_t s) {
  fill_bits_kernel<<<dim3(b.nw + 2, b.nh), dim3(32, 8), 0, s>>>(
      in, mask, out, h, w, raw, invalid, need_nonfinite, finalize, b, targets, count);
  // a thread up to 8 targets, whatever their number
  const long long blocks = ((long long)h * w + 2047) / 2048;
  fill_pass_kernel<<<(unsigned)blocks, 256, 0, s>>>(in, out, targets, count, h, w, raw, invalid,
                                                    second, cap_axis, cap_diag, finalize, b);
  return cudaGetLastError();
}

// The scratch of a call: the bitsets (FillBits), FILL_COUNTS target counts,
// then h * w target indices.
constexpr int FILL_COUNTS = 4;

}  // namespace

// One pass of the 8-direction hole fill, on `stream`: in, out float32
// [h, w] (distinct), h * w < 2^31; mask uint8 [h, w] or null (every pixel);
// a pixel is a target where its mask is set and, with need_nonfinite, its
// value is not finite.  raw != 0 reads invalid_value as +inf; second != 0
// takes the second-smallest candidate, else the count / 2-th; cap_axis /
// cap_diag cap the rays' steps; finalize != 0 writes invalid_value for
// non-finite results.  scratch: the bitsets (h * ceil(w / 32) + ceil(h /
// 32) * (w + 2 (h + w - 1)) 32-bit words), then 4 target counts and h * w
// target indices (int32), written and read by the call.  All contiguous on
// the current device.  Returns a cudaError_t code.
extern "C" int fill_pass_f32(const void* in, const void* mask, void* out, void* scratch, int h,
                             int w, int raw, float invalid, int need_nonfinite, int second,
                             int cap_axis, int cap_diag, int finalize, void* stream) {
  if (h < 1 || w < 1 || (long long)h * w >= (1LL << 31) || cap_axis < 0 || cap_diag < 0 ||
      scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const FillBits b = fill_bits(scratch, h, w);
  int* count = (int*)(b.anti + (size_t)b.nh * b.nd);
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  return (int)fill_pass((const float*)in, (const uint8_t*)mask, (float*)out, b, count,
                        count + FILL_COUNTS, h, w, raw, invalid, need_nonfinite, second,
                        cap_axis, cap_diag, finalize, s);
}

// The three passes of the fill, on `stream`, in one call: occlusion's
// non-finite pixels by the second smallest candidate (reading in, raw != 0
// reading invalid_value as +inf), then mismatch's by the median, then every
// pixel still non-finite by the median, invalid_value written where none
// was found.  in, out float32 [h, w] (distinct), occlusion and mismatch
// uint8 [h, w]; scratch: fill_pass_f32's, then h * w float32 values (the
// second pass's output).  All contiguous on the current device.  Returns a
// cudaError_t code.
extern "C" int fill_holes_8dir_f32(const void* in, const void* occlusion, const void* mismatch,
                                   void* out, void* scratch, int h, int w, int raw,
                                   float invalid, int cap_axis, int cap_diag, void* stream) {
  if (h < 1 || w < 1 || (long long)h * w >= (1LL << 31) || cap_axis < 0 || cap_diag < 0 ||
      scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const FillBits b = fill_bits(scratch, h, w);
  int* counts = (int*)(b.anti + (size_t)b.nh * b.nd);
  int* targets = counts + FILL_COUNTS;
  float* second_out = (float*)(targets + (size_t)h * w);
  float* o = (float*)out;
  cudaError_t err = cudaMemsetAsync(counts, 0, 3 * sizeof(int), s);
  if (err == cudaSuccess)
    err = fill_pass((const float*)in, (const uint8_t*)occlusion, o, b, counts, targets, h, w,
                    raw, invalid, 1, 1, cap_axis, cap_diag, 0, s);
  if (err == cudaSuccess)
    err = fill_pass(o, (const uint8_t*)mismatch, second_out, b, counts + 1, targets, h, w, 0,
                    invalid, 1, 0, cap_axis, cap_diag, 0, s);
  if (err == cudaSuccess)
    err = fill_pass(second_out, nullptr, o, b, counts + 2, targets, h, w, 0, invalid, 1, 0,
                    cap_axis, cap_diag, 1, s);
  return (int)err;
}

// Speckle removal of disp float32 [h, w] into out (the same shape), on
// `stream`.  scratch: 4 * h * w int32 values, 8-byte aligned (the totals,
// 64-bit, then the labels and the tile roots' counts); conn8 != 0 takes
// 8-connectivity, else 4; has_bg != 0 spares components with no member !=
// bg.  All contiguous on the current device; h * w < 2^31.  Returns a
// cudaError_t code.
extern "C" int remove_speckles_f32(const void* disp, void* out, void* scratch, int h, int w,
                                   float invalid, float diff, int min_area, int conn8,
                                   int has_bg, float bg, void* stream) {
  if (h < 1 || w < 1 || (long long)h * w >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n = h * w;
  unsigned long long* total = (unsigned long long*)scratch;
  int* labels = (int*)(total + n);
  int* local = labels + n;
  const float* d = (const float*)disp;
  const dim3 tiles((w + TILE - 1) / TILE, (h + TILE - 1) / TILE);
  speckle_tile_kernel<<<tiles, dim3(TILE, TILE_ROWS), 0, s>>>(d, h, w, invalid, diff, conn8,
                                                              has_bg, bg, labels, local, total);
  speckle_merge_kernel<<<tiles, dim3(TILE, 3), 0, s>>>(d, labels, h, w, invalid, diff, conn8);
  const unsigned flat = (unsigned)((n + 255) / 256);
  speckle_tally_kernel<<<flat, 256, 0, s>>>(labels, local, total, n);
  speckle_kill_kernel<<<flat, 256, 0, s>>>(d, labels, total, (float*)out, n, invalid, min_area,
                                           has_bg);
  return (int)cudaGetLastError();
}
