// Cross arms and the arm-rectangle mean of the AD-Census aggregation, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves both functions to XLA
// (`stereo_match_traditional_tpu/ops/aggregate.py:55` `_arm_one_direction`
// and `:119` `cross_arms`; `:266` `_sat`, `:313` `_rect_sums_shared_bounds`
// and `:486` `rect_mean_aggregate`).  The port's plain versions
// (`ops/aggregate.py` `_cross_arms_plain`, `_rect_mean_aggregate_plain`)
// run them as a few hundred PyTorch kernels: a stack of max_length shifted
// images a direction, float64 cumsums of the whole volume and four gathers.
//
// cross_arms_i32: offset o of an arm is accepted iff it is in bounds and
// the largest channel difference to the centre is <= tao(o) (tao1 for o <=
// sec_length, else tao2), in float32; the arm is the number of leading
// accepted offsets, at most max_length; a refused first offset that is in
// bounds (a NaN difference is neither accepted nor refused) gives 1 where
// the pixel is >= 2 from the border.  Vertical arms of a row band take
// global rows (row_offset, global_rows) for both rules and the band's own
// rows, clamped into it, for the values (the plain version's edge-clamped
// shifts).  The first design, a thread a pixel walking each arm through the
// cache to its first refused offset, waited a dependent load an offset, as
// long as the warp's longest arm.  Two kernels now, by the image:
//   * grey uint8 (the pipelines' images; max_length <= 252):
//     cross_arms_u8_kernel, a thread four neighbouring pixels of a row as
//     the bytes of a word, an offset of all four tested by two SIMD
//     instructions (__vabsdiffu4, __vcmpleu4 against the threshold as an
//     integer), the bounds applied once at the end (__vminu4 with the
//     packed limits), the rows' bytes for the horizontal arms staged once
//     in shared memory;
//   * colour or float32: cross_arms_kernel, a thread a pixel testing eight
//     offsets at a time, their loads independent, a warp vote between the
//     eights.
// Bound: bytes, the image in and the four int32 maps out (~2.4 us at
// Teddy).
//
// The rect mean: the plain version's float64 summed-area table S of every
// d-slice (S[i][j] = sum x[:i, :j], a zero row and column in front), the
// rectangle sum of the four corner picks in its order, ((S[i1+1][j1+1] -
// S[i0][j1+1]) - S[i1+1][j0]) + S[i0][j0], rounded to float32 once and
// divided by the float32 count.  The AD-Census costs sum exactly in float64
// (`_sat`'s note), so the result is the plain version's whatever the order
// of the sums.  For other float32 volumes the table's entries round: the
// plain version sums along the rows, then down each column one row after
// another, and so do both routes below, so that two corners of a column
// share the rounding of the rows above both, which cancels in their
// difference as it does in the plain version (a table summed in the other
// order, or rounded once an entry, strays from it by up to 2 float32 ulps of
// a mean at 720p).  Bound: bytes, the volume in and out once, the arms in
// (0.025 ms at Teddy, 0.286 ms at 720p, a view).  Two routes, chosen by the
// arguments (the wrapper, `aggregate_cuda.rect_mean_cuda`, says which):
//
// rect_mean_walker_f32, where the caller gives a static bound on the arms
// (`max_span`, the JAX package's argument; the cap L) and its ring fits a
// block's shared memory (L <= 48): no float64 table reaches device memory.
//   * A pre-pass, a warp a (slice, row), scans each row in float64 and
//     writes the row prefix at every strip's left halo edge (the carries,
//     n * h * ceil(W / 128) doubles); slice 0's warps also write each pixel's
//     rectangle, shared by the slices (its corners as byte offsets from the
//     pixel and its float count, 8 bytes), from the arms clamped into
//     [0, L], and count the arms outside into a device word (a cap below the
//     arms gives clamped rectangles; the callers' caps are the arms' own
//     bound, and the card checks read 0).
//   * The walker: a block of 1024 threads owns one slice's strip of 128
//     output columns and walks down the slice, 16 table rows a step, reading
//     the columns [c0 - L, c0 + 128 + L) of each row and the rows' carries
//     through cp.async one step ahead.
//     A step (a) scans its rows from their carries, a warp a row, (b) adds
//     them to each column's running sum, a thread a column, down the rows
//     one after another (the plain version's second cumsum), into a ring of
//     2L + 17 table rows in shared memory, and (c) writes every output row
//     whose rectangle rows [r - L, r + L + 1] are in the ring: four
//     shared-memory corner reads, one rounding, __fdiv_rn, the centre cost
//     where the count is 0, coalesced float32 stores.  The ring is
//     (2L + 17) * (2L + 129) doubles (131 KB at L = 34; 156 KB with the
//     stages): one block a SM.  No division or modulo in the step's loops:
//     ring slots and copy positions advance by increments.  (Strips of 64
//     columns, two blocks of 512 threads a SM, took 14-17 % longer on an
//     H100 at 720p/D=128 and 375x450/D=60; 32 columns, three times as long:
//     each strip scans and sums its halo's columns again.  Writing a step's
//     outputs beside the next step's scan, two barriers a step and 16 more
//     ring rows, took 4 % longer.)
//   Each value is read twice from device memory (pre-pass and walker) and
//   written once, about 12 bytes against the bound's 8.
//
// rect_mean_f32, a call without a cap or with one whose ring does not fit:
// three kernels a chunk of slices on a float64 scratch of the chunk (the
// wrapper sizes it): a warp a row scans along it (float32 in, float64 out),
// a thread a column sums down the rows in place, a thread an output picks
// its corners.  This design moves ~40 bytes a value (the table written,
// read and written again, four corners read), and the corner picks,
// scattered float64 reads of a table long gone from L2, take half its time.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "walker.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

// ---- cross arms ----------------------------------------------------------

constexpr int ARM_GROUP = 8;      // offsets a generic thread tests between two warp votes
constexpr int ARM_PACK = 4;       // pixels a thread of the u8 kernel: one 32-bit word
constexpr int ARM_U8_COLS = 32 * ARM_PACK;  // columns of a u8 block's rows
constexpr int ARM_U8_MAX = 252;   // the largest max_length of the u8 kernel (bytes count)

// The columns a u8 block reads on each side of its 128: max_length and the
// up to 3 offsets past it that a step of four tests, rounded up to a word.
__host__ __device__ constexpr int arm_u8_pad(int max_length) { return (max_length + 6) & ~3; }

// An arm's limit: offsets 1..lim are in bounds and within max_length; none
// where the first offset is out (a band row beyond the image's border) or
// the pixel is outside the image.
__device__ __forceinline__ int arm_limit(bool inside, int pos, int sign, int gsize,
                                         int max_length) {
  const bool first_in = pos + sign >= 0 && pos + sign <= gsize - 1;
  return inside && first_in ? min(max_length, sign < 0 ? pos : gsize - 1 - pos) : 0;
}

// The generic kernel (colour or float32 images, or caps above ARM_U8_MAX):
// a thread a pixel of a 32 x 8 block, the four directions in turn, offsets
// tested ARM_GROUP at a time (their loads independent, each only where the
// offset is within the limit), a warp vote between groups; the arm grows by
// the group's trailing ones while every offset so far was accepted.
template <typename T, int C>
__global__ void __launch_bounds__(256)
cross_arms_kernel(const T* __restrict__ img, int h, int w, int row_offset, int global_rows,
                  int max_length, int sec_length, float tao1, float tao2,
                  int* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const bool inside = i < h && j < w;
  const int ic = min(i, h - 1), jc = min(j, w - 1);
  const long long plane = (long long)h * w;
  float cen[C];
#pragma unroll
  for (int c = 0; c < C; ++c) cen[c] = (float)__ldg(img + ((long long)ic * w + jc) * C + c);
#pragma unroll 1
  for (int dir = 0; dir < 4; ++dir) {  // left, right, up, down
    const bool vertical = dir >= 2;
    const int sign = (dir & 1) ? 1 : -1;
    const int pos = vertical ? i + row_offset : j;
    const int gsize = vertical ? global_rows : w;
    const int lim = arm_limit(inside, pos, sign, gsize, max_length);
    int arm = 0;
    bool open = lim >= 1, fail1 = false;
    for (int o0 = 1; o0 <= max_length; o0 += ARM_GROUP) {
      if (!__any_sync(FULL, open)) break;
      unsigned acc = 0;
#pragma unroll
      for (int k = 0; k < ARM_GROUP; ++k) {
        const int o = o0 + k;
        if (o <= lim) {
          // a vertical offset reads the band's own row, clamped into it
          const long long at = vertical ? (long long)min(max(ic + sign * o, 0), h - 1) * w + jc
                                        : (long long)ic * w + jc + sign * o;
          float m = fabsf((float)__ldg(img + at * C) - cen[0]);
#pragma unroll
          for (int c = 1; c < C; ++c) {  // the largest channel difference, NaN if any is
            const float d = fabsf((float)__ldg(img + at * C + c) - cen[c]);
            m = (isnan(m) || d <= m) ? m : d;
          }
          const float tao = o <= sec_length ? tao1 : tao2;
          acc |= (unsigned)(m <= tao) << k;
          if (o == 1) fail1 = m > tao;  // a NaN difference is neither
        }
      }
      if (open) {
        const int ones = __ffs(~acc) - 1;
        arm += ones;
        open = ones == ARM_GROUP && o0 + ARM_GROUP <= lim;
      }
    }
    const bool border_ok = sign < 0 ? pos >= 2 : pos <= gsize - 3;
    if (inside)
      out[dir * plane + (long long)i * w + j] = (arm == 0 && fail1 && border_ok) ? 1 : arm;
  }
}

// The 4 bytes of a u8 image from element e on (e and the word after it
// read as aligned 32-bit words from `words`, the image's bytes from `skew`
// on); the word after is read only where it holds an element below `n`.
__device__ __forceinline__ uint32_t load4(const uint32_t* __restrict__ words, int skew, int e,
                                          int n) {
  const int a = e + skew, wi = a >> 2, sh = (a & 3) * 8;
  const uint32_t lo = __ldg(words + wi);
  const uint32_t hi = sh && (wi + 1) * 4 - skew < n ? __ldg(words + wi + 1) : 0u;
  return __funnelshift_r(lo, hi, sh);
}

// The u8 grey kernel: a thread holds 4 neighbouring pixels of a row as the 4
// bytes of a word and tests one offset of all four at once: __vabsdiffu4
// for the differences and __vcmpleu4 against the threshold as an integer
// (|a - b| <= tao iff |a - b| <= floor(tao) for integer differences; t1, t2
// in [-1, 255], -1 accepting nothing), a bytewise count of the leading
// accepted offsets, four offsets a step, a thread stopping once its four
// pixels' arms have closed or its largest limit is passed.  The bounds are
// applied once at the end: the arm is the smaller of the leading accepted
// offsets and the pixel's limit (__vminu4), so the offsets tested past a
// limit read clamped pixels that change nothing.  Its block of 32 x 8
// threads owns 128 columns of 8 rows, a warp a row: the horizontal arms read
// the warp's row's bytes [j0 - pad, j0 + 128 + pad) from shared memory (the
// columns clamped into the image; pad = arm_u8_pad(max_length), so a step's
// last offsets stay inside), the vertical arms the image itself (the band's
// rows clamped into it).
__global__ void __launch_bounds__(256)
cross_arms_u8_kernel(const uint8_t* __restrict__ img, int h, int w, int row_offset,
                     int global_rows, int max_length, int sec_length, int t1, int t2,
                     int* __restrict__ out) {
  extern __shared__ uint32_t rows[];  // [8][row_words]
  const int pad = arm_u8_pad(max_length);
  const int row_words = (ARM_U8_COLS + 2 * pad) / 4 + 1;  // a spare word for the shifts
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j0 = blockIdx.x * ARM_U8_COLS, i = blockIdx.y * 8 + ty, j = j0 + ARM_PACK * tx;
  uint32_t* row = rows + ty * row_words;
  uint8_t* bytes = reinterpret_cast<uint8_t*>(row);
  const uint8_t* src = img + (long long)min(i, h - 1) * w;
  for (int c = tx; c < row_words * 4; c += 32)
    bytes[c] = __ldg(src + min(max(j0 - pad + c, 0), w - 1));
  __syncwarp();
  if (i >= h || j >= w) return;
  const int n = h * w;
  const int skew = (int)((uintptr_t)img & 3);
  const uint32_t* words = reinterpret_cast<const uint32_t*>(img - skew);
  const uint32_t centre = row[(pad + ARM_PACK * tx) >> 2];
  const uint32_t ones = 0x01010101u;
  const uint32_t t1x4 = t1 < 0 ? 0u : (uint32_t)t1 * ones, t2x4 = t2 < 0 ? 0u : (uint32_t)t2 * ones;
#pragma unroll 1
  for (int dir = 0; dir < 4; ++dir) {  // left, right, up, down
    const bool vertical = dir >= 2;
    const int sign = (dir & 1) ? 1 : -1;
    uint32_t lim4 = 0;  // byte b: the limit of pixel j + b
    int most = 0;
#pragma unroll
    for (int b = 0; b < ARM_PACK; ++b) {
      const int pos = vertical ? i + row_offset : j + b;
      const int lim = arm_limit(j + b < w, pos, sign, vertical ? global_rows : w, max_length);
      lim4 |= (uint32_t)lim << (8 * b);
      most = max(most, lim);
    }
    uint32_t open = 0xffffffffu, arm = 0, first = 0;
    for (int o0 = 1; open && o0 <= most; o0 += 4) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int o = o0 + k;
        uint32_t x;
        if (vertical) {
          x = load4(words, skew, min(max(i + sign * o, 0), h - 1) * w + j, n);
        } else {
          const int c = pad + ARM_PACK * tx + sign * o;  // the bytes c..c + 3 of the row
          x = __funnelshift_r(row[c >> 2], row[(c >> 2) + 1], (c & 3) * 8);
        }
        const bool tao1_here = o <= sec_length;
        const uint32_t le = (tao1_here ? t1 : t2) < 0
                                ? 0u
                                : __vcmpleu4(__vabsdiffu4(x, centre), tao1_here ? t1x4 : t2x4);
        if (o == 1) first = le;
        open &= le;
        arm = __vadd4(arm, open & ones);
      }
    }
    arm = __vminu4(arm, lim4);
    // a refused first offset in bounds: the limit is >= 1 and it failed
    const uint32_t fail1 = __vcmpgtu4(lim4, 0u) & ~first;
#pragma unroll
    for (int b = 0; b < ARM_PACK; ++b) {
      if (j + b >= w) break;
      const int pos = vertical ? i + row_offset : j + b;
      const int gsize = vertical ? global_rows : w;
      const bool border_ok = sign < 0 ? pos >= 2 : pos <= gsize - 3;
      const int a = (arm >> (8 * b)) & 0xff;
      out[dir * n + i * w + j + b] = (a == 0 && ((fail1 >> (8 * b)) & 1u) && border_ok) ? 1 : a;
    }
  }
}

template <typename T, int C>
cudaError_t launch_arms(const void* img, int h, int w, int row_offset, int global_rows,
                        int max_length, int sec_length, float tao1, float tao2, int* out,
                        cudaStream_t s) {
  const dim3 block(32, 8);
  cross_arms_kernel<T, C><<<dim3((w + 31) / 32, (h + 7) / 8), block, 0, s>>>(
      (const T*)img, h, w, row_offset, global_rows, max_length, sec_length, tao1, tao2, out);
  return cudaGetLastError();
}

// The integer threshold of a u8 difference: |a - b| <= tao iff |a - b| <=
// it; -1 where no difference is accepted.
int u8_threshold(float tao) {
  return tao < 0.0f ? -1 : tao >= 255.0f ? 255 : (int)floorf(tao);
}

// ---- rect mean ------------------------------------------------------------

// Row i of every slice's table, S[s][i + 1][j + 1] = sum of x[s][i][0..j]
// (float64), and its zero column 0: one warp a (slice, row), 32 columns a
// step, the running total carried from step to step.  The plain version's
// first cumsum runs along the rows too; the prefixes of float32 values of a
// row are exact in float64 but for values below ~2^-17 of the row's sum, so
// the order of the additions rarely shows.
__global__ void __launch_bounds__(256)
row_scan_kernel(const float* __restrict__ x, int n, int h, int w, double* __restrict__ sat) {
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long long)n * h) return;
  const int s = (int)(warp / h);
  const int i = (int)(warp - (long long)s * h);
  const int wp = w + 1;
  const float* src = x + ((long long)s * h + i) * w;
  double* row = sat + ((long long)s * (h + 1) + i + 1) * wp;
  if (lane == 0) row[0] = 0.0;
  double carry = 0.0;
  for (int j0 = 0; j0 < w; j0 += 32) {
    const int j = j0 + lane;
    double v = j < w ? (double)__ldg(src + j) : 0.0;
#pragma unroll
    for (int k = 1; k < 32; k <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, v, k);
      if (lane >= k) v += u;
    }
    v += carry;
    if (j < w) row[j + 1] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
}

// Each column jj of every slice's table summed down its rows in place,
// after the zero row 0: one thread a (slice, column), consecutive threads
// on consecutive columns (coalesced).  A running float64 sum in the order
// of the plain version's second cumsum (PyTorch's scan along an outer
// dimension: one thread a column, acc = acc + x row by row), so the two
// tables agree entry for entry wherever the row prefixes do.
__global__ void __launch_bounds__(256)
column_sums_kernel(int n, int h, int w, double* __restrict__ sat) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int wp = w + 1;
  if (t >= (long long)n * wp) return;
  const int s = (int)(t / wp);
  const int jj = (int)(t - (long long)s * wp);
  double* col = sat + (long long)s * (h + 1) * wp + jj;
  col[0] = 0.0;
  double acc = 0.0;
  int i = 1;
  // eight rows' loads issued before their stores: the compiler cannot tell
  // a store to row i from a load of row i + 1, so one row at a time would
  // wait out a load's latency a row
  for (; i + 7 <= h; i += 8) {
    double v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = col[(long long)(i + k) * wp];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      acc = acc + v[k];
      col[(long long)(i + k) * wp] = acc;
    }
  }
  for (; i <= h; ++i) {
    acc = acc + col[(long long)i * wp];
    col[(long long)i * wp] = acc;
  }
}

// One output value a thread: the rectangle of its pixel's arms (the
// plain version's clamped bounds, inclusive or exclusive-upper), its
// float64 sum from the four corners in the plain version's order, one
// rounding to float32, the float32 division by the arms' count; the
// centre cost where the count is 0.  (A thread a pixel looping over the
// chunk's slices, the arms read once, measured 25 % slower at 720p.)
__global__ void __launch_bounds__(256)
rect_pick_kernel(const float* __restrict__ x, const double* __restrict__ sat, int n, int h,
                 int w, const int* __restrict__ arm_l, const int* __restrict__ arm_r,
                 const int* __restrict__ arm_u, const int* __restrict__ arm_d, int inclusive,
                 float* __restrict__ out) {
  const long long plane = (long long)h * w;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n * plane) return;
  const int s = (int)(t / plane);
  const long long p = t - (long long)s * plane;
  const int i = (int)(p / w);
  const int j = (int)(p - (long long)i * w);
  const long long up = __ldg(arm_u + p), down = __ldg(arm_d + p);
  const long long left = __ldg(arm_l + p), right = __ldg(arm_r + p);
  const int e = inclusive ? 0 : 1;
  const long long count = inclusive ? (up + down + 1) * (left + right + 1)
                                    : (up + down) * (left + right);
  const int i0 = (int)min(max((long long)i - up, 0LL), (long long)h - 1);
  const int i1 = (int)min(max((long long)i + down - e, 0LL), (long long)h - 1);
  const int j0 = (int)min(max((long long)j - left, 0LL), (long long)w - 1);
  const int j1 = (int)min(max((long long)j + right - e, 0LL), (long long)w - 1);
  const int wp = w + 1;
  const double* sl = sat + (long long)s * (h + 1) * wp;
  const double a = sl[(long long)(i1 + 1) * wp + (j1 + 1)];
  const double b = sl[(long long)i0 * wp + (j1 + 1)];
  const double c = sl[(long long)(i1 + 1) * wp + j0];
  const double d = sl[(long long)i0 * wp + j0];
  const float total = (float)(((a - b) - c) + d);
  const float mean = __fdiv_rn(total, (float)(count > 1 ? count : 1));
  out[t] = count > 0 ? mean : __ldg(x + t);
}


// ---- rect mean: the strip walker ---------------------------------------------

constexpr int WALK_S = 128;      // output columns of a strip
constexpr int WALK_R = 16;       // table rows a step (a warp a row in the scan)
constexpr int WALK_NT = 1024;    // threads of a walker block (one a SM)
constexpr int WALK_STAGES = 2;   // input steps in flight
constexpr int WALK_PRE = WALK_R * WALK_S / WALK_NT;  // outputs a thread in a steady step
constexpr int WALK_MAX_SPAN = 48;                    // the largest cap whose ring fits a block
constexpr int WALK_PER = (WALK_S + 2 * WALK_MAX_SPAN + 31) / 32;  // input columns a lane, at most

// The walker's shared memory at cap L: the ring of 2L + 1 + WALK_R table rows
// of WALK_S + 2L + 1 doubles, then WALK_STAGES steps of WALK_R carries
// (doubles) and of WALK_R input rows of WALK_S + 2L floats.
__host__ __device__ constexpr size_t walker_shared_bytes(int span) {
  return (size_t)(2 * span + 1 + WALK_R) * (WALK_S + 2 * span + 1) * sizeof(double) +
         (size_t)WALK_STAGES * WALK_R * sizeof(double) +
         (size_t)WALK_STAGES * WALK_R * (WALK_S + 2 * span) * sizeof(float);
}

// The pre-pass: one warp a (slice, row).  The row prefix P[e] = sum x[:e]
// (float64) at each strip k's left halo edge e = k * WALK_S - span, where
// that is > 0, into carries[s][k][i] (strips whose edge is <= 0 start from 0
// and read none): the edges lie WALK_S apart, so the warp sums each run
// between two edges (WALK_S / 32 columns a lane, a butterfly of the lanes)
// onto the carry.  The warps of slice 0 also write each pixel's rectangle, shared
// by the slices, from its arms clamped into [0, span] (and add the number
// of arms outside to *over_cap): geom[p].x packs the table rows and columns
// of its corners as offsets from the pixel, r - i0, i1 + 1 - r, j - j0 and
// j1 + 1 - j, a byte each from the low byte (each <= span + 1), geom[p].y
// the float32 count of the rectangle (0: the centre cost).
__global__ void __launch_bounds__(256)
rect_carry_kernel(const float* __restrict__ x, int n, int h, int w, int span, int strips,
                  const int* __restrict__ arm_l, const int* __restrict__ arm_r,
                  const int* __restrict__ arm_u, const int* __restrict__ arm_d, int inclusive,
                  double* __restrict__ carries, uint2* __restrict__ geom,
                  int* __restrict__ over_cap) {
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long long)n * h) return;
  const int s = (int)(warp / h);
  const int i = (int)(warp - (long long)s * h);
  const float* src = x + ((long long)s * h + i) * w;
  double* dst = carries + (long long)s * strips * h + i;  // strip k's carry at dst[k * h]
  double carry = 0.0;
#pragma unroll 4
  for (int k = 1; k < strips; ++k) {
    const int e = k * WALK_S - span;  // this strip's edge; the run [e - WALK_S, e) before it
    if (e <= 0) continue;
    const int j = max(e - WALK_S, 0) + lane;
    double v = 0.0;
#pragma unroll
    for (int q = 0; q < WALK_S; q += 32) v += j + q < e ? (double)__ldg(src + j + q) : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    carry += v;
    if (lane == 0) dst[(long long)k * h] = carry;
  }
  if (s != 0) return;
  const int ex = inclusive ? 0 : 1;
  int over = 0;
  for (int j = lane; j < w; j += 32) {
    const long long p = (long long)i * w + j;
    const int a[4] = {__ldg(arm_l + p), __ldg(arm_r + p), __ldg(arm_u + p), __ldg(arm_d + p)};
    int c[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      c[k] = min(max(a[k], 0), span);
      over += c[k] != a[k];
    }
    const int left = c[0], right = c[1], up = c[2], down = c[3];
    const int count =
        inclusive ? (up + down + 1) * (left + right + 1) : (up + down) * (left + right);
    const unsigned d_up = min(up, i);
    const unsigned d_down = min(max(i + down - ex, 0), h - 1) + 1 - i;
    const unsigned d_left = min(left, j);
    const unsigned d_right = min(max(j + right - ex, 0), w - 1) + 1 - j;
    geom[p] = make_uint2(d_up | d_down << 8 | d_left << 16 | d_right << 24,
                         __float_as_uint((float)count));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) over += __shfl_down_sync(FULL, over, o);
  if (lane == 0 && over) atomicAdd(over_cap, over);
}

// The walker: block (k, s) writes the rect means of slice s's columns
// [k * WALK_S, (k + 1) * WALK_S), walking down the slice WALK_R table rows a
// step (the header describes it).  Table row t lives in the ring at slot
// t % ring_rows (slots tracked by increments, no division in the loop);
// table columns jlo..jhi of the strip at ring columns 0..jhi - jlo.  After
// table row T is built, output row r needs table rows max(r - span, 0) ..
// min(r + span + 1, h): the rows r < T - span are written (all that are
// left once T = h), and the ring, 2 * span + 1 + WALK_R rows, still holds the
// oldest row they need, r - span >= T - WALK_R - 2 * span.  The next step's
// first barrier keeps its rows from overwriting the ring before the outputs
// are read.  Each step's input rows and carries arrive by cp.async one step
// ahead.
__global__ void __launch_bounds__(WALK_NT, 1)
rect_walker_kernel(const float* __restrict__ x, int h, int w, int span, int strips,
                   const double* __restrict__ carries, const uint2* __restrict__ geom,
                   float* __restrict__ out) {
  extern __shared__ double ring[];
  const int cols = WALK_S + 2 * span + 1;
  const int ring_rows = 2 * span + 1 + WALK_R;
  const int stage_len = WALK_R * (cols - 1);
  double* stage_carry = ring + (size_t)ring_rows * cols;  // [stage][row]
  // [stage][row][column]
  float* stages = reinterpret_cast<float*>(stage_carry + WALK_STAGES * WALK_R);
  const int k = blockIdx.x;
  const long long s = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = k * WALK_S;
  const int jlo = max(c0 - span, 0);
  const int nin = min(c0 + WALK_S + span, w) - jlo;  // input columns a row; table columns nin + 1
  const float* xs = x + s * h * w;
  const double* cs = carries + (s * strips + k) * h;
  const bool carried = c0 - span > 0;
  const int steps = (h + WALK_R - 1) / WALK_R;
  // this thread's first (row, column) of a step's rows x nin inputs, and its
  // stride in rows and columns
  const int fr = tid / nin, fc = tid - fr * nin;
  const int dr = WALK_NT / nin, dc = WALK_NT - dr * nin;

  auto fetch = [&](int step) {
    if (step < steps) {
      const int b = step % WALK_STAGES;
      float* st = stages + b * stage_len;
      const int rows = min(WALK_R, h - step * WALK_R);
      const float* src = xs + (long long)step * WALK_R * w + jlo;
      for (int r = fr, c = fc; r < rows;) {
        cp_async4(st + r * (cols - 1) + c, src + (long long)r * w + c);
        r += dr;
        c += dc;
        if (c >= nin) {
          c -= nin;
          ++r;
        }
      }
      if (carried && tid < rows)
        cp_async8(stage_carry + b * WALK_R + tid, cs + step * WALK_R + tid);
    }
    cp_async_commit();
  };

  for (int c = tid; c <= nin; c += WALK_NT) ring[c] = 0.0;  // table row 0
  double acc = 0.0;  // thread c's running sum down table column jlo + c
  fetch(0);
  int done = 0;       // output rows written
  int slot_t0 = 1;    // the slot of this step's first table row
  int slot_done = 0;  // the slot of table row `done`
  for (int step = 0; step < steps; ++step) {
    fetch(step + 1);
    const int t0 = 1 + step * WALK_R;
    const int nrows = min(WALK_R, h + 1 - t0);  // this step builds table rows [t0, t0 + nrows)
    const int last = t0 + nrows - 1;
    const int upto = last == h ? h : max(last - span, 0);  // then writes rows [done, upto)
    // ahead of the barrier: the rectangles of the step's first outputs
    uint2 pre[WALK_PRE];
#pragma unroll
    for (int q = 0; q < WALK_PRE; ++q) {
      const int e = q * WALK_NT + tid;
      const int r = done + e / WALK_S, j = c0 + e % WALK_S;
      pre[q] = r < upto && j < w ? __ldg(geom + (long long)r * w + j) : make_uint2(0u, 0u);
    }
    cp_async_wait<WALK_STAGES - 1>();
    __syncthreads();
    // (a) row t0 + warp's prefixes from its carry: a lane sums a run of
    // columns, a warp scan of the runs, the lane's run written out
    if (warp < nrows) {
      const int b = step % WALK_STAGES;
      const float* src = stages + b * stage_len + warp * (cols - 1);
      int slot = slot_t0 + warp;
      if (slot >= ring_rows) slot -= ring_rows;
      double* row = ring + (size_t)slot * cols;
      const double carry = carried ? stage_carry[b * WALK_R + warp] : 0.0;
      const int per = (nin + 31) >> 5;
      const int lo = min(lane * per, nin), hi = min(lo + per, nin);
      double v[WALK_PER];
      double part = 0.0;
#pragma unroll
      for (int q = 0; q < WALK_PER; ++q) {
        v[q] = lo + q < hi ? (double)src[lo + q] : 0.0;
        part += v[q];
      }
      double incl = part;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double u = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += u;
      }
      const double before = __shfl_up_sync(FULL, incl, 1);
      double run = lane == 0 ? carry : carry + before;
#pragma unroll
      for (int q = 0; q < WALK_PER; ++q)
        if (lo + q < hi) {
          run += v[q];
          row[lo + q + 1] = run;
        }
      if (lane == 0) row[0] = carry;
    }
    __syncthreads();
    // (b) down each column, one row after another, eight rows' loads ahead
    if (tid <= nin) {
      int slot = slot_t0;
#pragma unroll
      for (int half = 0; half < WALK_R; half += 8) {
        double v[8];
        int at[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          at[r] = slot * cols + tid;
          if (half + r < nrows) v[r] = ring[at[r]];
          if (++slot == ring_rows) slot = 0;
        }
#pragma unroll
        for (int r = 0; r < 8; ++r)
          if (half + r < nrows) {
            acc = acc + v[r];
            ring[at[r]] = acc;
          }
      }
    }
    __syncthreads();
    // (c) output rows [done, upto)
    auto emit = [&](int e, uint2 g) {
      const int rr = e / WALK_S, r = done + rr, j = c0 + e % WALK_S;
      if (j >= w) return;
      const float count = __uint_as_float(g.y);
      float res;
      if (count > 0.0f) {
        int sr = slot_done + rr;
        if (sr >= ring_rows) sr -= ring_rows;
        int s0 = sr - (int)(g.x & 0xffu);  // table row i0
        if (s0 < 0) s0 += ring_rows;
        int s1 = sr + (int)((g.x >> 8) & 0xffu);  // table row i1 + 1
        if (s1 >= ring_rows) s1 -= ring_rows;
        const int j0 = j - jlo - (int)((g.x >> 16) & 0xffu), j1 = j - jlo + (int)(g.x >> 24);
        const double* lo = ring + (size_t)s0 * cols;
        const double* hi = ring + (size_t)s1 * cols;
        const float total = (float)(((hi[j1] - lo[j1]) - hi[j0]) + lo[j0]);
        res = __fdiv_rn(total, count);
      } else {
        res = __ldg(xs + (long long)r * w + j);
      }
      out[(s * h + r) * w + j] = res;
    };
    const int nout = (upto - done) * WALK_S;
#pragma unroll
    for (int q = 0; q < WALK_PRE; ++q)
      if (q * WALK_NT + tid < nout) emit(q * WALK_NT + tid, pre[q]);
    for (int e = WALK_PRE * WALK_NT + tid; e < nout; e += WALK_NT) {
      const int r = done + e / WALK_S, j = c0 + e % WALK_S;
      emit(e, j < w ? __ldg(geom + (long long)r * w + j) : make_uint2(0u, 0u));
    }
    slot_done += upto - done;
    if (slot_done >= ring_rows) slot_done -= ring_rows;
    done = upto;
    slot_t0 += WALK_R;
    if (slot_t0 >= ring_rows) slot_t0 -= ring_rows;
  }
}

}  // namespace

// The four cross arms of an image, on `stream`: img [h, w] (channels 1) or
// [h, w, 3] (channels 3), uint8 (u8 != 0) or float32, contiguous; out int32
// [4, h, w] (left, right, up, down), contiguous, on the current device;
// 4 * h * w < 2^31.
// Row i of the image is global row row_offset + i of an image of
// global_rows rows.  Returns a cudaError_t code.
extern "C" int cross_arms_i32(const void* img, int channels, int u8, int h, int w,
                              int row_offset, int global_rows, int max_length, int sec_length,
                              float tao1, float tao2, void* out, void* stream) {
  if (h < 1 || w < 1 || max_length < 1 || (channels != 1 && channels != 3) ||
      global_rows < 1 || 4LL * h * w >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int* o = (int*)out;
  if (u8 && channels == 1 && max_length <= ARM_U8_MAX && !isnan(tao1) && !isnan(tao2)) {
    const int pad = arm_u8_pad(max_length);
    const size_t bytes = 8 * ((ARM_U8_COLS + 2 * pad) / 4 + 1) * sizeof(uint32_t);
    cross_arms_u8_kernel<<<dim3((w + ARM_U8_COLS - 1) / ARM_U8_COLS, (h + 7) / 8), dim3(32, 8),
                           bytes, s>>>((const uint8_t*)img, h, w, row_offset, global_rows,
                                       max_length, sec_length, u8_threshold(tao1),
                                       u8_threshold(tao2), o);
    return (int)cudaGetLastError();
  }
  if (u8) {
    return channels == 1 ? (int)launch_arms<uint8_t, 1>(img, h, w, row_offset, global_rows,
                                                        max_length, sec_length, tao1, tao2, o, s)
                         : (int)launch_arms<uint8_t, 3>(img, h, w, row_offset, global_rows,
                                                        max_length, sec_length, tao1, tao2, o, s);
  }
  return channels == 1 ? (int)launch_arms<float, 1>(img, h, w, row_offset, global_rows,
                                                    max_length, sec_length, tao1, tao2, o, s)
                       : (int)launch_arms<float, 3>(img, h, w, row_offset, global_rows,
                                                    max_length, sec_length, tao1, tao2, o, s);
}

// The arm-rectangle mean of every slice of vol [n, h, w] (float32,
// contiguous) into out (the same shape), on `stream`.  arms: four int32
// [h, w] maps (left, right, up, down) shared by the slices; inclusive != 0
// takes [-up, down] x [-left, right], else [-up, down) x [-left, right).
// scratch: float64, chunk * (h + 1) * (w + 1) values; the slices go in
// chunks of `chunk`.  Returns a cudaError_t code.
extern "C" int rect_mean_f32(const void* vol, long long n, int h, int w, const void* arm_l,
                             const void* arm_r, const void* arm_u, const void* arm_d,
                             int inclusive, void* scratch, int chunk, void* out, void* stream) {
  if (n < 1 || h < 1 || w < 1 || chunk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* x = (const float*)vol;
  float* o = (float*)out;
  double* sat = (double*)scratch;
  const long long plane = (long long)h * w;
  for (long long s0 = 0; s0 < n; s0 += chunk) {
    const int nc = (int)(n - s0 < chunk ? n - s0 : chunk);
    const float* xc = x + s0 * plane;
    const long long rows = (long long)nc * h;
    row_scan_kernel<<<(unsigned)((rows * 32 + 255) / 256), 256, 0, s>>>(xc, nc, h, w, sat);
    const long long cols = (long long)nc * (w + 1);
    column_sums_kernel<<<(unsigned)((cols + 255) / 256), 256, 0, s>>>(nc, h, w, sat);
    const long long values = (long long)nc * plane;
    rect_pick_kernel<<<(unsigned)((values + 255) / 256), 256, 0, s>>>(
        xc, sat, nc, h, w, (const int*)arm_l, (const int*)arm_r, (const int*)arm_u,
        (const int*)arm_d, inclusive, o + s0 * plane);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// The rect mean of every slice of vol [n, h, w] by the strip walker, for
// arms within [0, span] (the cap; a caller's `max_span`), on `stream`; the
// other arguments as rect_mean_f32's.  scratch: carries, float64, n *
// ceil(w / 128) * h values; geom, 2 * h * w 32-bit words (8-byte aligned);
// over_cap, one int32 that the call adds the arms outside [0, span] to.
// n <= 65535, 0 <= span <= 48 (walker_shared_bytes(span) <= 227 KB).
// Returns a cudaError_t code.
extern "C" int rect_mean_walker_f32(const void* vol, long long n, int h, int w,
                                    const void* arm_l, const void* arm_r, const void* arm_u,
                                    const void* arm_d, int inclusive, int span, void* carries,
                                    void* geom, void* over_cap, void* out, void* stream) {
  if (n < 1 || n > 65535 || h < 1 || w < 1 || span < 0 || span > WALK_MAX_SPAN ||
      walker_shared_bytes(span) > WALK_SHARED_LIMIT)
    return (int)cudaErrorInvalidValue;
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  static std::atomic<bool> sized[MAX_DEVICES];  // per device, false at first
  if (!sized[device].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(rect_walker_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)WALK_SHARED_LIMIT);
    if (err != cudaSuccess) return (int)err;
    // the largest shared-memory carveout
    err = cudaFuncSetAttribute(rect_walker_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    sized[device].store(true, std::memory_order_release);
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int strips = (w + WALK_S - 1) / WALK_S;
  const long long warps = n * h;
  rect_carry_kernel<<<(unsigned)((warps * 32 + 255) / 256), 256, 0, s>>>(
      (const float*)vol, (int)n, h, w, span, strips, (const int*)arm_l, (const int*)arm_r,
      (const int*)arm_u, (const int*)arm_d, inclusive, (double*)carries, (uint2*)geom,
      (int*)over_cap);
  rect_walker_kernel<<<dim3(strips, (unsigned)n), WALK_NT, walker_shared_bytes(span), s>>>(
      (const float*)vol, h, w, span, strips, (const double*)carries, (const uint2*)geom,
      (float*)out);
  return (int)cudaGetLastError();
}
