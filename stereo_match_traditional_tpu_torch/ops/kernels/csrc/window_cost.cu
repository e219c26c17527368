// Windowed SAD and NCC cost volumes, one view per call, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package builds both volumes with XLA
// ops, a shifted stack and two banded MXU matmuls per box sum
// (stereo_match_traditional_tpu/ops/volume.py:152-182 box_sum_valid /
// box_sum_same).  Three entry points:
//
// sad_volume_f32 replaces volume.sad_volume (volume.py:224), both views,
// with `mean`.  With r = winsize + 1,
//   out[d, i, j] = sum_{|a|,|b| <= r} |A(i+a, j+b) - B(i+a, j+b + dir*e)|
//   left view:  A = left,  B = right, dir = -1, e = min(d, j)
//   right view: A = right, B = left,  dir = +1, e = min(d, W-1-j)
// with every read clamped into the image.  That is what border_fill of
// box_sum_valid over the shifted stack of the replicate-padded images
// gives: the padding is the clamp, and for e <= the column's limit the
// shifted padded column never leaves [0, Wp-1].  One launch: the thread that
// writes the entry d == limit of a pixel also writes it into the border
// triangle d > limit, so the volume is never read back.  mean divides by
// (2r+1)^2 (IEEE).  channels = 3 is the colour mode of
// sad_volume(channel_min=True) (volume.py:224-274, CBLSM.h:45-63): the
// images are [H, W, 3] and the term |A - B| becomes min_c |A_c - B_c|;
// every other step is the grey mode's.  Both-u8 colour pixels are staged as
// one packed word (R, G, B, 0) in the slot a grey float takes, and the term
// is __vabsdiffu4 and two byte minima, so the shared memory and MAX_RADIUS
// stay as they are.  float32 colour pixels are staged as three planes, which
// triples the bands' shared memory: that mode takes radii up to
// MAX_RADIUS_RGBF = 15 (226 KB at r = 15 of the 227 KB a block may take).
//
// ncc_window_sums_f32 replaces volume.ncc_sums: it centres both images at
// 128 and writes the zero-padded (2r+1)^2 window sums of x and x^2 of each
// (sum_l, sum_l2, sum_r, sum_r2) and, from them, the two variance terms
//   var = max(sum2 - (sum * sum) / n, 0),  n = (2r+1)^2,
// which depend on the pixel alone, so the volume kernel need not divide for
// them once per disparity.
//
// ncc_volume_f32 replaces volume.ncc_volume (volume.py:296): the sums
// kernel, then the cross sums sum_lr[d, i, j] = sum lf(i+a, j+b) *
// rf(i+a, j+b-d) of the centred images, zero outside the image
// (box_sum_same), fused with the epilogue
//   num = sum_lr - (sum_l * sum_r[j-d]) / n
//   ncc = num / sqrt(max(var_l * var_r[j-d], eps)); -2 where a var < 0.5
// and the sentinel where j - r - d < 0 (NCC.h:81), written without a
// window sum (about a quarter of the volume at W=450, D=200, r=10; a block
// whose columns are all invalid for its disparities computes nothing).  With
// d_offset the volume is the slice of global disparities d_offset ..
// d_offset + d_range - 1 (the (tile, disp) runners): every d above, in the
// reads of the other image and in the validity test, is the global one
// (entry d of the output is global disparity d_offset + d).
//
// What bounds it, and the design.  The function is bound by the bytes of
// the volume it writes (40 MB a view at Teddy 375x450/D=60, 135 MB at
// D=200), but a kernel that sums each window anew does (2r+1)^2 terms a
// value, and one that re-forms the column sums per disparity and 8-row tile
// (this file's first version) still made ~31 (9x9) to ~89 (21x21)
// shared-memory loads a value and ran at 7 % / 4.5 % of the bound.  Here
// every term is formed twice (entering and leaving a column sum) and every
// sum slides:
//  * A block owns a strip of `sw` output columns (cw = blockDim.x >= sw + 2r
//    columns of column sums), DC = 32 disparities and a run of `rr` rows.
//    It loads the two images' bands for the run once (rr + 2r rows; base: cw
//    columns, other: cw + DC - 1 columns; u8 or float32 in device memory,
//    float32 in shared memory) and walks down the rows.
//  * Stage 1, vertical: thread (column c, group g of DS = 8 disparities)
//    keeps 8 column sums in registers: col -= term(row - r - 1); col +=
//    term(row + r), the 8 values of the other image being a window of
//    consecutive shared-memory words.  18 loads and 8 stores for 8 sums.
//  * Stage 2, horizontal: the column sums lie in shared memory as [d][c]; a
//    warp takes one run of K = 8 output columns, lane = disparity (odd
//    pitch, no bank conflict): one full sum of 2r+1 columns, then s -=
//    col(x - r); s += col(x + r + 1).  (2r+1 + 2(K-1)) / K loads a value,
//    one store into the [x][d] tile of window sums (pitch 33).
//  * Stage 3: lanes run along x again: a lane takes V consecutive columns of
//    one disparity, a warp 32 columns of V disparities, which are 32
//    different banks of the [x][d] tile; epilogue; one store of V floats a
//    lane, whole 128-byte lines a warp, d-major [D, H, W] as the callers
//    read it.  V = 4 where W % 4 == 0 (every row of the volume then starts
//    on a 16-byte boundary), 2 where W % 2 == 0, else 1.  SAD's border
//    triangle: the lane that writes d == limit leaves the value in shared
//    memory, and a step later the four threads of that column write it to
//    the d > limit entries (one thread a column looping over them alone took
//    7 us a row at Teddy: 0.12 ms a call).
//  * The three stages of a row touch different buffers (column sums and
//    window sums are double-buffered), so a step runs stage 3 of row s - 2,
//    stage 1 of row s and stage 2 of row s - 1 between two barriers: one
//    barrier a row of sw x 32 values.
//  About 9 (9x9) to 11 (21x21) shared-memory accesses a value for any r, no
//  division by a run-time number anywhere (thread indices come from the 2-D
//  block), address arithmetic hoisted out of the row loop.
//  * Occupancy (pick_tiling; measured, see there): strips of 64 columns for
//    r <= 4, 96 up to r = 12, else 128, of equal width; runs of 8 rows up to
//    a 25-row window.  Teddy/D=60, 9x9: 9 strips x 47 runs x 2 chunks = 846
//    blocks of 256 threads, 44 KB of shared memory and 56-64 registers a
//    thread: four blocks an SM, the stores of one under the arithmetic of
//    the others.  Teddy/D=200, 21x21: 6 x 47 x 7 blocks of 384 threads, 76
//    KB, two an SM.  Longer runs would amortise the warm-up (2r+1 rows of
//    stage-1 loads a run) but their bands cost blocks an SM and the grid gets
//    coarse for 132 SMs: 16 and 32 rows measured slower or equal.
//  * What bounds it now (clock64 around the stages of one block, 9x9 at
//    720x1280/D=128): stage 3 29 % (stalled stores: the card takes ~1.9 TB/s
//    while the row loop runs), stage 2 21 %, stage 1 16 %, band load and
//    warm-up 18 %; for NCC stage 3 is 50 % (two IEEE divisions and a root a
//    value).  0.038 ms against a bound of 0.012 at Teddy/D=60, 0.28 against
//    0.14 at 720x1280/D=128; NCC 0.18 against 0.040 and 0.65 against 0.14.
//
// Exactness: for u8 inputs (grey or colour) every term is an integer and
// every partial sum is a sum over a subset of one window (a leaving term is
// subtracted before the entering one is added), so it stays below 2^24
// (SAD: 255 (2r+1)^2, exact for any r the kernel takes; NCC: 128^2 (2r+1)^2
// for win_size <= 15) and sliding is exact: the sums equal the plain version's (float64,
// rounded once) and JAX's, bit for bit.  Above win_size 15 the column sums
// are still exact (128^2 (2r+1) < 2^24) and only the horizontal sums round.
// For non-integer inputs a sliding sum carries its rounding along the walk:
// the walks restart from full sums every run of at most MAX_RR = 24 rows and
// every K = 8 columns, so a sum sees at most 2 MAX_RR + 2r + 2K roundings of
// half an ulp of the largest partial sum (< 1e-5 relative to the sum of the
// terms' magnitudes).  The epilogue uses IEEE operations in the plain
// version's order (no fast-math; __f*_rn keeps nvcc from contracting them),
// so for exact sums the NCC volume is bit-exact too.
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int DS = 8;         // disparities a stage-1 thread carries
constexpr int G = 4;          // groups of DS disparities: blockDim.y
constexpr int DC = DS * G;    // disparities per block: the lanes of stage 2
constexpr int K = 8;          // output columns per horizontal run
constexpr int MAX_CW = 128;   // widest strip of column sums: blockDim.x
constexpr int RP = DC + 1;    // pitch of the window sums' [x][d] tile: odd, no bank conflict
constexpr int MAX_RR = 24;    // longest run of rows pick_tiling makes (at MAX_RADIUS)
constexpr int SUMS_RR = 8;    // the sums kernel's run of rows
constexpr int MAX_RADIUS = 32;
constexpr int MAX_RADIUS_RGBF = 15;   // float32 colour: three planes of bands

// How a pixel is staged and a term formed: a grey float (SAD or NCC), a
// packed u8 colour word, or three float32 colour planes (SAD's colour mode).
enum Mode { GREY = 0, RGB8 = 1, RGBF = 2 };
__host__ __device__ constexpr int planes_of(int mode) { return mode == RGBF ? 3 : 1; }

struct Tiling {
  int cw;   // columns of column sums a block holds (blockDim.x), 64, 96 or 128
  int sw;   // output columns a strip advances by, <= cw - 2r, a multiple of 4
  int rr;   // output rows per block
};

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The strip: 64 columns while the 2r halo columns are at most an eighth of
// it (r <= 4), 96 up to r = 12, else 128, or cw_fixed if not 0; then strips
// of equal width.  Narrow strips make small blocks, of which an SM holds
// several: the stores of one overlap the arithmetic of the others.  Measured
// (device time, ms): 9x9, 64 / 96 / 128 columns: 0.039 / 0.042 / 0.043 at
// 375x450/D=60, 0.281 / 0.280 / 0.304 at 720x1280/D=128; 21x21 NCC: 0.210 /
// 0.181 / 0.208 at 375x450/D=200, 0.773 / 0.646 / 0.702 at 720x1280/D=128.
Tiling pick_tiling(int h, int w, int r, int cw_fixed) {
  Tiling t{};
  t.cw = cw_fixed ? cw_fixed : r <= 4 ? 64 : r <= 12 ? 96 : MAX_CW;
  if (((t.cw - 2 * r) & ~3) < 4) t.cw = MAX_CW;   // 2r <= 64 leaves 64 columns there
  const int strips = ceil_div(w, (t.cw - 2 * r) & ~3);
  t.sw = (ceil_div(w, strips) + 3) & ~3;
  // rows per run: 8 up to a 25-row window, 16 up to 49 rows, then 24, so
  // that the 2r+1-row warm-up stays within ~3 runs' worth of loads.  Measured
  // at r = 4 and 10: longer runs lose more to the blocks an SM then holds
  // (their bands' shared memory) and to the coarser grid than they save.
  t.rr = std::min(8 * ceil_div(2 * r + 1, 25), MAX_RR);
  if (t.rr > h) t.rr = h;
  return t;
}

// The images are uint8 (u8 != 0) or float32.
__device__ __forceinline__ float pixel(const void* __restrict__ img, int u8, size_t at) {
  return u8 ? (float)((const unsigned char*)img)[at] : ((const float*)img)[at];
}

// img(y, x): clamped into the image (SAD: replicate padding), or centred at
// 128 and 0 outside it (NCC: zero padding of the centred image).
template <bool NCC>
__device__ __forceinline__ float read(const void* __restrict__ img, int u8, int h, int w,
                                      int y, int x) {
  if (NCC)
    return (y >= 0 && y < h && x >= 0 && x < w)
               ? __fsub_rn(pixel(img, u8, (size_t)y * w + x), 128.0f) : 0.0f;
  return pixel(img, u8, (size_t)min(max(y, 0), h - 1) * w + min(max(x, 0), w - 1));
}

// A staged pixel: one float (GREY; RGB8, whose bits are the packed word) or
// three (RGBF, read from planes `pstride` floats apart).
template <int MODE>
struct Pix {
  float c[planes_of(MODE)];
};

template <int MODE>
__device__ __forceinline__ Pix<MODE> load_pix(const float* p, int pstride) {
  Pix<MODE> v;
#pragma unroll
  for (int k = 0; k < planes_of(MODE); ++k) v.c[k] = p[k * pstride];
  return v;
}

// Stage pixel (y, x) of img at dst (planes pstride floats apart): GREY reads
// as read<NCC> does; the colour modes (SAD only) clamp into the [h, w, 3]
// image.
template <bool NCC, int MODE>
__device__ __forceinline__ void stage(float* dst, int pstride, const void* __restrict__ img,
                                      int u8, int h, int w, int y, int x) {
  if (MODE == GREY) {
    *dst = read<NCC>(img, u8, h, w, y, x);
    return;
  }
  const size_t at = 3 * ((size_t)min(max(y, 0), h - 1) * w + min(max(x, 0), w - 1));
  if (MODE == RGB8) {
    const unsigned char* p = (const unsigned char*)img + at;
    *dst = __uint_as_float((unsigned)p[0] | (unsigned)p[1] << 8 | (unsigned)p[2] << 16);
  } else {
    const float* p = (const float*)img + at;
#pragma unroll
    for (int k = 0; k < 3; ++k) dst[k * pstride] = p[k];
  }
}

// The term of a pixel pair: NCC's product, SAD's |a - b|, or the colour
// modes' min_c |a_c - b_c| (RGB8: the byte-wise |a - b| of the packed words,
// whose fourth byte is 0, then the least of its three low bytes).
template <bool NCC, int MODE>
__device__ __forceinline__ float term(const Pix<MODE>& a, const Pix<MODE>& b) {
  if (NCC) return __fmul_rn(a.c[0], b.c[0]);
  if (MODE == GREY) return fabsf(__fsub_rn(a.c[0], b.c[0]));
  if (MODE == RGB8) {
    const unsigned d = __vabsdiffu4(__float_as_uint(a.c[0]), __float_as_uint(b.c[0]));
    return (float)(__vminu4(__vminu4(d, d >> 8), d >> 16) & 0xffu);
  }
  float t = fabsf(__fsub_rn(a.c[0], b.c[0]));
#pragma unroll
  for (int k = 1; k < planes_of(MODE); ++k) t = fminf(t, fabsf(__fsub_rn(a.c[k], b.c[k])));
  return t;
}

// max(sum2 - (sum * sum) / n, 0): the variance term of one window
__device__ __forceinline__ float variance(float s, float s2, float n) {
  return fmaxf(__fsub_rn(s2, __fdiv_rn(__fmul_rn(s, s), n)), 0.0f);
}

__device__ __forceinline__ float ncc_value(float sum_lr, float sl, float var_l, float sr,
                                           float var_r, float n, float eps) {
  const float num = __fsub_rn(sum_lr, __fdiv_rn(__fmul_rn(sl, sr), n));
  if (var_l < 0.5f || var_r < 0.5f) return -2.0f;
  return __fdiv_rn(num, __fsqrt_rn(fmaxf(__fmul_rn(var_l, var_r), eps)));
}

// V consecutive floats at a V-float boundary
template <int V>
__device__ __forceinline__ void store_vec(float* o, const float (&v)[V]) {
  if (V == 4)
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
  else if (V == 2)
    *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
  else
    o[0] = v[0];
}

size_t volume_smem_bytes(const Tiling& t, int r, int mode) {
  const size_t band = t.rr + 2 * r;
  return sizeof(float) * (band * (t.cw + t.cw + DC - 1) * planes_of(mode) +
                          2 * DC * (t.cw + 1) + 2 * t.cw * RP + 2 * t.cw);
}

// DIR = -1: the other image is read at column c - d (left view, NCC);
// DIR = +1: at c + d (SAD's right view).  V: floats per store, 4 or 2 where
// W is a multiple of it (every row of the volume then starts on such a
// boundary), else 1.  MODE: how pixels are staged and terms formed (GREY for
// NCC).  sums: the planes of ncc_sums_kernel (NCC only).
template <bool NCC, int DIR, int V, int MODE>
__global__ void __launch_bounds__(MAX_CW * G, NCC ? 1 : 2)
window_kernel(const void* __restrict__ base, const void* __restrict__ other, int u8,
              const float* __restrict__ sums, float* __restrict__ out, int h, int w,
              int d_range, int d_off, int r, int sw, int rr, int mean, float eps,
              float sentinel) {
  extern __shared__ float smem[];
  const int cw = blockDim.x, bw = cw + DC - 1, cp = cw + 1;
  const int cl = threadIdx.x, g = threadIdx.y;
  const int j0 = blockIdx.x * sw, i0 = blockIdx.y * rr, d0 = blockIdx.z * DC;
  const int ncol = min(sw, w - j0), rows = min(rr, h - i0), d1 = min(d0 + DC, d_range);
  const size_t plane = (size_t)h * w;
  const int j = j0 + cl;

  if (NCC) {
    if (d_off + d0 > j0 + ncol - 1 - r) {   // no column of the strip is valid from d0 on
      if (cl < ncol)
        for (int row = 0; row < rows; ++row)
          for (int d = d0 + g; d < d1; d += G)
            out[d * plane + (size_t)(i0 + row) * w + j] = sentinel;
      return;
    }
  } else if (d0 > (DIR < 0 ? j0 + ncol - 1 : w - 1 - j0)) {
    return;   // all border triangle: written by the blocks that hold d == limit
  }

  const int band = rows + 2 * r, np = planes_of(MODE);
  const int pa = band * cw, pb = band * bw;   // plane strides (RGBF)
  float* a_s = smem;               // base image, [np][band][cw]: rows i0 - r.., columns j0 - r..
  float* b_s = a_s + np * pa;      // other image, [np][band][bw]
  float* col_s = b_s + np * pb;        // column sums, two buffers of [DC][cp]
  float* res_s = col_s + 2 * DC * cp;  // window sums, two buffers of [cw][RP]
  float* diag_s = res_s + 2 * cw * RP; // SAD: the values at d == limit, two buffers of [cw]
  // b_s column m holds the other image's column xb0 + m; thread (cl, d0 + dl)
  // reads column j0 - r + cl + DIR * (d_off + d0 + dl)
  const int xb0 = j0 - r + (DIR < 0 ? -(d_off + d0 + DC - 1) : d_off + d0);
  for (int br = g; br < band; br += G) {
    const int y = i0 - r + br;
    stage<NCC, MODE>(a_s + br * cw + cl, pa, base, u8, h, w, y, j0 - r + cl);
    stage<NCC, MODE>(b_s + br * bw + cl, pb, other, u8, h, w, y, xb0 + cl);
    if (cl < DC - 1)
      stage<NCC, MODE>(b_s + br * bw + cw + cl, pb, other, u8, h, w, y, xb0 + cw + cl);
  }
  __syncthreads();

  // stage 1 warm-up: the column sums of output row i0
  const float* ap = a_s + cl;
  const float* bp = b_s + cl + (DIR < 0 ? DC - 1 - g * DS : g * DS);
  float col[DS];
#pragma unroll
  for (int k = 0; k < DS; ++k) col[k] = 0.0f;
  for (int br = 0; br <= 2 * r; ++br) {
    const Pix<MODE> a = load_pix<MODE>(ap + br * cw, pa);
    const float* b = bp + br * bw;
#pragma unroll
    for (int k = 0; k < DS; ++k)
      col[k] = __fadd_rn(col[k], term<NCC, MODE>(a, load_pix<MODE>(b + DIR * k, pb)));
  }

  const int tid = g * cw + cl, lane = tid & 31, run_step = (cw * G >> 5) * K;
  const float n = (float)((2 * r + 1) * (2 * r + 1));
  const int limit = DIR < 0 ? j : w - 1 - j;   // SAD: the last disparity with a window of its own
  // SAD: this block holds the entry d == limit of column j and that column
  // has a border triangle d > limit to fill with it
  const bool fills = !NCC && cl < ncol && limit >= d0 && limit < d1 && limit < d_range - 1;
  // stage 3's lanes: V consecutive columns from x, the disparities d0 + dl0 +
  // it * G * V; column jx + t has windows of its own up to d == lim0 - DIR * t
  const int x = (cl & ~31) + lane / V * V, jx = j0 + x, dl0 = g * V + lane % V;
  const int lim0 = DIR < 0 ? jx : w - 1 - jx, lim_all = DIR < 0 ? lim0 : lim0 - (V - 1);
  const size_t o_step = (size_t)(G * V) * plane;
  // One barrier a step; in step s the block runs stage 3 of row s - 2, stage 1
  // of row s, stage 2 of row s - 1 and SAD's border fill of row s - 3, which
  // touch different buffers.
  for (int step = 0; step < rows + (NCC ? 2 : 3); ++step) {
    float* col_w = col_s + (step & 1) * DC * cp;
    const float* col_r = col_s + (~step & 1) * DC * cp;
    float* res_w = res_s + (~step & 1) * cw * RP;
    const float* res_r = res_s + (step & 1) * cw * RP;

    // stage 3, row step - 2: epilogue and stores.  A lane takes V consecutive
    // columns of one disparity, a warp 32 columns of V disparities: the lanes
    // read 32 different banks of the [x][d] tile and store whole lines.
    if (step >= 2 && step < rows + 2 && x < ncol) {
      const size_t pix = (size_t)(i0 + step - 2) * w + jx;
      float2 lv[V];                                                 // (sum_l, var_l)
      const float2* rv = (const float2*)(sums + 6 * plane) + pix;   // (sum_r, var_r)
      if (NCC) {
#pragma unroll
        for (int t = 0; t < V; ++t) lv[t] = ((const float2*)(sums + 4 * plane))[pix + t];
      }
      const float* rp = res_r + x * RP + dl0;
      float* o = out + (d0 + dl0) * plane + pix;
      float* diag_w = diag_s + (step & 1) * cw + x;
#pragma unroll
      for (int it = 0; it < DS / V; ++it, o += o_step) {
        const int d = d0 + dl0 + it * (G * V);
        if (d >= d1) break;
        float v[V];
#pragma unroll
        for (int t = 0; t < V; ++t) v[t] = rp[it * (G * V) + t * RP];
        if (NCC) {
#pragma unroll
          for (int t = 0; t < V; ++t) {
            const int gd = d_off + d;   // the global disparity of entry d
            if (jx + t - r - gd >= 0) {
              const float2 r2 = rv[t - gd];
              v[t] = ncc_value(v[t], lv[t].x, lv[t].y, r2.x, r2.y, n, eps);
            } else {
              v[t] = sentinel;
            }
          }
          store_vec<V>(o, v);
        } else {
          if (mean) {
#pragma unroll
            for (int t = 0; t < V; ++t) v[t] = __fdiv_rn(v[t], n);
          }
          if (d <= lim_all) {
            store_vec<V>(o, v);
          } else {
            // column jx + t has windows of its own up to d == lim0 - DIR * t
#pragma unroll
            for (int t = 0; t < V; ++t) {
              if (d <= lim0 - DIR * t) o[t] = v[t];
              if (d == lim0 - DIR * t) diag_w[t] = v[t];
            }
          }
          if (d == lim_all) diag_w[DIR < 0 ? 0 : V - 1] = v[DIR < 0 ? 0 : V - 1];
        }
      }
    }
    // SAD, row step - 3: the border triangle takes the last window's value;
    // the four threads of a column share its disparities
    if (step >= 3 && fills) {
      const float v = diag_s[(~step & 1) * cw + cl];
      const size_t pix = (size_t)(i0 + step - 3) * w + j;
      for (int dd = limit + 1 + g; dd < d_range; dd += G) out[dd * plane + pix] = v;
    }

    // stage 1, row step: slide down (row - 1 - r leaves, row + r enters)
    if (step < rows) {
      if (step > 0) {
        const Pix<MODE> ao = load_pix<MODE>(ap + (step - 1) * cw, pa);
        const Pix<MODE> ai = load_pix<MODE>(ap + (step + 2 * r) * cw, pa);
        const float* bo = bp + (step - 1) * bw;
        const float* bi = bp + (step + 2 * r) * bw;
#pragma unroll
        for (int k = 0; k < DS; ++k)
          col[k] = __fadd_rn(
              __fsub_rn(col[k], term<NCC, MODE>(ao, load_pix<MODE>(bo + DIR * k, pb))),
              term<NCC, MODE>(ai, load_pix<MODE>(bi + DIR * k, pb)));
      }
#pragma unroll
      for (int k = 0; k < DS; ++k) col_w[(g * DS + k) * cp + cl] = col[k];
    }

    // stage 2, row step - 1: lane = disparity, a warp per run of K output columns
    if (step >= 1 && step <= rows) {
      for (int x0 = (tid >> 5) * K; x0 < ncol; x0 += run_step) {
        const float* __restrict__ c = col_r + lane * cp + x0;
        float* __restrict__ o = res_w + x0 * RP + lane;
        float s = 0.0f;
#pragma unroll 4
        for (int m = 0; m <= 2 * r; ++m) s = __fadd_rn(s, c[m]);
        o[0] = s;
        const int kend = min(K, ncol - x0);
#pragma unroll
        for (int t = 1; t < K; ++t) {
          if (t < kend) {
            s = __fadd_rn(__fsub_rn(s, c[t - 1]), c[t + 2 * r]);
            o[t * RP] = s;
          }
        }
      }
    }
    __syncthreads();
  }
}

// The four window sums and two variance terms of the centred images:
// planes[0..3] = sum_l, sum_l2, sum_r, sum_r2, each [h, w]; then, as the
// volume kernel reads them, the pairs (sum_l, var_l) [h, w, 2] and (sum_r,
// var_r) [h, w, 2].
// blockDim = (cw, 2): thread (c, image) slides the column sums of x and x^2
// down a run of rows; then thread (x, image) adds 2r+1 of each (0.7 M
// values in all at Teddy: the kernel is a launch and a few microseconds).
__global__ void __launch_bounds__(MAX_CW * 2)
ncc_sums_kernel(const void* __restrict__ left, const void* __restrict__ right, int u8,
                float* __restrict__ planes, int h, int w, int r, int sw, int rr) {
  extern __shared__ float smem[];
  const int cw = blockDim.x, cl = threadIdx.x, p = threadIdx.y;
  const int j0 = blockIdx.x * sw, i0 = blockIdx.y * rr;
  const int ncol = min(sw, w - j0), rows = min(rr, h - i0), band = rows + 2 * r;
  const size_t plane = (size_t)h * w;
  float* v_s = smem + p * band * cw;              // centred image p, [band][cw]
  float* c_s = smem + 2 * band * cw + p * 2 * cw;  // column sums of x, x^2: [2][cw]
  const void* img = p ? right : left;
  for (int br = 0; br < band; ++br)
    v_s[br * cw + cl] = read<true>(img, u8, h, w, i0 - r + br, j0 - r + cl);
  // a thread reads only the column it wrote until the sums are exchanged
  float c1 = 0.0f, c2 = 0.0f;
  for (int br = 0; br <= 2 * r; ++br) {
    const float v = v_s[br * cw + cl];
    c1 = __fadd_rn(c1, v);
    c2 = __fadd_rn(c2, __fmul_rn(v, v));
  }
  const float n = (float)((2 * r + 1) * (2 * r + 1));
  for (int row = 0; row < rows; ++row) {
    if (row > 0) {
      const float vo = v_s[(row - 1) * cw + cl], vi = v_s[(row + 2 * r) * cw + cl];
      c1 = __fadd_rn(__fsub_rn(c1, vo), vi);
      c2 = __fadd_rn(__fsub_rn(c2, __fmul_rn(vo, vo)), __fmul_rn(vi, vi));
    }
    c_s[cl] = c1;
    c_s[cw + cl] = c2;
    __syncthreads();
    if (cl < ncol) {
      float s1 = 0.0f, s2 = 0.0f;
      for (int m = 0; m <= 2 * r; ++m) {
        s1 = __fadd_rn(s1, c_s[cl + m]);
        s2 = __fadd_rn(s2, c_s[cw + cl + m]);
      }
      const size_t pix = (size_t)(i0 + row) * w + j0 + cl;
      planes[(2 * p) * plane + pix] = s1;
      planes[(2 * p + 1) * plane + pix] = s2;
      ((float2*)(planes + (4 + 2 * p) * plane))[pix] = make_float2(s1, variance(s1, s2, n));
    }
    __syncthreads();
  }
}

template <bool NCC, int DIR, int V, int MODE>
cudaError_t launch_volume_v(const void* base, const void* other, int u8, const float* sums,
                            float* out, int h, int w, int d_range, int d_off, int r, int mean,
                            float eps, float sentinel, cudaStream_t s) {
  const Tiling t = pick_tiling(h, w, r, 0);
  const size_t smem = volume_smem_bytes(t, r, MODE);
  // The attribute belongs to the current device, so it is set on every launch
  // that needs it and never remembered.
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        window_kernel<NCC, DIR, V, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(ceil_div(w, t.sw), ceil_div(h, t.rr), ceil_div(d_range, DC));
  window_kernel<NCC, DIR, V, MODE><<<grid, dim3(t.cw, G), smem, s>>>(
      base, other, u8, sums, out, h, w, d_range, d_off, r, t.sw, t.rr, mean, eps, sentinel);
  return cudaGetLastError();
}

// The widest store the rows' alignment allows.  NCC stops at 2: with four
// epilogues a lane it ran a third slower (720x1280/D=128, 0.98 against 0.69-0.73 ms).
template <bool NCC, int DIR, int MODE>
cudaError_t launch_volume(const void* base, const void* other, int u8, const float* sums,
                          float* out, int h, int w, int d_range, int d_off, int r, int mean,
                          float eps, float sentinel, cudaStream_t s) {
  if constexpr (!NCC) {
    if (w % 4 == 0)
      return launch_volume_v<NCC, DIR, 4, MODE>(base, other, u8, sums, out, h, w, d_range,
                                                d_off, r, mean, eps, sentinel, s);
  }
  if (w % 2 == 0)
    return launch_volume_v<NCC, DIR, 2, MODE>(base, other, u8, sums, out, h, w, d_range, d_off,
                                              r, mean, eps, sentinel, s);
  return launch_volume_v<NCC, DIR, 1, MODE>(base, other, u8, sums, out, h, w, d_range, d_off, r,
                                            mean, eps, sentinel, s);
}

// SAD, one view and mode
template <int DIR, int MODE>
cudaError_t launch_sad(const void* base, const void* other, int u8, float* out, int h, int w,
                       int d_range, int r, int mean, cudaStream_t s) {
  return launch_volume<false, DIR, MODE>(base, other, u8, nullptr, out, h, w, d_range, 0, r,
                                         mean, 0.0f, 0.0f, s);
}

cudaError_t launch_sums(const void* left, const void* right, int u8, float* planes, int h,
                        int w, int r, cudaStream_t s) {
  Tiling t = pick_tiling(h, w, r, MAX_CW);
  t.rr = std::min(SUMS_RR, h);
  const size_t smem = sizeof(float) * (2 * (t.rr + 2 * r) * t.cw + 4 * t.cw);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ncc_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(ceil_div(w, t.sw), ceil_div(h, t.rr));
  ncc_sums_kernel<<<grid, dim3(t.cw, 2), smem, s>>>(left, right, u8, planes, h, w, r, t.sw,
                                                    t.rr);
  return cudaGetLastError();
}

bool bad_shape(int h, int w, int d_range, int radius) {
  return h < 1 || w < 1 || d_range < 1 || radius < 1 || radius > MAX_RADIUS;
}

}  // namespace

// Launch on `stream`.  left, right: [h, w] (channels = 1) or [h, w, 3]
// (channels = 3: the minimum-channel colour term), both uint8 (u8 != 0) or
// both float32; out: float32 [d_range, h, w]; all contiguous on the current
// device.  radius = winsize + 1, 1 <= radius <= 32 (15 for float32 colour).
// right_view, mean: 0 or 1.  Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int sad_volume_f32(const void* left, const void* right, int u8, void* out, int h,
                              int w, int d_range, int radius, int right_view, int mean,
                              int channels, void* stream) {
  if (bad_shape(h, w, d_range, radius) || (channels != 1 && channels != 3) ||
      (channels == 3 && !u8 && radius > MAX_RADIUS_RGBF))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* o = (float*)out;
  const int mode = channels == 1 ? GREY : u8 ? RGB8 : RGBF;
  // the right view swaps the images' roles: base = right, other = left
  const void* base = right_view ? right : left;
  const void* other = right_view ? left : right;
  if (right_view) {
    if (mode == GREY) return (int)launch_sad<1, GREY>(base, other, u8, o, h, w, d_range, radius,
                                                      mean, s);
    if (mode == RGB8) return (int)launch_sad<1, RGB8>(base, other, u8, o, h, w, d_range, radius,
                                                      mean, s);
    return (int)launch_sad<1, RGBF>(base, other, u8, o, h, w, d_range, radius, mean, s);
  }
  if (mode == GREY) return (int)launch_sad<-1, GREY>(base, other, u8, o, h, w, d_range, radius,
                                                     mean, s);
  if (mode == RGB8) return (int)launch_sad<-1, RGB8>(base, other, u8, o, h, w, d_range, radius,
                                                     mean, s);
  return (int)launch_sad<-1, RGBF>(base, other, u8, o, h, w, d_range, radius, mean, s);
}

// Launch on `stream`.  left, right: the [h, w] images (uncentred), both
// uint8 (u8 != 0) or both float32; planes: float32 [8, h, w], written:
// sum_l, sum_l2, sum_r, sum_r2 (the zero-padded (2r+1)^2 window sums of the
// 128-centred images and of their squares), then the pairs (sum_l, var_l)
// and (sum_r, var_r), each [h, w, 2].  radius = win_size, 1 <= radius <= 32.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int ncc_window_sums_f32(const void* left, const void* right, int u8, void* planes,
                                   int h, int w, int radius, void* stream) {
  if (bad_shape(h, w, 1, radius)) return (int)cudaErrorInvalidValue;
  return (int)launch_sums(left, right, u8, (float*)planes, h, w, radius,
                          (cudaStream_t)stream);
}

// Launch on `stream`: the sums kernel into `planes` (scratch, float32
// [8, h, w], as ncc_window_sums_f32 writes it), then the volume kernel.
// left, right: the [h, w] images (uncentred), both uint8 (u8 != 0) or both
// float32; out: float32 [d_range, h, w], entry d of global disparity
// d_offset + d (the whole range: 0); all contiguous on the current device.
// radius = win_size, 1 <= radius <= 32; d_offset >= 0.  Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int ncc_volume_f32(const void* left, const void* right, int u8, void* planes,
                              void* out, int h, int w, int d_range, int d_offset, int radius,
                              float eps, float sentinel, void* stream) {
  if (bad_shape(h, w, d_range, radius) || d_offset < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = launch_sums(left, right, u8, (float*)planes, h, w, radius, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_volume<true, -1, GREY>(left, right, u8, (const float*)planes, (float*)out,
                                            h, w, d_range, d_offset, radius, 0, eps, sentinel,
                                            s);
}
