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
// cross_arms_i32: one thread a pixel walks its four arms, at most
// max_length steps each, reading the image through the cache, and stops at
// the first step that fails.  The arm is the number of leading accepted
// offsets: offset o is accepted iff its global position is in the image
// and the largest channel difference to the centre is <= tao(o) (tao1 for
// o <= sec_length, else tao2), in float32; a failed first step (not the
// border) gives 1 where the pixel is >= 2 from the border.  Vertical arms
// of a row band read global rows (row_offset, global_rows) for both rules
// and the band's own rows, clamped into the band, for the values, as the
// plain version's edge-clamped shifts.  Bound: bytes, the image in and the
// four int32 maps out (~2.4 us at Teddy); the walk is ~4 x 34 cached loads
// a pixel at most, latency the real limit.
//
// rect_mean_f32: the plain version's float64 summed-area table S of every
// d-slice (S[i][j] = sum x[:i, :j], a zero row and column in front), the
// rectangle sum of the four corner picks in its order, ((S[i1+1][j1+1] -
// S[i0][j1+1]) - S[i1+1][j0]) + S[i0][j0], rounded to float32 once and
// divided by the float32 count.  Three kernels a chunk of slices on a
// float64 scratch of the chunk (the wrapper sizes it): a warp a row scans
// along it (float32 in, float64 out), a thread a column sums down the rows
// in place, a thread an output picks its corners.  The AD-Census costs sum
// exactly in float64 (`_sat`'s note), so the result is the plain version's
// whatever the order of the sums.  For other float32 volumes the table's
// entries round: the plain version sums along the rows, then down each
// column one row after another, and so does this, so that two corners of a
// column share the rounding of the rows above both, which cancels in their
// difference as it does in the plain version (a table summed in the other
// order, or rounded once an entry, strays from it by up to 2 float32 ulps
// of a mean at 720p).  Bound: bytes, the volume in and out once (0.024 ms at
// Teddy, 0.28 ms at 720p, a view); this design moves ~40 bytes a
// value (the table written, read and written again, four corners read),
// and the corner picks, scattered float64 reads, take half its time.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// The largest of |a_c - b_c| over the channels, NaN if any is NaN (as
// torch.amax).
template <typename T, int C>
__device__ __forceinline__ float channel_diff(const T* __restrict__ img, long long a,
                                              long long b) {
  float m = fabsf((float)__ldg(img + a * C) - (float)__ldg(img + b * C));
#pragma unroll
  for (int c = 1; c < C; ++c) {
    const float v = fabsf((float)__ldg(img + a * C + c) - (float)__ldg(img + b * C + c));
    m = (isnan(m) || v <= m) ? m : v;
  }
  return m;
}

// One arm of the pixel at local (i, j): along columns (vertical == false,
// positions j in [0, w)) or along rows (vertical, global position gi in
// [0, global_rows), local rows clamped into [0, h)).
template <typename T, int C>
__device__ int arm(const T* __restrict__ img, int h, int w, int i, int j, int gi,
                   int global_rows, bool vertical, int sign, int max_length, int sec_length,
                   float tao1, float tao2) {
  const int pos = vertical ? gi : j;
  const int gsize = vertical ? global_rows : w;
  const long long centre = (long long)i * w + j;
  int leading = 0;
  bool fail1 = false;
  for (int o = 1; o <= max_length; ++o) {
    const int t = pos + sign * o;
    const bool inb = t >= 0 && t <= gsize - 1;
    long long q;
    if (vertical) {
      const int r = min(max(i + sign * o, 0), h - 1);
      q = (long long)r * w + j;
    } else {
      q = (long long)i * w + min(max(j + sign * o, 0), w - 1);
    }
    const float diff = channel_diff<T, C>(img, q, centre);
    const float tao = o <= sec_length ? tao1 : tao2;
    if (o == 1) fail1 = inb && diff > tao;
    if (!(inb && diff <= tao)) break;
    ++leading;
  }
  const bool border_ok = sign < 0 ? pos >= 2 : pos <= gsize - 3;
  return (leading == 0 && fail1 && border_ok) ? 1 : leading;
}

template <typename T, int C>
__global__ void __launch_bounds__(256)
cross_arms_kernel(const T* __restrict__ img, int h, int w, int row_offset, int global_rows,
                  int max_length, int sec_length, float tao1, float tao2,
                  int* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= h || j >= w) return;
  const long long plane = (long long)h * w;
  const long long p = (long long)i * w + j;
  const int gi = i + row_offset;
  // left, right, up, down
  out[p] = arm<T, C>(img, h, w, i, j, gi, global_rows, false, -1, max_length, sec_length,
                     tao1, tao2);
  out[plane + p] = arm<T, C>(img, h, w, i, j, gi, global_rows, false, +1, max_length,
                             sec_length, tao1, tao2);
  out[2 * plane + p] = arm<T, C>(img, h, w, i, j, gi, global_rows, true, -1, max_length,
                                 sec_length, tao1, tao2);
  out[3 * plane + p] = arm<T, C>(img, h, w, i, j, gi, global_rows, true, +1, max_length,
                                 sec_length, tao1, tao2);
}

template <typename T, int C>
cudaError_t launch_arms(const void* img, int h, int w, int row_offset, int global_rows,
                        int max_length, int sec_length, float tao1, float tao2, int* out,
                        cudaStream_t s) {
  const dim3 block(32, 8);
  const dim3 grid((w + 31) / 32, (h + 7) / 8);
  cross_arms_kernel<T, C><<<grid, block, 0, s>>>((const T*)img, h, w, row_offset,
                                                 global_rows, max_length, sec_length, tao1,
                                                 tao2, out);
  return cudaGetLastError();
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

}  // namespace

// The four cross arms of an image, on `stream`: img [h, w] (channels 1) or
// [h, w, 3] (channels 3), uint8 (u8 != 0) or float32, contiguous; out int32
// [4, h, w] (left, right, up, down), contiguous, on the current device.
// Row i of the image is global row row_offset + i of an image of
// global_rows rows.  Returns a cudaError_t code.
extern "C" int cross_arms_i32(const void* img, int channels, int u8, int h, int w,
                              int row_offset, int global_rows, int max_length, int sec_length,
                              float tao1, float tao2, void* out, void* stream) {
  if (h < 1 || w < 1 || max_length < 1 || (channels != 1 && channels != 3) ||
      global_rows < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int* o = (int*)out;
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
