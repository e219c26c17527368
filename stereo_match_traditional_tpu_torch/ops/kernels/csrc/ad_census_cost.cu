// Fused AD + Census cost volume, one view, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package computes this volume with XLA
// ops (stereo_match_traditional_tpu/ops/volume.py:554 ad_census_volume, with
// census_transform :464 and census_volume :522, whose Hamming distance is
// lax.population_count).  torch has no popcount, so the plain version
// (ops/volume.py of the port) needs a dozen SWAR passes over an int64
// [D, H, W] volume; here each Hamming distance is one __popcll.
//
//   cost(d, y, x) = (1 - exp(-AD / sigma_c)) + (1 - exp(-Ham / sigma_s))
//   left view:  AD = |L(y, x) - R(y, max(x - d, 0))|,     Ham of cL(y, x), cR(y, max(x - d, 0))
//   right view: AD = |L(y, min(x + d, W-1)) - R(y, x)|,   Ham of cL(y, min(x + d, W-1)), cR(y, x)
//
// Census signature (AD-Census.h:166-192): for each offset of the
// rows x cols window in row-major order, shift left once and set the low
// bit iff centre > neighbour and the neighbour lies in the image.  At most
// 63 bits, the same value as the port's int64 census_transform and as the
// JAX package's (hi << 32) | lo words.
//
// What bounds it: device memory.  Per output element the kernel reads
// two floats and two int64 signatures, mostly from L1/L2 (neighbouring
// threads read neighbouring columns), and writes one float; at Teddy
// (375x450, D=60) that is a 40 MB volume written once.  Two launches: the
// signatures of both images (one thread per pixel, 63 clamped reads from
// cache), then the volume (one thread per pixel and chunk of DC
// disparities, x fastest so stores coalesce).
//
// Numerics: no fast-math.  expf is CUDA's full-accuracy expf and '/' is
// IEEE division, so the volume differs from the plain version only by
// expf's last-ulp rounding; AD and Hamming are exact integers.  part = 1
// or 2 writes the raw AD or Hamming volume (as float) instead of the cost,
// so both integer parts can be checked exactly against the plain
// ad_volume / census_volume.
#include <cuda_runtime.h>

namespace {

constexpr int BX = 128;  // threads per block along x
constexpr int DC = 8;    // disparities per thread

__global__ void __launch_bounds__(BX)
census_kernel(const float* __restrict__ img0, const float* __restrict__ img1,
              long long* __restrict__ sig, int h, int w, int rr, int rc) {
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= w) return;
  const float* img = blockIdx.z == 0 ? img0 : img1;
  const float c = img[(size_t)y * w + x];
  unsigned long long s = 0;
  for (int r = -rr; r <= rr; ++r) {
    const int yy = y + r;
    const bool row_in = yy >= 0 && yy < h;
    const float* row = img + (size_t)min(max(yy, 0), h - 1) * w;
    for (int q = -rc; q <= rc; ++q) {
      const int xx = x + q;
      const bool in = row_in && xx >= 0 && xx < w;
      const float nb = row[min(max(xx, 0), w - 1)];
      s = (s << 1) | (unsigned long long)(in && c > nb);
    }
  }
  sig[((size_t)blockIdx.z * h + y) * w + x] = (long long)s;
}

template <bool RIGHT_VIEW>
__global__ void __launch_bounds__(BX)
cost_kernel(const float* __restrict__ left, const float* __restrict__ right,
            const long long* __restrict__ sig, float* __restrict__ out, int h,
            int w, int d_range, float sigma_c, float sigma_s, int part) {
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y;
  const int d0 = blockIdx.z * DC;
  if (x >= w) return;
  const size_t row = (size_t)y * w;
  const size_t plane = (size_t)h * w;
  const long long* sig_l = sig;
  const long long* sig_r = sig + plane;
  // the view's own pixel, and the row the match column moves along; the AD
  // part (part 1) has no signatures
  const float base = RIGHT_VIEW ? right[row + x] : left[row + x];
  const long long base_sig = part == 1 ? 0 : RIGHT_VIEW ? sig_r[row + x] : sig_l[row + x];
  const float* other = RIGHT_VIEW ? left + row : right + row;
  const long long* other_sig = RIGHT_VIEW ? sig_l + row : sig_r + row;
#pragma unroll
  for (int j = 0; j < DC; ++j) {
    const int d = d0 + j;
    if (d >= d_range) break;
    const int col = RIGHT_VIEW ? min(x + d, w - 1) : max(x - d, 0);
    const float ad = fabsf(base - other[col]);
    float v;
    if (part == 1) {
      v = ad;
    } else {
      const float ham = (float)__popcll(base_sig ^ other_sig[col]);
      v = part == 2 ? ham : (1.0f - expf(-ad / sigma_c)) + (1.0f - expf(-ham / sigma_s));
    }
    out[(size_t)d * plane + row + x] = v;
  }
}

}  // namespace

// Launch on `stream`.  left, right: float32 [h, w]; sig: int64 scratch
// [2, h, w]; out: float32 [d_range, h, w]; all contiguous on the current
// device.  rows * cols <= 63.  right_view: 0 or 1.  part: 0 cost, 1 AD,
// 2 Hamming; the AD part skips the census launch and leaves sig untouched.
// Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int ad_census_volume_f32(const void* left, const void* right, void* sig,
                                    void* out, int h, int w, int d_range, int rows,
                                    int cols, float sigma_c, float sigma_s,
                                    int right_view, int part, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 block(BX);
  if (part != 1) {
    census_kernel<<<dim3((w + BX - 1) / BX, h, 2), block, 0, s>>>(
        (const float*)left, (const float*)right, (long long*)sig, h, w, rows / 2, cols / 2);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((w + BX - 1) / BX, h, (d_range + DC - 1) / DC);
  if (right_view) {
    cost_kernel<true><<<grid, block, 0, s>>>(
        (const float*)left, (const float*)right, (const long long*)sig, (float*)out,
        h, w, d_range, sigma_c, sigma_s, part);
  } else {
    cost_kernel<false><<<grid, block, 0, s>>>(
        (const float*)left, (const float*)right, (const long long*)sig, (float*)out,
        h, w, d_range, sigma_c, sigma_s, part);
  }
  return (int)cudaGetLastError();
}
