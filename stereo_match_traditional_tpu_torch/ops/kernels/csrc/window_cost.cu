// Windowed SAD and NCC cost volumes, one view per call, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package builds both volumes with XLA
// ops, a shifted stack and two banded MXU matmuls per box sum
// (stereo_match_traditional_tpu/ops/volume.py:152-182 box_sum_valid /
// box_sum_same).  Two entry points:
//
// sad_volume_f32 replaces volume.sad_volume (volume.py:224), both views,
// with `mean`.  With r = winsize + 1,
//   out[d, i, j] = sum_{|a|,|b| <= r} |A(i+a, j+b) - B(i+a, j+b + dir*e)|
//   left view:  A = left,  B = right, dir = -1, e = min(d, j)
//   right view: A = right, B = left,  dir = +1, e = min(d, W-1-j)
// with every read clamped into the image.  That is what border_fill of
// box_sum_valid over the shifted stack of the replicate-padded images
// gives: the padding is the clamp, and for e <= the column's limit the
// shifted padded column never leaves [0, Wp-1].  The main kernel writes
// the entries with d <= limit; a second launch copies out[limit, i, j]
// into the border triangle d > limit.  mean divides by (2r+1)^2 (IEEE).
//
// ncc_volume_f32 replaces volume.ncc_volume (volume.py:296).  It fuses the
// cross sum sum_lr[d, i, j] = sum lf(i+a, j+b) * rf(i+a, j+b-d) of the
// 128-centred images, zero outside the image (box_sum_same), with the
// epilogue on the four 2-D window sums the wrapper computes once:
//   num = sum_lr - (sum_l * sum_r[j-d]) / n
//   var_l = max(sum_l2 - (sum_l * sum_l) / n, 0), var_r likewise at j-d
//   ncc = num / sqrt(max(var_l * var_r, eps)); -2 where var_l or var_r < 0.5
// and the sentinel where j - r - d < 0 (NCC.h:81), which is written without
// computing the window: at D=200 most of the volume is sentinel.
//
// Exactness: for u8 inputs every term is an integer and every partial
// window sum stays below 2^24 (SAD: 255 (2r+1)^2 = 20,655 for 9x9, exact
// for any r <= 127; NCC: 128^2 (2r+1)^2 for win_size r <= 15), so the float
// sums here equal the plain version's (float64, rounded once) and JAX's in
// any order, bit for bit.  Above win_size 15, or for non-integer inputs, the
// sums round and agree within a tolerance.  The epilogue uses IEEE
// operations in the plain version's order (no fast-math; __f*_rn keeps
// nvcc from contracting them), so for exact sums the NCC volume is
// bit-exact too.
//
// Design and what bounds it: a block owns a TH x TW tile of output pixels
// and a chunk of DC disparities.  It loads the base tile with its r-halo
// and the other image's band (halo plus DC-1 shifts) into shared memory
// once, then per disparity forms the TH x (TW+2r) column sums of 2r+1 terms
// and each thread adds 2r+1 of them: ~2(2r+1) shared-memory terms per
// output instead of (2r+1)^2.  Shared-memory loads bound it; device memory
// sees each output written once (40 MB a view at Teddy, D=60).
#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;        // output columns per block: one warp per row
constexpr int TH = 8;         // output rows per block
constexpr int NT = TW * TH;   // threads per block
constexpr int DC = 16;        // disparities per block

size_t smem_bytes(int r) {
  const size_t rows = TH + 2 * r, cols = TW + 2 * r;
  return sizeof(float) * (rows * cols + rows * (cols + DC - 1) + TH * cols);
}

// img(y, x), clamped into the image (SAD: replicate padding) or 0 outside
// it (NCC: zero padding).
template <bool ZERO_OUTSIDE>
__device__ __forceinline__ float read(const float* img, int h, int w, int y, int x) {
  if (ZERO_OUTSIDE) return (y >= 0 && y < h && x >= 0 && x < w) ? img[(size_t)y * w + x] : 0.0f;
  return img[(size_t)min(max(y, 0), h - 1) * w + min(max(x, 0), w - 1)];
}

__device__ __forceinline__ float ncc_value(float sum_lr, float sl, float sl2, float sr,
                                           float sr2, float n, float eps) {
  const float num = __fsub_rn(sum_lr, __fdiv_rn(__fmul_rn(sl, sr), n));
  const float var_l = fmaxf(__fsub_rn(sl2, __fdiv_rn(__fmul_rn(sl, sl), n)), 0.0f);
  const float var_r = fmaxf(__fsub_rn(sr2, __fdiv_rn(__fmul_rn(sr, sr), n)), 0.0f);
  if (var_l < 0.5f || var_r < 0.5f) return -2.0f;
  return __fdiv_rn(num, __fsqrt_rn(fmaxf(__fmul_rn(var_l, var_r), eps)));
}

template <bool NCC>
__global__ void __launch_bounds__(NT)
window_kernel(const float* __restrict__ base, const float* __restrict__ other,
              const float* __restrict__ sum_l, const float* __restrict__ sum_l2,
              const float* __restrict__ sum_r, const float* __restrict__ sum_r2,
              float* __restrict__ out, int h, int w, int d_range, int r, int dir,
              int mean, float eps, float sentinel) {
  extern __shared__ float smem[];
  const int side = 2 * r + 1, rows = TH + 2 * r, cols = TW + 2 * r, bcols = cols + DC - 1;
  float* a_s = smem;                // base tile with halo, [rows][cols]
  float* b_s = a_s + rows * cols;   // band of the other image, [rows][bcols]
  float* c_s = b_s + rows * bcols;  // column sums, [TH][cols]
  const int tx = threadIdx.x % TW, ty = threadIdx.x / TW;
  const int j0 = blockIdx.x * TW, i0 = blockIdx.y * TH, d0 = blockIdx.z * DC;
  const int d1 = min(d0 + DC, d_range);
  const int i = i0 + ty, j = j0 + tx;
  const bool mine = i < h && j < w;
  const size_t plane = (size_t)h * w, pix = (size_t)i * w + j;
  // NCC: no column of the tile is valid past d_valid
  const int d_valid = NCC ? min(j0 + TW, w) - 1 - r : d_range - 1;
  int d = d0;
  if (d0 <= d_valid) {
    // band column c + off(d) holds the other image's column j0 - r + c + dir*d
    const int bx0 = j0 - r + (dir < 0 ? 1 - d1 : d0);
    for (int e = threadIdx.x; e < rows * cols; e += NT)
      a_s[e] = read<NCC>(base, h, w, i0 - r + e / cols, j0 - r + e % cols);
    for (int e = threadIdx.x; e < rows * bcols; e += NT)
      b_s[e] = read<NCC>(other, h, w, i0 - r + e / bcols, bx0 + e % bcols);
    __syncthreads();
    float sl = 0.0f, sl2 = 0.0f;
    if (NCC && mine) {
      sl = sum_l[pix];
      sl2 = sum_l2[pix];
    }
    const float n = (float)(side * side);
    const int d_stop = min(d1, d_valid + 1);
    for (; d < d_stop; ++d) {
      const int off = dir < 0 ? d1 - 1 - d : d - d0;
      for (int e = threadIdx.x; e < TH * cols; e += NT) {
        const float* ap = a_s + e;
        const float* bp = b_s + (e / cols) * bcols + e % cols + off;
        float acc = 0.0f;
        for (int k = 0; k < side; ++k) {
          const float a = ap[k * cols], b = bp[k * bcols];
          acc = __fadd_rn(acc, NCC ? __fmul_rn(a, b) : fabsf(__fsub_rn(a, b)));
        }
        c_s[e] = acc;
      }
      __syncthreads();
      if (mine) {
        const float* cp = c_s + ty * cols + tx;
        float s = 0.0f;
        for (int k = 0; k < side; ++k) s = __fadd_rn(s, cp[k]);
        if (NCC) {
          out[d * plane + pix] = j - r - d >= 0
              ? ncc_value(s, sl, sl2, sum_r[pix - d], sum_r2[pix - d], n, eps) : sentinel;
        } else if (d <= (dir < 0 ? j : w - 1 - j)) {  // the triangle is border-filled
          out[d * plane + pix] = mean ? __fdiv_rn(s, n) : s;
        }
      }
      __syncthreads();
    }
  }
  // NCC: the rest of the chunk is invalid for every column of the tile
  if (mine)
    for (; d < d1; ++d) out[d * plane + pix] = sentinel;
}

// out[d, i, j] = out[lim, i, j] for d > lim, lim = j (left) or W-1-j (right).
__global__ void border_fill_kernel(float* __restrict__ out, int h, int w, int d_range,
                                   int right_view) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x, i = blockIdx.y;
  if (j >= w) return;
  const int lim = right_view ? w - 1 - j : j;
  if (lim >= d_range - 1) return;
  const size_t plane = (size_t)h * w, pix = (size_t)i * w + j;
  const float v = out[lim * plane + pix];
  for (int d = lim + 1; d < d_range; ++d) out[d * plane + pix] = v;
}

template <bool NCC>
cudaError_t launch(const float* base, const float* other, const float* sum_l,
                   const float* sum_l2, const float* sum_r, const float* sum_r2, float* out,
                   int h, int w, int d_range, int r, int dir, int mean, float eps,
                   float sentinel, cudaStream_t s) {
  const size_t smem = smem_bytes(r);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        window_kernel<NCC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, (d_range + DC - 1) / DC);
  window_kernel<NCC><<<grid, NT, smem, s>>>(base, other, sum_l, sum_l2, sum_r, sum_r2, out,
                                            h, w, d_range, r, dir, mean, eps, sentinel);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`.  left, right: float32 [h, w]; out: float32
// [d_range, h, w]; all contiguous on the current device.  radius = winsize
// + 1, 1 <= radius <= 32.  right_view, mean: 0 or 1.  Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int sad_volume_f32(const void* left, const void* right, void* out, int h, int w,
                              int d_range, int radius, int right_view, int mean,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* base = (const float*)(right_view ? right : left);
  const float* other = (const float*)(right_view ? left : right);
  cudaError_t err = launch<false>(base, other, nullptr, nullptr, nullptr, nullptr,
                                  (float*)out, h, w, d_range, radius, right_view ? 1 : -1,
                                  mean, 0.0f, 0.0f, s);
  if (err != cudaSuccess) return (int)err;
  border_fill_kernel<<<dim3((w + 127) / 128, h), 128, 0, s>>>((float*)out, h, w, d_range,
                                                              right_view);
  return (int)cudaGetLastError();
}

// Launch on `stream`.  lf, rf: the 128-centred float32 [h, w] images;
// sum_l, sum_l2, sum_r, sum_r2: their zero-padded (2r+1)^2 window sums of
// x and x^2, float32 [h, w]; out: float32 [d_range, h, w]; all contiguous
// on the current device.  radius = win_size, 1 <= radius <= 32.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int ncc_volume_f32(const void* lf, const void* rf, const void* sum_l,
                              const void* sum_l2, const void* sum_r, const void* sum_r2,
                              void* out, int h, int w, int d_range, int radius, float eps,
                              float sentinel, void* stream) {
  return (int)launch<true>((const float*)lf, (const float*)rf, (const float*)sum_l,
                           (const float*)sum_l2, (const float*)sum_r, (const float*)sum_r2,
                           (float*)out, h, w, d_range, radius, -1, 0, eps, sentinel,
                           (cudaStream_t)stream);
}
