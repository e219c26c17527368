// Adaptive-support-weight cost volume, left view, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_asw_kernel`
// (stereo_match_traditional_tpu/ops/kernels/asw_pallas.py:131, launched by
// `_asw_pallas_left` through `pl.pallas_call` at :264).  It computes
//
//   cost(p, d) = sum_o w * min(|L(p+o) - R(p+o-d)|, T) / sum_o w
//   w = exp(-((L(p+o) - L(p))^2 + (R(p+o-d) - R(p-d))^2) / (2 sc^2)
//           - |o|^2 / ss^2)
//
// over the (2r+1)^2 window offsets o (r = win_size + 1, 25x25 at the
// reference's win_size 11).  The space term is squared because the
// reference multiplies the space mask into both views' weights
// (ASW/ASW.h:222-248).  Every row and column index is clamped into the
// image, which is the replicate padding of asw_pallas.py:251-252.  Output
// columns x < d read clamped right columns; the caller's
// border_fill('left') overwrites exactly those entries.
//
// What bounds it on the H100: operations.  At Teddy size (375x450, D=60,
// r=12) the volume is 375*450*60*625 ~= 6.3e9 weighted window terms.  The
// device memory traffic is the two images once per block and the
// [D, H, W] output once (40 MB, 0.012 ms).  The scarce unit is the
// special-function unit: MUFU.EX2 runs 16 lanes a clock on an SM against
// 128 for float32 arithmetic, so one exponential a term (the fused weight
// of the TPU kernel) costs as much as eight arithmetic instructions.
//
// Design: the weight is taken in the reference's own factored form,
//
//   w = wL(p, o) * wR(p - d, o),
//   wL(p, o) = exp2(-(L(p+o) - L(p))^2 c - s(o) / 2)   (wR likewise on R),
//
// which needs D-fold fewer exponentials.  A block owns a TH x TW = 8 x 32
// pixel tile and DC = 32 disparities; a thread owns one pixel and keeps
// num[DC] and den[DC] in registers.  Shared memory holds the left tile with its halo,
// one right band of width TW + 2r + DC - 1 for the same rows (by the shear
// identity k = dx - d, asw_pallas.py:13-30, one band serves every (dx, d)
// pair of the chunk), and, per warp (= tile row), the table wR(q, o) of
// one window row for the TW + DC - 1 right centres q = x - d the row
// needs: (2r+1) (TW+DC-1) exponentials where the fused form took
// (2r+1) TW DC.  The warp builds its own table and reads only its own, so
// a window row costs two __syncwarp and no block barrier.  wL is one
// exponential per (pixel, offset), in a register, shared by the DC
// disparities.  The right values of a window row sit in registers as a
// sliding window over k = jx - jd, JX offsets at a time with static
// indices, so a term is one shared load (wR), a subtract, min(|.|, T), a
// multiply, an FMA and an add: at six arithmetic instructions and 1.3
// shared loads a term the 6.75e9 thread-terms of Teddy (D=60 padded to two
// chunks of 32) are ~1.5 ms of instruction slots on 132 SMs at 1.98 GHz,
// and the tables and wL add ~15 %.  At the reference window the block uses 69 KB of
// shared memory (50 KB of tables), two blocks an SM.
//
// Numerics: the factored weight rounds differently from the fused one of
// the plain version (two exponentials and a product against one), and
// ex2.approx.ftz is accurate to 2^-22: a few ulp on a weight, far inside
// the rtol 1e-4 / atol 1e-3 that the kernel is held to.
#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;   // tile width, one warp per tile row
constexpr int TH = 8;    // tile height
constexpr int DC = 32;   // disparities per block
constexpr int JX = 4;    // window columns per register window of right values
constexpr int NC = TW + DC - 1;  // right centres a tile row needs

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__global__ void __launch_bounds__(TW * TH)
asw_left_kernel(const float* __restrict__ left, const float* __restrict__ right,
                float* __restrict__ out, int h, int w, int d_range, int radius,
                float c_color, float c_space_half, float trunc) {
  extern __shared__ float smem[];
  const int side = 2 * radius + 1;
  const int rows = TH + 2 * radius;
  const int lw = TW + 2 * radius;
  const int rw = TW + 2 * radius + DC - 1 + JX;  // JX columns of slack for the last window
  float* ls = smem;                 // [rows][lw]: L(y0-r+i, x0-r+j)
  float* rs = ls + rows * lw;       // [rows][rw]: R(y0-r+i, x0-r-(d0+DC-1)+j)
  float* tables = rs + rows * rw;   // [TH][side][NC]: wR of the current window row

  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int d0 = blockIdx.z * DC;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TW + tx;

  for (int i = tid; i < rows * lw; i += TW * TH) {
    const int r = i / lw;
    const int c = i - r * lw;
    const int yy = clampi(y0 - radius + r, 0, h - 1);
    const int xx = clampi(x0 - radius + c, 0, w - 1);
    ls[i] = left[(size_t)yy * w + xx];
  }
  const int rx0 = x0 - radius - (d0 + DC - 1);
  for (int i = tid; i < rows * rw; i += TW * TH) {
    const int r = i / rw;
    const int c = i - r * rw;
    const int yy = clampi(y0 - radius + r, 0, h - 1);
    const int xx = clampi(rx0 + c, 0, w - 1);
    rs[i] = right[(size_t)yy * w + xx];
  }
  __syncthreads();

  // Right centre q = x - d of (tx, jd) is band column ci + radius with
  // ci = tx + DC-1-jd; R(y+oy, q+ox) sits in band row ty+jy, column ci+jx
  // (jy = oy+r, jx = ox+r).
  const float lc = ls[(ty + radius) * lw + tx + radius];
  const float* rcen = rs + (ty + radius) * rw + radius;   // rcen[ci] = R(y, q)
  float* table = tables + ty * side * NC;                 // table[jx * NC + ci]
  float num[DC], den[DC];
#pragma unroll
  for (int jd = 0; jd < DC; ++jd) {
    num[jd] = 0.f;
    den[jd] = 0.f;
  }

  for (int jy = 0; jy < side; ++jy) {
    const float* lrow = ls + (ty + jy) * lw + tx;
    const float* rrow = rs + (ty + jy) * rw;
    const int vy = (jy - radius) * (jy - radius);
    __syncwarp();  // the previous window row's table has been read
    for (int ci = tx; ci < NC; ci += TW) {
      const float rc = rcen[ci];
      for (int jx = 0; jx < side; ++jx) {
        const float dr = rrow[ci + jx] - rc;
        const float sp = (float)(vy + (jx - radius) * (jx - radius)) * c_space_half;
        table[jx * NC + ci] = ex2(-(dr * dr) * c_color - sp);
      }
    }
    __syncwarp();
    for (int jx0 = 0; jx0 < side; jx0 += JX) {
      // rwin[i] = R(y+oy, x + (jx0 + i - (DC-1)) - r - d0): offset jj, disparity jd
      // reads i = jj + DC-1-jd
      float rwin[JX + DC - 1];
#pragma unroll
      for (int i = 0; i < JX + DC - 1; ++i) rwin[i] = rrow[tx + jx0 + i];
      const float* wr = table + jx0 * NC + tx;
#pragma unroll
      for (int jj = 0; jj < JX; ++jj) {
        const int jx = jx0 + jj;
        if (jx < side) {
          const float l = lrow[jx];
          const float dl = l - lc;
          const float sp = (float)(vy + (jx - radius) * (jx - radius)) * c_space_half;
          const float wl = ex2(-(dl * dl) * c_color - sp);
#pragma unroll
          for (int jd = 0; jd < DC; ++jd) {
            const float wgt = wl * wr[jj * NC + DC - 1 - jd];
            const float e = fminf(fabsf(l - rwin[jj + DC - 1 - jd]), trunc);
            num[jd] = fmaf(wgt, e, num[jd]);
            den[jd] += wgt;
          }
        }
      }
    }
  }

  const int x = x0 + tx;
  const int y = y0 + ty;
  if (x < w && y < h) {
#pragma unroll
    for (int jd = 0; jd < DC; ++jd) {
      const int d = d0 + jd;
      if (d < d_range) {
        out[((size_t)d * h + y) * w + x] = num[jd] / fmaxf(den[jd], 1e-20f);
      }
    }
  }
}

}  // namespace

// Launch on `stream`.  left, right: float32 [h, w]; out: float32
// [d_range, h, w]; all contiguous on the current device.  c_color =
// log2(e) / (2 sc^2), c_space = log2(e) / ss^2.  Returns cudaGetLastError()
// after the launch (0 = launched); a window whose tables do not fit in the
// 227 KB of shared memory (radius above ~35) is refused with
// cudaErrorInvalidValue.
extern "C" int asw_volume_left_f32(const void* left, const void* right, void* out,
                                   int h, int w, int d_range, int radius,
                                   float c_color, float c_space, float trunc,
                                   void* stream) {
  const size_t rows = TH + 2 * radius;
  const size_t side = 2 * radius + 1;
  const size_t smem = sizeof(float) * (rows * ((TW + 2 * radius) +
                                               (TW + 2 * radius + DC - 1 + JX)) +
                                       TH * side * NC);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        asw_left_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 block(TW, TH);
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, (d_range + DC - 1) / DC);
  asw_left_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const float*)left, (const float*)right, (float*)out, h, w, d_range, radius,
      c_color, 0.5f * c_space, trunc);
  return (int)cudaGetLastError();
}
