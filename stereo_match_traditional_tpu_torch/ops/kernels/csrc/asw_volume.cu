// Adaptive-support-weight cost volume, left view, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_asw_kernel`
// (stereo_match_traditional_tpu/ops/kernels/asw_pallas.py, launched by
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
// What bounds it on the H100: arithmetic.  At Teddy size (375x450, D=60,
// r=12) the volume is 375*450*60*625 ~= 6.3e9 weighted window terms, each
// about 10 FP32 instructions (one shared-memory load, subtractions, three
// FMAs, abs, min, the den add) plus one exponential on the special
// function unit.  Device memory traffic is only the two images once per
// block and the [D, H, W] output once.
//
// Design: a block owns a TH x TW pixel tile and DC disparities; each
// thread owns one pixel and keeps num[DC], den[DC] and the right centres
// R(y, x-d) in registers.  Shared memory holds the left tile with its
// halo, (TH+2r) x (TW+2r), and one right band of width TW+2r+DC-1 for the
// same rows: by the shear identity k = dx - d (asw_pallas.py:13-30) the
// one band serves every (dx, d) pair of the chunk.  At r=12 that is 16 KB.
//
// exp: exp2f of an argument pre-scaled by log2(e) (folded into the two
// constants the host passes).  exp2f costs one MUFU.EX2 plus range
// handling and is accurate to 2 ulp over the whole range, whereas __expf
// multiplies by log2(e) inside and loses up to ~1.2*|x| ulp, which grows
// with the colour difference.
#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;   // tile width, one warp per tile row
constexpr int TH = 8;    // tile height
constexpr int DC = 16;   // disparities per block

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__global__ void __launch_bounds__(TW * TH)
asw_left_kernel(const float* __restrict__ left, const float* __restrict__ right,
                float* __restrict__ out, int h, int w, int d_range, int radius,
                float c_color, float c_space, float trunc) {
  extern __shared__ float smem[];
  const int side = 2 * radius + 1;
  const int rows = TH + 2 * radius;
  const int lw = TW + 2 * radius;
  const int rw = TW + 2 * radius + DC - 1;
  float* ls = smem;               // [rows][lw]: L(y0-r+i, x0-r+j)
  float* rs = smem + rows * lw;   // [rows][rw]: R(y0-r+i, x0-r-(d0+DC-1)+j)

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

  // R(y+oy, x+ox-d) sits in band row ty+jy, column tx+jx+(DC-1-jd), with
  // jy = oy+r, jx = ox+r, jd = d-d0.
  const float lc = ls[(ty + radius) * lw + tx + radius];
  float rc[DC], num[DC], den[DC];
#pragma unroll
  for (int jd = 0; jd < DC; ++jd) {
    rc[jd] = rs[(ty + radius) * rw + tx + radius + DC - 1 - jd];
    num[jd] = 0.f;
    den[jd] = 0.f;
  }

  for (int jy = 0; jy < side; ++jy) {
    const float* lrow = ls + (ty + jy) * lw + tx;
    const float* rrow = rs + (ty + jy) * rw + tx + DC - 1;
    const int vy = (jy - radius) * (jy - radius);
    for (int jx = 0; jx < side; ++jx) {
      const float l = lrow[jx];
      const float dl = l - lc;
      const float dl2 = dl * dl;
      const float sp = (float)(vy + (jx - radius) * (jx - radius)) * c_space;
#pragma unroll
      for (int jd = 0; jd < DC; ++jd) {
        const float r = rrow[jx - jd];
        const float dr = r - rc[jd];
        const float wgt = exp2f(-(dl2 + dr * dr) * c_color - sp);
        const float e = fminf(fabsf(l - r), trunc);
        num[jd] = fmaf(wgt, e, num[jd]);
        den[jd] += wgt;
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
// after the launch (0 = launched).
extern "C" int asw_volume_left_f32(const void* left, const void* right, void* out,
                                   int h, int w, int d_range, int radius,
                                   float c_color, float c_space, float trunc,
                                   void* stream) {
  const size_t rows = TH + 2 * radius;
  const size_t smem =
      sizeof(float) * rows * ((TW + 2 * radius) + (TW + 2 * radius + DC - 1));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        asw_left_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 block(TW, TH);
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, (d_range + DC - 1) / DC);
  asw_left_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const float*)left, (const float*)right, (float*)out, h, w, d_range, radius,
      c_color, c_space, trunc);
  return (int)cudaGetLastError();
}
