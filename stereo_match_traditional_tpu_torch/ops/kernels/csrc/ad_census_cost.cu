// Fused AD + Census cost volumes, both views in one pass, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package computes these volumes with XLA
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
// What bounds it: device memory.  The function reads two images and writes
// two float32 [D, H, W] volumes, 8 bytes a (d, y, x); at 720x1280, D=128
// that is 944 MB, 0.28 ms at 3.35 TB/s.  The design serves the stores:
//
// * Each value is computed once.  The right view's value at (d, y, x) is
//   the left view's at (d, y, x + d) wherever x + d <= W-1 (the same L, R
//   and signatures); the rest of the right view, x > W-1-d, is its clamp
//   triangle, cost(L(y, W-1), R(y, x)), which does not depend on d.  The
//   left view's clamp triangle (x < d) and the right view's hold min(d, W)
//   columns each, so the lane of left column x < d also writes right
//   column W-1-x: every right entry is written once, also for D > W.
// * The census is computed once per image per launch: census_9x7_kernel
//   (the pipelines' window; census_kernel for any other) writes the
//   [2, H, W] signatures from a shared-memory tile of the image rows.
// * u8 images: AD is an integer in 0..255 and Ham one in 0..63, so the two
//   exponential terms come from tables of 256 + 64 entries, built once per
//   launch by the census launch's first block with the same expression
//   (expf, IEEE division) and read into shared memory by every cost block:
//   the same bits as the direct formula, with no exponential or division
//   per value.  float32 images keep the direct formula.
// * 16-byte stores.  A warp store instruction costs the SM about the same
//   whatever its width, and at 4 bytes a lane the stores alone kept the
//   kernel at ~2.4 TB/s, so a lane holds 4 neighbouring columns of one
//   disparity and stores them as one float4.  Where the destination is not
//   16-byte aligned (the right view at most d; any row when W % 4 != 0)
//   the lanes pass their values one lane up by shuffles and store aligned
//   quads; only a warp's two ends are stored one value at a time.  Stores
//   are streaming (__stcs): neither volume fits in the 50 MB L2.
// * A lane's right pixels for d + 1 are those for d moved one column, so
//   it reads one staged right pixel and signature per disparity.
//
// Numerics: no fast-math.  expf is CUDA's full-accuracy expf and '/' is
// IEEE division, so the volume differs from the plain version only by
// expf's last-ulp rounding; AD and Hamming are exact integers.  part = 1
// or 2 writes the raw AD or Hamming volume (as float) instead of the cost,
// so both integer parts can be checked exactly against the plain
// ad_volume / census_volume.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;        // threads a cost block: CG x DG warps
constexpr int TX = 256;        // left-view columns a cost block owns, 128 a warp, 4 a lane
constexpr int CG = TX / 128;
constexpr int DG = NT / 32 / CG;
constexpr int DPW = 8;         // disparities a warp takes
constexpr int DC = DG * DPW;   // disparities a cost block owns
constexpr int CX = 32;         // census block: CX x CY threads
constexpr int CY = 8;
constexpr int CR = 4;          // rows a thread of the 9 x 7 census takes
static_assert(NT >= 256 && CX * CY >= 256, "one thread per entry of the AD table");
static_assert(TX % 128 == 0 && NT / 32 % CG == 0, "whole warps of 128 columns");

// Out-of-image neighbours are staged as the type's largest value, so that
// "centre > neighbour" is false for them whatever the centre.
template <typename T>
__device__ __forceinline__ T sentinel() {
  if constexpr (sizeof(T) == 1) return T(255);
  else return __int_as_float(0x7f800000);   // +inf
}

// The tables for u8 images, by the direct formula's expression (expf and
// IEEE division), written by the census launch's first block.
__device__ __forceinline__ void write_tables(float* tabs, float sigma_c, float sigma_s) {
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
  if (tabs == nullptr || blockIdx.x != 0 || blockIdx.y != 0 || blockIdx.z != 0) return;
  tabs[t] = 1.0f - expf(-(float)t / sigma_c);
  if (t < 64) tabs[256 + t] = 1.0f - expf(-(float)t / sigma_s);
}

// Stage rows [y0, y0 + th) x columns [x0, x0 + tw) of img into tile
// (row-major, tw wide), out-of-image entries as the sentinel.
template <typename T>
__device__ __forceinline__ void load_tile(T* tile, const T* __restrict__ img, int h, int w,
                                          int y0, int x0, int th, int tw) {
  for (int i = threadIdx.y * CX + threadIdx.x; i < tw * th; i += CX * CY) {
    const int yy = y0 + i / tw;
    const int xx = x0 + i % tw;
    tile[i] = yy >= 0 && yy < h && xx >= 0 && xx < w ? img[(size_t)yy * w + xx] : sentinel<T>();
  }
}

// Census signatures of both images (blockIdx.z) for the 9 x 7 window, the
// one every pipeline uses.  A thread takes CR rows of one column and reads
// each of its 7 window columns once, 12 values down, for the 4 x 63 bits;
// every bit position is a constant, so a bit is a compare and an OR.
template <typename T>
__global__ void __launch_bounds__(CX * CY)
census_9x7_kernel(const T* __restrict__ img0, const T* __restrict__ img1,
                  long long* __restrict__ sig, float* __restrict__ tabs, int h, int w,
                  float sigma_c, float sigma_s) {
  constexpr int RR = 4, RC = 3, TW = CX + 2 * RC, TH = CY * CR + 2 * RR;
  __shared__ T tile[TH * TW];
  write_tables(tabs, sigma_c, sigma_s);
  const T* img = blockIdx.z == 0 ? img0 : img1;
  const int by = blockIdx.y * CY * CR;
  const int bx = blockIdx.x * CX;
  load_tile(tile, img, h, w, by - RR, bx - RC, TH, TW);
  __syncthreads();
  const int r0 = threadIdx.y * CR;               // the thread's first row in the block
  const int tx = threadIdx.x;
  T c[CR];
#pragma unroll
  for (int i = 0; i < CR; ++i) c[i] = tile[(r0 + i + RR) * TW + tx + RC];
  unsigned hi[CR], lo[CR];
#pragma unroll
  for (int i = 0; i < CR; ++i) hi[i] = lo[i] = 0u;
#pragma unroll
  for (int q = 0; q < 2 * RC + 1; ++q) {
    T v[CR + 2 * RR];
#pragma unroll
    for (int t = 0; t < CR + 2 * RR; ++t) v[t] = tile[(r0 + t) * TW + tx + q];
#pragma unroll
    for (int i = 0; i < CR; ++i) {
#pragma unroll
      for (int r = 0; r < 2 * RR + 1; ++r) {
        const int bit = 62 - (r * (2 * RC + 1) + q);   // row-major offsets, first is the top bit
        if (c[i] > v[i + r]) {
          if (bit >= 32) hi[i] |= 1u << (bit - 32);
          else lo[i] |= 1u << bit;
        }
      }
    }
  }
  const int x = bx + tx;
  if (x >= w) return;
#pragma unroll
  for (int i = 0; i < CR; ++i) {
    const int y = by + r0 + i;
    if (y < h) {
      sig[((size_t)blockIdx.z * h + y) * w + x] =
          (long long)(((unsigned long long)hi[i] << 32) | lo[i]);
    }
  }
}

// Census signatures for any other window (rows * cols <= 63): one pixel a
// thread, the window read from a shared tile of the block's pixels and halo.
template <typename T>
__global__ void __launch_bounds__(CX * CY)
census_kernel(const T* __restrict__ img0, const T* __restrict__ img1,
              long long* __restrict__ sig, float* __restrict__ tabs, int h, int w, int rr,
              int rc, float sigma_c, float sigma_s) {
  extern __shared__ __align__(16) unsigned char census_smem[];
  T* tile = reinterpret_cast<T*>(census_smem);
  write_tables(tabs, sigma_c, sigma_s);
  const T* img = blockIdx.z == 0 ? img0 : img1;
  const int tw = CX + 2 * rc;
  load_tile(tile, img, h, w, blockIdx.y * CY - rr, blockIdx.x * CX - rc, CY + 2 * rr, tw);
  __syncthreads();
  const int x = blockIdx.x * CX + threadIdx.x;
  const int y = blockIdx.y * CY + threadIdx.y;
  if (x >= w || y >= h) return;
  const T* centre = tile + (threadIdx.y + rr) * tw + threadIdx.x + rc;
  const T cv = *centre;
  unsigned long long s = 0;
  for (int r = -rr; r <= rr; ++r) {
    for (int q = -rc; q <= rc; ++q) s = (s << 1) | (unsigned long long)(cv > centre[r * tw + q]);
  }
  sig[((size_t)blockIdx.z * h + y) * w + x] = (long long)s;
}

// One value of the volume from a left pixel a, a right pixel b and their
// signatures; the same expression as the plain version for float32 images,
// its table lookups for u8 images.
template <typename T, int PART>
__device__ __forceinline__ float cost_value(T a, T b, long long ca, long long cb,
                                            const float* tab_ad, const float* tab_ham,
                                            float sigma_c, float sigma_s) {
  if constexpr (sizeof(T) == 1) {
    const int ad = abs((int)a - (int)b);
    if constexpr (PART == 1) return (float)ad;
    const int ham = __popcll(ca ^ cb);
    if constexpr (PART == 2) return (float)ham;
    return tab_ad[ad] + tab_ham[ham];
  } else {
    const float ad = fabsf(a - b);
    if constexpr (PART == 1) return ad;
    const float ham = (float)__popcll(ca ^ cb);
    if constexpr (PART == 2) return ham;
    return (1.0f - expf(-ad / sigma_c)) + (1.0f - expf(-ham / sigma_s));
  }
}

// Store one warp row: the 4 values `own` of source columns xq..xq+3 (xq =
// xw + 4 * lane, the warp's 128 columns from xw) go to out[e + c] for each
// source column c in [lo, hi).  Where the address of out[e + xw] is not a
// multiple of 4 floats (s != 0, the same for the whole warp) each lane takes
// the s values before its own from the lane below by shuffles, so that its
// 16-byte store is aligned; the columns at the warp's two ends and outside
// [lo, hi) are stored one by one.
__device__ __forceinline__ void store_quads(float* __restrict__ out, long long e, int s,
                                            const float (&own)[4], int lane, int xq, int lo,
                                            int hi) {
  float q[4] = {own[0], own[1], own[2], own[3]};
  if (s != 0) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = __shfl_up_sync(0xffffffffu, own[i], 1);
    q[0] = s == 1 ? p[3] : s == 2 ? p[2] : p[1];
    q[1] = s == 1 ? own[0] : s == 2 ? p[3] : p[2];
    q[2] = s == 1 ? own[1] : s == 2 ? own[0] : p[3];
    q[3] = s == 1 ? own[2] : s == 2 ? own[1] : own[0];
  }
  const int c0 = xq - s;   // the source column of q[0]
  if ((lane > 0 || s == 0) && c0 >= lo && c0 + 4 <= hi) {
    __stcs(reinterpret_cast<float4*>(out + (e + c0)), make_float4(q[0], q[1], q[2], q[3]));
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // lane 0's first s values are the warp below's, its last lane stores them
      if (c0 + i >= lo && c0 + i < hi && (lane > 0 || i >= s)) __stcs(out + (e + c0 + i), q[i]);
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i >= 4 - s && xq + i >= lo && xq + i < hi) __stcs(out + (e + xq + i), own[i]);
    }
  }
}

// Block (strip of TX left columns from x0, chunk of DC disparities from d0,
// row y).  Warp (cg, dg) takes the 128 columns from x0 + 128 * cg and the
// DPW disparities from d0 + DPW * dg; its lane the 4 columns xq..xq+3.  Per
// disparity d the lane computes the 4 values from its left pixels (held in
// registers) and 4 staged right pixels (a window sliding one column a
// disparity), stores them to the left view at columns xq.., to the right view
// at columns xq - d.. (where xq + i >= d), and the right clamp triangle's
// values at W-1-xq-i (where xq + i < d).  out_l or out_r may be null: that
// view is not written.
template <typename T, int PART>
__global__ void __launch_bounds__(NT)
cost_kernel(const T* __restrict__ left, const T* __restrict__ right,
            const long long* __restrict__ sig, const float* __restrict__ tabs,
            float* __restrict__ out_l, float* __restrict__ out_r, int h, int w, int d_range,
            float sigma_c, float sigma_s) {
  __shared__ float tab_ad[256];
  __shared__ float tab_ham[64];
  __shared__ T l_s[TX];                      // L(y, x0 + k), clamped into the image
  __shared__ long long cl_s[TX];             // cL at the same columns
  __shared__ T r_s[TX + DC];                 // R(y, clamp(c)), c = x0 - d0 - (DC - 1) + k
  __shared__ long long cr_s[TX + DC];        // cR at the same columns

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int x0 = blockIdx.x * TX;
  const int d0 = blockIdx.y * DC;
  const int y = blockIdx.z;
  const int xw = x0 + 128 * (warp % CG);
  const int xq = xw + 4 * lane;
  const int ds = d0 + DPW * (warp / CG);
  const size_t row = (size_t)y * w;
  const long long* sig_l = sig;
  const long long* sig_r = sig + (size_t)h * w;
  const int cbase = x0 - d0 - (DC - 1);

  // Stage the block's row of right and left pixels and signatures: the
  // columns [cbase, cbase + TX + DC - 1) of R and [x0, x0 + TX) of L,
  // clamped into the image.
  for (int k = tid; k < TX + DC - 1; k += NT) {
    r_s[k] = right[row + min(max(cbase + k, 0), w - 1)];
    if (k < TX) l_s[k] = left[row + min(x0 + k, w - 1)];
  }
  // the inputs of the right clamp triangle's values at columns W-1-xq-i,
  // the same for every d > xq + i
  const bool want_tri = out_r != nullptr && xq < min(ds + DPW, d_range) && xq < w;
  T tl = want_tri ? left[row + w - 1] : T(0);
  T tr[4];
  long long tcl = 0, tcr[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 4; ++i) tr[i] = want_tri ? right[row + max(w - 1 - xq - i, 0)] : T(0);
  if constexpr (PART != 1) {
    if constexpr (sizeof(T) == 1 && PART == 0) {
      if (tid < 256) tab_ad[tid] = tabs[tid];
      if (tid < 64) tab_ham[tid] = tabs[256 + tid];
    }
    for (int k = tid; k < TX + DC - 1; k += NT) {
      cr_s[k] = sig_r[row + min(max(cbase + k, 0), w - 1)];
      if (k < TX) cl_s[k] = sig_l[row + min(x0 + k, w - 1)];
    }
    if (want_tri) {
      tcl = sig_l[row + w - 1];
#pragma unroll
      for (int i = 0; i < 4; ++i) tcr[i] = sig_r[row + max(w - 1 - xq - i, 0)];
    }
  }
  __syncthreads();
  if (xw >= w || ds >= d_range) return;   // a warp past the image's last column or disparity

  float tri[4];
  T l[4], r[4];
  long long cl[4], cr[4];
  const int kb = (xq - x0) + (DC - 1) - (ds - d0);   // r_s index of column xq - ds
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    tri[i] = cost_value<T, PART>(tl, tr[i], tcl, tcr[i], tab_ad, tab_ham, sigma_c, sigma_s);
    l[i] = l_s[xq - x0 + i];
    cl[i] = PART != 1 ? cl_s[xq - x0 + i] : 0;
    r[i] = r_s[kb + i];
    cr[i] = PART != 1 ? cr_s[kb + i] : 0;
  }
  const unsigned base_l = (unsigned)((size_t)out_l >> 2);   // the outputs' addresses in floats
  const unsigned base_r = (unsigned)((size_t)out_r >> 2);
#pragma unroll
  for (int m = 0; m < DPW; ++m) {
    const int d = ds + m;
    if (d >= d_range) break;   // the same for the whole warp
    if (m > 0) {               // slide the right window one column down
#pragma unroll
      for (int i = 3; i > 0; --i) {
        r[i] = r[i - 1];
        cr[i] = cr[i - 1];
      }
      r[0] = r_s[kb - m];
      if constexpr (PART != 1) cr[0] = cr_s[kb - m];
    }
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = cost_value<T, PART>(l[i], r[i], cl[i], cr[i], tab_ad, tab_ham, sigma_c, sigma_s);
    }
    const long long e = ((long long)d * h + y) * w;   // (d, y, 0)
    if (out_l != nullptr) {
      store_quads(out_l, e, (int)((base_l + (unsigned)(e + xw)) & 3u), v, lane, xq, 0, w);
    }
    if (out_r != nullptr) {
      store_quads(out_r, e - d, (int)((base_r + (unsigned)(e - d + xw)) & 3u), v, lane, xq, d, w);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (xq + i < d && xq + i < w) __stcs(out_r + (e + w - 1 - xq - i), tri[i]);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* left, const void* right, void* sig, void* out_l, void* out_r,
                   int h, int w, int d_range, int rows, int cols, float sigma_c,
                   float sigma_s, int part, cudaStream_t s) {
  const T* l = (const T*)left;
  const T* r = (const T*)right;
  long long* sg = (long long*)sig;
  float* tabs = part == 0 && sizeof(T) == 1 ? (float*)(sg + 2 * (size_t)h * w) : nullptr;
  if (part != 1) {
    if (rows == 9 && cols == 7) {
      census_9x7_kernel<T><<<dim3((w + CX - 1) / CX, (h + CY * CR - 1) / (CY * CR), 2),
                             dim3(CX, CY), 0, s>>>(l, r, sg, tabs, h, w, sigma_c, sigma_s);
    } else {
      const int rr = rows / 2, rc = cols / 2;
      const size_t smem = sizeof(T) * (size_t)(CX + 2 * rc) * (CY + 2 * rr);
      census_kernel<T><<<dim3((w + CX - 1) / CX, (h + CY - 1) / CY, 2), dim3(CX, CY), smem,
                         s>>>(l, r, sg, tabs, h, w, rr, rc, sigma_c, sigma_s);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((w + TX - 1) / TX, (d_range + DC - 1) / DC, h);
  float* ol = (float*)out_l;
  float* orr = (float*)out_r;
  if (part == 0) {
    cost_kernel<T, 0><<<grid, NT, 0, s>>>(l, r, sg, tabs, ol, orr, h, w, d_range, sigma_c,
                                          sigma_s);
  } else if (part == 1) {
    cost_kernel<T, 1><<<grid, NT, 0, s>>>(l, r, sg, tabs, ol, orr, h, w, d_range, sigma_c,
                                          sigma_s);
  } else {
    cost_kernel<T, 2><<<grid, NT, 0, s>>>(l, r, sg, tabs, ol, orr, h, w, d_range, sigma_c,
                                          sigma_s);
  }
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`.  left, right: [h, w] images, uint8 when u8 is 1,
// float32 otherwise; sig: int64 scratch of 2 * h * w + 160 entries (the
// signatures [2, h, w], then the two tables as 320 floats; unused by the AD
// part); out_left, out_right: float32 [d_range, h, w], 4-byte aligned, either
// may be null (that view is not written, not both); all contiguous on the
// current device.  rows * cols <= 63; h <= 65535; d_range >= 1.  part:
// 0 cost, 1 AD, 2 Hamming; the AD part skips the census kernel.  Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int ad_census_volume_f32(const void* left, const void* right, int u8, void* sig,
                                    void* out_left, void* out_right, int h, int w,
                                    int d_range, int rows, int cols, float sigma_c,
                                    float sigma_s, int part, void* stream) {
  if ((out_left == nullptr && out_right == nullptr) || h < 1 || w < 1 || d_range < 1 ||
      h > 65535 || part < 0 || part > 2) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(u8 ? launch<unsigned char>(left, right, sig, out_left, out_right, h, w, d_range,
                                          rows, cols, sigma_c, sigma_s, part, s)
                  : launch<float>(left, right, sig, out_left, out_right, h, w, d_range, rows,
                                  cols, sigma_c, sigma_s, part, s));
}
