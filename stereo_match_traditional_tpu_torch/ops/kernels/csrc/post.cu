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
// fill_pass_f32: one pass of the fill, one thread a pixel.  A target pixel
// walks the 8 rays of the pass's input map (E, W, S, N, SE, NW, SW, NE) to
// the first finite value within the ray's cap (axis rays cap_axis steps,
// diagonal rays cap_diag), keeps the found values sorted (at most 8, an
// insertion each) and takes the second smallest (second != 0; the smallest
// where only one was found) or the count / 2-th; a pixel whose rays found
// nothing, or that is no target, keeps its value.  Bit-exact: a pure
// selection.  The three passes are three launches, each reading the last
// one's output; the first maps invalid_value to +inf as it reads
// (raw != 0), the last writes invalid_value for what stays non-finite
// (finalize != 0).  Bound: bytes, the map and the masks in and the map out
// (~1 us at Teddy); the walks (at most ~8 x cap cached loads a target
// pixel, more where the rays are unbounded) are what it spends.
//
// remove_speckles_f32: connected components of the valid pixels (finite
// and != invalid_value) whose neighbours (left, up, and with 8-connectivity
// up-right and up-left) differ by <= diff_insame in float32, by union-find
// on the device (Playne and Hawick's linking: a root is hooked under the
// smaller root by atomicMin, and the hook retried from the value the atomic
// returns, so no host round trip is needed; each walk to a root halves the
// path it takes, as ECL-CC's do).  Then every valid pixel's root
// (the smallest index of its component) counts its area and, with a
// background value, its members that are not background, with atomics;
// pixels of components smaller than min_area, and with a background value
// holding a member that is not background, become invalid_value.  Only the
// areas reach the output, so the result is the plain version's bit for bit
// whatever order the links take.  Four kernels and a memset a call.
// Bound: bytes, the map in and out (~1.4 us at Teddy); the atomics and the
// walks up the trees are what it spends.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float fill_value(const float* __restrict__ in, long long q, int raw,
                                            float invalid) {
  const float v = __ldg(in + q);
  return (raw && v == invalid) ? INFINITY : v;
}

__global__ void __launch_bounds__(256)
fill_pass_kernel(const float* __restrict__ in, const uint8_t* __restrict__ mask,
                 float* __restrict__ out, int h, int w, int raw, float invalid,
                 int need_nonfinite, int second, int cap_axis, int cap_diag, int finalize) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= h || j >= w) return;
  const long long p = (long long)i * w + j;
  const float v = fill_value(in, p, raw, invalid);
  const bool target = (mask == nullptr || __ldg(mask + p) != 0) &&
                      (!need_nonfinite || !isfinite(v));
  float res = v;
  if (target) {
    const int di[8] = {0, 0, 1, -1, 1, -1, 1, -1};
    const int dj[8] = {1, -1, 0, 0, 1, -1, -1, 1};
    float cand[8];
    int k = 0;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int cap = r < 4 ? cap_axis : cap_diag;
      int ii = i, jj = j;
      for (int t = 1; t <= cap; ++t) {
        ii += di[r];
        jj += dj[r];
        if (ii < 0 || ii >= h || jj < 0 || jj >= w) break;
        const float u = fill_value(in, (long long)ii * w + jj, raw, invalid);
        if (isfinite(u)) {
          int m = k++;
          while (m > 0 && cand[m - 1] > u) {
            cand[m] = cand[m - 1];
            --m;
          }
          cand[m] = u;
          break;
        }
      }
    }
    if (k > 0) res = cand[second ? (k > 1 ? 1 : 0) : k / 2];
  }
  if (finalize && !isfinite(res)) res = invalid;
  out[p] = res;
}

// ---- speckles ---------------------------------------------------------------

// The root of x's tree.  A label is never above its pixel's index and a
// root labels itself, so the walk stops at the first label that does not
// fall; on the way each visited pixel is pointed at its grandparent (path
// halving: an ancestor, so every tree stays a tree of its component).
// Reads and writes go past the L1 cache: other blocks hook roots with
// atomics.
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

__global__ void __launch_bounds__(256) label_init_kernel(int* labels, int n) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < n) labels[p] = p;
}

__global__ void __launch_bounds__(256)
label_link_kernel(const float* __restrict__ d, int* labels, int h, int w, float invalid,
                  float diff, int conn8) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= h || j >= w) return;
  const int p = i * w + j;
  const float v = __ldg(d + p);
  if (!speckle_valid(v, invalid)) return;
  // left, up, up-right, up-left (the plain version's pairs)
  const int di[4] = {0, -1, -1, -1};
  const int dj[4] = {-1, 0, 1, -1};
  const int dirs = conn8 ? 4 : 2;
  for (int k = 0; k < dirs; ++k) {
    const int ii = i + di[k], jj = j + dj[k];
    if (ii < 0 || jj < 0 || jj >= w) continue;
    const int q = ii * w + jj;
    const float u = __ldg(d + q);
    if (speckle_valid(u, invalid) && fabsf(v - u) <= diff) unite(labels, p, q);
  }
}

__global__ void __launch_bounds__(256)
label_count_kernel(const float* __restrict__ d, int* labels, int* __restrict__ area,
                   int* __restrict__ foreground, int n, float invalid, int has_bg, float bg) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const float v = __ldg(d + p);
  if (!speckle_valid(v, invalid)) return;
  // no store of r to labels[p]: another thread's halving may still write p
  // an ancestor after it, so the kill kernel walks to the root itself
  const int r = find_root(labels, p);
  atomicAdd(area + r, 1);
  if (has_bg && v != bg) atomicAdd(foreground + r, 1);
}

__global__ void __launch_bounds__(256)
speckle_kill_kernel(const float* __restrict__ d, const int* __restrict__ labels,
                    const int* __restrict__ area, const int* __restrict__ foreground,
                    float* __restrict__ out, int n, float invalid, int min_area, int has_bg) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const float v = __ldg(d + p);
  bool kill = false;
  if (speckle_valid(v, invalid)) {
    int r = p;   // the trees no longer change: a plain walk, halved above
    while (labels[r] != r) r = labels[r];
    kill = area[r] < min_area && (!has_bg || foreground[r] > 0);
  }
  out[p] = kill ? invalid : v;
}

}  // namespace

// One pass of the 8-direction hole fill, on `stream`: in, out float32
// [h, w] (distinct); mask uint8 [h, w] or null (every pixel); a pixel is a
// target where its mask is set and, with need_nonfinite, its value is not
// finite.  raw != 0 reads invalid_value as +inf; second != 0 takes the
// second-smallest candidate, else the count / 2-th; cap_axis / cap_diag
// cap the rays' steps; finalize != 0 writes invalid_value for non-finite
// results.  All contiguous on the current device.  Returns a cudaError_t
// code.
extern "C" int fill_pass_f32(const void* in, const void* mask, void* out, int h, int w,
                             int raw, float invalid, int need_nonfinite, int second,
                             int cap_axis, int cap_diag, int finalize, void* stream) {
  if (h < 1 || w < 1 || cap_axis < 0 || cap_diag < 0) return (int)cudaErrorInvalidValue;
  const dim3 block(32, 8);
  const dim3 grid((w + 31) / 32, (h + 7) / 8);
  fill_pass_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)in, (const uint8_t*)mask, (float*)out, h, w, raw, invalid,
      need_nonfinite, second, cap_axis, cap_diag, finalize);
  return (int)cudaGetLastError();
}

// Speckle removal of disp float32 [h, w] into out (the same shape), on
// `stream`.  scratch: int32, 3 * h * w values (labels, areas, counts of
// members that are not background); conn8 != 0 takes 8-connectivity, else
// 4; has_bg != 0 spares components with no member != bg.  All contiguous
// on the current device; h * w < 2^31.  Returns a cudaError_t code.
extern "C" int remove_speckles_f32(const void* disp, void* out, void* scratch, int h, int w,
                                   float invalid, float diff, int min_area, int conn8,
                                   int has_bg, float bg, void* stream) {
  if (h < 1 || w < 1 || (long long)h * w >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n = h * w;
  int* labels = (int*)scratch;
  int* area = labels + n;
  int* foreground = area + n;
  cudaError_t err = cudaMemsetAsync(area, 0, 2 * sizeof(int) * (size_t)n, s);
  if (err != cudaSuccess) return (int)err;
  const float* d = (const float*)disp;
  const unsigned flat = (unsigned)((n + 255) / 256);
  label_init_kernel<<<flat, 256, 0, s>>>(labels, n);
  const dim3 block(32, 8);
  const dim3 grid((w + 31) / 32, (h + 7) / 8);
  label_link_kernel<<<grid, block, 0, s>>>(d, labels, h, w, invalid, diff, conn8);
  label_count_kernel<<<flat, 256, 0, s>>>(d, labels, area, foreground, n, invalid, has_bg, bg);
  speckle_kill_kernel<<<flat, 256, 0, s>>>(d, labels, area, foreground, (float*)out, n,
                                           invalid, min_area, has_bg);
  return (int)cudaGetLastError();
}
