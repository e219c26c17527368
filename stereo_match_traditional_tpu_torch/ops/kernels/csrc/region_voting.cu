// The canonical family's iterative region voting, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves the voting to XLA
// (`stereo_match_traditional_tpu/ops/post.py:886` iterative_region_voting).
// The port's plain version (`ops/post.py` `_iterative_region_voting_plain`)
// builds a [D, H, W] int32 one-hot of the rounded disparities each
// iteration and sums it over every pixel's cross region by integer prefix
// sums, a horizontal span and then a vertical one: some 20 passes over D * H
// * W values an iteration, of which only the pixels still invalid read the
// result.
//
// region_voting_f32 counts the votes of those pixels' regions alone:
//   * vote_prep_kernel, a thread a pixel: the map copied to the output; the
//     pixel's vote bin, int16 (round half to even of a valid value lying in
//     [0, D), else -1: it votes in no bin and counts in no total); its
//     horizontal span [x - left, x + right] clipped to the row, packed in one
//     word (two uint16); the invalid pixels listed, the first iteration's
//     targets (one global atomic a block);
//   * vote_count_kernel, a warp a listed target (grid-stride), a histogram of
//     D int32 bins a warp in shared memory: for each row y' of the target's
//     vertical span [y - up, y + down] (clipped), the row's horizontal span
//     at column x, from the arms of (y', x) as _vsum(_hsum(.)) takes them, is
//     read 32 bins at a time.  Neighbouring pixels mostly vote alike: a
//     ballot marks where a run of equal bins starts, and each run's first
//     lane adds the run's length to its bin, one shared atomic a run.  The
//     lanes then read the bins, zeroing them for the warp's next target: the
//     total, the largest bin and the lowest d that holds it; the plain
//     version's float32 tests decide the fill;
//   * vote_apply_kernel, a thread a listed target: a filled target's value
//     written and its bin set (it votes in the next iteration, never in its
//     own: the plain version's iterations read the whole previous map), the
//     others listed for the next iteration.
// Launches: a memset of the counts, the prep kernel, then two kernels an
// iteration.
//
// Exact: the counts are integers, in any order; the tests are the plain
// version's float32 ones (total > ts, bestv > th * total rounded once);
// ties go to the lowest d, argmax's first maximum.  Arms below 0 are read as
// 0 (every arm map of the port is >= 0).  Bound: bytes, the map and the four
// arms read and the map written once (KITTI size: 11.2 MB, 3.3 us); the work
// is the targets' regions, up to (2 cap + 1)^2 pixels each, read from L2 and
// L1 (the bins and spans of a KITTI map are 2.8 MB).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "device.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int VOTE_THREADS = 256;         // prep and apply blocks
constexpr int VOTE_WARPS = 8;             // count warps a block, at most
constexpr int VOTE_STATIC_SHARED = 49152;  // bins a block without the attribute
constexpr int VOTE_SHARED_LIMIT = 232448;  // dynamic shared memory a block may use

// Appends `value` to `list` where `take` holds, for every thread of the
// block (all of them call it): places by a shared atomic a warp, then one
// global atomic on *count a block.
__device__ __forceinline__ void list_append(bool take, int value, int* __restrict__ list,
                                            int* __restrict__ count) {
  __shared__ int block_n, block_base;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) block_n = 0;
  __syncthreads();
  const unsigned who = __ballot_sync(FULL, take);
  int at = 0;
  if (lane == 0 && who) at = atomicAdd(&block_n, __popc(who));
  at = __shfl_sync(FULL, at, 0);
  __syncthreads();
  if (threadIdx.x == 0 && block_n) block_base = atomicAdd(count, block_n);
  __syncthreads();
  if (take) list[block_base + at + __popc(who & ((1u << lane) - 1u))] = value;
}

__global__ void __launch_bounds__(VOTE_THREADS)
vote_prep_kernel(const float* __restrict__ disp, const int* __restrict__ left,
                 const int* __restrict__ right, float* __restrict__ out,
                 int16_t* __restrict__ bins, uint32_t* __restrict__ spans,
                 int* __restrict__ list, int* __restrict__ count, int h, int w, int nd,
                 float invalid) {
  const int n = h * w;
  for (long long p0 = (long long)blockIdx.x * VOTE_THREADS; p0 < n;
       p0 += (long long)gridDim.x * VOTE_THREADS) {
    const int p = (int)p0 + threadIdx.x;
    bool target = false;
    if (p < n) {
      const float v = __ldg(disp + p);
      out[p] = v;
      target = v == invalid;
      int b = -1;
      if (!target) {
        const float r = rintf(v);
        if (r >= 0.0f && r < (float)nd) b = (int)r;
      }
      bins[p] = (int16_t)b;
      const int x = p % w;
      const int lo = x - min(max(__ldg(left + p), 0), x);
      const int hi = x + min(max(__ldg(right + p), 0), w - 1 - x);
      spans[p] = (uint32_t)lo | ((uint32_t)hi << 16);
    }
    list_append(target, p, list, count);
  }
}

// Iteration k's targets list[0, counts[k]); res[t] the bin target t takes,
// -1 where it stays invalid.  The block's warps hold a histogram of nd bins
// each, zero between targets.
__global__ void __launch_bounds__(VOTE_WARPS * 32)
vote_count_kernel(const int16_t* __restrict__ bins, const uint32_t* __restrict__ spans,
                  const int* __restrict__ up, const int* __restrict__ down,
                  const int* __restrict__ list, const int* __restrict__ counts, int k,
                  int* __restrict__ res, int h, int w, int nd, float ts, float th) {
  extern __shared__ int hist_all[];
  const int n = counts[k];
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  int* hist = hist_all + (threadIdx.x >> 5) * nd;
  for (int d = lane; d < nd; d += 32) hist[d] = 0;
  __syncwarp();
  for (long long t = (long long)blockIdx.x * warps + (threadIdx.x >> 5); t < n;
       t += (long long)gridDim.x * warps) {
    const int p = __ldg(list + t);
    const int y = p / w, x = p - y * w;
    const int y0 = y - min(max(__ldg(up + p), 0), y);
    const int y1 = y + min(max(__ldg(down + p), 0), h - 1 - y);
    for (int yy = y0; yy <= y1; ++yy) {
      const int q = yy * w;
      const uint32_t s = __ldg(spans + q + x);
      const int hi = (int)(s >> 16);
      for (int c = (int)(s & 0xffffu) + lane; c - lane <= hi; c += 32) {
        const int b = c <= hi ? __ldg(bins + q + c) : -1;
        const int before = __shfl_up_sync(FULL, b, 1);
        const bool head = lane == 0 || b != before;
        const unsigned heads = __ballot_sync(FULL, head);
        if (head && b >= 0) {
          const unsigned after = heads & ~((2u << lane) - 1u);
          atomicAdd(hist + b, (after ? __ffs(after) - 1 : 32) - lane);
        }
      }
    }
    __syncwarp();
    int total = 0, best = -1, at = 0;
    for (int d = lane; d < nd; d += 32) {
      const int v = hist[d];
      hist[d] = 0;
      total += v;
      if (v > best) best = v, at = d;
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      total += __shfl_xor_sync(FULL, total, o);
      const int ob = __shfl_xor_sync(FULL, best, o), oa = __shfl_xor_sync(FULL, at, o);
      if (ob > best || (ob == best && oa < at)) best = ob, at = oa;
    }
    if (lane == 0) {
      const float tf = __int2float_rn(total);
      res[t] = (tf > ts && __int2float_rn(best) > __fmul_rn(th, tf)) ? at : -1;
    }
    __syncwarp();
  }
}

// Iteration k's targets: the filled ones written (value and bin), the rest
// listed in `next` for iteration k + 1.  A value equal to `invalid` leaves
// its pixel invalid: it stays a target and does not vote.
__global__ void __launch_bounds__(VOTE_THREADS)
vote_apply_kernel(float* __restrict__ out, int16_t* __restrict__ bins,
                  const int* __restrict__ list, const int* __restrict__ res,
                  int* __restrict__ next, int* __restrict__ counts, int k, float invalid) {
  const int n = counts[k];
  for (long long t0 = (long long)blockIdx.x * VOTE_THREADS; t0 < n;
       t0 += (long long)gridDim.x * VOTE_THREADS) {
    const long long t = t0 + threadIdx.x;
    bool keep = false;
    int p = 0;
    if (t < n) {
      p = list[t];
      const int b = res[t];
      keep = true;
      if (b >= 0) {
        const float v = (float)b;
        out[p] = v;
        if (v != invalid) {
          bins[p] = (int16_t)b;
          keep = false;
        }
      }
    }
    list_append(keep, p, next, counts + k + 1);
  }
}

// The count kernel's warps a block: as many of 8 as fit their bins in the
// static 48 KB (at most 1536 disparities for 8), down to one warp a block.
int count_warps(int nd) {
  const int fit = VOTE_STATIC_SHARED / (4 * nd);
  return fit < 1 ? 1 : (fit > VOTE_WARPS ? VOTE_WARPS : fit);
}

// The words of a call's target counts: num_iters + 1, rounded up to 4.
long long vote_count_words(int num_iters) { return (num_iters + 4) / 4 * 4; }

}  // namespace

// Iterative region voting of disp float32 [h, w] into out (the same shape,
// another buffer), on `stream`: num_iters >= 1 iterations over the cross
// regions of the int32 [h, w] arms (left, right, up, down), nd disparities
// (1 <= nd <= 32767), the thresholds ts and th, invalid the value of an
// invalid pixel.  scratch, int32 words: num_iters + 1 target counts (rounded
// up to 4 words), h * w packed spans, two lists of h * w targets, h * w
// decisions, then h * w int16 bins; counts[k] is iteration k's target count
// after the call.  All contiguous on the current device; h * w < 2^31, w <=
// 65536.  Returns a cudaError_t code.
extern "C" int region_voting_f32(const void* disp, const void* left, const void* right,
                                 const void* up, const void* down, int h, int w, int nd,
                                 float ts, float th, int num_iters, float invalid, void* out,
                                 void* scratch, void* stream) {
  if (h < 1 || w < 1 || w > 65536 || (long long)h * w >= (1LL << 31) || nd < 1 ||
      nd > 32767 || num_iters < 1 || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  int device = 0, sm_count = 0;
  cudaError_t err = current_device(&device, &sm_count);
  if (err != cudaSuccess) return (int)err;
  static std::atomic<bool> sized[MAX_DEVICES];  // per device, false at first
  err = allow_shared_bytes(sized[device], vote_count_kernel, VOTE_SHARED_LIMIT);
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)h * w;
  int* counts = (int*)scratch;
  uint32_t* spans = (uint32_t*)(counts + vote_count_words(num_iters));
  int* lists[2] = {(int*)(spans + n), (int*)(spans + 2 * n)};
  int* res = (int*)(spans + 3 * n);
  int16_t* bins = (int16_t*)(spans + 4 * n);
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;

  const int warps = count_warps(nd);
  const size_t shared = (size_t)warps * nd * sizeof(int);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, vote_count_kernel, warps * 32,
                                                      shared);
  if (err != cudaSuccess) return (int)err;
  const long long flat = (n + VOTE_THREADS - 1) / VOTE_THREADS;
  const unsigned resident = (unsigned)sm_count * 8;  // prep / apply blocks
  const unsigned prep_blocks = (unsigned)(flat < resident ? flat : resident);
  const long long warp_blocks = (n + warps - 1) / warps;
  const long long count_cap = (long long)sm_count * (per_sm > 0 ? per_sm : 1);
  const unsigned count_blocks = (unsigned)(warp_blocks < count_cap ? warp_blocks : count_cap);

  err = cudaMemsetAsync(counts, 0, (num_iters + 1) * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  vote_prep_kernel<<<prep_blocks, VOTE_THREADS, 0, s>>>(
      (const float*)disp, (const int*)left, (const int*)right, o, bins, spans, lists[0],
      counts, h, w, nd, invalid);
  for (int k = 0; k < num_iters; ++k) {
    vote_count_kernel<<<count_blocks, warps * 32, shared, s>>>(
        bins, spans, (const int*)up, (const int*)down, lists[k & 1], counts, k, res, h, w, nd,
        ts, th);
    vote_apply_kernel<<<prep_blocks, VOTE_THREADS, 0, s>>>(o, bins, lists[k & 1], res,
                                                           lists[(k + 1) & 1], counts, k,
                                                           invalid);
  }
  return (int)cudaGetLastError();
}
