// The canonical cross aggregation of the AD-Census family, for Hopper
// (sm_90a): cross_support_f32 and cross_aggregate_f32.
//
// Replaces no Pallas kernel: the JAX package leaves
// `stereo_match_traditional_tpu/ops/aggregate.py:792` `cross_aggregate` to
// XLA.  The port's plain version (`ops/aggregate.py`
// `_cross_aggregate_plain`) runs each pass as a float64 prefix sum along the
// axis and two gathers a pixel, rounded to float32 (`_span_sum`), some 300
// PyTorch kernels a view and four iterations.  An iteration is two span sums
// inside each pixel's arms, horizontal then vertical (or the other way, the
// order flipping each iteration), divided by the pixel's support.
//   * cross_support_f32, once a call: the arms clamped into [0, cap] and
//     packed into a word a pixel (those outside counted into a device word,
//     as the rect walker does) and both supports, integer counts exact in
//     float32.
//   * cross_aggregate_f32, one launch an iteration: the span walker.  A
//     block of 1024 threads owns one slice's strip of 128 lanes (columns
//     horizontally first, rows vertically first) and walks along the other
//     axis, R walk rows a step: (a) each row's strip and its halo of `cap`
//     lanes a side arrive by cp.async one step ahead and a warp a row takes
//     their float64 prefix from the halo's first lane; (b) a thread an item
//     picks the two ends of its pixel's first-pass span and rounds to
//     float32, as the plain version does after each pass; (c) a thread a
//     lane adds the rows to its lane's running float64 sum along the walk
//     (the plain version's cumsum, in its order) into a ring of 2 cap + 1 + R
//     table rows in shared memory; (d) every row whose span of table rows is
//     in the ring is written: two ring picks, one rounding, __fdiv_rn by the
//     support.  The first pass's sums never reach device memory.  Walking
//     along the columns, vertically first, reads each image row's run of a
//     step as whole 128-byte lines at R = 32.  Caps above 67 take strips of
//     32 lanes (the ring of 2 cap + 1 + R rows of a wider strip does not fit).
// The AD-Census costs sum exactly in float64 (`_sat`'s note), so the first
// iteration equals the plain version bit for bit; later iterations sum
// float32 means in prefixes that start at the halo here and at lane 0
// there, so a sum may round the other way near a float32 boundary, and a
// sum of tiny means (below ~1e-6) carries the prefixes' float64 error
// (~1e-13) in more of its float32 ulps.  Bound: bytes, the volume in and
// out once and the arms in (0.144 ms a view and four iterations at KITTI
// size); the walker moves each value ~1.4 times in and once out an
// iteration, and, as the rect walker, is bound by its steps, not its bytes.
// The source is apart from aggregate.cu so that its walker instances
// compile beside that file's kernels, not after them (the build starts one
// nvcc a source).
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "walker.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

constexpr int CROSS_MAX_SPAN = 255;  // the largest cap (the canonical arms' own bound)

__host__ __device__ constexpr int ilog2(int v) { return v > 1 ? 1 + ilog2(v >> 1) : 0; }

// The first pass's lanes a strip reads: its own S and `span` each side,
// within the `across` lanes of the image.
__host__ __device__ constexpr int cross_nin(int S, int span, int across) {
  return S + 2 * span < across ? S + 2 * span : across;
}
// The ring's table rows: 2 span + 1 + R, or the walk's whole table where
// that is fewer (no slot is then reused).
__host__ __device__ constexpr int cross_ring_rows(int R, int span, int walk) {
  return 2 * span + 1 + R < walk + 1 ? 2 * span + 1 + R : walk + 1;
}
// The walker's shared memory: the ring of second-pass prefix rows (S + 1
// doubles a row), R first-pass prefix rows (nin + 1 doubles, odd), two
// stages of R input rows (nin floats, odd), R rows of first-pass sums (S + 1
// floats).  The odd and S + 1 strides keep a warp that reads down a column
// (the vertical-first layout) off a single bank.
__host__ __device__ constexpr size_t cross_shared_bytes(int S, int R, int span, int walk,
                                                        int across) {
  return (size_t)cross_ring_rows(R, span, walk) * (S + 1) * sizeof(double) +
         (size_t)R * ((cross_nin(S, span, across) + 1) | 1) * sizeof(double) +
         (size_t)2 * R * (cross_nin(S, span, across) | 1) * sizeof(float) +
         (size_t)R * (S + 1) * sizeof(float);
}
// The largest cap whose walker fits a block at strip S and step R, any shape.
__host__ __device__ constexpr int cross_max_span(int S, int R) {
  int span = CROSS_MAX_SPAN;
  while (span > 0 && cross_shared_bytes(S, R, span, 1 << 30, 1 << 30) > WALK_SHARED_LIMIT) --span;
  return span;
}

// One pixel's arms clamped into [0, span], a byte each (left, right, up,
// down from the low byte), and the two support counts of the plain version
// (`ops/aggregate.py` `cross_aggregate`: the span sums of a plane of ones,
// horizontal then vertical and vertical then horizontal; integers below
// 2^18, exact in float32) from the clamped arms of the pixels they cover.
// The arms outside [0, span] are added to *over_cap.  A thread a pixel of a
// 32 x 8 block; each count walks at most 2 span + 1 neighbours' arms.
__global__ void __launch_bounds__(256)
cross_support_kernel(const int* __restrict__ arm_l, const int* __restrict__ arm_r,
                     const int* __restrict__ arm_u, const int* __restrict__ arm_d, int h, int w,
                     int span, uint32_t* __restrict__ packed, float* __restrict__ sup_h,
                     float* __restrict__ sup_v, int* __restrict__ over_cap) {
  const int j = blockIdx.x * 32 + threadIdx.x, i = blockIdx.y * 8 + threadIdx.y;
  auto clamp_arm = [span](int a) { return min(max(a, 0), span); };
  int over = 0;
  if (i < h && j < w) {
    const long long p = (long long)i * w + j;
    const int a[4] = {__ldg(arm_l + p), __ldg(arm_r + p), __ldg(arm_u + p), __ldg(arm_d + p)};
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      over += clamp_arm(a[k]) != a[k];
      word |= (uint32_t)clamp_arm(a[k]) << (8 * k);
    }
    packed[p] = word;
    int sh = 0;  // rows i - up .. i + down of each row's horizontal span
    const int t0 = max(i - clamp_arm(a[2]), 0), t1 = min(i + clamp_arm(a[3]), h - 1);
    for (int t = t0; t <= t1; ++t) {
      const long long q = (long long)t * w + j;
      sh += min(j + clamp_arm(__ldg(arm_r + q)), w - 1) - max(j - clamp_arm(__ldg(arm_l + q)), 0);
    }
    int sv = 0;  // columns j - left .. j + right of each column's vertical span
    const int u0 = max(j - clamp_arm(a[0]), 0), u1 = min(j + clamp_arm(a[1]), w - 1);
    for (int u = u0; u <= u1; ++u) {
      const long long q = (long long)i * w + u;
      sv += min(i + clamp_arm(__ldg(arm_d + q)), h - 1) - max(i - clamp_arm(__ldg(arm_u + q)), 0);
    }
    sh += t1 - t0 + 1;  // the + 1 of each row's count
    sv += u1 - u0 + 1;
    sup_h[p] = (float)sh;
    sup_v[p] = (float)sv;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) over += __shfl_down_sync(FULL, over, o);
  if (threadIdx.x == 0 && over) atomicAdd(over_cap, over);
}

// One iteration of the cross aggregation of slice blockIdx.y, a strip of S
// lanes a block (the header describes the walk).  H: horizontal first, the
// walk goes down the rows (walk = h) and the lanes are columns (across = w);
// else vertical first, the walk goes along the columns and the lanes are
// rows.  Walk row a, lane b is pixel (a, b) or (b, a).  The first pass sums
// along the lanes inside arms (left, right) or (up, down), the second along
// the walk inside the other two.
//   Table row t of the second pass (the float64 sum of walk rows [0, t) of a
// lane, t = 0 .. walk) lives in ring slot t % ring_rows (slots tracked by
// increments).  After table row T is built, output row r needs table rows
// max(r - up, 0) .. min(r + down + 1, walk): the rows r < T - span are
// written (all that are left once T = walk), and the ring, 2 span + 1 + R
// rows, still holds the oldest row they need, r - span >= T - R - 2 span.
// The next step's first barrier keeps its rows from overwriting the ring
// before the outputs are read.  Each step's input rows arrive by cp.async one
// step ahead.
template <bool H, int S, int R, int NT>
__global__ void __launch_bounds__(NT, 1)
cross_walker_kernel(const float* __restrict__ x, int h, int w, int span,
                    const uint32_t* __restrict__ arms, const float* __restrict__ sup,
                    float* __restrict__ out) {
  constexpr int LOG_S = ilog2(S), LOG_R = ilog2(R);
  constexpr int RS = S + 1;          // row stride of the ring and of the sums
  constexpr int ITEMS = R * S / NT;  // (walk row, lane) items a thread in a step
  constexpr int SH1 = H ? 0 : 16;    // the first pass's arms: (left, right) or (up, down)
  constexpr int SH2 = H ? 16 : 0;    // the second pass's
  // a scan lane's inputs, at most
  constexpr int PER = ((S + 2 * cross_max_span(S, R) + 31) / 32) | 1;
  static_assert(S == 1 << LOG_S && R == 1 << LOG_R && ITEMS * NT == R * S && NT / 32 >= R &&
                    NT >= S,
                "strip, step and block shapes");
  extern __shared__ double cross_smem[];
  const int walk = H ? h : w, across = H ? w : h;
  const int ring_rows = cross_ring_rows(R, span, walk);
  const int nin_max = cross_nin(S, span, across);
  const int PS = (nin_max + 1) | 1, SS = nin_max | 1;
  double* ring = cross_smem;                                   // [ring_rows][RS]
  double* pre = ring + (size_t)ring_rows * RS;                 // [R][PS]
  float* stage = reinterpret_cast<float*>(pre + (size_t)R * PS);  // [2][R][SS]
  float* sums = stage + 2 * R * SS;                            // [R][RS]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b0 = blockIdx.x * S, blo = max(b0 - span, 0);
  const int nin = min(b0 + S + span, across) - blo, lanes = min(S, across - b0);
  const long long plane = (long long)h * w;
  const float* xs = x + (long long)blockIdx.y * plane;
  float* os = out + (long long)blockIdx.y * plane;
  const int steps = (walk + R - 1) / R;
  auto at = [w](int a, int b) -> long long {
    return H ? (long long)a * w + b : (long long)b * w + a;
  };
  // item e of a step's R x S (walk row, lane) grid: lanes fastest where a
  // walk row is contiguous (H), walk rows fastest where a lane's run is
  auto item = [](int e, int& r, int& c) {
    if (H) {
      r = e >> LOG_S;
      c = e & (S - 1);
    } else {
      r = e & (R - 1);
      c = e >> LOG_R;
    }
  };
  // H: this thread's first (row, column) of a step's rows x nin inputs and
  // its stride in rows and columns
  const int fr = tid / nin, fc = tid - fr * nin;
  const int dr = NT / nin, dc = NT - dr * nin;
  auto fetch = [&](int step) {
    if (step < steps) {
      float* st = stage + (step & 1) * R * SS;
      const int a0 = step * R, rows = min(R, walk - a0);
      if (H) {
        const float* src = xs + (long long)a0 * w + blo;
        for (int r = fr, c = fc; r < rows;) {
          cp_async4(st + r * SS + c, src + (long long)r * w + c);
          r += dr;
          c += dc;
          if (c >= nin) {
            c -= nin;
            ++r;
          }
        }
      } else {
        const float* src = xs + (long long)blo * w + a0;
        for (int e = tid; e < nin * R; e += NT) {
          const int r = e & (R - 1), c = e >> LOG_R;
          if (r < rows) cp_async4(st + r * SS + c, src + (long long)c * w + r);
        }
      }
    }
    cp_async_commit();
  };
  // output row r, lane c from its arms' word and its support
  auto emit = [&](int r, int c, int done, int slot_done, uint32_t word, float support) {
    const int lo = max(r - (int)((word >> SH2) & 0xffu), 0);
    const int hi = min(r + (int)((word >> (SH2 + 8)) & 0xffu) + 1, walk);
    int sr = slot_done + (r - done);
    if (sr >= ring_rows) sr -= ring_rows;
    int s0 = sr - (r - lo);
    if (s0 < 0) s0 += ring_rows;
    int s1 = sr + (hi - r);
    if (s1 >= ring_rows) s1 -= ring_rows;
    const float total = (float)(ring[s1 * RS + c] - ring[s0 * RS + c]);
    os[at(r, b0 + c)] = __fdiv_rn(total, support);
  };

  for (int c = tid; c < S; c += NT) ring[c] = 0.0;  // table row 0
  double acc = 0.0;  // thread c < S: the running sum down lane c
  fetch(0);
  int done = 0;       // output rows written
  int slot_t0 = 1;    // the slot of this step's first table row
  int slot_done = 0;  // the slot of table row `done`
  for (int step = 0; step < steps; ++step) {
    fetch(step + 1);
    const int a0 = step * R, nrows = min(R, walk - a0);
    const int last = a0 + nrows;  // this step builds table rows a0 + 1 .. last
    const int upto = last == walk ? walk : max(last - span, 0);  // then writes [done, upto)
    // ahead of the barrier: the arms of the step's first-pass items and of
    // its first outputs, and their supports
    uint32_t word[ITEMS], out_word[ITEMS];
    float out_sup[ITEMS];
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      int r, c;
      item(q * NT + tid, r, c);
      word[q] = r < nrows && c < lanes ? __ldg(arms + at(a0 + r, b0 + c)) : 0u;
      const bool o = done + r < upto && c < lanes;
      out_word[q] = o ? __ldg(arms + at(done + r, b0 + c)) : 0u;
      out_sup[q] = o ? __ldg(sup + at(done + r, b0 + c)) : 1.0f;
    }
    cp_async_wait<1>();
    __syncthreads();
    // (a) the first pass's prefix of walk row `warp`, from 0 at lane blo: a
    // lane sums a run of inputs (an odd count: no bank conflicts) held in
    // registers, a warp scan of the runs, the lane's run written out
    if (warp < nrows) {
      const float* src = stage + (step & 1) * R * SS + warp * SS;
      double* row = pre + warp * PS;
      const int per = ((nin + 31) >> 5) | 1;
      const int lo = min(lane * per, nin), hi = min(lo + per, nin);
      float v[PER];
      double part = 0.0;
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        v[q] = lo + q < hi ? src[lo + q] : 0.0f;
        part += (double)v[q];
      }
      double incl = part;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double u = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += u;
      }
      const double before = __shfl_up_sync(FULL, incl, 1);
      double run = lane == 0 ? 0.0 : before;
#pragma unroll
      for (int q = 0; q < PER; ++q)
        if (lo + q < hi) {
          run += (double)v[q];
          row[lo + q + 1] = run;
        }
      if (lane == 0) row[0] = 0.0;
    }
    __syncthreads();
    // (b) the first pass's span sums, rounded to float32
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      int r, c;
      item(q * NT + tid, r, c);
      if (r < nrows && c < lanes) {
        const int b = b0 + c;
        const int lo = max(b - (int)((word[q] >> SH1) & 0xffu), 0) - blo;
        const int hi = min(b + (int)((word[q] >> (SH1 + 8)) & 0xffu) + 1, across) - blo;
        const double* row = pre + r * PS;
        sums[r * RS + c] = (float)(row[hi] - row[lo]);
      }
    }
    __syncthreads();
    // (c) the second pass's table rows: down each lane, one row after
    // another (the plain version's cumsum along the walk)
    if (tid < S) {
      float v[R];
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = r < nrows ? sums[r * RS + tid] : 0.0f;
      int slot = slot_t0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < nrows) {
          acc = acc + (double)v[r];
          ring[slot * RS + tid] = acc;
        }
        if (++slot == ring_rows) slot = 0;
      }
    }
    __syncthreads();
    // (d) output rows [done, upto), R at a time
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      int r, c;
      item(q * NT + tid, r, c);
      if (done + r < upto && c < lanes) emit(done + r, c, done, slot_done, out_word[q], out_sup[q]);
    }
    for (int base = done + R; base < upto; base += R) {
#pragma unroll
      for (int q = 0; q < ITEMS; ++q) {
        int r, c;
        item(q * NT + tid, r, c);
        if (base + r < upto && c < lanes) {
          const long long p = at(base + r, b0 + c);
          emit(base + r, c, done, slot_done, __ldg(arms + p), __ldg(sup + p));
        }
      }
    }
    slot_done += upto - done;
    if (slot_done >= ring_rows) slot_done -= ring_rows;
    done = upto;
    slot_t0 += nrows;
    while (slot_t0 >= ring_rows) slot_t0 -= ring_rows;
  }
}

template <bool H, int S, int R, int NT>
cudaError_t launch_cross_walker(const float* x, int n, int h, int w, int span,
                                const uint32_t* arms, const float* sup, float* out, int device,
                                cudaStream_t s) {
  static std::atomic<bool> sized[MAX_DEVICES];  // per device, false at first
  if (!sized[device].load(std::memory_order_acquire)) {
    cudaError_t err = cudaFuncSetAttribute(cross_walker_kernel<H, S, R, NT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)WALK_SHARED_LIMIT);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(cross_walker_kernel<H, S, R, NT>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    sized[device].store(true, std::memory_order_release);
  }
  const int walk = H ? h : w, across = H ? w : h;
  const size_t bytes = cross_shared_bytes(S, R, span, walk, across);
  cross_walker_kernel<H, S, R, NT><<<dim3((across + S - 1) / S, (unsigned)n), NT, bytes, s>>>(
      x, h, w, span, arms, sup, out);
  return cudaGetLastError();
}

// The instance by the pass order and the cap alone: vertical first, 32 walk
// rows (columns) a step, so that each image row's run of a step is a whole
// 128-byte line, up to caps of 37 (measured 15 % faster than 16 rows at
// KITTI size on an H100; horizontal first gains nothing from it); else
// strips of 128 lanes (1024 threads, 16 rows a step) up to caps of 67, then
// of 32 lanes (256 threads, 8 rows a step) up to 255.  An instance takes no
// cap above its cross_max_span, whatever the shape: a short walk would fit
// a wider halo's ring in the block, but not the halo's inputs in its scan
// lanes' registers (PER).
template <bool H>
cudaError_t launch_cross(const float* x, int n, int h, int w, int span, const uint32_t* arms,
                         const float* sup, float* out, int device, cudaStream_t s) {
  static_assert(cross_max_span(32, 8) == CROSS_MAX_SPAN, "the narrowest strip takes every cap");
  if (!H && span <= cross_max_span(128, 32))
    return launch_cross_walker<false, 128, 32, 1024>(x, n, h, w, span, arms, sup, out, device, s);
  if (span <= cross_max_span(128, 16))
    return launch_cross_walker<H, 128, 16, 1024>(x, n, h, w, span, arms, sup, out, device, s);
  return launch_cross_walker<H, 32, 8, 256>(x, n, h, w, span, arms, sup, out, device, s);
}

}  // namespace

// The cross aggregation's per-call inputs, on `stream`: from the four int32
// [h, w] arms (left, right, up, down), each clamped into [0, span], the
// packed arms (uint32 [h, w], a byte each from the low byte) and the two
// float32 [h, w] supports, horizontal first (sup_h) and vertical first
// (sup_v); the arms outside [0, span] are added to the int32 *over_cap.
// 0 <= span <= 255, h * w < 2^31.  Returns a cudaError_t code.
extern "C" int cross_support_f32(const void* arm_l, const void* arm_r, const void* arm_u,
                                 const void* arm_d, int h, int w, int span, void* packed,
                                 void* sup_h, void* sup_v, void* over_cap, void* stream) {
  if (h < 1 || w < 1 || span < 0 || span > CROSS_MAX_SPAN || (long long)h * w >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cross_support_kernel<<<dim3((w + 31) / 32, (h + 7) / 8), dim3(32, 8), 0,
                         (cudaStream_t)stream>>>(
      (const int*)arm_l, (const int*)arm_r, (const int*)arm_u, (const int*)arm_d, h, w, span,
      (uint32_t*)packed, (float*)sup_h, (float*)sup_v, (int*)over_cap);
  return (int)cudaGetLastError();
}

// One iteration of the cross aggregation of every slice of vol [n, h, w]
// (float32, contiguous) into out (the same shape, another buffer), on
// `stream`: horizontal_first != 0 sums each row span, then each column span
// of those sums, and divides by sup (cross_support_f32's sup_h); else
// column spans first (sup_v).  packed: cross_support_f32's arms at the same
// span.  1 <= n <= 65535, 0 <= span <= 255.  Returns a cudaError_t code.
extern "C" int cross_aggregate_f32(const void* vol, long long n, int h, int w,
                                   const void* packed, const void* sup, int span,
                                   int horizontal_first, void* out, void* stream) {
  if (n < 1 || n > 65535 || h < 1 || w < 1 || span < 0 || span > CROSS_MAX_SPAN)
    return (int)cudaErrorInvalidValue;
  int device;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  const float* x = (const float*)vol;
  const uint32_t* a = (const uint32_t*)packed;
  const float* sp = (const float*)sup;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  return horizontal_first
             ? (int)launch_cross<true>(x, (int)n, h, w, span, a, sp, o, device, s)
             : (int)launch_cross<false>(x, (int)n, h, w, span, a, sp, o, device, s);
}
