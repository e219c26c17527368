// Banded scanline passes for Hopper (sm_90a): one directional pass of the
// 4-path scanline over a band of path steps, continued from a carry that the
// neighbouring band handed over (the streamed executor,
// stereo_match_traditional_tpu_torch/parallel/streamed.py).
//
// Replaces no Pallas kernel: the JAX package runs these passes with lax.scan
// (stereo_match_traditional_tpu/ops/scanline.py:126 directional_pass_banded,
// :266 canonical_pass_banded).  The plain versions are the port's
// ops/scanline.py functions of the same names.  One template, two C entries:
// scanline_banded_f32 (the legacy family, a penalty p2 a (step, lane)) and
// scanline_banded_canonical_f32 (the canonical family, a penalty scale a
// (step, disparity, lane)).
//
//   out(t, d) = c(t, d) + min(prev(d), prev(d-1) + P1, prev(d+1) + P1,
//                             prev_min + P2) - prev_min
//
// with +inf at d = -1 and d = D; legacy: P1 = p1, P2 = p2(t, m), and with
// dm1 = 0 the reference's vertical quirk l2 = prev(d) + P1; canonical:
// P1 = p1_base * s(t, d, m), P2 = p2_base * s(t, d, m).  The operations are
// the plain version's, in its order, each rounded once (__fadd_rn, __fsub_rn,
// __fmul_rn: nvcc contracts no FMA through them), and a minimum is exact in
// any order, so the kernel equals the plain version bit for bit.
//
// Layout.  cost, the penalties and out are read and written through three
// strides each (step, disparity, lane; in floats), so one kernel runs the
// vertical pass of a [D, t, W] band (steps along rows, lanes along columns)
// and the horizontal one (steps along columns, lanes along rows) without a
// transposed copy.  A negative step stride, from a base at the path's first
// step, runs a path backwards.  The carry (prev [D, M], prev_min [M]) is read
// at the start and written at the end; reset is the one path step before
// which the carry is zero (-1: none).
//
// Design (simple first): a block takes 32 consecutive lanes, one a thread of
// each warp, so that the loads and stores of the vertical pass are coalesced
// along the lanes; the block's warps cover the disparities, VPT neighbouring
// ones a thread, held in registers.  Each step reads prev(d +- 1) across a
// thread's chunk edges and the previous step's minimum from shared memory
// (double-buffered by step), and reduces the new minimum over the warps in
// shared memory: two barriers a step.  The next step's inputs are loaded
// before the current step's arithmetic.
//
// What bounds it: a step is a chain of two barriers and a shared-memory
// reduction, so the pass is latency-bound at about a step's round trip times
// the path length; the least time the card could take is the volume read and
// written once (8 bytes a value, plus the penalties).  The horizontal pass's
// lanes are rows, so its loads are not coalesced (32 sectors a warp load):
// the streamed executor runs its horizontal passes, whose rows are whole
// paths, with the direct kernels' horizontal design instead
// (scanline_horizontal_band_f32 in scanline.cu,
// scanline_canonical_horizontal_band_f32 in scanline_canonical.cu).
// Limits: 1 <= D <= 256 (16 disparities a thread, 16 warps); offsets are
// 64-bit.
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 32;       // lanes a block, one a thread of each warp
constexpr int MAX_GROUPS = 16;  // warps a block: disparity groups of VPT values

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

template <int VPT, bool CANON>
__global__ void __launch_bounds__(LANES * MAX_GROUPS)
banded_kernel(const float* __restrict__ cost, long long cs_t, long long cs_d, long long cs_m,
              const float* __restrict__ pen, long long ps_t, long long ps_d, long long ps_m,
              float* __restrict__ out, long long os_t, long long os_d, long long os_m,
              const float* __restrict__ cin, const float* __restrict__ cin_min,
              float* __restrict__ cout, float* __restrict__ cout_min, int n_steps,
              int d_range, int m_lanes, float p1, float p2, int reset, int dm1) {
  __shared__ float e_lo[2][MAX_GROUPS][LANES];   // prev at a group's first disparity
  __shared__ float e_hi[2][MAX_GROUPS][LANES];   // ... and at its last
  __shared__ float part[MAX_GROUPS][LANES];      // a group's minimum of the step
  __shared__ float pmin[2][LANES];               // the step's minimum over d

  const int lane = threadIdx.x;
  const int g = threadIdx.y;
  const int ng = blockDim.y;
  const int m = blockIdx.x * LANES + lane;
  const bool live = m < m_lanes;
  const int d0 = g * VPT;
  const float INF = inf_f();

  float prev[VPT];
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    const int d = d0 + v;
    prev[v] = live && d < d_range ? cin[(long long)d * m_lanes + m] : INF;
  }
  e_lo[0][g][lane] = prev[0];
  e_hi[0][g][lane] = prev[VPT - 1];
  if (g == 0) pmin[0][lane] = live ? cin_min[m] : 0.0f;

  // step k's inputs: c[v] = cost(k, d0 + v, m); s[v] the penalty (legacy: s[0])
  float c[VPT], s[VPT];
  auto load = [&](int k, float (&cv)[VPT], float (&sv)[VPT]) {
    const long long ct = (long long)k * cs_t + (long long)m * cs_m;
    const long long pt = (long long)k * ps_t + (long long)m * ps_m;
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      const int d = d0 + v;
      const bool ok = live && d < d_range;
      cv[v] = ok ? cost[ct + (long long)d * cs_d] : 0.0f;
      if (CANON) sv[v] = ok ? pen[pt + (long long)d * ps_d] : 0.0f;
      else sv[v] = v == 0 && live ? pen[pt] : 0.0f;
    }
  };
  load(0, c, s);
  __syncthreads();

  int buf = 0;
  for (int k = 0; k < n_steps; ++k) {
    float cn[VPT] = {}, sn[VPT] = {};
    if (k + 1 < n_steps) load(k + 1, cn, sn);
    float left = g > 0 ? e_hi[buf][g - 1][lane] : INF;        // prev(d0 - 1)
    float right = g + 1 < ng ? e_lo[buf][g + 1][lane] : INF;  // prev(d0 + VPT)
    float pm = pmin[buf][lane];
    if (k == reset) {   // the path restarts: a zero carry
#pragma unroll
      for (int v = 0; v < VPT; ++v) prev[v] = d0 + v < d_range ? 0.0f : INF;
      left = g > 0 ? 0.0f : INF;
      right = g + 1 < ng ? 0.0f : INF;
      pm = 0.0f;
    }
    float o[VPT];
    float lmin = INF;
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      if (d0 + v < d_range) {
        const float lo = v > 0 ? prev[v - 1] : left;
        const float hi = v + 1 < VPT ? prev[v + 1] : right;
        const float p1c = CANON ? __fmul_rn(p1, s[v]) : p1;
        const float p2c = CANON ? __fmul_rn(p2, s[v]) : s[0];
        const float l1 = prev[v];
        const float l2 = __fadd_rn(dm1 ? lo : prev[v], p1c);
        const float l3 = __fadd_rn(hi, p1c);
        const float l4 = __fadd_rn(pm, p2c);
        o[v] = __fsub_rn(__fadd_rn(c[v], fminf(fminf(l1, l2), fminf(l3, l4))), pm);
        lmin = fminf(lmin, o[v]);
      } else {
        o[v] = INF;
      }
    }
    if (live && out != nullptr) {
      const long long ot = (long long)k * os_t + (long long)m * os_m;
#pragma unroll
      for (int v = 0; v < VPT; ++v) {
        if (d0 + v < d_range) out[ot + (long long)(d0 + v) * os_d] = o[v];
      }
    }
#pragma unroll
    for (int v = 0; v < VPT; ++v) prev[v] = o[v];
    buf ^= 1;
    e_lo[buf][g][lane] = prev[0];
    e_hi[buf][g][lane] = prev[VPT - 1];
    part[g][lane] = lmin;
    __syncthreads();
    if (g == 0) {
      float mn = part[0][lane];
      for (int j = 1; j < ng; ++j) mn = fminf(mn, part[j][lane]);
      pmin[buf][lane] = mn;
    }
    __syncthreads();
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      c[v] = cn[v];
      s[v] = sn[v];
    }
  }
  if (!live) return;
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    const int d = d0 + v;
    if (d < d_range) cout[(long long)d * m_lanes + m] = prev[v];
  }
  if (g == 0) cout_min[m] = pmin[buf][lane];
}

template <int VPT, bool CANON>
cudaError_t launch_vpt(const float* cost, const long long* cs, const float* pen,
                       const long long* ps, float* out, const long long* os, const float* cin,
                       const float* cin_min, float* cout, float* cout_min, int n_steps,
                       int d_range, int m_lanes, float p1, float p2, int reset, int dm1,
                       cudaStream_t stream) {
  const dim3 block(LANES, (d_range + VPT - 1) / VPT);
  const dim3 grid((m_lanes + LANES - 1) / LANES);
  banded_kernel<VPT, CANON><<<grid, block, 0, stream>>>(
      cost, cs[0], cs[1], cs[2], pen, ps[0], ps[1], ps[2], out, os[0], os[1], os[2], cin,
      cin_min, cout, cout_min, n_steps, d_range, m_lanes, p1, p2, reset, dm1);
  return cudaGetLastError();
}

template <bool CANON>
int launch(const void* cost, long long cs_t, long long cs_d, long long cs_m, const void* pen,
           long long ps_t, long long ps_d, long long ps_m, void* out, long long os_t,
           long long os_d, long long os_m, const void* carry, const void* carry_min,
           void* carry_out, void* carry_min_out, int n_steps, int d_range, int m_lanes,
           float p1, float p2, int reset, int dm1, void* stream) {
  if (n_steps < 1 || d_range < 1 || d_range > LANES / 2 * MAX_GROUPS || m_lanes < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const long long cs[3] = {cs_t, cs_d, cs_m};
  const long long ps[3] = {ps_t, ps_d, ps_m};
  const long long os[3] = {os_t, os_d, os_m};
  const float* c = (const float*)cost;
  const float* p = (const float*)pen;
  float* o = (float*)out;
  const float* ci = (const float*)carry;
  const float* cm = (const float*)carry_min;
  float* co = (float*)carry_out;
  float* com = (float*)carry_min_out;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (d_range <= MAX_GROUPS) {
    err = launch_vpt<1, CANON>(c, cs, p, ps, o, os, ci, cm, co, com, n_steps, d_range,
                               m_lanes, p1, p2, reset, dm1, st);
  } else if (d_range <= 2 * MAX_GROUPS) {
    err = launch_vpt<2, CANON>(c, cs, p, ps, o, os, ci, cm, co, com, n_steps, d_range,
                               m_lanes, p1, p2, reset, dm1, st);
  } else if (d_range <= 4 * MAX_GROUPS) {
    err = launch_vpt<4, CANON>(c, cs, p, ps, o, os, ci, cm, co, com, n_steps, d_range,
                               m_lanes, p1, p2, reset, dm1, st);
  } else if (d_range <= 8 * MAX_GROUPS) {
    err = launch_vpt<8, CANON>(c, cs, p, ps, o, os, ci, cm, co, com, n_steps, d_range,
                               m_lanes, p1, p2, reset, dm1, st);
  } else {
    err = launch_vpt<16, CANON>(c, cs, p, ps, o, os, ci, cm, co, com, n_steps, d_range,
                                m_lanes, p1, p2, reset, dm1, st);
  }
  return (int)err;
}

}  // namespace

// Launch on `stream`.  cost and out: [n_steps, d_range, m_lanes] float32 at the
// given strides (in floats; a step stride may be negative, from a base at the
// path's first step); out may be null (only the carry is wanted).  p2: the
// penalty a (step, lane), at strides (p2_t, p2_m).  carry / carry_min: the
// incoming prev [d_range, m_lanes] and prev_min [m_lanes], contiguous;
// carry_out / carry_min_out receive the outgoing ones (they may be the same
// memory).  reset: the path step before which the carry is zero, or -1.
// dm1 = 0 is the reference's vertical quirk (l2 = prev(d) + p1).
// 1 <= d_range <= 256.  Returns cudaGetLastError() after the launch.
extern "C" int scanline_banded_f32(const void* cost, long long cs_t, long long cs_d,
                                   long long cs_m, const void* p2, long long p2_t, long long p2_m,
                                   void* out, long long os_t, long long os_d, long long os_m,
                                   const void* carry, const void* carry_min, void* carry_out,
                                   void* carry_min_out, int n_steps, int d_range, int m_lanes,
                                   float p1, int reset, int dm1, void* stream) {
  return launch<false>(cost, cs_t, cs_d, cs_m, p2, p2_t, 0, p2_m, out, os_t, os_d, os_m, carry,
                       carry_min, carry_out, carry_min_out, n_steps, d_range, m_lanes, p1, 0.0f,
                       reset, dm1, stream);
}

// The canonical family: scale, the penalty scale a (step, disparity, lane),
// at strides (sc_t, sc_d, sc_m); P1 = p1_base * scale, P2 = p2_base * scale.
// The rest as scanline_banded_f32's (l2 reads prev(d - 1)).
extern "C" int scanline_banded_canonical_f32(
    const void* cost, long long cs_t, long long cs_d, long long cs_m, const void* scale,
    long long sc_t, long long sc_d, long long sc_m, void* out, long long os_t, long long os_d,
    long long os_m, const void* carry, const void* carry_min, void* carry_out,
    void* carry_min_out, int n_steps, int d_range, int m_lanes, float p1_base, float p2_base,
    int reset, void* stream) {
  return launch<true>(cost, cs_t, cs_d, cs_m, scale, sc_t, sc_d, sc_m, out, os_t, os_d, os_m,
                      carry, carry_min, carry_out, carry_min_out, n_steps, d_range, m_lanes,
                      p1_base, p2_base, reset, 1, stream);
}
