// One direction of GATv2 segment attention, forward and backward, as device
// code (sm_90a, float32): the single-direction kernel's camera side
// (fused_attn.cu; the JAX package never takes it), the online softmax and
// residual store that the split walkers of attend_split.cuh share, and the
// per-edge backward formulas they run.
//
// Per segment s and head h, over the segment's edges e:
//   l_e = att_h . LeakyReLU(xl_e + xr_s),  alpha = softmax_s(l),
//   out_s = sum_e alpha_e xl_e                 (0 for an empty segment).
// Lane j of a warp holds feature j of a D-wide row (D <= 32), head j / C
// (C a power of two); per-head sums are lane shuffles (common.cuh). The
// online softmax (m, den, num) stays in registers, each edge row is read
// once. The camera side here is a block of NWARPS warps per segment over
// perm[ptr[s] .. ptr[s+1]): warp w takes every NWARPS-th edge from the
// w-th, and the warps' partial triples (or d xr sums) merge in shared
// memory in warp order. Its bound is the byte bound of attend_split.cuh's
// walkers, but a camera's block walks its ~40-1,300 edges one DRAM latency
// per row per warp, and a hub camera sets the launch's length: the dual
// core (fused_dual_attn.cu) walks both CSRs split instead, and so would
// this side if a path took it.
// No float atomics: results are bitwise reproducible on a given card.
#pragma once

#include "common.cuh"

namespace gasfm {

// The online softmax of one warp over rows perm[i] (i itself without perm),
// i = begin, begin + stride, ... < end.
__device__ __forceinline__ Online attend_walk(const float* __restrict__ xl,
                                              const int* __restrict__ perm, int begin, int end,
                                              int stride, int D, int C, float xr, float at,
                                              float slope, int lane) {
  const bool act = lane < D;
  Online s;
  s.init();
  for (int i = begin; i < end; i += stride) {
    const int e = perm == nullptr ? i : perm[i];
    const float x = act ? xl[(size_t)e * D + lane] : 0.f;
    s.push(group_sum(leaky_relu(x + xr, slope) * at, C), x);
  }
  return s;
}

// Write segment `seg`'s output row and, when m != NULL (under autograd), its
// per-head softmax max and denominator (S, H).
__device__ __forceinline__ void attend_store(const Online& s, int seg, int D, int C, int lane,
                                             float* __restrict__ out, float* __restrict__ m,
                                             float* __restrict__ den) {
  if (lane >= D) return;
  out[(size_t)seg * D + lane] = s.finish();
  if (m != nullptr && (lane & (C - 1)) == 0) {
    const int H = D / C;
    m[(size_t)seg * H + lane / C] = s.m;
    den[(size_t)seg * H + lane / C] = s.den;
  }
}

// Forward, a block of NWARPS warps over segment `seg`'s rows perm[ptr[seg]
// ..]. Every thread of the block must call it.
template <int NWARPS>
__device__ __forceinline__ void attend_segment_block(
    const float* __restrict__ xl, const float* __restrict__ xr, const float* __restrict__ att,
    const int* __restrict__ ptr, const int* __restrict__ perm, int seg, int D, int C,
    float slope, float* __restrict__ out, float* __restrict__ m, float* __restrict__ den) {
  __shared__ float sm[NWARPS][32], sd[NWARPS][32], sn[NWARPS][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool act = lane < D;
  const float q = act ? xr[(size_t)seg * D + lane] : 0.f;
  const float at = act ? att[lane] : 0.f;
  const Online s =
      attend_walk(xl, perm, ptr[seg] + warp, ptr[seg + 1], NWARPS, D, C, q, at, slope, lane);
  sm[warp][lane] = s.m;
  sd[warp][lane] = s.den;
  sn[warp][lane] = s.num;
  __syncthreads();
  if (warp == 0) {
    Online t;
    t.init();
    for (int w = 0; w < NWARPS; ++w) t.merge(sm[w][lane], sd[w][lane], sn[w][lane]);
    attend_store(t, seg, D, C, lane, out, m, den);
  }
}

// ---- backward ------------------------------------------------------------------
//
// With alpha_e = exp(l_e - m_s) / den_s from the forward's residuals and
// g = d out (this lane's feature):
//   d xl_e  = alpha_e g + dz_e,  dz_e = dl_e att leaky'(z_e),  z_e = xl_e + xr_s
//   dl_e    = alpha_e * sum_{c in h} g_c (xl_e,c - out_c)
//   d xr_s  = sum_e dz_e,        d att = sum_e dl_e leaky(z_e)
// The shift m carries no gradient (softmax shift invariance): it is read from
// the forward's residuals, never differentiated.
struct AttendBwdLane {
  float xr, at, g, o, mx, inv_den;
};

__device__ __forceinline__ AttendBwdLane attend_bwd_lane(
    const float* __restrict__ xr, const float* __restrict__ att,
    const float* __restrict__ out, const float* __restrict__ gout,
    const float* __restrict__ mrow, const float* __restrict__ drow, int seg, int D,
    int C, int lane) {
  AttendBwdLane r{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (lane < D) {
    const int H = D / C;
    r.xr = xr[(size_t)seg * D + lane];
    r.at = att[lane];
    r.g = gout[(size_t)seg * D + lane];
    r.o = out[(size_t)seg * D + lane];
    r.mx = mrow[(size_t)seg * H + lane / C];
    const float dn = drow[(size_t)seg * H + lane / C];
    r.inv_den = dn > 0.f ? 1.f / dn : 0.f;
  }
  return r;
}

// One edge of a segment: writes d xl, adds to the lane's d xr and d att sums.
__device__ __forceinline__ void attend_bwd_edge(const AttendBwdLane& q, float x, int C,
                                                float slope, bool act,
                                                float* __restrict__ dxl, float& dxr,
                                                float& datt) {
  const float z = x + q.xr;
  const float gz = leaky_relu(z, slope);
  const float logit = group_sum(gz * q.at, C);
  const float alpha = expf(fminf(logit - q.mx, 0.f)) * q.inv_den;
  const float dl = alpha * group_sum(q.g * (x - q.o), C);
  const float dz = dl * q.at * (z >= 0.f ? 1.f : slope);
  if (act) *dxl = fmaf(alpha, q.g, dz);
  dxr += dz;
  datt = fmaf(dl, gz, datt);
}

// The backward walk of one warp over rows perm[i] (i without perm): writes
// their d xl rows, adds to this lane's d xr and d att.
__device__ __forceinline__ void attend_bwd_walk(const AttendBwdLane& q,
                                                const float* __restrict__ xl,
                                                const int* __restrict__ perm, int begin,
                                                int end, int stride, int D, int C, float slope,
                                                int lane, float* __restrict__ dxl, float& dxr,
                                                float& datt) {
  const bool act = lane < D;
  for (int i = begin; i < end; i += stride) {
    const int e = perm == nullptr ? i : perm[i];
    const float x = act ? xl[(size_t)e * D + lane] : 0.f;
    attend_bwd_edge(q, x, C, slope, act, dxl + (size_t)e * D + lane, dxr, datt);
  }
}

// Backward, a block of NWARPS warps over segment `seg`'s rows perm[ptr[seg]
// ..]; the warps' d xr sums merge in warp order. Every thread of the block
// must call it.
template <int NWARPS>
__device__ __forceinline__ void attend_bwd_segment_block(
    const float* __restrict__ xl, const float* __restrict__ xr, const float* __restrict__ att,
    const float* __restrict__ out, const float* __restrict__ m, const float* __restrict__ den,
    const float* __restrict__ g, const int* __restrict__ ptr, const int* __restrict__ perm,
    int seg, int D, int C, float slope, float* __restrict__ dxl, float* __restrict__ dxr,
    float& datt) {
  __shared__ float sdxr[NWARPS][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const AttendBwdLane q = attend_bwd_lane(xr, att, out, g, m, den, seg, D, C, lane);
  float acc = 0.f;
  attend_bwd_walk(q, xl, perm, ptr[seg] + warp, ptr[seg + 1], NWARPS, D, C, slope, lane, dxl,
                  acc, datt);
  sdxr[warp][lane] = acc;
  __syncthreads();
  if (warp == 0) {
    float t = 0.f;
    for (int w = 0; w < NWARPS; ++w) t += sdxr[w][lane];
    if (lane < D) dxr[(size_t)seg * D + lane] = t;
  }
}

}  // namespace gasfm
