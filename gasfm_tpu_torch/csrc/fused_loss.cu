// ESFM loss terms, forward and backward, for sm_90a.
//
// Replaces the TPU kernels of gasfm_tpu/ops/pallas/fused_loss.py
// (_fwd_raw / _fwd_kernel, fused_esfm_terms; _bwd_raw / _bwd_kernel). Per
// edge e = (cam, pt):
//
//   proj  = P[cam] (3x4) . X[pt] (4)
//   pos   = depth >= margin (hinge) or |depth| >= margin
//   term  = pos ? ||proj_xy / depth - uv|| : (margin - depth) * hinge_w
//
// and three scalars: sum of terms, number of edges, number of pos edges.
//
// What bounds it on the H100: bytes — 64 + 16 + 8 + 8 bytes gathered or read
// per edge against ~40 flops. Design against it: one thread per edge, the
// camera row and the point row read straight from their tables (both stay
// in L2: m x 48 and n x 16 bytes), nothing per-edge written back. The sum is
// deterministic: a fixed-order shared-memory tree per block writes one
// partial triple per block, and a second one-block pass sums the partials in
// block order — no float atomics.
//
// Backward (gasfm_esfm_terms_bwd): the cotangent of the edge sum, times d
// term / d proj per edge, with the gradient-direction equalization of the
// reference's backward hook (none / all / valid_only), gives g (3) per edge;
// then dP[cam] += g X^T and dX[pt] += P^T g. Both table gradients are segment
// sums, taken without atomics by walking the segments: one warp per point
// over its contiguous edges (lanes stride the edges, a butterfly sums them),
// one block per camera over the camera CSR (a fixed-order shared-memory
// tree). Each edge's projection is recomputed on both sides (~60 flops
// against re-reading 64 gathered bytes): bytes bound as the forward.

#include "common.cuh"

namespace gasfm {

constexpr int kLossThreads = 256;

__device__ __forceinline__ void block_tree_sum(float (*red)[kLossThreads]) {
  for (int s = kLossThreads / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) {
      red[0][threadIdx.x] += red[0][threadIdx.x + s];
      red[1][threadIdx.x] += red[1][threadIdx.x + s];
      red[2][threadIdx.x] += red[2][threadIdx.x + s];
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kLossThreads) esfm_terms_kernel(
    const float* __restrict__ P, const float* __restrict__ Xt,
    const float* __restrict__ uv, const int* __restrict__ cam_idx,
    const int* __restrict__ pt_idx, int E, float margin, int hinge,
    float hinge_w, float* __restrict__ partials) {
  __shared__ float red[3][kLossThreads];
  const int e = blockIdx.x * kLossThreads + threadIdx.x;
  float term = 0.f, n_valid = 0.f, n_pos = 0.f;
  if (e < E) {
    const float* p = P + (size_t)cam_idx[e] * 12;
    const float4 x = reinterpret_cast<const float4*>(Xt)[pt_idx[e]];
    float pr[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      pr[i] = p[4 * i] * x.x + p[4 * i + 1] * x.y + p[4 * i + 2] * x.z + p[4 * i + 3] * x.w;
    }
    const float depth = pr[2];
    const bool pos = hinge ? depth >= margin : fabsf(depth) >= margin;
    const float den = pos ? depth : 1.f;
    const float rx = pr[0] / den - uv[2 * (size_t)e];
    const float ry = pr[1] / den - uv[2 * (size_t)e + 1];
    const float sq = rx * rx + ry * ry;
    const float rn = sq > 0.f ? sqrtf(sq) : 0.f;
    term = pos ? rn : (margin - depth) * hinge_w;
    n_valid = 1.f;
    n_pos = pos ? 1.f : 0.f;
  }
  red[0][threadIdx.x] = term;
  red[1][threadIdx.x] = n_valid;
  red[2][threadIdx.x] = n_pos;
  __syncthreads();
  block_tree_sum(red);
  if (threadIdx.x == 0) {
    partials[3 * (size_t)blockIdx.x + 0] = red[0][0];
    partials[3 * (size_t)blockIdx.x + 1] = red[1][0];
    partials[3 * (size_t)blockIdx.x + 2] = red[2][0];
  }
}

__global__ void __launch_bounds__(kLossThreads) sum_partials_kernel(
    const float* __restrict__ partials, int nb, float* __restrict__ out) {
  __shared__ float red[3][kLossThreads];
  float a = 0.f, b = 0.f, c = 0.f;
  for (int i = threadIdx.x; i < nb; i += kLossThreads) {
    a += partials[3 * (size_t)i];
    b += partials[3 * (size_t)i + 1];
    c += partials[3 * (size_t)i + 2];
  }
  red[0][threadIdx.x] = a;
  red[1][threadIdx.x] = b;
  red[2][threadIdx.x] = c;
  __syncthreads();
  block_tree_sum(red);
  if (threadIdx.x == 0) {
    out[0] = red[0][0];
    out[1] = red[1][0];
    out[2] = red[2][0];
  }
}

// ---- backward ------------------------------------------------------------------

constexpr int kEqNone = 0, kEqAll = 1, kEqValidOnly = 2;

// g = d loss / d proj of edge e (after equalization), with the camera row p
// and the point x it was computed from. Mirrors _bwd_kernel line for line.
__device__ __forceinline__ void esfm_edge_grad(const float* __restrict__ p, const float4 x,
                                               float u, float v, float margin, int hinge,
                                               float hinge_w, int eq_mode, float coef,
                                               float icnt, float g[3]) {
  float pr[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    pr[i] = p[4 * i] * x.x + p[4 * i + 1] * x.y + p[4 * i + 2] * x.z + p[4 * i + 3] * x.w;
  }
  const float depth = pr[2];
  const bool pos = hinge ? depth >= margin : fabsf(depth) >= margin;
  const float denom = pos ? depth : 1.f;
  const float inv_d = 1.f / denom;
  const float px = pr[0] / denom, py = pr[1] / denom;
  const float rx = px - u, ry = py - v;
  const float sq = rx * rx + ry * ry;
  const bool nz = sq > 0.f;
  const float inv_rn = nz ? 1.f / sqrtf(sq) : 0.f;
  const float hx = rx * inv_rn, hy = ry * inv_rn;  // exactly 0 at the 0-residual tie
  float g0 = pos ? hx * inv_d * coef : 0.f;
  float g1 = pos ? hy * inv_d * coef : 0.f;
  const float rdotp = hx * (pr[0] * inv_d) + hy * (pr[1] * inv_d);
  float gd = (pos ? -rdotp * inv_d : -hinge_w) * coef;
  if (eq_mode != kEqNone && (eq_mode == kEqAll || pos)) {
    const float n3 = sqrtf(g0 * g0 + g1 * g1 + gd * gd);
    const float scale = icnt / fmaxf(n3, 1e-12f);
    g0 *= scale;
    g1 *= scale;
    gd *= scale;
  }
  g[0] = g0;
  g[1] = g1;
  g[2] = gd;
}

constexpr int kLossBwdWarps = 8;

// Grid: n_pt_blocks point blocks (warp per point), then one block per camera.
__global__ void __launch_bounds__(kLossThreads) esfm_terms_bwd_kernel(
    const float* __restrict__ P, const float* __restrict__ Xt,
    const float* __restrict__ uv, const int* __restrict__ cam_idx,
    const int* __restrict__ pt_idx, const int* __restrict__ pt_ptr,
    const int* __restrict__ cam_ptr, const int* __restrict__ cam_perm, int n_pts,
    float margin, int hinge, float hinge_w, int eq_mode, const float* __restrict__ coef_p,
    const float* __restrict__ count_p, int n_pt_blocks, float* __restrict__ dP,
    float* __restrict__ dX) {
  __shared__ float red[12][kLossThreads];
  const float coef = coef_p[0];
  const float icnt = 1.f / fmaxf(count_p[0], 1.f);
  const float4* X4 = reinterpret_cast<const float4*>(Xt);
  const int lane = threadIdx.x & 31;

  if ((int)blockIdx.x < n_pt_blocks) {
    const int pt = blockIdx.x * kLossBwdWarps + (threadIdx.x >> 5);
    if (pt >= n_pts) return;  // no block-wide sync on the point side
    const float4 x = X4[pt];
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    const int end = pt_ptr[pt + 1];
    for (int e = pt_ptr[pt] + lane; e < end; e += 32) {
      const float* p = P + (size_t)cam_idx[e] * 12;
      float g[3];
      esfm_edge_grad(p, x, uv[2 * (size_t)e], uv[2 * (size_t)e + 1], margin, hinge, hinge_w,
                     eq_mode, coef, icnt, g);
#pragma unroll
      for (int j = 0; j < 4; ++j) d[j] += p[j] * g[0] + p[4 + j] * g[1] + p[8 + j] * g[2];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) d[j] = group_sum(d[j], 32);
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j) dX[4 * (size_t)pt + j] = d[j];
    }
    return;
  }

  const int cam = blockIdx.x - n_pt_blocks;
  const float* p = P + (size_t)cam * 12;
  float d[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) d[k] = 0.f;
  const int end = cam_ptr[cam + 1];
  for (int i = cam_ptr[cam] + threadIdx.x; i < end; i += kLossThreads) {
    const int e = cam_perm[i];
    const float4 x = X4[pt_idx[e]];
    float g[3];
    esfm_edge_grad(p, x, uv[2 * (size_t)e], uv[2 * (size_t)e + 1], margin, hinge, hinge_w,
                   eq_mode, coef, icnt, g);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      d[4 * r] += g[r] * x.x;
      d[4 * r + 1] += g[r] * x.y;
      d[4 * r + 2] += g[r] * x.z;
      d[4 * r + 3] += g[r] * x.w;
    }
  }
#pragma unroll
  for (int k = 0; k < 12; ++k) red[k][threadIdx.x] = d[k];
  __syncthreads();
  for (int s2 = kLossThreads / 2; s2 > 0; s2 >>= 1) {
    if ((int)threadIdx.x < s2) {
#pragma unroll
      for (int k = 0; k < 12; ++k) red[k][threadIdx.x] += red[k][threadIdx.x + s2];
    }
    __syncthreads();
  }
  if (threadIdx.x < 12) dP[(size_t)cam * 12 + threadIdx.x] = red[threadIdx.x][0];
}

}  // namespace gasfm

// partials: (ceil(E / 256), 3) scratch; out: (3,) = (sum of terms, #edges, #pos).
extern "C" int gasfm_esfm_terms(const float* P, const float* Xt, const float* uv,
                                const int* cam_idx, const int* pt_idx, int E,
                                float margin, int hinge, float hinge_w,
                                float* partials, float* out, void* stream) {
  using namespace gasfm;
  const int nb = (E + kLossThreads - 1) / kLossThreads;
  cudaStream_t s = (cudaStream_t)stream;
  if (nb > 0) {
    esfm_terms_kernel<<<nb, kLossThreads, 0, s>>>(P, Xt, uv, cam_idx, pt_idx, E,
                                                  margin, hinge, hinge_w, partials);
  }
  sum_partials_kernel<<<1, kLossThreads, 0, s>>>(partials, nb, out);
  return (int)cudaGetLastError();
}

// coef: device pointer to d loss / d (edge sum); count: device pointer to the
// equalization count (valid-and-positive edges for valid_only, all edges for
// all), read as 1 / max(count, 1). eq_mode: 0 none, 1 all, 2 valid_only.
// dP (m, 12), dX (n, 4).
extern "C" int gasfm_esfm_terms_bwd(const float* P, const float* Xt, const float* uv,
                                    const int* cam_idx, const int* pt_idx, const int* pt_ptr,
                                    const int* cam_ptr, const int* cam_perm, int n_pts,
                                    int n_cams, float margin, int hinge, float hinge_w,
                                    int eq_mode, const float* coef, const float* count,
                                    float* dP, float* dX, void* stream) {
  using namespace gasfm;
  const int n_pt_blocks = (n_pts + kLossBwdWarps - 1) / kLossBwdWarps;
  const int grid = n_pt_blocks + n_cams;
  if (grid > 0) {
    esfm_terms_bwd_kernel<<<grid, kLossThreads, 0, (cudaStream_t)stream>>>(
        P, Xt, uv, cam_idx, pt_idx, pt_ptr, cam_ptr, cam_perm, n_pts, margin, hinge, hinge_w,
        eq_mode, coef, count, n_pt_blocks, dP, dX);
  }
  return (int)cudaGetLastError();
}
