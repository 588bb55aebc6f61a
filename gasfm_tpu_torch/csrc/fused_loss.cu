// ESFM loss terms (forward), for sm_90a.
//
// Replaces the TPU kernel of gasfm_tpu/ops/pallas/fused_loss.py
// (_fwd_raw / _fwd_kernel, fused_esfm_terms). Per edge e = (cam, pt):
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
