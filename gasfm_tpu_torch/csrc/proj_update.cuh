// The projection update's per-edge forward device code, of the standalone
// projection-update kernel (fused_proj_update.cu; the layer step's forward
// and backward, and this update's backward, take the edge tiles of
// edge_tile.cuh instead):
//
//   e = ([en | skip2] . W^T + b + pg + ps[pt] + pv[cam]) / 4  (+ res)
//
// en (E, d_in), skip2 (E, d2) or NULL, res (E, De) or NULL, W (De, d_in + d2)
// in torch's layout, b and pg (De,), ps (n, De), pv (m, De); d_in, d2, De <= 32
// and d_in + d2 <= 64. One warp per edge, lane j holding feature j
// (common.cuh).
#pragma once

#include "common.cuh"

namespace gasfm {

constexpr int kUpdateMaxK = 64;  // d_in + d2

// Shared-memory copy of the forward's parameters: W transposed to (d_in + d2,
// De), so the lanes of a warp (one output feature each) read consecutive banks,
// and c0 = b + pg.
struct UpdateParams {
  float w[kUpdateMaxK * 32];
  float c0[32];
};

// Cooperative load by the whole block; the caller synchronises afterwards.
__device__ __forceinline__ void load_update_params(UpdateParams& sp, const float* __restrict__ w,
                                                   const float* __restrict__ b,
                                                   const float* __restrict__ pg, int De, int K) {
  for (int i = threadIdx.x; i < De * K; i += blockDim.x) sp.w[(i % K) * De + i / K] = w[i];
  for (int i = threadIdx.x; i < De; i += blockDim.x) sp.c0[i] = b[i] + pg[i];
}

// e of one edge at this lane (0 at lanes >= De). All 32 lanes take part.
__device__ __forceinline__ float update_forward(
    const UpdateParams& sp, int edge, int lane, const float* __restrict__ en, int d_in,
    const float* __restrict__ skip2, int d2, const float* __restrict__ res,
    const float* __restrict__ ps, const float* __restrict__ pv,
    const int* __restrict__ pt_idx, const int* __restrict__ cam_idx, int De) {
  const bool act = lane < De;
  const float a = lane < d_in ? en[(size_t)edge * d_in + lane] : 0.f;
  const float s = lane < d2 ? skip2[(size_t)edge * d2 + lane] : 0.f;
  float acc = 0.f;
  for (int k = 0; k < d_in; ++k) {
    const float ak = __shfl_sync(GASFM_FULL_MASK, a, k);
    if (act) acc = fmaf(ak, sp.w[k * De + lane], acc);
  }
  for (int k = 0; k < d2; ++k) {
    const float sk = __shfl_sync(GASFM_FULL_MASK, s, k);
    if (act) acc = fmaf(sk, sp.w[(d_in + k) * De + lane], acc);
  }
  if (!act) return 0.f;
  const int p = pt_idx[edge];
  const int c = cam_idx[edge];
  float x = ((acc + sp.c0[lane]) + (ps[(size_t)p * De + lane] + pv[(size_t)c * De + lane])) * 0.25f;
  if (res != nullptr) x += res[(size_t)edge * De + lane];
  return x;
}

}  // namespace gasfm
