// The projection update's per-edge device code, forward and backward, of the
// standalone projection-update kernel (fused_proj_update.cu; the layer
// step's forward and backward take the edge tiles of edge_tile.cuh instead):
//
//   e = ([en | skip2] . W^T + b + pg + ps[pt] + pv[cam]) / 4  (+ res)
//
// en (E, d_in), skip2 (E, d2) or NULL, res (E, De) or NULL, W (De, d_in + d2)
// in torch's layout, b and pg (De,), ps (n, De), pv (m, De); d_in, d2, De <= 32
// and d_in + d2 <= 64. One warp per edge, lane j holding feature j
// (common.cuh).
//
// Backward, from the cotangent g of e: d res = g; d en and d skip2 are
// (g / 4) . W per edge (update_backward); d ps the point sums of g / 4 (the
// caller's warp per point, over the point's contiguous edges); d pv the camera
// sums (camera_update_sum_kernel); d W / d b = d pg the outer sums of g / 4
// with [en | skip2] (outer_sum_kernel, common.cuh). No atomics.
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

// The backward's copy of W, in torch's (De, d_in + d2) layout.
__device__ __forceinline__ void load_update_weights(float* s_w, const float* __restrict__ w,
                                                    int De, int K) {
  for (int i = threadIdx.x; i < De * K; i += blockDim.x) s_w[i] = w[i];
}

// d en and d skip2 of one edge from du, this lane's g / 4 (0 at lanes >= De):
// d en[k] = sum_j du_j W[j, k], d skip2 likewise. All 32 lanes take part.
__device__ __forceinline__ void update_backward(float du, int edge, int lane,
                                                const float* s_w, int De, int d_in, int d2,
                                                float* __restrict__ den,
                                                float* __restrict__ dskip2) {
  const int K = d_in + d2;
  float o1 = 0.f, o2 = 0.f;
  for (int j = 0; j < De; ++j) {
    const float dj = __shfl_sync(GASFM_FULL_MASK, du, j);
    if (lane < d_in) o1 = fmaf(dj, s_w[j * K + lane], o1);
    if (lane < d2) o2 = fmaf(dj, s_w[j * K + d_in + lane], o2);
  }
  if (lane < d_in) den[(size_t)edge * d_in + lane] = o1;
  if (dskip2 != nullptr && lane < d2) dskip2[(size_t)edge * d2 + lane] = o2;
}

constexpr int kCamSumWarps = 8;

// d pv[c] = sum over the camera's edges of g / 4: one block per camera, warps
// striding over its edge list, merged in a fixed warp order.
__global__ void __launch_bounds__(kCamSumWarps * 32) camera_update_sum_kernel(
    const float* __restrict__ g, const int* __restrict__ cam_ptr,
    const int* __restrict__ cam_perm, int De, float* __restrict__ dpv) {
  __shared__ float s[kCamSumWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cam = blockIdx.x;
  float acc = 0.f;
  const int end = cam_ptr[cam + 1];
  for (int i = cam_ptr[cam] + warp; i < end; i += kCamSumWarps) {
    const int e = cam_perm[i];
    if (lane < De) acc += g[(size_t)e * De + lane] * 0.25f;
  }
  s[warp][lane] = acc;
  __syncthreads();
  if (warp == 0) {
    float t = 0.f;
    for (int w2 = 0; w2 < kCamSumWarps; ++w2) t += s[w2][lane];
    if (lane < De) dpv[(size_t)cam * De + lane] = t;
  }
}

inline void launch_camera_update_sums(const float* g, const int* cam_ptr, const int* cam_perm,
                                      int n_cams, int De, float* dpv, cudaStream_t stream) {
  if (n_cams > 0) {
    camera_update_sum_kernel<<<n_cams, kCamSumWarps * 32, 0, stream>>>(g, cam_ptr, cam_perm, De,
                                                                       dpv);
  }
}

}  // namespace gasfm
