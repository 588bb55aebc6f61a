// The per-edge frontend prologue of the frontend kernel (fused_dual_attn.cu;
// the layer step's forward takes the edge tiles of edge_tile.cuh instead):
// flax-form LayerNorm (var = E[x^2] - mean^2) + ReLU over the De <= 32
// features of an edge, then the two GATv2 source linears (De -> Dp, De -> Dc,
// both <= 32) with their weights in shared memory.
#pragma once

#include "common.cuh"

namespace gasfm {

// Shared-memory copy of the frontend parameters. Weights arrive in torch's
// (out, in) layout and are stored transposed, (in, out), so the lanes of a
// warp (one output feature each) read consecutive banks.
struct FrontParams {
  float g[32], b[32];
  float wp[32 * 32], bp[32];
  float wc[32 * 32], bc[32];
};

// Cooperative load by the whole block; the caller synchronises afterwards.
__device__ __forceinline__ void load_front_params(
    FrontParams& sp, const float* __restrict__ lng, const float* __restrict__ lnb,
    const float* __restrict__ wlp, const float* __restrict__ blp,
    const float* __restrict__ wlc, const float* __restrict__ blc,
    int De, int Dp, int Dc, bool raw) {
  for (int i = threadIdx.x; i < Dp * De; i += blockDim.x) {
    sp.wp[(i % De) * Dp + i / De] = wlp[i];
  }
  for (int i = threadIdx.x; i < Dc * De; i += blockDim.x) {
    sp.wc[(i % De) * Dc + i / De] = wlc[i];
  }
  for (int i = threadIdx.x; i < Dp; i += blockDim.x) sp.bp[i] = blp[i];
  for (int i = threadIdx.x; i < Dc; i += blockDim.x) sp.bc[i] = blc[i];
  if (!raw) {
    for (int i = threadIdx.x; i < De; i += blockDim.x) {
      sp.g[i] = lng[i];
      sp.b[i] = lnb[i];
    }
  }
}

// This lane's normalized feature relu(LN(x)) (lanes >= De hold x == 0 and
// return 0). Under `raw` the features pass through unchanged.
__device__ __forceinline__ float front_norm(float x, int De, bool raw,
                                            const FrontParams& sp, float eps,
                                            int lane) {
  if (raw) return x;
  const float inv = 1.f / (float)De;
  const float mean = group_sum(x, 32) * inv;
  const float var = group_sum(x * x, 32) * inv - mean * mean;
  if (lane >= De) return 0.f;
  return fmaxf((x - mean) * rsqrtf(var + eps) * sp.g[lane] + sp.b[lane], 0.f);
}

// Both source linears of the edge whose features v are spread over the
// lanes: lane j receives output j of each (0 above the output width).
__device__ __forceinline__ void front_linears(float v, int De, int Dp, int Dc,
                                              const FrontParams& sp, int lane,
                                              float& yp, float& yc) {
  float ap = 0.f, ac = 0.f;
  for (int k = 0; k < De; ++k) {
    const float vk = __shfl_sync(GASFM_FULL_MASK, v, k);
    if (lane < Dp) ap = fmaf(vk, sp.wp[k * Dp + lane], ap);
    if (lane < Dc) ac = fmaf(vk, sp.wc[k * Dc + lane], ac);
  }
  yp = lane < Dp ? ap + sp.bp[lane] : 0.f;
  yc = lane < Dc ? ac + sp.bc[lane] : 0.f;
}

// ---------------------------------------------------------------------------
// Backward of the prologue (LayerNorm + ReLU + the two source linears), of the
// frontend's backward kernel.
// ---------------------------------------------------------------------------

// Backward copy of the parameters, weights in torch's (out, in) layout: lane j
// reading column j of row i hits bank j.
struct FrontBackParams {
  float g[32], b[32];
  float wp[32 * 32];  // wlp (Dp, De), row-major
  float wc[32 * 32];  // wlc (Dc, De)
};

__device__ __forceinline__ void load_front_back_params(
    FrontBackParams& sp, const float* __restrict__ lng, const float* __restrict__ lnb,
    const float* __restrict__ wlp, const float* __restrict__ wlc, int De, int Dp, int Dc,
    bool raw) {
  for (int i = threadIdx.x; i < Dp * De; i += blockDim.x) sp.wp[i] = wlp[i];
  for (int i = threadIdx.x; i < Dc * De; i += blockDim.x) sp.wc[i] = wlc[i];
  if (!raw) {
    for (int i = threadIdx.x; i < De; i += blockDim.x) {
      sp.g[i] = lng[i];
      sp.b[i] = lnb[i];
    }
  }
}

// One edge, lanes as in the forward. x: this lane's prologue input (0 at lanes
// >= De); dxp / dxc: this lane's cotangent of xl_p / xl_c (0 above Dp / Dc);
// dv: the cotangent of the normalized output v itself (the e_norm output's;
// 0 if none). Recomputes the LayerNorm from x, adds this lane's LayerNorm
// scale and bias gradients into dg / db, and returns this lane's d x. The
// LayerNorm backward is the JAX kernel's: rstd * (dxhat - mean(dxhat) -
// xhat * mean(dxhat xhat)). The source linears' weight and bias gradients
// are outer sums over all edges (outer_sum_kernel), not taken here.
__device__ __forceinline__ float front_backward(float x, float dxp, float dxc, float dv,
                                                int De, int Dp, int Dc, bool raw,
                                                const FrontBackParams& sp, float eps,
                                                int lane, float& dg, float& db) {
  const bool act = lane < De;
  // dv_j += sum_i dxp_i wlp[i, j] + sum_i dxc_i wlc[i, j]
  for (int i = 0; i < Dp; ++i) {
    const float di = __shfl_sync(GASFM_FULL_MASK, dxp, i);
    if (act) dv = fmaf(di, sp.wp[i * De + lane], dv);
  }
  for (int i = 0; i < Dc; ++i) {
    const float di = __shfl_sync(GASFM_FULL_MASK, dxc, i);
    if (act) dv = fmaf(di, sp.wc[i * De + lane], dv);
  }
  if (raw) return act ? dv : 0.f;
  const float inv = 1.f / (float)De;
  const float mean = group_sum(x, 32) * inv;
  const float var = group_sum(x * x, 32) * inv - mean * mean;
  const float rstd = rsqrtf(var + eps);
  const float xhat = act ? (x - mean) * rstd : 0.f;
  const float y = act ? xhat * sp.g[lane] + sp.b[lane] : 0.f;
  const float dy = (act && y > 0.f) ? dv : 0.f;  // through the ReLU
  dg = fmaf(dy, xhat, dg);
  db += dy;
  const float dxh = act ? dy * sp.g[lane] : 0.f;
  const float m1 = group_sum(dxh, 32) * inv;
  const float m2 = group_sum(dxh * xhat, 32) * inv;
  return act ? rstd * (dxh - m1 - xhat * m2) : 0.f;
}

}  // namespace gasfm
