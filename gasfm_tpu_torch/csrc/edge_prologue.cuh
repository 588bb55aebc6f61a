// The per-edge frontend prologue shared by the frontend kernel
// (fused_dual_attn.cu) and the layer-step kernel (fused_layer_step.cu):
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

}  // namespace gasfm
