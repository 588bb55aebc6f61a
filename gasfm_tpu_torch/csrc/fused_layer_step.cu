// Merged layer step prologue, for sm_90a: layer l's projection update fused
// with layer l+1's frontend prologue. The wrapper runs the dual core
// (fused_dual_attn.cu, gasfm_dual_attend) right after it.
//
// Replaces the TPU kernel of gasfm_tpu/ops/pallas/fused_layer_step.py
// (_fwd_raw / _fwd_kernel, fused_layer_step). Per edge:
//
//   e_l      = ([en | skip2] . W^T + c0 + ps[pt] + pv[cam]) / 4  (+ res)
//   en_{l+1} = relu(LN_{l+1}(e_l))          (skipped under raw, en_{l+1} = e_l)
//   xl_p, xl_c = the next layer's two GATv2 source linears of en_{l+1}
//
// with c0 = b + pg (lin_proj's bias plus the global table row). The first layer's
// width-adapting residual rides the skip2 slot (skip2 = relu(LN_res(uv)),
// W's skip columns = 4 * W_skip, c0 += 4 * b_skip), as in the JAX package.
//
// What bounds it on the H100: bytes. Per edge it reads en, skip2, res and
// the two gathered table rows (ps[pt], pv[cam]) and writes e_l, en_{l+1},
// xl_p and xl_c — about 0.9 KB per edge at the flagship widths — against
// ~2.5 kflop of fma, far below the float32 rate. Design against it: every
// intermediate stays in registers, each stream is touched once as a
// coalesced row per warp, the update's weights (<= 64 x 32) and the
// frontend's weights sit in shared memory for the whole grid-stride sweep.
#include "edge_prologue.cuh"

namespace gasfm {

constexpr int kStepWarps = 8;

__global__ void __launch_bounds__(kStepWarps * 32) layer_step_prologue_kernel(
    const float* __restrict__ en, int d_in, const float* __restrict__ skip2, int d2,
    const float* __restrict__ res, const float* __restrict__ w,
    const float* __restrict__ b, const float* __restrict__ pg,
    const float* __restrict__ ps,
    const float* __restrict__ pv, const int* __restrict__ pt_idx,
    const int* __restrict__ cam_idx, int E, int De,
    const float* __restrict__ lng, const float* __restrict__ lnb, int raw, float eps,
    const float* __restrict__ wlp, const float* __restrict__ blp, int Dp,
    const float* __restrict__ wlc, const float* __restrict__ blc, int Dc,
    float* __restrict__ e_l, float* __restrict__ en_next,
    float* __restrict__ xl_p, float* __restrict__ xl_c) {
  __shared__ FrontParams sp;
  __shared__ float s_w[64 * 32];  // update weights transposed to (d_in + d2, De)
  __shared__ float s_c0[32];
  const int K = d_in + d2;
  for (int i = threadIdx.x; i < De * K; i += blockDim.x) s_w[(i % K) * De + i / K] = w[i];
  for (int i = threadIdx.x; i < De; i += blockDim.x) s_c0[i] = b[i] + pg[i];
  load_front_params(sp, lng, lnb, wlp, blp, wlc, blc, De, Dp, Dc, raw != 0);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const bool act = lane < De;
  const int stride = gridDim.x * kStepWarps;
  for (int edge = blockIdx.x * kStepWarps + (threadIdx.x >> 5); edge < E; edge += stride) {
    const float a = lane < d_in ? en[(size_t)edge * d_in + lane] : 0.f;
    const float s = lane < d2 ? skip2[(size_t)edge * d2 + lane] : 0.f;
    float acc = 0.f;
    for (int k = 0; k < d_in; ++k) {
      const float ak = __shfl_sync(GASFM_FULL_MASK, a, k);
      if (act) acc = fmaf(ak, s_w[k * De + lane], acc);
    }
    for (int k = 0; k < d2; ++k) {
      const float sk = __shfl_sync(GASFM_FULL_MASK, s, k);
      if (act) acc = fmaf(sk, s_w[(d_in + k) * De + lane], acc);
    }
    float x = 0.f;
    if (act) {
      const int p = pt_idx[edge];
      const int c = cam_idx[edge];
      x = ((acc + s_c0[lane]) + (ps[(size_t)p * De + lane] + pv[(size_t)c * De + lane])) * 0.25f;
      if (res != nullptr) x += res[(size_t)edge * De + lane];
      e_l[(size_t)edge * De + lane] = x;
    }
    const float v = front_norm(x, De, raw != 0, sp, eps, lane);
    if (!raw && act) en_next[(size_t)edge * De + lane] = v;
    float yp, yc;
    front_linears(v, De, Dp, Dc, sp, lane, yp, yc);
    if (lane < Dp) xl_p[(size_t)edge * Dp + lane] = yp;
    if (lane < Dc) xl_c[(size_t)edge * Dc + lane] = yc;
  }
}

}  // namespace gasfm

extern "C" int gasfm_layer_step_prologue(
    const float* en, int d_in, const float* skip2, int d2, const float* res,
    const float* w, const float* b, const float* pg, const float* ps, const float* pv,
    const int* pt_idx, const int* cam_idx, int E, int De, const float* lng,
    const float* lnb, int raw, float eps, const float* wlp, const float* blp,
    int Dp, const float* wlc, const float* blc, int Dc, float* e_l,
    float* en_next, float* xl_p, float* xl_c, int grid, void* stream) {
  using namespace gasfm;
  if (E > 0) {
    layer_step_prologue_kernel<<<grid, kStepWarps * 32, 0, (cudaStream_t)stream>>>(
        en, d_in, skip2, d2, res, w, b, pg, ps, pv, pt_idx, cam_idx, E, De, lng, lnb,
        raw, eps, wlp, blp, Dp, wlc, blc, Dc, e_l, en_next, xl_p, xl_c);
  }
  return (int)cudaGetLastError();
}
