// Merged layer step prologue, for sm_90a: layer l's projection update fused
// with layer l+1's frontend prologue, forward and backward. The wrapper runs
// the dual core (fused_dual_attn.cu, gasfm_dual_attend) right after the
// forward, and its backward (gasfm_dual_attend_bwd) right before the backward.
//
// Replaces the TPU kernels of gasfm_tpu/ops/pallas/fused_layer_step.py
// (_fwd_raw / _fwd_kernel, fused_layer_step; _bwd_raw / _bwd_body). Per edge:
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
//
// Backward (gasfm_layer_step_bwd): one warp per point, over the point's
// contiguous edges (grid-stride over points). Per edge it recomputes the
// LayerNorm from the saved e_l, takes the dual core's d xl_p / d xl_c back
// through the source linears and the LayerNorm (front_backward), adds e_l's
// own cotangent, and writes d e_l (= d res), d en and d skip2 (d e_l / 4
// through W). The point table's gradient d ps is the warp's sum over the
// point's edges, in registers. Then, over the streams now in memory: d pv,
// one block per camera over the camera CSR; the weight gradients d W / d b,
// d wl / d bl as tiled outer sums (outer_sum_kernel, common.cuh) — kept out
// of the per-edge kernel, whose per-lane sums of whole weight rows took 172
// registers and one block per SM. Bytes again: per edge it reads e_l, en,
// skip2, d xl_p, d xl_c and the two output cotangents and writes d e_l, d en,
// d skip2; the outer sums read d xl_p, d xl_c, e_norm, d e_l, en, skip2 once
// more. No atomics anywhere.
//
// The update's per-edge code, forward and backward, and the camera sums of
// d pv live in proj_update.cuh, shared with the standalone projection-update
// kernel (fused_proj_update.cu).
#include "edge_prologue.cuh"
#include "proj_update.cuh"

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
  __shared__ UpdateParams su;
  load_update_params(su, w, b, pg, De, d_in + d2);
  load_front_params(sp, lng, lnb, wlp, blp, wlc, blc, De, Dp, Dc, raw != 0);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kStepWarps;
  for (int edge = blockIdx.x * kStepWarps + (threadIdx.x >> 5); edge < E; edge += stride) {
    const float x = update_forward(su, edge, lane, en, d_in, skip2, d2, res, ps, pv, pt_idx,
                                   cam_idx, De);
    if (lane < De) e_l[(size_t)edge * De + lane] = x;
    const float v = front_norm(x, De, raw != 0, sp, eps, lane);
    if (!raw && lane < De) en_next[(size_t)edge * De + lane] = v;
    float yp, yc;
    front_linears(v, De, Dp, Dc, sp, lane, yp, yc);
    if (lane < Dp) xl_p[(size_t)edge * Dp + lane] = yp;
    if (lane < Dc) xl_c[(size_t)edge * Dc + lane] = yc;
  }
}

// Warp per point, over the point's contiguous edges (grid-stride over points).
// ln_partials: (gridDim.x, 2 * 32), this block's sums of d ln_scale and
// d ln_bias.
__global__ void __launch_bounds__(kStepWarps * 32) layer_step_bwd_kernel(
    const float* __restrict__ en, int d_in, const float* __restrict__ skip2, int d2,
    const float* __restrict__ w, const float* __restrict__ e_l,
    const int* __restrict__ pt_ptr, int n_pts, int De, const float* __restrict__ lng,
    const float* __restrict__ lnb, int raw, float eps, const float* __restrict__ wlp,
    int Dp, const float* __restrict__ wlc, int Dc, const float* __restrict__ dxl_p,
    const float* __restrict__ dxl_c, const float* __restrict__ den_next,
    const float* __restrict__ de_l_ext, float* __restrict__ d_el,
    float* __restrict__ den_out, float* __restrict__ dskip2, float* __restrict__ dps,
    float* __restrict__ ln_partials) {
  __shared__ FrontBackParams sp;
  __shared__ float s_w[32 * kUpdateMaxK];  // W (De, d_in + d2), torch layout
  __shared__ float sbuf[2 * 32];
  load_update_weights(s_w, w, De, d_in + d2);
  load_front_back_params(sp, lng, lnb, wlp, wlc, De, Dp, Dc, raw != 0);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const bool act = lane < De;
  float acc[2] = {0.f, 0.f};  // d ln_scale, d ln_bias of this lane's feature
  const int stride = gridDim.x * kStepWarps;
  for (int pt = blockIdx.x * kStepWarps + (threadIdx.x >> 5); pt < n_pts; pt += stride) {
    float dps_acc = 0.f;
    const int end = pt_ptr[pt + 1];
    for (int edge = pt_ptr[pt]; edge < end; ++edge) {
      const float x = act ? e_l[(size_t)edge * De + lane] : 0.f;
      const float dxp = lane < Dp ? dxl_p[(size_t)edge * Dp + lane] : 0.f;
      const float dxc = lane < Dc ? dxl_c[(size_t)edge * Dc + lane] : 0.f;
      const float dv = (den_next != nullptr && act) ? den_next[(size_t)edge * De + lane] : 0.f;
      float d = front_backward(x, dxp, dxc, dv, De, Dp, Dc, raw != 0, sp, eps, lane, acc[0],
                               acc[1]);
      if (de_l_ext != nullptr && act) d += de_l_ext[(size_t)edge * De + lane];
      if (act) d_el[(size_t)edge * De + lane] = d;
      const float du = d * 0.25f;  // 0 at lanes >= De
      dps_acc += du;
      update_backward(du, edge, lane, s_w, De, d_in, d2, den_out, dskip2);
    }
    if (act) dps[(size_t)pt * De + lane] = dps_acc;
  }
  block_partial(acc, sbuf, ln_partials + (size_t)blockIdx.x * 2 * 32);
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

// v: (E, De) the normalized output en_next (e_l itself under raw). d_el: (E,
// De) the total cotangent of e_l (returned as d res); den_out (E, d_in);
// dskip2 (E, d2) or NULL; dps (n, De); dpv (m, De); den_next and de_l_ext
// may be NULL (no cotangent). ln_partials (grid, 64) scratch, ln_sums (2,
// 32): d ln_scale, d ln_bias. outer_partials (3, ogrid, kOuterRow) scratch;
// outer_sums (3, kOuterRow): d wlp / d blp, d wlc / d blc, and d W / d b
// (d W's columns: en's, then skip2's), each [a][b] (32 x 64) then bias[a].
extern "C" int gasfm_layer_step_bwd(
    const float* en, int d_in, const float* skip2, int d2, const float* w, const float* e_l,
    const float* v, const int* pt_ptr, int n_pts, const int* cam_ptr, const int* cam_perm,
    int n_cams, int E, int De, const float* lng, const float* lnb, int raw, float eps,
    const float* wlp, int Dp, const float* wlc, int Dc, const float* dxl_p,
    const float* dxl_c, const float* den_next, const float* de_l_ext, float* d_el,
    float* den_out, float* dskip2, float* dps, float* dpv, float* ln_partials,
    float* ln_sums, float* outer_partials, float* outer_sums, int grid, int ogrid,
    void* stream) {
  using namespace gasfm;
  cudaStream_t s = (cudaStream_t)stream;
  layer_step_bwd_kernel<<<grid, kStepWarps * 32, 0, s>>>(
      en, d_in, skip2, d2, w, e_l, pt_ptr, n_pts, De, lng, lnb, raw, eps, wlp, Dp, wlc, Dc,
      dxl_p, dxl_c, den_next, de_l_ext, d_el, den_out, dskip2, dps, ln_partials);
  launch_camera_update_sums(d_el, cam_ptr, cam_perm, n_cams, De, dpv, s);
  launch_column_sum(ln_partials, grid, 2 * 32, ln_sums, s);
  OuterJobs jobs{};
  jobs.job[0] = OuterJob{dxl_p, Dp, 1.f, v, De, nullptr, 0};
  jobs.job[1] = OuterJob{dxl_c, Dc, 1.f, v, De, nullptr, 0};
  jobs.job[2] = OuterJob{d_el, De, 0.25f, en, d_in, skip2, d2};
  launch_outer_sums(jobs, 3, E, ogrid, outer_partials, outer_sums, s);
  return (int)cudaGetLastError();
}
