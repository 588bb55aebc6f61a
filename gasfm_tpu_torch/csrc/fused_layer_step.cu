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
// Backward (gasfm_layer_step_bwd), four launches: the edge-tile kernel
// (edge_tile.cuh), one column sum of its partial rows, and the point and
// camera segment sums of d_el / 4 (segment.cuh) for d ps and d pv. What bounds
// it on the H100 is bytes again (~0.6 KB per edge: e_l, en, skip2, d xl_p,
// d xl_c and the two output cotangents read once, d e_l, d en and d skip2
// written once, d e_l read twice more by the sums) against ~6.5k float32 FMAs
// per edge, which the CUDA cores take in a third of the bytes' time if the
// products keep them fed. The first design gave each point one warp with
// lane j holding feature j: every product was a chain of shuffles and shared
// loads (~116 dependent steps per edge), a warp waited on its point's edges
// one at a time (133 on the longest power-law point), and the weight
// gradients took a second pass over the streams (outer_sum_kernel) plus
// separate camera and LayerNorm sums: 7 launches, ~0.46 / ~0.68 ms per call
// on the two bench scenes. Now the work is split by edges, not by points:
// tiles of 32 edges staged in shared memory with 16-byte loads, every
// product register-tiled, every weight gradient in registers across a
// block's tiles, each sum in a fixed order without atomics.
//
// The update's per-edge forward lives in proj_update.cuh, shared with the
// standalone projection-update kernel (fused_proj_update.cu).
#include "edge_prologue.cuh"
#include "edge_tile.cuh"
#include "proj_update.cuh"
#include "segment.cuh"

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

// d_el (E, De): the total cotangent of e_l (returned as d res); den_out (E,
// d_in); dskip2 (E, d2) or NULL; dps (n, De); dpv (m, De); den_next and
// de_l_ext may be NULL (no cotangent). partials (grid, row) scratch, sums
// (row,): the weight gradients, laid out as StepRow (edge_tile.cuh) says.
// grid: the tile kernel's blocks, at most kTileBlocksPerSm per SM.
extern "C" int gasfm_layer_step_bwd(
    const float* en, int d_in, const float* skip2, int d2, const float* w, const float* e_l,
    const int* pt_ptr, int n_pts, const int* cam_ptr, const int* cam_perm, int n_cams, int E,
    int De, const float* lng, const float* lnb, int raw, float eps, const float* wlp, int Dp,
    const float* wlc, int Dc, const float* dxl_p, const float* dxl_c, const float* den_next,
    const float* de_l_ext, float* d_el, float* den_out, float* dskip2, float* dps, float* dpv,
    float* partials, float* sums, int grid, void* stream) {
  using namespace gasfm;
  cudaStream_t s = (cudaStream_t)stream;
  const int rows = E > 0 ? grid : 0;
  if (rows > 0) {
    layer_step_bwd_tile_kernel<<<rows, kTileThreads, 0, s>>>(
        en, d_in, skip2, d2, w, e_l, E, De, lng, lnb, raw, eps, wlp, Dp, wlc, Dc, dxl_p, dxl_c,
        den_next, de_l_ext, d_el, den_out, dskip2, partials);
  }
  launch_column_sum(partials, rows, StepRow(De, d_in + d2, Dp, Dc).len, sums, s);
  segment_sum(d_el, De, pt_ptr, nullptr, n_pts, 0.25f, dps, s);
  segment_sum(d_el, De, cam_ptr, cam_perm, n_cams, 0.25f, dpv, s);
  return (int)cudaGetLastError();
}
