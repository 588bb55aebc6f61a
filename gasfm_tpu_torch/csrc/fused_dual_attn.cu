// Dual GATv2 segment attention and the layer frontend, for sm_90a, forward
// and backward.
//
// Replaces the TPU kernels of gasfm_tpu/ops/pallas/fused_dual_attn.py:
//   - gasfm_dual_attend       <- _dual_fwd_raw / _dual_fwd_kernel (fused_dual_attend)
//   - gasfm_dual_attend_bwd   <- _dual_bwd_raw / _dual_bwd_kernel
//   - gasfm_frontend_prologue <- the LN + ReLU + source-linear prologue of
//     _front_fwd_raw / _front_fwd_kernel (fused_frontend); the wrapper runs
//     gasfm_dual_attend right after it.
//   - gasfm_frontend_prologue_bwd <- the prologue half of _front_bwd_raw /
//     _front_bwd_kernel; the wrapper runs gasfm_dual_attend_bwd before it.
//
// What bounds it on the H100: bytes. Per edge the core reads its two source
// rows (xl_p, xl_c: 4*(Dp+Dc) bytes) and one camera-order index; per segment
// one query row and one output row; ~10 flops per feature and edge are far
// below the card's float32 rate, so the floor is those bytes over 3.35 TB/s.
// Design against it: no one-hot matmuls (the TPU kernel's way to gather on
// the MXU) — the edges of a point are contiguous in the point-major layout
// and the edges of a camera are listed by the camera CSR, so each segment is
// a loop over its own rows, read once, with the online softmax (m, den, num)
// in registers. Query rows are loaded once per segment. The per-direction
// device code is attend.cuh's, shared with the single-direction kernel.
//   - Point side: one warp per point (14 edges per point on the dense bench
//     scene, 3 on the power-law one); lane = feature, head = lane / C.
//   - Camera side: one block per camera (up to ~1,300 edges); its warps
//     stride over the camera's edge list and merge their (m, den, num)
//     triples in shared memory in a fixed order.
// Under autograd the forward also writes each segment's per-head max and
// denominator (n, H) / (m, H), so the backward reads them instead of
// recomputing the softmax (one more pass over xl). The backward walks the
// same segments: per edge it recomputes the logit from xl and the query,
// writes d xl, and keeps the query's and the attention vector's gradients in
// registers; the segment sums (d xr) need no atomics, the attention-vector
// sums over all edges go through per-block partials and a fixed-order
// column sum (common.cuh).
// No float atomics anywhere: results are bitwise reproducible run to run.
#include "attend.cuh"
#include "edge_prologue.cuh"

namespace gasfm {

constexpr int kDualWarps = 16;   // warps per block of the dual core
constexpr int kFrontWarps = 8;   // warps per block of the prologue

template <int NWARPS>
__global__ void __launch_bounds__(NWARPS * 32) dual_attend_kernel(
    const float* __restrict__ xl_p, const float* __restrict__ xl_c,
    const float* __restrict__ xr_p, const float* __restrict__ xr_c,
    const float* __restrict__ att_p, const float* __restrict__ att_c,
    const int* __restrict__ pt_ptr, const int* __restrict__ cam_ptr,
    const int* __restrict__ cam_perm, int n_pts, int Dp, int Cp, int Dc, int Cc,
    float slope, int n_pt_blocks, float* __restrict__ out_p,
    float* __restrict__ out_c, float* __restrict__ m_p, float* __restrict__ den_p,
    float* __restrict__ m_c, float* __restrict__ den_c) {
  if ((int)blockIdx.x < n_pt_blocks) {
    // ---- point side: warp per point, its edges are contiguous.
    const int pt = blockIdx.x * NWARPS + (threadIdx.x >> 5);
    if (pt < n_pts) {
      attend_segment_warp(xl_p, xr_p, att_p, pt_ptr, pt, Dp, Cp, slope, out_p, m_p, den_p);
    }
    return;
  }
  // ---- camera side: block per camera, warps stride over its edge list.
  attend_segment_block<NWARPS>(xl_c, xr_c, att_c, cam_ptr, cam_perm, blockIdx.x - n_pt_blocks,
                               Dc, Cc, slope, out_c, m_c, den_c);
}

// Warp per edge (grid-stride): en = relu(LN(e)) unless raw, then the two
// source linears. Writes en (not under raw), xl_p and xl_c.
__global__ void __launch_bounds__(kFrontWarps * 32) frontend_prologue_kernel(
    const float* __restrict__ e, int E, int De, const float* __restrict__ lng,
    const float* __restrict__ lnb, int raw, float eps,
    const float* __restrict__ wlp, const float* __restrict__ blp, int Dp,
    const float* __restrict__ wlc, const float* __restrict__ blc, int Dc,
    float* __restrict__ en, float* __restrict__ xl_p, float* __restrict__ xl_c) {
  __shared__ FrontParams sp;
  load_front_params(sp, lng, lnb, wlp, blp, wlc, blc, De, Dp, Dc, raw != 0);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kFrontWarps;
  for (int edge = blockIdx.x * kFrontWarps + (threadIdx.x >> 5); edge < E; edge += stride) {
    const float x = lane < De ? e[(size_t)edge * De + lane] : 0.f;
    const float v = front_norm(x, De, raw != 0, sp, eps, lane);
    if (!raw && lane < De) en[(size_t)edge * De + lane] = v;
    float yp, yc;
    front_linears(v, De, Dp, Dc, sp, lane, yp, yc);
    if (lane < Dp) xl_p[(size_t)edge * Dp + lane] = yp;
    if (lane < Dc) xl_c[(size_t)edge * Dc + lane] = yc;
  }
}

// ---- backward of the dual core (attend.cuh) -------------------------------------
//
// Grid: n_pt_blocks point blocks (warp per point), then one block per camera.
// partials: (grid, 32), one d att row per block (point blocks: d att_p,
// camera blocks: d att_c), summed by column_sum_kernel.
template <int NWARPS>
__global__ void __launch_bounds__(NWARPS * 32) dual_attend_bwd_kernel(
    const float* __restrict__ xl_p, const float* __restrict__ xl_c,
    const float* __restrict__ xr_p, const float* __restrict__ xr_c,
    const float* __restrict__ att_p, const float* __restrict__ att_c,
    const float* __restrict__ out_p, const float* __restrict__ out_c,
    const float* __restrict__ m_p, const float* __restrict__ den_p,
    const float* __restrict__ m_c, const float* __restrict__ den_c,
    const float* __restrict__ g_p, const float* __restrict__ g_c,
    const int* __restrict__ pt_ptr, const int* __restrict__ cam_ptr,
    const int* __restrict__ cam_perm, int n_pts, int Dp, int Cp, int Dc, int Cc,
    float slope, int n_pt_blocks, float* __restrict__ dxl_p, float* __restrict__ dxl_c,
    float* __restrict__ dxr_p, float* __restrict__ dxr_c, float* __restrict__ partials) {
  __shared__ float sbuf[32];
  float acc[1] = {0.f};  // this lane's d att over the block's edges
  if ((int)blockIdx.x < n_pt_blocks) {
    const int pt = blockIdx.x * NWARPS + (threadIdx.x >> 5);
    if (pt < n_pts) {
      attend_bwd_segment_warp(xl_p, xr_p, att_p, out_p, m_p, den_p, g_p, pt_ptr, pt, Dp, Cp,
                              slope, dxl_p, dxr_p, acc[0]);
    }
  } else {
    attend_bwd_segment_block<NWARPS>(xl_c, xr_c, att_c, out_c, m_c, den_c, g_c, cam_ptr,
                                     cam_perm, blockIdx.x - n_pt_blocks, Dc, Cc, slope, dxl_c,
                                     dxr_c, acc[0]);
  }
  block_partial(acc, sbuf, partials + (size_t)blockIdx.x * 32);
}

// ---- backward of the frontend prologue ------------------------------------------
//
// Warp per edge (grid-stride): recompute the LayerNorm from e, then
// front_backward: d e, and the LayerNorm scale / bias gradients summed per
// lane. partials: (gridDim.x, 2 * 32), one row per block. The source linears'
// gradients are outer sums (d xl_p^T v, d xl_c^T v) by outer_sum_kernel.
__global__ void __launch_bounds__(kFrontWarps * 32) frontend_prologue_bwd_kernel(
    const float* __restrict__ e, int E, int De, const float* __restrict__ lng,
    const float* __restrict__ lnb, int raw, float eps, const float* __restrict__ wlp,
    int Dp, const float* __restrict__ wlc, int Dc, const float* __restrict__ dxl_p,
    const float* __restrict__ dxl_c, const float* __restrict__ den,
    float* __restrict__ de, float* __restrict__ partials) {
  __shared__ FrontBackParams sp;
  __shared__ float sbuf[2 * 32];
  load_front_back_params(sp, lng, lnb, wlp, wlc, De, Dp, Dc, raw != 0);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  float acc[2] = {0.f, 0.f};  // d ln_scale, d ln_bias of this lane's feature
  const int stride = gridDim.x * kFrontWarps;
  for (int edge = blockIdx.x * kFrontWarps + (threadIdx.x >> 5); edge < E; edge += stride) {
    const float x = lane < De ? e[(size_t)edge * De + lane] : 0.f;
    const float dxp = lane < Dp ? dxl_p[(size_t)edge * Dp + lane] : 0.f;
    const float dxc = lane < Dc ? dxl_c[(size_t)edge * Dc + lane] : 0.f;
    const float dv = (den != nullptr && lane < De) ? den[(size_t)edge * De + lane] : 0.f;
    const float dx = front_backward(x, dxp, dxc, dv, De, Dp, Dc, raw != 0, sp, eps, lane,
                                    acc[0], acc[1]);
    if (lane < De) de[(size_t)edge * De + lane] = dx;
  }
  block_partial(acc, sbuf, partials + (size_t)blockIdx.x * 2 * 32);
}

}  // namespace gasfm

extern "C" int gasfm_dual_attend(
    const float* xl_p, const float* xl_c, const float* xr_p, const float* xr_c,
    const float* att_p, const float* att_c, const int* pt_ptr, const int* cam_ptr,
    const int* cam_perm, int n_pts, int n_cams, int Dp, int Cp, int Dc, int Cc,
    float slope, float* out_p, float* out_c, float* m_p, float* den_p, float* m_c,
    float* den_c, void* stream) {
  using namespace gasfm;
  const int n_pt_blocks = (n_pts + kDualWarps - 1) / kDualWarps;
  const int grid = n_pt_blocks + n_cams;
  if (grid > 0) {
    dual_attend_kernel<kDualWarps><<<grid, kDualWarps * 32, 0, (cudaStream_t)stream>>>(
        xl_p, xl_c, xr_p, xr_c, att_p, att_c, pt_ptr, cam_ptr, cam_perm, n_pts,
        Dp, Cp, Dc, Cc, slope, n_pt_blocks, out_p, out_c, m_p, den_p, m_c, den_c);
  }
  return (int)cudaGetLastError();
}

extern "C" int gasfm_frontend_prologue(
    const float* e, int E, int De, const float* lng, const float* lnb, int raw,
    float eps, const float* wlp, const float* blp, int Dp, const float* wlc,
    const float* blc, int Dc, float* en, float* xl_p, float* xl_c, int grid,
    void* stream) {
  using namespace gasfm;
  if (E > 0) {
    frontend_prologue_kernel<<<grid, kFrontWarps * 32, 0, (cudaStream_t)stream>>>(
        e, E, De, lng, lnb, raw, eps, wlp, blp, Dp, wlc, blc, Dc, en, xl_p, xl_c);
  }
  return (int)cudaGetLastError();
}

// partials: (n_pt_blocks + n_cams, 32) scratch; datt: (2, 32), row 0 d att_p
// (first Dp columns), row 1 d att_c (first Dc columns).
extern "C" int gasfm_dual_attend_bwd(
    const float* xl_p, const float* xl_c, const float* xr_p, const float* xr_c,
    const float* att_p, const float* att_c, const float* out_p, const float* out_c,
    const float* m_p, const float* den_p, const float* m_c, const float* den_c,
    const float* g_p, const float* g_c, const int* pt_ptr, const int* cam_ptr,
    const int* cam_perm, int n_pts, int n_cams, int Dp, int Cp, int Dc, int Cc, float slope,
    float* dxl_p, float* dxl_c, float* dxr_p, float* dxr_c, float* datt, float* partials,
    void* stream) {
  using namespace gasfm;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_pt_blocks = (n_pts + kDualWarps - 1) / kDualWarps;
  const int grid = n_pt_blocks + n_cams;
  if (grid > 0) {
    dual_attend_bwd_kernel<kDualWarps><<<grid, kDualWarps * 32, 0, s>>>(
        xl_p, xl_c, xr_p, xr_c, att_p, att_c, out_p, out_c, m_p, den_p, m_c, den_c, g_p,
        g_c, pt_ptr, cam_ptr, cam_perm, n_pts, Dp, Cp, Dc, Cc, slope, n_pt_blocks, dxl_p,
        dxl_c, dxr_p, dxr_c, partials);
  }
  launch_column_sum(partials, n_pt_blocks, 32, datt, s);
  launch_column_sum(partials + (size_t)n_pt_blocks * 32, n_cams, 32, datt + 32, s);
  return (int)cudaGetLastError();
}

// v: (E, De) the prologue's normalized output (e itself under raw).
// ln_partials: (grid, 64) scratch; ln_sums: (2, 32), d ln_scale and d ln_bias
// in the first De columns. outer_partials: (2, ogrid, kOuterRow) scratch;
// outer_sums: (2, kOuterRow), for d wlp / d blp then d wlc / d blc, each
// [a][b] (32 x 64) then bias[a] (32).
extern "C" int gasfm_frontend_prologue_bwd(
    const float* e, int E, int De, const float* lng, const float* lnb, int raw, float eps,
    const float* wlp, int Dp, const float* wlc, int Dc, const float* dxl_p,
    const float* dxl_c, const float* den, const float* v, float* de, float* ln_partials,
    float* ln_sums, float* outer_partials, float* outer_sums, int grid, int ogrid,
    void* stream) {
  using namespace gasfm;
  cudaStream_t s = (cudaStream_t)stream;
  frontend_prologue_bwd_kernel<<<grid, kFrontWarps * 32, 0, s>>>(
      e, E, De, lng, lnb, raw, eps, wlp, Dp, wlc, Dc, dxl_p, dxl_c, den, de, ln_partials);
  launch_column_sum(ln_partials, grid, 2 * 32, ln_sums, s);
  OuterJobs jobs{};
  jobs.job[0] = OuterJob{dxl_p, Dp, 1.f, v, De, nullptr, 0};
  jobs.job[1] = OuterJob{dxl_c, Dc, 1.f, v, De, nullptr, 0};
  launch_outer_sums(jobs, 2, E, ogrid, outer_partials, outer_sums, s);
  return (int)cudaGetLastError();
}
