// Dual GATv2 segment attention and the layer frontend, for sm_90a.
//
// Replaces the TPU kernels of gasfm_tpu/ops/pallas/fused_dual_attn.py:
//   - gasfm_dual_attend       <- _dual_fwd_raw / _dual_fwd_kernel (fused_dual_attend)
//   - gasfm_frontend_prologue <- the LN + ReLU + source-linear prologue of
//     _front_fwd_raw / _front_fwd_kernel (fused_frontend); the wrapper runs
//     gasfm_dual_attend right after it.
//
// What bounds it on the H100: bytes. Per edge the core reads its two source
// rows (xl_p, xl_c: 4*(Dp+Dc) bytes) and one camera-order index; per segment
// one query row and one output row; ~10 flops per feature and edge are far
// below the card's float32 rate, so the floor is those bytes over 3.35 TB/s.
// Design against it: no one-hot matmuls (the TPU kernel's way to gather on
// the MXU) — the edges of a point are contiguous in the point-major layout
// and the edges of a camera are listed by the camera CSR, so each segment is
// a loop over its own rows, read once, with the online softmax (m, den, num)
// in registers. Query rows are loaded once per segment.
//   - Point side: one warp per point (14 edges per point on the dense bench
//     scene, 3 on the power-law one); lane = feature, head = lane / C.
//   - Camera side: one block per camera (up to ~1,300 edges); its warps
//     stride over the camera's edge list and merge their (m, den, num)
//     triples in shared memory in a fixed order.
// No float atomics anywhere: results are bitwise reproducible run to run.
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
    float* __restrict__ out_c) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if ((int)blockIdx.x < n_pt_blocks) {
    // ---- point side: warp per point, its edges are contiguous.
    const int pt = blockIdx.x * NWARPS + warp;
    if (pt >= n_pts) return;
    const bool act = lane < Dp;
    const float xr = act ? xr_p[(size_t)pt * Dp + lane] : 0.f;
    const float at = act ? att_p[lane] : 0.f;
    Online s;
    s.init();
    const int end = pt_ptr[pt + 1];
    for (int e = pt_ptr[pt]; e < end; ++e) {
      const float x = act ? xl_p[(size_t)e * Dp + lane] : 0.f;
      s.push(group_sum(leaky_relu(x + xr, slope) * at, Cp), x);
    }
    if (act) out_p[(size_t)pt * Dp + lane] = s.finish();
    return;
  }

  // ---- camera side: block per camera, warps stride over its edge list.
  __shared__ float sm[NWARPS][32], sd[NWARPS][32], sn[NWARPS][32];
  const int cam = blockIdx.x - n_pt_blocks;
  const bool act = lane < Dc;
  const float xr = act ? xr_c[(size_t)cam * Dc + lane] : 0.f;
  const float at = act ? att_c[lane] : 0.f;
  Online s;
  s.init();
  const int end = cam_ptr[cam + 1];
  for (int i = cam_ptr[cam] + warp; i < end; i += NWARPS) {
    const int e = cam_perm[i];
    const float x = act ? xl_c[(size_t)e * Dc + lane] : 0.f;
    s.push(group_sum(leaky_relu(x + xr, slope) * at, Cc), x);
  }
  sm[warp][lane] = s.m;
  sd[warp][lane] = s.den;
  sn[warp][lane] = s.num;
  __syncthreads();
  if (warp == 0) {
    Online t;
    t.init();
    for (int w = 0; w < NWARPS; ++w) t.merge(sm[w][lane], sd[w][lane], sn[w][lane]);
    if (act) out_c[(size_t)cam * Dc + lane] = t.finish();
  }
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

}  // namespace gasfm

extern "C" int gasfm_dual_attend(
    const float* xl_p, const float* xl_c, const float* xr_p, const float* xr_c,
    const float* att_p, const float* att_c, const int* pt_ptr, const int* cam_ptr,
    const int* cam_perm, int n_pts, int n_cams, int Dp, int Cp, int Dc, int Cc,
    float slope, float* out_p, float* out_c, void* stream) {
  using namespace gasfm;
  const int n_pt_blocks = (n_pts + kDualWarps - 1) / kDualWarps;
  const int grid = n_pt_blocks + n_cams;
  if (grid > 0) {
    dual_attend_kernel<kDualWarps><<<grid, kDualWarps * 32, 0, (cudaStream_t)stream>>>(
        xl_p, xl_c, xr_p, xr_c, att_p, att_c, pt_ptr, cam_ptr, cam_perm, n_pts,
        Dp, Cp, Dc, Cc, slope, n_pt_blocks, out_p, out_c);
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
