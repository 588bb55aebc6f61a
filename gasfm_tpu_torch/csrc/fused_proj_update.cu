// The standalone projection update of a GASFM layer, for sm_90a, forward and
// backward:
//
//   e = ([en | skip2] . W^T + b + pg + ps[pt] + pv[cam]) / 4  (+ res)
//
// Replaces the TPU kernels of gasfm_tpu/ops/pallas/fused_proj_update.py:
//   - gasfm_proj_update     <- _fwd_raw / _fwd_kernel (packed_edge_update, :464)
//   - gasfm_proj_update_bwd <- _bwd_raw / _bwd_kernel
// The JAX package runs it on a packed layer whose successor is not packed
// (the depth head's layer L-2, whose successor widens the stream), where the
// update cannot defer into the next layer-step kernel. The TPU kernels work
// on lane-packed streams (4 edges per 128-lane row) with block-diagonal
// weights, one-hot matmul gathers of the point window and the camera table,
// and table gradients resident across the sequential grid. None of that
// carries over: here a warp owns an edge row (proj_update.cuh; the layer
// step's forward ran the same code until it took the edge tiles of
// edge_tile.cuh), the gathers are direct loads, and the table gradients are
// CSR segment sums.
//
// What bounds it on the H100: bytes over 3.35 TB/s. The forward reads en,
// skip2 and res and the two gathered table rows per edge and writes e, about
// 0.65 KB per edge at De = 32, d2 = 2, against ~2 * 34 * 32 flops; the
// weights (<= 64 x 32) sit in shared memory for the whole grid-stride sweep.
// The backward reads g once per edge in a warp per point (d en, d skip2 and
// the point sums d ps, in registers), g again through the camera CSR (d pv, a
// block per camera), and g, en and skip2 once more for the tiled outer sums of
// d W and d b (outer_sum_kernel, common.cuh); d res = g is the wrapper's, with
// no kernel work. No float atomics: bitwise reproducible on a given card.
#include "proj_update.cuh"

namespace gasfm {

constexpr int kUpdateWarps = 8;

__global__ void __launch_bounds__(kUpdateWarps * 32) proj_update_kernel(
    const float* __restrict__ en, int d_in, const float* __restrict__ skip2, int d2,
    const float* __restrict__ res, const float* __restrict__ w,
    const float* __restrict__ b, const float* __restrict__ pg,
    const float* __restrict__ ps, const float* __restrict__ pv,
    const int* __restrict__ pt_idx, const int* __restrict__ cam_idx, int E, int De,
    float* __restrict__ out) {
  __shared__ UpdateParams su;
  load_update_params(su, w, b, pg, De, d_in + d2);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kUpdateWarps;
  for (int edge = blockIdx.x * kUpdateWarps + (threadIdx.x >> 5); edge < E; edge += stride) {
    const float x = update_forward(su, edge, lane, en, d_in, skip2, d2, res, ps, pv, pt_idx,
                                   cam_idx, De);
    if (lane < De) out[(size_t)edge * De + lane] = x;
  }
}

// Warp per point, over the point's contiguous edges (grid-stride over points):
// d en and d skip2 per edge, and d ps = the point's sum of g / 4 (0 for a point
// without edges).
__global__ void __launch_bounds__(kUpdateWarps * 32) proj_update_bwd_kernel(
    const float* __restrict__ g, const float* __restrict__ w, const int* __restrict__ pt_ptr,
    int n_pts, int d_in, int d2, int De, float* __restrict__ den,
    float* __restrict__ dskip2, float* __restrict__ dps) {
  __shared__ float s_w[32 * kUpdateMaxK];  // W (De, d_in + d2), torch layout
  load_update_weights(s_w, w, De, d_in + d2);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kUpdateWarps;
  for (int pt = blockIdx.x * kUpdateWarps + (threadIdx.x >> 5); pt < n_pts; pt += stride) {
    float dps_acc = 0.f;
    const int end = pt_ptr[pt + 1];
    for (int edge = pt_ptr[pt]; edge < end; ++edge) {
      const float du = lane < De ? g[(size_t)edge * De + lane] * 0.25f : 0.f;
      dps_acc += du;
      update_backward(du, edge, lane, s_w, De, d_in, d2, den, dskip2);
    }
    if (lane < De) dps[(size_t)pt * De + lane] = dps_acc;
  }
}

}  // namespace gasfm

// en (E, d_in), skip2 (E, d2) or NULL, res (E, De) or NULL, w (De, d_in + d2),
// b, pg (De,), ps (n, De), pv (m, De); out (E, De).
extern "C" int gasfm_proj_update(const float* en, int d_in, const float* skip2, int d2,
                                 const float* res, const float* w, const float* b,
                                 const float* pg, const float* ps, const float* pv,
                                 const int* pt_idx, const int* cam_idx, int E, int De,
                                 float* out, int grid, void* stream) {
  using namespace gasfm;
  if (E > 0) {
    proj_update_kernel<<<grid, kUpdateWarps * 32, 0, (cudaStream_t)stream>>>(
        en, d_in, skip2, d2, res, w, b, pg, ps, pv, pt_idx, cam_idx, E, De, out);
  }
  return (int)cudaGetLastError();
}

// g (E, De) the cotangent of e; den (E, d_in); dskip2 (E, d2) or NULL; dps (n,
// De); dpv (m, De). outer_partials (ogrid, kOuterRow) scratch; outer_sums
// (kOuterRow): d W [a][b] (32 x 64, columns en's then skip2's) then d b[a].
extern "C" int gasfm_proj_update_bwd(const float* g, const float* en, int d_in,
                                     const float* skip2, int d2, const float* w,
                                     const int* pt_ptr, int n_pts, const int* cam_ptr,
                                     const int* cam_perm, int n_cams, int E, int De,
                                     float* den, float* dskip2, float* dps, float* dpv,
                                     float* outer_partials, float* outer_sums, int grid,
                                     int ogrid, void* stream) {
  using namespace gasfm;
  cudaStream_t s = (cudaStream_t)stream;
  proj_update_bwd_kernel<<<grid, kUpdateWarps * 32, 0, s>>>(g, w, pt_ptr, n_pts, d_in, d2, De,
                                                            den, dskip2, dps);
  launch_camera_update_sums(g, cam_ptr, cam_perm, n_cams, De, dpv, s);
  OuterJobs jobs{};
  jobs.job[0] = OuterJob{g, De, 0.25f, en, d_in, skip2, d2};
  launch_outer_sums(jobs, 1, E, ogrid, outer_partials, outer_sums, s);
  return (int)cudaGetLastError();
}
