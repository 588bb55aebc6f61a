// The 4-way gather-broadcast edge update of the set-of-sets layers, for
// sm_90a, forward and backward:
//
//   out[e] = (pe[e] + ps[pt[e]] + pv[cam[e]] + pg) / 4
//
// with pe (E, D), ps (n, D), pv (m, D), pg (1, D).
//
// Replaces the TPU kernels of gasfm_tpu/ops/pallas/fused_update.py:
//   - gasfm_edge_combine     <- _fwd_raw / _fwd_kernel (fused_edge_combine)
//   - gasfm_edge_combine_bwd <- _bwd_raw / _bwd_kernel
// The TPU kernels gather the point window and the camera table through
// one-hot matmuls and keep the table gradients resident in VMEM across the
// sequential grid. Here the gathers are direct loads, and the table
// gradients are CSR segment sums with no cross-block state.
//
// What bounds them on the H100: bytes over 3.35 TB/s, ~0.1 flop per byte.
// Forward: read pe, write out (E x D each; 237 MB at D = 256 on the dense
// bench scene), the tables (~8 MB) read from L2 — one thread per output
// float4, consecutive threads on consecutive addresses, adds in the plain
// version's order, so the result is bitwise the plain one. Backward: read g
// once on the point side, write d pe = g / 4, d ps and d pv (E x D, n x D,
// m x D), read g again through the camera CSR. The point pass first gave
// each point a warp that walked its rows one at a time with no loads
// issued ahead: the wide scene's 670-row point on one warp made the pass
// 18x its bytes (0.60 ms at D = 256, 0.078 ms at D = 32). Now it is the
// segment sum's split walk (segment.cuh, #15/#18) with its COMBINE flag:
// short points several to a warp (runs of points per warp at D > 64), a
// long point a 32-warp block, a hub's parts merged by a second launch;
// every row the walk reads is also written back as d pe = g / 4 in the same
// vector, and each block writes the column sums of the rows it summed as
// one partial row, whose column sum (column_sum_kernel, common.cuh) is d pg
// = sum over edges of g / 4: every edge lies in exactly one short point or
// one part, so no row is counted twice and g is read once for d pe, d ps
// and d pg. The camera sums d pv are the plain segment sum of segment.cu
// (#15/#18), with its merge launch where a camera is a hub. Three launches
// per call (four or five with a hub), no float atomics: bitwise
// reproducible on a given card.
#include "segment.cuh"

namespace gasfm {

constexpr int kCombineThreads = 256;

template <int VEC>
__global__ void __launch_bounds__(kCombineThreads) edge_combine_kernel(
    const float* __restrict__ pe, const float* __restrict__ ps, const float* __restrict__ pv,
    const float* __restrict__ pg, const int* __restrict__ pt_idx,
    const int* __restrict__ cam_idx, int Dv, long long total, float* __restrict__ out) {
  using T = typename VecT<VEC>::T;
  const T* e_rows = reinterpret_cast<const T*>(pe);
  const T* s_rows = reinterpret_cast<const T*>(ps);
  const T* v_rows = reinterpret_cast<const T*>(pv);
  const T* g_row = reinterpret_cast<const T*>(pg);
  T* o = reinterpret_cast<T*>(out);
  for (long long i = (long long)blockIdx.x * kCombineThreads + threadIdx.x; i < total;
       i += (long long)gridDim.x * kCombineThreads) {
    const long long e = i / Dv;
    const int c = (int)(i - e * Dv);
    T x = e_rows[i];
    vadd(x, s_rows[(size_t)pt_idx[e] * Dv + c]);
    vadd(x, v_rows[(size_t)cam_idx[e] * Dv + c]);
    vadd(x, g_row[c]);
    o[i] = vscale(x, 0.25f);
  }
}

template <int VEC>
void launch_edge_combine(const float* pe, const float* ps, const float* pv, const float* pg,
                         const int* pt_idx, const int* cam_idx, int E, int D, float* out,
                         cudaStream_t s) {
  const int Dv = D / VEC;
  const long long total = (long long)E * Dv;
  if (total <= 0) return;
  const long long want = (total + kCombineThreads - 1) / kCombineThreads;
  const int grid = (int)(want < (1LL << 20) ? want : (1LL << 20));
  edge_combine_kernel<VEC><<<grid, kCombineThreads, 0, s>>>(pe, ps, pv, pg, pt_idx, cam_idx,
                                                            Dv, total, out);
}

}  // namespace gasfm

// out (E, D) = (pe + ps[pt_idx] + pv[cam_idx] + pg) / 4; 1 <= D <= 256,
// 16-byte aligned rows when D % 4 == 0.
extern "C" int gasfm_edge_combine(const float* pe, const float* ps, const float* pv,
                                  const float* pg, const int* pt_idx, const int* cam_idx, int E,
                                  int D, float* out, void* stream) {
  using namespace gasfm;
  cudaStream_t s = (cudaStream_t)stream;
  if (D % 4 == 0) {
    launch_edge_combine<4>(pe, ps, pv, pg, pt_idx, cam_idx, E, D, out, s);
  } else {
    launch_edge_combine<1>(pe, ps, pv, pg, pt_idx, cam_idx, E, D, out, s);
  }
  return (int)cudaGetLastError();
}

// From the cotangent g (E, D): dpe (E, D) = g / 4; dps (n, D) and dpv (m, D)
// its point and camera CSR sums / 4; dpg (D,) its column sum / 4, through
// partials: (n_chunks_p + ceil(n_pts / 32), D) scratch, one row per block
// of the point pass. Each side's split (pt_split / cam_split, n_long,
// n_chunks: the segment sum's, segment.cuh) and its (n_chunks, D) scratch
// pt_part / cam_part, read only where a segment has several parts. g and
// the outputs aligned to 16 bytes when D % 4 == 0 (8 when D % 4 == 2).
extern "C" int gasfm_edge_combine_bwd(const float* g, int D, int E, const int* pt_ptr, int n_pts,
                                      const int* pt_split, int n_long_p, int n_chunks_p,
                                      const int* cam_ptr, const int* cam_perm,
                                      const int* cam_split, int n_long_c, int n_chunks_c,
                                      int n_cams, float* dpe, float* dps, float* dpv, float* dpg,
                                      float* partials, float* pt_part, float* cam_part,
                                      void* stream) {
  using namespace gasfm;
  cudaStream_t s = (cudaStream_t)stream;
  const SegmentSplit spp(pt_split, n_long_p, n_chunks_p);
  const int rows = segment_sum_combine(g, D, pt_ptr, E, spp, n_pts, 0.25f, dps, pt_part, dpe,
                                       partials, s);
  segment_sum(g, D, cam_ptr, cam_perm, E, SegmentSplit(cam_split, n_long_c, n_chunks_c), n_cams,
              0.25f, dpv, cam_part, s);
  launch_column_sum(partials, rows, D, dpg, s);
  return (int)cudaGetLastError();
}
