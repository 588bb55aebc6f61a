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
// version's order, so the result is bitwise the plain one. Backward: one
// read of g gives d pe = g / 4 and the point sums d ps (a warp per point
// over its contiguous rows, segment.cuh), and the same warps keep running
// column sums of their points' d ps rows, merged per block in warp order
// into one partial row; every edge is in exactly one point segment, so the
// column sum of those partial rows (column_sum_kernel, common.cuh) is d pg
// = sum over edges of g / 4 — no second pass over g. The camera sums d pv
// read g a second time through the camera CSR: the segment sum of
// segment.cu (#15/#18), with its merge launch where a camera is a hub.
// Three launches per call (four with a hub), no float atomics: bitwise
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

// Backward, point side: per point (warp, grid-stride) d pe = g / 4 for its
// rows and d ps = sum of them; each block writes the sum of its points' d ps
// rows to partials[blockIdx.x] (D floats).
template <int VEC>
__global__ void __launch_bounds__(kSegWarps * 32) edge_combine_bwd_point_kernel(
    const float* __restrict__ g, int D, const int* __restrict__ pt_ptr, int n_pts,
    float* __restrict__ dpe, float* __restrict__ dps, float* __restrict__ partials) {
  using T = typename VecT<VEC>::T;
  __shared__ __align__(16) float part[kSegWarps][kSegMaxD];
  const T* rows = reinterpret_cast<const T*>(g);
  T* de = reinterpret_cast<T*>(dpe);
  const int warp = threadIdx.x >> 5;
  RowSum<VEC> rs, tot;
  rs.init(D);
  tot.init(D);
  for (int s = blockIdx.x * kSegWarps + warp; s < n_pts; s += gridDim.x * kSegWarps) {
    rs.clear();
    const int end = pt_ptr[s + 1];
    for (int e = pt_ptr[s] + rs.sub; e < end; e += rs.R) {
      const T* row = rows + (size_t)e * rs.Dv;
#pragma unroll
      for (int k = 0; k < RowSum<VEC>::KMAX; ++k) {
        const int c = rs.col + rs.W * k;
        if (c < rs.Dv) {
          const T x = vscale(row[c], 0.25f);
          de[(size_t)e * rs.Dv + c] = x;
          vadd(rs.acc[k], x);
        }
      }
    }
    rs.merge_groups();
    rs.store(reinterpret_cast<T*>(dps), s, 1.f);
#pragma unroll
    for (int k = 0; k < RowSum<VEC>::KMAX; ++k) vadd(tot.acc[k], rs.acc[k]);
  }
  tot.store_shared(part[warp]);  // zeros for a warp without a point
  __syncthreads();
  for (int f = threadIdx.x; f < D; f += kSegWarps * 32) {
    float t = 0.f;
    for (int w = 0; w < kSegWarps; ++w) t += part[w][f];
    partials[(size_t)blockIdx.x * D + f] = t;
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

template <int VEC>
void launch_edge_combine_bwd(const float* g, int D, int E, const int* pt_ptr, int n_pts,
                             const int* cam_ptr, const int* cam_perm, const SegmentSplit& spc,
                             int n_cams, int grid, float* dpe, float* dps, float* dpv,
                             float* dpg, float* partials, float* cam_part, cudaStream_t s) {
  edge_combine_bwd_point_kernel<VEC><<<grid, kSegWarps * 32, 0, s>>>(g, D, pt_ptr, n_pts, dpe,
                                                                     dps, partials);
  segment_sum(g, D, cam_ptr, cam_perm, E, spc, n_cams, 0.25f, dpv, cam_part, s);
  launch_column_sum(partials, grid, D, dpg, s);
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
// its point and camera CSR sums / 4; dpg (D,) its column sum / 4 (through
// partials, (grid, D) scratch, grid >= 1 blocks of the point pass). The
// camera sums take the cameras' split (cam_split, n_long_c, n_chunks_c; the
// segment sum's, segment.cuh) and cam_part, (n_chunks_c, D) scratch.
extern "C" int gasfm_edge_combine_bwd(const float* g, int D, int E, const int* pt_ptr, int n_pts,
                                      const int* cam_ptr, const int* cam_perm,
                                      const int* cam_split, int n_long_c, int n_chunks_c,
                                      int n_cams, int grid, float* dpe, float* dps, float* dpv,
                                      float* dpg, float* partials, float* cam_part,
                                      void* stream) {
  using namespace gasfm;
  cudaStream_t s = (cudaStream_t)stream;
  const SegmentSplit spc(cam_split, n_long_c, n_chunks_c);
  if (D % 4 == 0) {
    launch_edge_combine_bwd<4>(g, D, E, pt_ptr, n_pts, cam_ptr, cam_perm, spc, n_cams, grid, dpe,
                               dps, dpv, dpg, partials, cam_part, s);
  } else {
    launch_edge_combine_bwd<1>(g, D, E, pt_ptr, n_pts, cam_ptr, cam_perm, spc, n_cams, grid, dpe,
                               dps, dpv, dpg, partials, cam_part, s);
  }
  return (int)cudaGetLastError();
}
