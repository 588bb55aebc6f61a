// Single-direction GATv2 segment attention, for sm_90a, forward and backward.
//
// Replaces the TPU kernels of gasfm_tpu/ops/pallas/fused_attn.py:
//   - gasfm_attend     <- _fused_attn_fwd_raw / _fused_attn_fwd_kernel
//     (fused_attend_h, :624): one direction's segment-softmax aggregation;
//   - gasfm_attend_bwd <- _fused_attn_bwd_raw / _fused_attn_bwd_kernel: its
//     d xl, d xr and d att.
// The JAX package reaches them where the dual kernel does not apply: on a
// scene of more than 1024 cameras its point direction runs here (the camera
// direction runs as the composite of gathers, a segment max and segment
// sums). The TPU kernel walks the edges in chunks with windowed one-hot
// matmuls and carries an online softmax across its sequential grid; here a
// segment is a loop over its own edge rows (attend.cuh, the code the dual
// kernel runs per direction): with perm == NULL the point CSR, a warp per
// point; with perm the camera CSR, a block of kAttendWarps warps per camera.
//
// What bounds it on the H100: bytes. It reads each edge row of xl once
// (4 * D bytes), the CSR offsets (and on the camera side the permutation),
// one query row per segment, and writes one output row per segment (plus
// the (S, H) max and denominator under autograd); ~10 flops per feature and
// edge are far below the card's float32 rate. The backward reads xl, the
// forward's outputs and residuals and the cotangent, writes d xl (E x D) and
// d xr, and sums d att over all edges as per-block partial rows and a
// fixed-order column sum (common.cuh). No float atomics: results are bitwise
// reproducible on a given card.
#include "attend.cuh"

namespace gasfm {

constexpr int kAttendWarps = 16;  // warps per block: points per point block, warps per camera

template <int NWARPS>
__global__ void __launch_bounds__(NWARPS * 32) attend_kernel(
    const float* __restrict__ xl, const float* __restrict__ xr, const float* __restrict__ att,
    const int* __restrict__ ptr, const int* __restrict__ perm, int n_seg, int D, int C,
    float slope, float* __restrict__ out, float* __restrict__ m, float* __restrict__ den) {
  if (perm == nullptr) {
    const int seg = blockIdx.x * NWARPS + (threadIdx.x >> 5);
    if (seg < n_seg) attend_segment_warp(xl, xr, att, ptr, seg, D, C, slope, out, m, den);
  } else {
    attend_segment_block<NWARPS>(xl, xr, att, ptr, perm, blockIdx.x, D, C, slope, out, m, den);
  }
}

// partials: (gridDim.x, 32), one d att row per block.
template <int NWARPS>
__global__ void __launch_bounds__(NWARPS * 32) attend_bwd_kernel(
    const float* __restrict__ xl, const float* __restrict__ xr, const float* __restrict__ att,
    const float* __restrict__ out, const float* __restrict__ m, const float* __restrict__ den,
    const float* __restrict__ g, const int* __restrict__ ptr, const int* __restrict__ perm,
    int n_seg, int D, int C, float slope, float* __restrict__ dxl, float* __restrict__ dxr,
    float* __restrict__ partials) {
  __shared__ float sbuf[32];
  float acc[1] = {0.f};  // this lane's d att over the block's edges
  if (perm == nullptr) {
    const int seg = blockIdx.x * NWARPS + (threadIdx.x >> 5);
    if (seg < n_seg) {
      attend_bwd_segment_warp(xl, xr, att, out, m, den, g, ptr, seg, D, C, slope, dxl, dxr,
                              acc[0]);
    }
  } else {
    attend_bwd_segment_block<NWARPS>(xl, xr, att, out, m, den, g, ptr, perm, blockIdx.x, D, C,
                                     slope, dxl, dxr, acc[0]);
  }
  block_partial(acc, sbuf, partials + (size_t)blockIdx.x * 32);
}

inline int attend_grid(int n_seg, const int* perm) {
  return perm == nullptr ? (n_seg + kAttendWarps - 1) / kAttendWarps : n_seg;
}

}  // namespace gasfm

// out (n_seg, D) = per-segment softmax aggregation of xl (E, D) with queries
// xr (n_seg, D) and attention vector att (D,), heads of C features; the
// segments are ptr's contiguous runs (perm == NULL) or perm[ptr[s] ..].
// m, den (n_seg, H): per-head softmax max and denominator, or NULL (not
// written). D <= 32, C a power of two.
extern "C" int gasfm_attend(const float* xl, const float* xr, const float* att, const int* ptr,
                            const int* perm, int n_seg, int D, int C, float slope, float* out,
                            float* m, float* den, void* stream) {
  using namespace gasfm;
  const int grid = attend_grid(n_seg, perm);
  if (grid > 0) {
    attend_kernel<kAttendWarps><<<grid, kAttendWarps * 32, 0, (cudaStream_t)stream>>>(
        xl, xr, att, ptr, perm, n_seg, D, C, slope, out, m, den);
  }
  return (int)cudaGetLastError();
}

// The backward of gasfm_attend from its inputs, output, residuals (m, den)
// and the cotangent g (n_seg, D): dxl (E, D), dxr (n_seg, D), datt (32,)
// (first D entries). partials: (grid, 32) scratch, grid = ceil(n_seg / 16)
// point blocks (perm == NULL) or n_seg camera blocks.
extern "C" int gasfm_attend_bwd(const float* xl, const float* xr, const float* att,
                                const float* out, const float* m, const float* den,
                                const float* g, const int* ptr, const int* perm, int n_seg,
                                int D, int C, float slope, float* dxl, float* dxr, float* datt,
                                float* partials, void* stream) {
  using namespace gasfm;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = attend_grid(n_seg, perm);
  if (grid > 0) {
    attend_bwd_kernel<kAttendWarps><<<grid, kAttendWarps * 32, 0, s>>>(
        xl, xr, att, out, m, den, g, ptr, perm, n_seg, D, C, slope, dxl, dxr, partials);
  }
  launch_column_sum(partials, grid, 32, datt, s);
  return (int)cudaGetLastError();
}
