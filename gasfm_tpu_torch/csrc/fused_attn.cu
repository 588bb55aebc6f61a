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
// sums). The TPU kernel walks the edges in fixed chunks with windowed
// one-hot matmuls and carries an online softmax across its sequential grid,
// so its work per grid step is bounded whatever the degrees.
//
// The point side keeps that bound: the points come split by length once per
// graph on the host (ViewGraph.pt_chunks), and a warp walks either a quad of
// four short points or one 32-edge chunk of a long one (attend_split.cuh,
// the device code the dual core's backward shares), the chunks after the
// quads. A chunk writes a partial (the online triple forward, the d xr sum
// backward) and a second launch merges each long point's partials in chunk
// order (flash-decoding). The forward's residual m is the max over all of a
// point's chunks, as the backward's exp(min(logit - m, 0)) needs.
//
// The camera side (perm != NULL) is a block of kAttendWarps warps per camera,
// the dual forward's camera code (attend.cuh). The JAX package never takes it.
//
// What bounds it on the H100: bytes. It reads each edge row of xl once
// (4 * D bytes), the CSR offsets (and on the camera side the permutation),
// one query row per segment, and writes one output row per segment (plus
// the (S, H) max and denominator under autograd); ~10 flops per feature and
// edge are far below the card's float32 rate. The backward reads xl, the
// forward's outputs and residuals and the cotangent, writes d xl (E x D) and
// d xr, and sums d att over all edges as per-block partial rows and a
// fixed-order column sum (common.cuh). No float atomics: every sum is taken
// in a fixed order, so results are bitwise reproducible on a given card.
#include "attend_split.cuh"

namespace gasfm {

constexpr int kAttendWarps = 16;         // warps per camera block
constexpr int kPointWarps = 8;           // warps per point-side block
constexpr int kPointBwdBlocksPerSm = 4;  // resident backward blocks per SM (64 registers)

// ---- the camera side: a block per camera (attend.cuh) ------------------------

template <int NWARPS>
__global__ void __launch_bounds__(NWARPS * 32) attend_camera_kernel(
    const float* __restrict__ xl, const float* __restrict__ xr, const float* __restrict__ att,
    const int* __restrict__ ptr, const int* __restrict__ perm, int D, int C, float slope,
    float* __restrict__ out, float* __restrict__ m, float* __restrict__ den) {
  attend_segment_block<NWARPS>(xl, xr, att, ptr, perm, blockIdx.x, D, C, slope, out, m, den);
}

// partials: (gridDim.x, 32), one d att row per block.
template <int NWARPS>
__global__ void __launch_bounds__(NWARPS * 32) attend_camera_bwd_kernel(
    const float* __restrict__ xl, const float* __restrict__ xr, const float* __restrict__ att,
    const float* __restrict__ out, const float* __restrict__ m, const float* __restrict__ den,
    const float* __restrict__ g, const int* __restrict__ ptr, const int* __restrict__ perm,
    int D, int C, float slope, float* __restrict__ dxl, float* __restrict__ dxr,
    float* __restrict__ partials) {
  __shared__ float sbuf[32];
  float acc[1] = {0.f};  // this lane's d att over the block's edges
  attend_bwd_segment_block<NWARPS>(xl, xr, att, out, m, den, g, ptr, perm, blockIdx.x, D, C,
                                   slope, dxl, dxr, acc[0]);
  block_partial(acc, sbuf, partials + (size_t)blockIdx.x * 32);
}

// ---- the point side: quads of short points, chunks of long ones (attend_split.cuh)

// Forward, one unit per warp: the quads, then the chunks. part: (n_chunks,
// kTriple), each chunk's triple.
template <int NWARPS, int NH>
__global__ void __launch_bounds__(NWARPS * 32) attend_point_kernel(
    const float* __restrict__ xl, const float* __restrict__ xr, const float* __restrict__ att,
    const int* __restrict__ ptr, SegmentSplit sp, int n_seg, int n_quads, int D, int C,
    float slope, float* __restrict__ out, float* __restrict__ m, float* __restrict__ den,
    float* __restrict__ part) {
  const int lane = threadIdx.x & 31;
  const int u = blockIdx.x * NWARPS + (threadIdx.x >> 5);
  if (u < n_quads) {
    attend_quad<NH>(xl, xr, att, ptr, n_seg, u, D, C, slope, out, m, den);
    return;
  }
  const int k = u - n_quads;
  if (k >= sp.n_chunks) return;
  int seg, begin, end;
  chunk_rows(ptr, sp, k, seg, begin, end);
  const bool act = lane < D;
  const float q = act ? xr[(size_t)seg * D + lane] : 0.f;
  const float at = act ? att[lane] : 0.f;
  const Online s = attend_rows(xl, begin, end, D, C, q, at, slope, lane);
  float* p = part + (size_t)k * kTriple;
  p[lane] = s.m;
  p[32 + lane] = s.den;
  p[64 + lane] = s.num;
}

// Forward, second launch: a warp per long point merges its chunks' triples
// in chunk order (kChunkUnroll chunks loaded ahead) and writes the point's
// results.
template <int NWARPS>
__global__ void __launch_bounds__(NWARPS * 32) attend_merge_kernel(
    const float* __restrict__ part, SegmentSplit sp, int D, int C, float* __restrict__ out,
    float* __restrict__ m, float* __restrict__ den) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * NWARPS + (threadIdx.x >> 5);
  if (i >= sp.n_long) return;
  const Online t = merge_triples(part, sp.long_ptr[i], sp.long_ptr[i + 1], lane);
  attend_store(t, sp.long_seg[i], D, C, lane, out, m, den);
}


// Backward: warps stride over the units, quads then chunks (a fixed
// assignment for a given grid). A quad writes its short points' d xr rows;
// a chunk its d xr partial row, dxr_part (n_chunks, 32). partials:
// (gridDim.x, 32), one d att row per block: each lane's quad sums (4
// features) are summed over the warp's four points in a fixed order and
// handed to the lane of each feature.
template <int NWARPS, int NH>
__global__ void __launch_bounds__(NWARPS * 32, kPointBwdBlocksPerSm) attend_point_bwd_kernel(
    const float* __restrict__ xl, const float* __restrict__ xr, const float* __restrict__ att,
    const float* __restrict__ out, const float* __restrict__ m, const float* __restrict__ den,
    const float* __restrict__ g, const int* __restrict__ ptr, SegmentSplit sp, int n_seg,
    int n_quads, int D, int C, float slope, float* __restrict__ dxl, float* __restrict__ dxr,
    float* __restrict__ dxr_part, float* __restrict__ partials) {
  __shared__ float sbuf[32];
  const int lane = threadIdx.x & 31;
  float acc[1] = {0.f};                  // this lane's d att (feature lane) over its chunks
  float acc4[4] = {0.f, 0.f, 0.f, 0.f};  // and over its quads (features c0 .. c0 + 3)
  const int n_units = n_quads + sp.n_chunks;
  for (int u = blockIdx.x * NWARPS + (threadIdx.x >> 5); u < n_units; u += gridDim.x * NWARPS) {
    if (u < n_quads) {
      attend_bwd_quad<NH>(xl, xr, att, out, m, den, g, ptr, n_seg, u, D, C, slope, dxl, dxr,
                          acc4);
      continue;
    }
    const int k = u - n_quads;
    int seg, begin, end;
    chunk_rows(ptr, sp, k, seg, begin, end);
    const AttendBwdLane q = attend_bwd_lane(xr, att, out, g, m, den, seg, D, C, lane);
    float sum = 0.f;
    attend_bwd_rows(q, xl, begin, end, D, C, slope, lane, dxl, sum, acc[0]);
    dxr_part[(size_t)k * 32 + lane] = sum;
  }
  acc[0] += quad_datt_lane(acc4);
  block_partial(acc, sbuf, partials + (size_t)blockIdx.x * 32);
}

// Backward, second launch: a warp per long point sums its chunks' d xr rows
// in chunk order (kChunkUnroll rows loaded ahead).
template <int NWARPS>
__global__ void __launch_bounds__(NWARPS * 32) attend_bwd_merge_kernel(
    const float* __restrict__ dxr_part, SegmentSplit sp, int D, float* __restrict__ dxr) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * NWARPS + (threadIdx.x >> 5);
  if (i >= sp.n_long) return;
  const float t = sum_rows_in_order<kChunkUnroll>(dxr_part, sp.long_ptr[i], sp.long_ptr[i + 1],
                                                  lane);
  if (lane < D) dxr[(size_t)sp.long_seg[i] * D + lane] = t;
}

}  // namespace gasfm

// out (n_seg, D) = per-segment softmax aggregation of xl (E, D) with queries
// xr (n_seg, D) and attention vector att (D,), heads of C features.
// m, den (n_seg, H): per-head softmax max and denominator, or NULL (not
// written). D <= 32, C a power of two. The segments are:
//   - with perm != NULL, perm[ptr[s] .. ptr[s+1]) (the camera side); split
//     and part are unused;
//   - with perm == NULL, ptr's contiguous runs (the point side), split by
//     length in `split` (n_long long points, n_chunks chunks; layout
//     SegmentSplit); part: (n_chunks, 96) scratch. xl, xr and att are read
//     as 16-byte vectors when D % 4 == 0 and must then be 16-byte aligned.
extern "C" int gasfm_attend(const float* xl, const float* xr, const float* att, const int* ptr,
                            const int* perm, const int* split, int n_long, int n_chunks,
                            int n_seg, int D, int C, float slope, float* out, float* m,
                            float* den, float* part, void* stream) {
  using namespace gasfm;
  cudaStream_t s = (cudaStream_t)stream;
  if (perm != nullptr) {
    if (n_seg > 0) {
      attend_camera_kernel<kAttendWarps><<<n_seg, kAttendWarps * 32, 0, s>>>(
          xl, xr, att, ptr, perm, D, C, slope, out, m, den);
    }
    return (int)cudaGetLastError();
  }
  const SegmentSplit sp(split, n_long, n_chunks);
  const int n_quads = blocks_of(n_seg, kQuad);
  const int units = n_quads + n_chunks;
  if (units > 0) {
    by_heads(C, [&](auto nh) {
      attend_point_kernel<kPointWarps, decltype(nh)::value>
          <<<blocks_of(units, kPointWarps), kPointWarps * 32, 0, s>>>(
              xl, xr, att, ptr, sp, n_seg, n_quads, D, C, slope, out, m, den, part);
    });
  }
  if (n_long > 0) {
    attend_merge_kernel<kPointWarps><<<blocks_of(n_long, kPointWarps), kPointWarps * 32, 0, s>>>(
        part, sp, D, C, out, m, den);
  }
  return (int)cudaGetLastError();
}

// The backward of gasfm_attend from its inputs, output, residuals (m, den)
// and the cotangent g (n_seg, D): dxl (E, D), dxr (n_seg, D), datt (32,)
// (first D entries). partials: (n_blocks, 32) scratch, one row per block of
// the main launch: n_seg camera blocks (perm != NULL), or on the point side
// the caller's grid of kPointWarps-warp blocks (at most
// kPointBwdBlocksPerSm per SM, all resident). dxr_part: (n_chunks, 32)
// scratch of the point side. On the point side the (n_seg, D) and (E, D)
// streams are read and written as 16-byte vectors when D % 4 == 0 and must
// then be 16-byte aligned.
extern "C" int gasfm_attend_bwd(const float* xl, const float* xr, const float* att,
                                const float* out, const float* m, const float* den,
                                const float* g, const int* ptr, const int* perm,
                                const int* split, int n_long, int n_chunks, int n_seg, int D,
                                int C, float slope, float* dxl, float* dxr, float* datt,
                                float* dxr_part, float* partials, int n_blocks, void* stream) {
  using namespace gasfm;
  cudaStream_t s = (cudaStream_t)stream;
  if (perm != nullptr) {
    if (n_seg > 0) {
      attend_camera_bwd_kernel<kAttendWarps><<<n_seg, kAttendWarps * 32, 0, s>>>(
          xl, xr, att, out, m, den, g, ptr, perm, D, C, slope, dxl, dxr, partials);
    }
    launch_column_sum(partials, n_seg, 32, datt, s);
    return (int)cudaGetLastError();
  }
  const SegmentSplit sp(split, n_long, n_chunks);
  const int n_quads = blocks_of(n_seg, kQuad);
  if (n_blocks > 0) {
    by_heads(C, [&](auto nh) {
      attend_point_bwd_kernel<kPointWarps, decltype(nh)::value>
          <<<n_blocks, kPointWarps * 32, 0, s>>>(xl, xr, att, out, m, den, g, ptr, sp, n_seg,
                                                 n_quads, D, C, slope, dxl, dxr, dxr_part,
                                                 partials);
    });
  }
  if (n_long > 0) {
    attend_bwd_merge_kernel<kPointWarps>
        <<<blocks_of(n_long, kPointWarps), kPointWarps * 32, 0, s>>>(dxr_part, sp, D, dxr);
  }
  launch_column_sum(partials, n_blocks, 32, datt, s);
  return (int)cudaGetLastError();
}
