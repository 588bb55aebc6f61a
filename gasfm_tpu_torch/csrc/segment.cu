// CSR segment sum, segment max and row gather, for sm_90a.
//
// Replaces the TPU kernels of gasfm_tpu/ops/pallas/segment_kernels.py:
//   - gasfm_segment_sum <- _segment_sum_raw (segment_sum_kernel, the dense
//     one-hot sum used for the cameras) and _wseg_sum_raw
//     (windowed_segment_sum, the point-window sum), on split segments
//     (segment.cuh);
//   - gasfm_segment_max <- _segment_max_raw (segment_max_kernel, dense) and
//     _wseg_max_raw (windowed_segment_max): the per-segment max of the
//     softmax shifts, (E, d <= 8) -> (S, d), empty segments -> neutral. No
//     backward: its callers take the max of detached logits. It is the
//     sum's walk and split with fmaxf from -inf (segment.cuh, MaxRed);
//   - gasfm_gather_rows <- _gather_rows_raw (gather_rows_kernel) and
//     _wgather_raw (windowed_gather).
// The TPU kernels gather and scatter by one-hot matmuls on the MXU, over
// point windows or the whole (<= 1024-row) camera table. Here the edges of a
// point are contiguous in the point-major layout and the edges of a camera
// are listed by the camera CSR (cam_perm), so "windowed" and "dense"
// collapse into one CSR walk per segment: the point side with perm = NULL,
// the camera side through perm. Each kernel is the other's backward.
//
// What bounds them on the H100: bytes over 3.35 TB/s. A segment sum reads
// its E x D input once and writes S x D (plus the offsets and, on the camera
// side, the permutation): ~127 MB at D = 256 on the dense bench scene, ~38
// us. Its design against that is segment.cuh's: both CSRs split by length
// once per graph on the host (a point per warp and a camera per 32-warp
// block before), short segments several to a warp with rows' loads in
// flight, long ones a block each, a hub cut into parts whose partial rows a
// second launch adds in part order.
//
// The max reads E x d <= 8 floats (47,383 x 4 on the wide scene: 0.97 MB
// with the CSR, 0.3 us at 3.35 TB/s): a call is its launch and a chain of
// DRAM latencies (offsets, permutation, rows). Its first design gave a point
// a warp and a camera an 8-warp block, most of whose lanes held no row (a
// wide-scene camera has ~37): 3.4 us a call on the wide scene's cameras at
// D = 4, 8.2 on its points (H100 80GB HBM3, 700 W). On the sum's walk four
// short segments share a warp, each lane with 8 rows' loads in flight, in
// blocks of 8 warps (the wide scene's cameras take 40 SMs): 2.3 and 2.6 us.
//
// The gather writes E x D and reads each table row once per edge (the
// tables, at most 25 MB on the bench scenes, stay in the 50 MB L2): at D =
// 256 ~127 MB, the same ~38 us. Its first design gave one thread to each
// 16-byte vector, with a 64-bit division per vector and ids[e] reloaded for
// every vector of the row, and lost to index_select on the power-law scene.
// Now it uses the sums' row groups (W lanes per row: two float4 per lane at
// D = 256, one float2 per lane and row at D = 2): a warp takes 32
// consecutive edges, loads their 32 ids in one coalesced access, and hands
// each row group its id by a shuffle; all index arithmetic is 32-bit (the
// wrapper holds E x D and S x D below 2^31); four rows' loads are issued
// before their stores (4 KB in flight per warp at D = 256), and the E x D
// output is written with streaming stores (__stcs) so it does not push the
// table out of L2.
#include "segment.cuh"

namespace gasfm {

// Warps per block: two for rows of 64 floats or more, so the blocks (each
// writing 32 rows per warp) spread evenly over the SMs; eight for narrower
// rows, whose blocks are cheap to fill and many.
constexpr int kGatherWarpsWide = 2, kGatherWarpsNarrow = 8;
constexpr int kGatherUnroll = 4;  // row steps whose loads are in flight together

// out[e] = table[ids[e]], Dv vectors of VEC floats per row. Warp w takes the
// 32 edges [32 w, 32 w + 32), kGatherUnroll row steps at a time: each row
// group loads kGatherUnroll rows, then stores them.
template <int VEC>
__global__ void __launch_bounds__(kGatherWarpsNarrow * 32) gather_rows_kernel(
    const float* __restrict__ table, int Dv, const int* __restrict__ ids, int E,
    float* __restrict__ out) {
  using T = typename VecT<VEC>::T;
  constexpr int KMAX = 8 / VEC;  // vector columns per lane (D <= 256)
  const T* tab = reinterpret_cast<const T*>(table);
  T* o = reinterpret_cast<T*>(out);
  const int lane = threadIdx.x & 31;
  const int W = row_lanes(Dv), R = 32 / W, sub = lane / W, col = lane % W;
  const int e0 = (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * 32;
  if (e0 >= E) return;
  const int my_id = e0 + lane < E ? ids[e0 + lane] : 0;
  const int rows = min(32, E - e0);
  for (int r0 = 0; r0 < rows; r0 += R * kGatherUnroll) {
    T v[kGatherUnroll][KMAX];
#pragma unroll
    for (int u = 0; u < kGatherUnroll; ++u) {
      const int r = r0 + u * R + sub;
      const int id = __shfl_sync(GASFM_FULL_MASK, my_id, r & 31);
      if (r >= rows) continue;
      const T* src = tab + id * Dv;
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        const int c = col + W * k;
        if (c < Dv) v[u][k] = src[c];
      }
    }
#pragma unroll
    for (int u = 0; u < kGatherUnroll; ++u) {
      const int r = r0 + u * R + sub;
      if (r >= rows) continue;
      T* dst = o + (e0 + r) * Dv;
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        const int c = col + W * k;
        if (c < Dv) stcs(dst + c, v[u][k]);
      }
    }
  }
}

template <int VEC>
void launch_gather(const float* table, int D, const int* ids, int E, float* out,
                   cudaStream_t s) {
  if (E <= 0) return;
  const int warps = (E + 31) / 32;
  const int per_block = D >= 64 ? kGatherWarpsWide : kGatherWarpsNarrow;
  gather_rows_kernel<VEC><<<(warps + per_block - 1) / per_block, per_block * 32, 0, s>>>(
      table, D / VEC, ids, E, out);
}

}  // namespace gasfm

// out (n_seg, D) = per-segment sums of data (E, D): the rows ptr[s] ..
// ptr[s+1] (perm == NULL, the point CSR) or perm[ptr[s]] .. (the camera
// CSR). `split`: the segments of more than kSumRows rows (n_long of them)
// cut into n_chunks parts of kSumPartRows rows (ViewGraph.pt_chunks /
// cam_chunks, layout SegmentSplit); part: (n_chunks, D) scratch, written
// only for a hub's parts (NULL where no segment has several). Empty
// segments give 0.
// 1 <= D <= 256; data, out and part aligned to 16 bytes when D % 4 == 0 (8
// when D % 4 == 2).
extern "C" int gasfm_segment_sum(const float* data, int D, int E, const int* ptr,
                                 const int* perm, const int* split, int n_long, int n_chunks,
                                 int n_seg, float* out, float* part, void* stream) {
  using namespace gasfm;
  segment_sum(data, D, ptr, perm, E, SegmentSplit(split, n_long, n_chunks), n_seg, 1.f, out,
              part, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// out (n_seg, D) = per-segment max of data (E, D) over the same segments,
// split and scratch as gasfm_segment_sum's; an empty segment gives
// `neutral`. 1 <= D <= 8; data, out and part aligned as there.
extern "C" int gasfm_segment_max(const float* data, int D, int E, const int* ptr,
                                 const int* perm, const int* split, int n_long, int n_chunks,
                                 int n_seg, float neutral, float* out, float* part,
                                 void* stream) {
  using namespace gasfm;
  segment_max(data, D, ptr, perm, E, SegmentSplit(split, n_long, n_chunks), n_seg, neutral, out,
              part, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// out (E, D) = table[ids] with table (S, D); 1 <= D <= 256.
extern "C" int gasfm_gather_rows(const float* table, int D, const int* ids, int E, float* out,
                                 void* stream) {
  using namespace gasfm;
  cudaStream_t s = (cudaStream_t)stream;
  if (D % 4 == 0) {
    launch_gather<4>(table, D, ids, E, out, s);
  } else if (D % 2 == 0) {
    launch_gather<2>(table, D, ids, E, out, s);
  } else {
    launch_gather<1>(table, D, ids, E, out, s);
  }
  return (int)cudaGetLastError();
}
