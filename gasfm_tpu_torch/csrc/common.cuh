// Device helpers shared by the port's kernels (sm_90a, float32 throughout).
//
// Edge-stream convention of every kernel here: one warp owns one edge (or
// one segment), and lane j holds feature j of a width-D row (D <= 32), so a
// row is one coalesced 4*D-byte access. Multi-head rows are head-major: head
// h owns lanes [h*C, (h+1)*C) with C a power of two, and per-head sums are
// butterfly shuffles inside those lane groups.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define GASFM_FULL_MASK 0xffffffffu

namespace gasfm {

__device__ __forceinline__ float leaky_relu(float z, float slope) {
  return z >= 0.f ? z : slope * z;
}

// Sum over aligned groups of `width` lanes (a power of two <= 32); every lane
// of a group receives its group's sum. All 32 lanes must take part.
__device__ __forceinline__ float group_sum(float v, int width) {
  for (int off = width >> 1; off > 0; off >>= 1) {
    v += __shfl_xor_sync(GASFM_FULL_MASK, v, off);
  }
  return v;
}

// Online-softmax accumulator of one feature lane: the running max `m` of its
// head's logits, and the denominator and numerator taken at shift `m`. Any
// per-segment shift cancels in num / den, so the result is the segment
// softmax-weighted sum exactly, whatever order the edges arrive in.
struct Online {
  float m, den, num;

  __device__ __forceinline__ void init() {
    m = -INFINITY;
    den = 0.f;
    num = 0.f;
  }

  __device__ __forceinline__ void push(float logit, float x) {
    if (logit <= m) {
      const float p = expf(logit - m);
      den += p;
      num = fmaf(p, x, num);
    } else {  // new max: rescale what was summed so far (0 on the first edge)
      const float a = expf(m - logit);
      den = fmaf(den, a, 1.f);
      num = fmaf(num, a, x);
      m = logit;
    }
  }

  __device__ __forceinline__ void merge(float om, float oden, float onum) {
    const float m_new = fmaxf(m, om);
    if (m_new == -INFINITY) return;  // both empty
    const float a = expf(m - m_new);
    const float b = expf(om - m_new);
    den = den * a + oden * b;
    num = num * a + onum * b;
    m = m_new;
  }

  // An empty segment aggregates to 0 (the den > 0 guard of the reference).
  __device__ __forceinline__ float finish() const {
    return den > 0.f ? num / den : 0.f;
  }
};

// Features c0 .. c0 + 3 of row e of the (E, D) stream `src` (0 past D, for
// an invalid row, or for src == NULL): one 16-byte load when D is a multiple
// of 4 (the caller keeps the stream 16-byte aligned). Rows held 4 features
// per lane, 8 lanes per 32-wide row.
__device__ __forceinline__ void load_row4(const float* __restrict__ src, int D, int e, int c0,
                                          bool valid, float (&v)[4]) {
  v[0] = v[1] = v[2] = v[3] = 0.f;
  if (src == nullptr || !valid || c0 >= D) return;
  const float* p = src + (size_t)e * D + c0;
  if ((D & 3) == 0) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (c0 + q < D) v[q] = p[q];
    }
  }
}

__device__ __forceinline__ void store_row4(float* __restrict__ dst, int D, int e, int c0,
                                           bool valid, const float (&v)[4]) {
  if (dst == nullptr || !valid || c0 >= D) return;
  float* p = dst + (size_t)e * D + c0;
  if ((D & 3) == 0) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (c0 + q < D) p[q] = v[q];
    }
  }
}

// A CSR split by length (ViewGraph.pt_chunks or cam_chunks, split_segments):
// a segment of more than the split length is long and comes cut into chunks
// of that many rows, the last one ragged. One int32 table: [chunk_seg
// (n_chunks) | chunk_begin (n_chunks) | long_seg (n_long) | long_ptr (n_long
// + 1)]. chunk_begin indexes the CSR's rows: the edges of a point, the camera
// permutation's entries of a camera.
struct SegmentSplit {
  const int* chunk_seg;
  const int* chunk_begin;
  const int* long_seg;
  const int* long_ptr;
  int n_long, n_chunks;

  __host__ __device__ SegmentSplit(const int* table, int nl, int nc)
      : chunk_seg(table),
        chunk_begin(table + nc),
        long_seg(table + 2 * nc),
        long_ptr(table + 2 * nc + nl),
        n_long(nl),
        n_chunks(nc) {}
};

inline int blocks_of(int items, int per_block) { return (items + per_block - 1) / per_block; }

// ---------------------------------------------------------------------------
// Deterministic cross-edge sums of the backward kernels. A sum over all edges
// (a weight or bias gradient) is kept per lane in registers by each warp,
// merged per block in a fixed warp order (block_partial), written as one
// partial row per block, and the rows are summed in a fixed order by
// column_sum_kernel. No float atomics: results are bitwise reproducible on a
// given card (the grid size, and with it the order, depends on its SM count).
// ---------------------------------------------------------------------------

// Merge the per-lane accumulators acc[0..N) of every warp of the block, warp 0
// first, into `sbuf` (N * 32 floats of shared memory, layout [k][lane]) and
// write the block's sum to `row` (same layout). Every thread of the block must
// call it.
template <int N>
__device__ __forceinline__ void block_partial(const float (&acc)[N], float* sbuf,
                                              float* __restrict__ row) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int w = 0; w < nwarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int k = 0; k < N; ++k) {
        sbuf[k * 32 + lane] = (w == 0 ? 0.f : sbuf[k * 32 + lane]) + acc[k];
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < N * 32; i += blockDim.x) row[i] = sbuf[i];
}

constexpr int kSumGroups = 8;  // row groups per column in column_sum_kernel
constexpr int kSumUnroll = 8;  // rows whose loads are in flight together

// out[c] = sum over rows r of partials[r * cols + c], in a fixed order: block
// of 32 columns x 8 row groups (rows r = g mod 8), then the groups in order.
// Each thread loads kSumUnroll of its rows before adding them in row order,
// so the sum is the plain loop's, without a load's latency per row.
__global__ void __launch_bounds__(kSumGroups * 32) column_sum_kernel(
    const float* __restrict__ partials, int rows, int cols, float* __restrict__ out) {
  __shared__ float s[kSumGroups][32];
  const int lane = threadIdx.x & 31;
  const int grp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (col < cols) {
    int r = grp;
    for (; r + (kSumUnroll - 1) * kSumGroups < rows; r += kSumUnroll * kSumGroups) {
      float v[kSumUnroll];
#pragma unroll
      for (int u = 0; u < kSumUnroll; ++u) v[u] = partials[(size_t)(r + u * kSumGroups) * cols + col];
#pragma unroll
      for (int u = 0; u < kSumUnroll; ++u) acc += v[u];
    }
    for (; r < rows; r += kSumGroups) acc += partials[(size_t)r * cols + col];
  }
  s[grp][lane] = acc;
  __syncthreads();
  if (grp == 0 && col < cols) {
    float t = 0.f;
    for (int g = 0; g < kSumGroups; ++g) t += s[g][lane];
    out[col] = t;
  }
}

inline void launch_column_sum(const float* partials, int rows, int cols, float* out,
                              cudaStream_t stream) {
  if (cols > 0) {
    column_sum_kernel<<<(cols + 31) / 32, kSumGroups * 32, 0, stream>>>(partials, rows,
                                                                        cols, out);
  }
}

}  // namespace gasfm
