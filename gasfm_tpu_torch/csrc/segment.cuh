// Wide-row CSR segment sums and row gathers (sm_90a, float32), shared by
// segment.cu and fused_update.cu.
//
// Unlike the narrow streams of the other kernels (one lane per feature,
// D <= 32, common.cuh), these rows are 1 to 256 floats wide. A row is read
// as VEC-float vectors (VEC = 4, one 16-byte load per lane, when D % 4 == 0;
// else VEC = 1): Dv = D / VEC vectors per row. A warp splits into R = 32 / W
// row groups of W lanes (W the smallest power of two >= Dv, at most 32);
// group r takes rows r, r + R, r + 2R, ... of a segment and lane (lane % W)
// the vector columns lane % W + W * k. At D = 256 a lane holds two float4
// columns of one row; at D = 2 sixteen rows are in flight per warp, so the
// narrow layer-0 stream does not leave 30 of 32 lanes idle. The row groups
// merge by a butterfly (fixed order), so every sum is bitwise reproducible
// on a given card; no float atomics.
#pragma once

#include "common.cuh"

namespace gasfm {

constexpr int kSegMaxD = 256;  // widest row the kernels take
constexpr int kSegWarps = 8;   // warps per block, point side (warp per segment)
constexpr int kCamWarps = 32;  // warps per block, camera side (block per segment)

template <int VEC>
struct VecT;
template <>
struct VecT<1> {
  using T = float;
};
template <>
struct VecT<2> {
  using T = float2;
};
template <>
struct VecT<4> {
  using T = float4;
};

__device__ __forceinline__ void vzero(float& a) { a = 0.f; }
__device__ __forceinline__ void vzero(float4& a) { a = make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ void vadd(float& a, float b) { a += b; }
__device__ __forceinline__ void vadd(float4& a, const float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}
__device__ __forceinline__ float vscale(float a, float s) { return a * s; }
__device__ __forceinline__ float4 vscale(const float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}
__device__ __forceinline__ float vshfl_xor(float a, int off) {
  return __shfl_xor_sync(GASFM_FULL_MASK, a, off);
}
__device__ __forceinline__ float4 vshfl_xor(const float4 a, int off) {
  return make_float4(__shfl_xor_sync(GASFM_FULL_MASK, a.x, off),
                     __shfl_xor_sync(GASFM_FULL_MASK, a.y, off),
                     __shfl_xor_sync(GASFM_FULL_MASK, a.z, off),
                     __shfl_xor_sync(GASFM_FULL_MASK, a.w, off));
}

// Lanes per row: the smallest power of two >= dv, at most 32.
__device__ __forceinline__ int row_lanes(int dv) {
  int w = 1;
  while (w < dv && w < 32) w <<= 1;
  return w;
}

// Per-lane accumulator of a warp walking one segment's rows: KMAX vector
// columns (8 floats, whatever VEC: D <= 256).
template <int VEC>
struct RowSum {
  using T = typename VecT<VEC>::T;
  static constexpr int KMAX = 8 / VEC;
  T acc[KMAX];
  int W, R, sub, col, Dv;

  __device__ __forceinline__ void init(int D) {
    Dv = D / VEC;
    W = row_lanes(Dv);
    R = 32 / W;
    const int lane = threadIdx.x & 31;
    sub = lane / W;
    col = lane % W;
    clear();
  }

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int k = 0; k < KMAX; ++k) vzero(acc[k]);
  }

  // Add row `e` of `data` (this lane's columns).
  __device__ __forceinline__ void add_row(const T* __restrict__ data, int e) {
    const T* row = data + (size_t)e * Dv;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      const int c = col + W * k;
      if (c < Dv) vadd(acc[k], row[c]);
    }
  }

  // Merge the R row groups: afterwards every lane holds its columns' sum.
  // All 32 lanes must call it.
  __device__ __forceinline__ void merge_groups() {
    for (int off = W; off < 32; off <<= 1) {
#pragma unroll
      for (int k = 0; k < KMAX; ++k) vadd(acc[k], vshfl_xor(acc[k], off));
    }
  }

  // Write the sum times `scale` to `out` row `s` (lanes of row group 0).
  __device__ __forceinline__ void store(T* __restrict__ out, int s, float scale) const {
    if (sub != 0) return;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      const int c = col + W * k;
      if (c < Dv) out[(size_t)s * Dv + c] = vscale(acc[k], scale);
    }
  }

  // Write the sum to a D-float shared-memory row (lanes of row group 0).
  __device__ __forceinline__ void store_shared(float* srow) const {
    if (sub != 0) return;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      const int c = col + W * k;
      if (c < Dv) reinterpret_cast<T*>(srow)[c] = acc[k];
    }
  }
};

// Point side: out[s] = scale * sum of data rows [ptr[s], ptr[s+1]) — the
// segment's rows are contiguous. One warp per segment, warps stride over the
// segments (grid-stride).
template <int VEC>
__global__ void __launch_bounds__(kSegWarps * 32) segment_sum_contiguous_kernel(
    const float* __restrict__ data, int D, const int* __restrict__ ptr, int n_seg, float scale,
    float* __restrict__ out) {
  using T = typename VecT<VEC>::T;
  const T* rows = reinterpret_cast<const T*>(data);
  RowSum<VEC> rs;
  rs.init(D);
  const int warp = threadIdx.x >> 5;
  for (int s = blockIdx.x * kSegWarps + warp; s < n_seg; s += gridDim.x * kSegWarps) {
    rs.clear();
    const int end = ptr[s + 1];
    for (int e = ptr[s] + rs.sub; e < end; e += rs.R) rs.add_row(rows, e);
    rs.merge_groups();
    rs.store(reinterpret_cast<T*>(out), s, scale);
  }
}

// Camera side: out[c] = scale * sum of data rows perm[ptr[c] .. ptr[c+1]).
// Camera segments are few and long (128-133 cameras of ~500-900 edges on
// the bench scenes), so one block of kCamWarps warps per camera: the warps
// stride over the camera's edge list, then their partial rows are summed in
// warp order in shared memory.
template <int VEC>
__global__ void __launch_bounds__(kCamWarps * 32) segment_sum_permuted_kernel(
    const float* __restrict__ data, int D, const int* __restrict__ ptr,
    const int* __restrict__ perm, float scale, float* __restrict__ out) {
  using T = typename VecT<VEC>::T;
  __shared__ __align__(16) float part[kCamWarps][kSegMaxD];
  const T* rows = reinterpret_cast<const T*>(data);
  const int c = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  RowSum<VEC> rs;
  rs.init(D);
  const int end = ptr[c + 1], stride = kCamWarps * rs.R;
  int i = ptr[c] + warp * rs.R + rs.sub;
  for (; i + 3 * stride < end; i += 4 * stride) {  // four rows' ids, then their rows, in order
    int e[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) e[u] = perm[i + u * stride];
#pragma unroll
    for (int u = 0; u < 4; ++u) rs.add_row(rows, e[u]);
  }
  for (; i < end; i += stride) rs.add_row(rows, perm[i]);
  rs.merge_groups();
  rs.store_shared(part[warp]);
  __syncthreads();
  for (int f = threadIdx.x; f < D; f += kCamWarps * 32) {
    float t = 0.f;
    for (int w = 0; w < kCamWarps; ++w) t += part[w][f];
    out[(size_t)c * D + f] = t * scale;
  }
}

inline int seg_blocks(int n_seg) { return (n_seg + kSegWarps - 1) / kSegWarps; }

template <int VEC>
inline void launch_segment_sum(const float* data, int D, const int* ptr, const int* perm,
                               int n_seg, float scale, float* out, cudaStream_t s) {
  if (n_seg <= 0) return;
  if (perm == nullptr) {
    segment_sum_contiguous_kernel<VEC><<<seg_blocks(n_seg), kSegWarps * 32, 0, s>>>(
        data, D, ptr, n_seg, scale, out);
  } else {
    segment_sum_permuted_kernel<VEC><<<n_seg, kCamWarps * 32, 0, s>>>(data, D, ptr, perm,
                                                                      scale, out);
  }
}

// Contiguous (perm == NULL) or permuted segment sum of D-wide rows, vector
// width chosen from D (the caller guarantees 16-byte aligned rows when D %
// 4 == 0).
inline void segment_sum(const float* data, int D, const int* ptr, const int* perm, int n_seg,
                        float scale, float* out, cudaStream_t s) {
  if (D % 4 == 0) {
    launch_segment_sum<4>(data, D, ptr, perm, n_seg, scale, out, s);
  } else {
    launch_segment_sum<1>(data, D, ptr, perm, n_seg, scale, out, s);
  }
}

}  // namespace gasfm
