// Wide-row CSR segment sums and narrow-row segment maxima (sm_90a, float32),
// shared by segment.cu (#15/#18, and #17/#19: the max is this walk with the
// reduction swapped), fused_update.cu (#12: its point pass is this walk with
// the COMBINE flag, its camera sums the plain one), fused_layer_step.cu (#6's
// two sums), fused_proj_update.cu (#10's two sums) and fused_loss.cu (#8:
// both table gradients, this walk with rows computed in place of loaded, a
// row source), and the vector helpers of segment.cu's gather.
//
// Unlike the narrow streams of the other kernels (one lane per feature,
// D <= 32, common.cuh), these rows are 1 to 256 floats wide. A row is read
// as VEC-float vectors (VEC = 4, one 16-byte load per lane, when D % 4 == 0;
// VEC = 2 when D % 4 == 2; else 1): Dv = D / VEC vectors per row, W lanes
// per row (the smallest power of two >= Dv, at most 32), lane (lane % W)
// on vector columns lane % W + W * k. At D = 256 a lane holds two float4
// columns of a row; at D = 2 or 4 a row is one lane's.
//
// What bounds the sum on the H100: bytes, its E x D input read once and S x
// D written (~127 MB at D = 256 on the dense bench scene, 0.038 ms at
// 3.35 TB/s); at D <= 32 the input is a few MB and a call is its launch and
// a few DRAM latencies. The first design walked a point per warp and a
// camera per block of 32 warps: a point's rows one at a time, no loads
// issued ahead, so the power-law scene's point of 133 edges was 133
// dependent 1 KB rows (3.1x the bound), a hub point of 1,280 edges 0.57 ms;
// 1,280 blocks of 1,024 threads for the wide scene's cameras of ~37 edges,
// most of their warps without a row; a hub camera's 8,192 rows on one
// block. Now (segment_sum_kernel) the segments are split by length once per
// graph on the host: a short one (at most kSumRows rows) takes a lane group
// of G = max(8, 4W) lanes, 32 / G of them to a warp, so the narrow streams
// (D = 2, 4) keep their lanes busy, with several rows' loads issued ahead;
// at D > 64 (a row per warp step) a short camera takes 4 warps, and on the
// point side a warp streams the rows of kSumRun consecutive points. A long
// one takes a block of 32 warps, as the
// bench scenes' cameras (64-1,317 rows) did before, but a hub's rows come
// cut into parts of kSumPartRows, a block each, whose partial rows a second
// launch adds in part order: no block walks more than kSumPartRows rows,
// and a call is one launch unless a hub exists. Every sum is in a fixed
// order, with no float atomics: bitwise reproducible on a given card.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace gasfm {

constexpr int kSegMaxD = 256;   // widest row the sum takes
constexpr int kSegMaxCols = 8;  // widest row the max takes

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
// A 12-float row held whole by one lane (the ESFM loss's camera gradients,
// g x X per edge, computed in place, csrc/fused_loss.cu): Dv = 1, W = 1.
struct __align__(16) Row12 {
  float4 a, b, c;
};
template <>
struct VecT<12> {
  using T = Row12;
};

// The walk's reduction R. SumRed adds from 0, and its result is scaled by
// the caller's factor (an empty segment sums to 0); MaxRed takes fmaxf from
// -inf, its result is not scaled, and an empty segment gives the caller's
// neutral value, passed where the sum takes its factor. A max is exact in any
// order, so the split's order gives the plain version's bits.
struct SumRed {
  static constexpr bool kMax = false;
  __device__ __forceinline__ static float ident() { return 0.f; }
  __device__ __forceinline__ static float op(float a, float b) { return a + b; }
};
struct MaxRed {
  static constexpr bool kMax = true;
  __device__ __forceinline__ static float ident() { return -INFINITY; }
  __device__ __forceinline__ static float op(float a, float b) { return fmaxf(a, b); }
};

__device__ __forceinline__ void vfill(float& a, float f) { a = f; }
__device__ __forceinline__ void vfill(float2& a, float f) { a = make_float2(f, f); }
__device__ __forceinline__ void vfill(float4& a, float f) { a = make_float4(f, f, f, f); }
__device__ __forceinline__ void vfill(Row12& a, float f) {
  vfill(a.a, f);
  vfill(a.b, f);
  vfill(a.c, f);
}
template <class R, class T>
__device__ __forceinline__ void vinit(T& a) {
  vfill(a, R::ident());
}
template <class R>
__device__ __forceinline__ void vred(float& a, float b) {
  a = R::op(a, b);
}
template <class R>
__device__ __forceinline__ void vred(float2& a, const float2 b) {
  a.x = R::op(a.x, b.x);
  a.y = R::op(a.y, b.y);
}
template <class R>
__device__ __forceinline__ void vred(float4& a, const float4 b) {
  a.x = R::op(a.x, b.x);
  a.y = R::op(a.y, b.y);
  a.z = R::op(a.z, b.z);
  a.w = R::op(a.w, b.w);
}
template <class R>
__device__ __forceinline__ void vred(Row12& a, const Row12& b) {
  vred<R>(a.a, b.a);
  vred<R>(a.b, b.b);
  vred<R>(a.c, b.c);
}

template <class T>
__device__ __forceinline__ void vzero(T& a) {
  vinit<SumRed>(a);
}
template <class T>
__device__ __forceinline__ void vadd(T& a, const T b) {
  vred<SumRed>(a, b);
}
__device__ __forceinline__ float vscale(float a, float s) { return a * s; }
__device__ __forceinline__ float2 vscale(const float2 a, float s) {
  return make_float2(a.x * s, a.y * s);
}
__device__ __forceinline__ float4 vscale(const float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}
__device__ __forceinline__ Row12 vscale(const Row12& a, float s) {
  return Row12{vscale(a.a, s), vscale(a.b, s), vscale(a.c, s)};
}
__device__ __forceinline__ float vshfl_xor(float a, int off) {
  return __shfl_xor_sync(GASFM_FULL_MASK, a, off);
}
__device__ __forceinline__ float2 vshfl_xor(const float2 a, int off) {
  return make_float2(__shfl_xor_sync(GASFM_FULL_MASK, a.x, off),
                     __shfl_xor_sync(GASFM_FULL_MASK, a.y, off));
}
__device__ __forceinline__ float4 vshfl_xor(const float4 a, int off) {
  return make_float4(__shfl_xor_sync(GASFM_FULL_MASK, a.x, off),
                     __shfl_xor_sync(GASFM_FULL_MASK, a.y, off),
                     __shfl_xor_sync(GASFM_FULL_MASK, a.z, off),
                     __shfl_xor_sync(GASFM_FULL_MASK, a.w, off));
}
__device__ __forceinline__ Row12 vshfl_xor(const Row12& a, int off) {
  return Row12{vshfl_xor(a.a, off), vshfl_xor(a.b, off), vshfl_xor(a.c, off)};
}

// A segment's result as written: the sum times f, the max as it is.
template <class R>
__device__ __forceinline__ float finish(float t, float f) {
  if constexpr (R::kMax) {
    return t;
  } else {
    return t * f;
  }
}

// A short segment's result as written: the sum times f (0 if empty), the
// max, or f if the segment is empty.
template <class R, class T>
__device__ __forceinline__ T vfinish(const T a, float f, bool empty) {
  if constexpr (R::kMax) {
    T n;
    vfill(n, f);
    return empty ? n : a;
  } else {
    return vscale(a, f);
  }
}

// Streaming stores: rows written once and not read again soon (the gather's
// output, #12's d pe), kept from pushing the rows still to be read out of L2.
__device__ __forceinline__ void stcs(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void stcs(float2* p, float2 v) { __stcs(p, v); }
__device__ __forceinline__ void stcs(float4* p, float4 v) { __stcs(p, v); }

// Lanes per row: the smallest power of two >= dv, at most 32.
__host__ __device__ __forceinline__ int row_lanes(int dv) {
  int w = 1;
  while (w < dv && w < 32) w <<= 1;
  return w;
}

// ---- the CSR segment sum ----------------------------------------------------------
//
// out[s] = scale * sum of the rows of segment s (rows ptr[s] .. ptr[s+1], or
// perm[ptr[s]] .. on the camera side). A segment of at most kSumRows rows is
// short: a lane group sums it alone (at D > 64 a few warps). A longer one is
// long: a block of
// kSumBlockWarps warps sums it, its warps striding over its rows, and merges
// them in shared memory; a long segment of more than kSumPartRows rows (a
// hub) comes cut into parts of that many rows, one block each, whose partial
// rows a second launch adds in part order. The long segments and their parts
// come from the host, split once per graph (ViewGraph.pt_chunks /
// cam_chunks with rows = kSumPartRows, long_above = kSumRows). One launch
// unless a hub exists; every sum in a fixed order, bitwise reproducible.
//
// With the COMBINE flag (#12's point pass, point side only) the walk also
// writes every row it reads times scale to rows_out, at the row's own place
// (d pe = g / 4 from the one read of g), and each block of the main launch
// writes the column sums of the rows it summed, times scale, as one partial
// row, partials[blockIdx.x] (D floats): every row lies in exactly one short
// segment or one part, so the column sum of those rows (column_sum_kernel,
// common.cuh) is scale times the sum of all rows (d pg). Without the flag
// the kernel's arithmetic is the plain sum's.
//
// With MaxRed for R (segment_max: #17/#19, rows of at most kSegMaxCols
// floats, so W <= 8 and never COMBINE) the same walk takes each segment's
// max, from -inf by fmaxf, in blocks of kMaxBlockWarps warps: an empty
// segment gives the neutral value passed as `scale`, and a hub's part maxima
// are merged by max.

constexpr int kSumRows = 64;         // the longest short segment
constexpr int kSumGroup = 8;         // short segments per block at W = 32, 4 warps each
constexpr int kSumPartRows = 2048;   // rows of a long segment per block
constexpr int kSumBlockWarps = 32;   // warps per block of the main launch
constexpr int kSumMergeWarps = 8;    // warps per block of the hubs' merge
constexpr int kSumLoads = 8;         // vectors per lane whose loads are in flight together
constexpr int kSumRun = 4;           // points per warp on the point side at W = 32
// Warps per block of the max. Its rows are 1-8 floats, 4 short segments to a
// warp: 32-warp blocks would put the wide scene's 1,280 cameras on 10 SMs,
// each reading a tenth of the scattered rows (there the sum at D = 4 takes
// 4.1 us a call, the max in 8-warp blocks 2.3; H100 80GB HBM3, 700 W).
constexpr int kMaxBlockWarps = 8;

// The layout for rows of Dv VEC-float vectors with W lanes per row
// (row_lanes(Dv)): a short segment takes G lanes, NG = G / W row groups
// (G = max(8, 4W), at most 32: NG x U >= 32 rows in flight at W <= 16), so P
// = 32 / G short segments share a warp (up to four at D <= 16: a warp with
// 30 idle lanes at D = 2 otherwise); a lane holds K vector columns of a row
// (K > 1 only at W = 32: D > 64 with VEC = 4) and issues the loads of U
// rows before it adds them.
template <int VEC, int W>
struct SumLayout {
  static constexpr int G = W >= 8 ? 32 : (4 * W > 8 ? 4 * W : 8);
  static constexpr int P = 32 / G;
  static constexpr int NG = G / W;
  static constexpr int K = W == 32 ? 8 / VEC : 1;
  static constexpr int U = kSumLoads / K > 0 ? kSumLoads / K : 1;
};

// The rows of `run` consecutive segments s0 .. s0 + run - 1 of the point
// CSR as one stream (W = 32: a row per warp step, K vector columns per
// lane), U rows' loads issued before they are added, whatever segments
// they belong to; a segment's sum times scale is written when the stream
// crosses its end (an empty one's: 0). A long segment's rows are skipped:
// its block sums them. Every branch is the same on every lane. With
// COMBINE, each row times scale also goes to rows_out, and the segments'
// sums (unscaled) are added to tot.
template <int VEC, int K, int U, bool COMBINE = false>
__device__ __forceinline__ void sum_point_run(const typename VecT<VEC>::T* __restrict__ rows,
                                              int Dv, const int* __restrict__ ptr, int n_seg,
                                              int s0, int run, float scale,
                                              typename VecT<VEC>::T* __restrict__ out,
                                              typename VecT<VEC>::T* __restrict__ rows_out,
                                              typename VecT<VEC>::T (&tot)[K]) {
  using T = typename VecT<VEC>::T;
  const int lane = threadIdx.x & 31;
  const int nr = min(run, n_seg - s0);
  const int pj = lane <= nr ? ptr[s0 + lane] : 0;  // lanes 0 .. nr: the run's offsets
  const int nxt = __shfl_down_sync(GASFM_FULL_MASK, pj, 1);
  const unsigned longs = __ballot_sync(GASFM_FULL_MASK, lane < nr && nxt - pj > kSumRows);
  T acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) vzero(acc[k]);
  auto flush = [&](int c) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int col = lane + 32 * k;
      if (col < Dv) out[(size_t)(s0 + c) * Dv + col] = vscale(acc[k], scale);
      if constexpr (COMBINE) vadd(tot[k], acc[k]);
      vzero(acc[k]);
    }
  };
  int c = 0;
  while (c < nr) {
    if ((longs >> c) & 1u) {
      ++c;
      continue;
    }
    const unsigned ahead = longs >> c;
    const int stop = ahead ? c + __ffs(ahead) - 1 : nr;  // the next long segment, or the end
    const int lim = __shfl_sync(GASFM_FULL_MASK, pj, stop);
    int next = __shfl_sync(GASFM_FULL_MASK, pj, c + 1);  // where segment c ends
    for (int r = __shfl_sync(GASFM_FULL_MASK, pj, c); r < lim; r += U) {
      T v[U][K];
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int col = lane + 32 * k;
          vzero(v[u][k]);
          if (r + u < lim && col < Dv) v[u][k] = __ldg(rows + (size_t)(r + u) * Dv + col);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (r + u < lim) {
          while (r + u >= next) {
            flush(c);
            ++c;
            next = __shfl_sync(GASFM_FULL_MASK, pj, c + 1);
          }
#pragma unroll
          for (int k = 0; k < K; ++k) {
            vadd(acc[k], v[u][k]);
            if constexpr (COMBINE) {
              const int col = lane + 32 * k;
              if (col < Dv) {
                stcs(rows_out + (size_t)(r + u) * Dv + col, vscale(v[u][k], scale));
              }
            }
          }
        }
      }
    }
    while (c < stop) {  // the segment that holds the last rows, and empty ones after it
      flush(c);
      ++c;
    }
  }
}

// The walk's row source S, a template parameter of the walk as its
// reduction is: where a row comes from. src.at(s) is segment s's view v
// (what all its rows share; s < 0: no segment, nothing loaded):
// v.fetch(e, c) loads what vector column c of the row of edge e (the CSR
// row's edge: perm[r], or r without a permutation) is made of, a
// V::Fetched, and v.row(f, c) makes the column from it. The walk fetches the
// rows of a step before it makes and adds them, at most V::kAhead rows per
// lane. The default, TableRows, loads rows of `data` (fetch loads the
// vector, row returns it); csrc/fused_loss.cu's EdgeGradRows compute each
// edge's gradient row from the cameras, points and observations.
template <int VEC>
struct TableRows {
  using T = typename VecT<VEC>::T;
  using Fetched = T;
  static constexpr int kAhead = kSumLoads;
  static constexpr int kLongAbove = kSumRows;
  const T* rows;
  int Dv;
  __device__ __forceinline__ const TableRows& at(int) const { return *this; }
  __device__ __forceinline__ T fetch(int e, int c) const {
    return __ldg(rows + (size_t)e * Dv + c);
  }
  __device__ __forceinline__ T row(const T& f, int) const { return f; }
};

// The rows [begin, end) of one segment walked by the nw warps gw = 0 .. nw
// - 1 of a group, a row per W lanes (NG = 32 / W row groups per warp): warp
// gw's row groups take rows gw * NG + g, then every nw * NG-th, U at a time,
// the next U rows' permutation entries loaded while these rows are in
// flight; returns this lane's K columns summed over its rows, the row
// groups merged by a butterfly. end = min(begin + cap, *end_at); the first
// entries load before it is known: a row past it (below n_rows) loads an
// entry that is never used. With COMBINE (no permutation), each row times
// scale also goes to rows_out. R: the reduction (the sum's by default);
// rows_of: the segment's view of the row source.
template <int VEC, int W, bool COMBINE = false, class R = SumRed, class V>
__device__ __forceinline__ void sum_strided(const V& rows_of, int Dv,
                                            const int* __restrict__ perm, int n_rows,
                                            int begin, const int* __restrict__ end_at, int cap,
                                            int gw, int nw,
                                            typename VecT<VEC>::T (&acc)[SumLayout<VEC, W>::K],
                                            typename VecT<VEC>::T* __restrict__ rows_out = nullptr,
                                            float scale = 1.f) {
  using F = typename V::Fetched;
  constexpr int NG = 32 / W, K = SumLayout<VEC, W>::K;
  constexpr int U0 = K == 1 ? 4 : (8 / K > 0 ? 8 / K : 1);
  constexpr int U = U0 < V::kAhead ? U0 : V::kAhead;
  const int lane = threadIdx.x & 31, g = lane / W, col = lane % W;
  const int stride = nw * NG;
  int i = begin + gw * NG + g;
  int e[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int r = i + u * stride;
    e[u] = perm == nullptr ? r : (r < n_rows ? __ldg(perm + r) : 0);
  }
  const int end = min(begin + cap, *end_at);
#pragma unroll
  for (int c = 0; c < K; ++c) vinit<R>(acc[c]);
  for (; i < end; i += U * stride) {
    F v[U][K];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int c = 0; c < K; ++c) {
        v[u][c] = F{};
        if (i + u * stride < end && col + W * c < Dv) v[u][c] = rows_of.fetch(e[u], col + W * c);
      }
    }
    int en[U];  // the next U rows' entries, while these rows load
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = i + (U + u) * stride;
      en[u] = perm == nullptr ? r : (r < end ? __ldg(perm + r) : 0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int c = 0; c < K; ++c) {
        if (i + u * stride < end) {
          const auto x = rows_of.row(v[u][c], col + W * c);
          vred<R>(acc[c], x);
          if constexpr (COMBINE) {
            if (col + W * c < Dv) {
              stcs(rows_out + (size_t)e[u] * Dv + col + W * c, vscale(x, scale));
            }
          }
        }
      }
      e[u] = en[u];
    }
  }
#pragma unroll
  for (int off = W; off < 32; off <<= 1) {
#pragma unroll
    for (int c = 0; c < K; ++c) vred<R>(acc[c], vshfl_xor(acc[c], off));
  }
}

// Each warp's sums (lanes of row group 0) to its row of `sw`, then a block
// barrier. Every thread of the block must call it.
template <int VEC, int W>
__device__ __forceinline__ void sum_to_shared(
    const typename VecT<VEC>::T (&acc)[SumLayout<VEC, W>::K], int Dv, float (*sw)[kSegMaxD]) {
  using T = typename VecT<VEC>::T;
  const int lane = threadIdx.x & 31;
  if (lane < W) {
#pragma unroll
    for (int c = 0; c < SumLayout<VEC, W>::K; ++c) {
      if (lane + W * c < Dv) reinterpret_cast<T*>(sw[threadIdx.x >> 5])[lane + W * c] = acc[c];
    }
  }
  __syncthreads();
}

// COMBINE's partial row: each warp's column sums `tot` (lanes of row group
// 0) added in warp order, times scale, to partials[bid]. Every thread of the
// block must call it.
template <int VEC, int W>
__device__ __forceinline__ void sum_block_partial(
    const typename VecT<VEC>::T (&tot)[SumLayout<VEC, W>::K], int Dv, float (*sw)[kSegMaxD],
    float scale, int bid, float* __restrict__ partials) {
  sum_to_shared<VEC, W>(tot, Dv, sw);
  const int D = Dv * VEC;
  for (int j = threadIdx.x; j < D; j += kSumBlockWarps * 32) {
    float t = 0.f;
    for (int w = 0; w < kSumBlockWarps; ++w) t += sw[w][j];
    partials[(size_t)bid * D + j] = t * scale;
  }
}

// Block bid of the main launch, blocks of NW warps, in this order:
//   - [0, sp.n_chunks): part k of a long segment (sp: the parts), its rows
//     walked by all the block's warps (sum_strided), their sums added in
//     warp order: a segment of one part writes its sum times scale, a hub's
//     part its partial row, unscaled, to part[k];
//   - then the short segments. At W = 32 (D > 64 with VEC = 4) kSumGroup of
//     them per block, 32 / kSumGroup warps each, the same way (a warp per
//     segment left a 64-row segment of 1 KB rows a chain of 16 DRAM
//     latencies); on the point side a warp per run of `run` consecutive
//     points instead (sum_point_run: the power-law scene's ~3-row points).
//     At W < 32, P to a warp, G lanes each: a lane group takes rows g, g +
//     NG, ..., U at a time (their permutation entries, then their rows), and
//     the NG groups merge by a butterfly (with COMBINE, `run` segments in
//     turn per lane group).
// A short segment's sum times scale goes to out (an empty one's: 0); a long
// one is skipped there. COMBINE (point side, run = kSumRun at every W): see
// above. R: the reduction; NW: warps per block; src: the row source
// (TableRows: the rows of a table; W = 32 takes no other); sw: the block's
// (NW, kSegMaxD) shared floats. Every thread of the block must call it.
template <int VEC, int W, bool COMBINE, class R, int NW, class S>
__device__ __forceinline__ void segment_sum_block(
    int bid, const S& src, int Dv, const int* __restrict__ ptr, const int* __restrict__ perm,
    int n_rows, const SegmentSplit& sp, int n_seg, int run, float scale,
    float* __restrict__ out, float* __restrict__ part, float* __restrict__ rows_out,
    float* __restrict__ partials, float (*sw)[kSegMaxD]) {
  static_assert(!R::kMax || (W < 32 && !COMBINE), "the max's rows are at most 8 floats");
  using L = SumLayout<VEC, W>;
  using T = typename VecT<VEC>::T;
  T* copy = reinterpret_cast<T*>(rows_out);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int D = Dv * VEC;
  if (bid < sp.n_chunks) {
    const int k = bid, seg = sp.chunk_seg[k];
    T acc[L::K];
    sum_strided<VEC, W, COMBINE, R>(src.at(seg), Dv, perm, n_rows, sp.chunk_begin[k],
                                    ptr + seg + 1, kSumPartRows, warp, NW, acc, copy, scale);
    sum_to_shared<VEC, W>(acc, Dv, sw);
    const bool whole = ptr[seg + 1] - ptr[seg] <= kSumPartRows;
    float* dst = whole ? out + (size_t)seg * D : part + (size_t)k * D;
    const float f = whole ? scale : 1.f;
    for (int j = threadIdx.x; j < D; j += NW * 32) {
      float t = R::ident();
      for (int w = 0; w < NW; ++w) t = R::op(t, sw[w][j]);
      dst[j] = finish<R>(t, f);
      if constexpr (COMBINE) partials[(size_t)k * D + j] = t * scale;
    }
    return;
  }
  const int b = bid - sp.n_chunks;
  if constexpr (W == 32) {
    if (COMBINE || run > 0) {
      T tot[L::K];
#pragma unroll
      for (int k = 0; k < L::K; ++k) vzero(tot[k]);
      const int s0 = (b * kSumBlockWarps + warp) * run;
      if (s0 < n_seg) {
        sum_point_run<VEC, L::K, L::U, COMBINE>(src.rows, Dv, ptr, n_seg, s0, run, scale,
                                                reinterpret_cast<T*>(out), copy, tot);
      }
      if constexpr (COMBINE) sum_block_partial<VEC, W>(tot, Dv, sw, scale, bid, partials);
      return;
    }
    constexpr int kPer = kSumBlockWarps / kSumGroup;  // warps per short segment
    const int q = b * kSumGroup + warp / kPer;
    int begin = 0;
    const int* end_at = ptr;  // an empty walk where there is no short segment
    if (q < n_seg && ptr[q + 1] - ptr[q] <= kSumRows) begin = ptr[q], end_at = ptr + q + 1;
    T acc[L::K];
    sum_strided<VEC, W>(src.at(q), Dv, perm, n_rows, begin, end_at, kSumPartRows, warp % kPer,
                        kPer, acc);
    sum_to_shared<VEC, W>(acc, Dv, sw);
    for (int o = threadIdx.x; o < kSumGroup * D; o += kSumBlockWarps * 32) {
      const int j = o / D, f = o - j * D, s = b * kSumGroup + j;
      if (s >= n_seg || ptr[s + 1] - ptr[s] > kSumRows) continue;  // none, or long
      float t = 0.f;
      for (int w = j * kPer; w < (j + 1) * kPer; ++w) t += sw[w][f];
      out[(size_t)s * D + f] = t * scale;
    }
    return;
  }
  // A lane group takes one segment; with COMBINE, `run` consecutive ones in
  // turn (the warp's P groups on P x run consecutive segments), so a block
  // sums enough rows to pay for its partial row.
  using V = std::decay_t<decltype(src.at(0))>;
  using F = typename V::Fetched;
  constexpr int U = L::U < V::kAhead ? L::U : V::kAhead;
  const int reps = COMBINE ? run : 1;
  const int g = (lane % L::G) / W, col = lane % W;
  T tot[L::K];
#pragma unroll
  for (int k = 0; k < L::K; ++k) vzero(tot[k]);
  for (int it = 0; it < reps; ++it) {
    const int q = ((b * NW + warp) * reps + it) * L::P + lane / L::G;
    int seg = -1, begin = 0, end = 0;  // seg < 0: nothing to write
    if (q < n_seg) {
      seg = q;
      begin = ptr[q];
      end = ptr[q + 1];
      if (end - begin > S::kLongAbove) seg = -1, end = begin;  // long: its block sums it
    }
    const auto rows_of = src.at(seg);
    T acc[L::K];
#pragma unroll
    for (int k = 0; k < L::K; ++k) vinit<R>(acc[k]);
    for (int i = begin + g; i < end; i += L::NG * U) {
      int e[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = i + u * L::NG;
        e[u] = r < end ? (perm == nullptr ? r : __ldg(perm + r)) : -1;
      }
      F v[U][L::K];
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int k = 0; k < L::K; ++k) {
          const int c = col + W * k;
          v[u][k] = F{};
          if (e[u] >= 0 && c < Dv) v[u][k] = rows_of.fetch(e[u], c);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int k = 0; k < L::K; ++k) {
          if (e[u] >= 0) {
            const int c = col + W * k;
            const auto x = rows_of.row(v[u][k], c);
            vred<R>(acc[k], x);
            if constexpr (COMBINE) {
              if (c < Dv) stcs(copy + (size_t)e[u] * Dv + c, vscale(x, scale));
            }
          }
        }
      }
    }
#pragma unroll
    for (int off = W; off < L::G; off <<= 1) {
#pragma unroll
      for (int k = 0; k < L::K; ++k) vred<R>(acc[k], vshfl_xor(acc[k], off));
    }
    if (g == 0 && seg >= 0) {
      T* dst = reinterpret_cast<T*>(out) + (size_t)seg * Dv;
#pragma unroll
      for (int k = 0; k < L::K; ++k) {
        const int c = col + W * k;
        if (c < Dv) dst[c] = vfinish<R>(acc[k], scale, end == begin);
      }
    }
    if constexpr (COMBINE) {
#pragma unroll
      for (int k = 0; k < L::K; ++k) vadd(tot[k], acc[k]);  // 0 for a long or missing one
    }
  }
  if constexpr (COMBINE) {  // the warp's P lane groups, then the block's warps
#pragma unroll
    for (int off = L::G; off < 32; off <<= 1) {
#pragma unroll
      for (int k = 0; k < L::K; ++k) vadd(tot[k], vshfl_xor(tot[k], off));
    }
    sum_block_partial<VEC, W>(tot, Dv, sw, scale, bid, partials);
  }
}

// The main launch of the walk over the rows of `data` (segment_sum_block).
// At W < 32 (rows of 1-16 vectors) the launch bounds ask for two blocks per
// SM, which caps the kernel at 32 registers: ptxas then spills 20-32 bytes
// per thread at VEC = 4 and 8 at VEC = 2, W = 2 or 4 (a cap of one block per
// SM is not measured against it). With COMBINE the cap left 476 bytes of
// spills per thread at VEC = 4 (the rows held until their copies are
// stored), 7.5x the plain sum's time at D = 32 on the dense bench scene: it
// asks for one block per SM. NW: warps per block (the max's kMaxBlockWarps
// asks for four blocks per SM, 64 registers, no spills).
template <int VEC, int W, bool COMBINE = false, class R = SumRed, int NW = kSumBlockWarps>
__global__ void __launch_bounds__(NW * 32, NW == kSumBlockWarps
                                               ? (W == 32 || COMBINE ? 1 : 2)
                                               : kSumBlockWarps / NW)
    segment_sum_kernel(
    const float* __restrict__ data, int Dv, const int* __restrict__ ptr,
    const int* __restrict__ perm, int n_rows, SegmentSplit sp, int n_seg, int run, float scale,
    float* __restrict__ out, float* __restrict__ part, float* __restrict__ rows_out,
    float* __restrict__ partials) {
  __shared__ __align__(16) float sw[NW][kSegMaxD];
  const TableRows<VEC> src{reinterpret_cast<const typename VecT<VEC>::T*>(data), Dv};
  segment_sum_block<VEC, W, COMBINE, R, NW>(blockIdx.x, src, Dv, ptr, perm, n_rows, sp, n_seg,
                                            run, scale, out, part, rows_out, partials, sw);
}

// Blocks of the main launch: the parts, then the short segments' blocks
// (none when every segment is long).
template <int VEC, int W, int NW>
inline int sum_blocks(int n_seg, const SegmentSplit& sp, int run) {
  int short_blocks = 0;
  if (n_seg > sp.n_long) {
    if (W == 32 && run == 0) {
      short_blocks = blocks_of(n_seg, kSumGroup);
    } else {
      const int pieces = run > 0 ? blocks_of(n_seg, run) : n_seg;
      short_blocks = blocks_of(blocks_of(pieces, SumLayout<VEC, W>::P), NW);
    }
  }
  return sp.n_chunks + short_blocks;
}

// Second launch, only where a hub exists: a block per long segment (one of
// a single part has nothing to do). Warp w adds the partial rows of its
// share of the hub's parts (a contiguous run, the w-th of kSumMergeWarps)
// in part order, U rows loaded ahead; the warps' rows are then added in
// warp order and the sum times scale written (with MaxRed: the parts'
// maxima, their max). Lane j holds vector columns j, j + 32, ... (K of
// them).
template <int VEC, class R = SumRed>
__global__ void __launch_bounds__(kSumMergeWarps * 32) segment_sum_merge_kernel(
    const float* __restrict__ part, int Dv, SegmentSplit sp, float scale,
    float* __restrict__ out) {
  using T = typename VecT<VEC>::T;
  constexpr int K = 8 / VEC;
  constexpr int U = kSumLoads / K;
  __shared__ __align__(16) float sw[kSumMergeWarps][kSegMaxD];
  const T* rows = reinterpret_cast<const T*>(part);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x;
  const int k_begin = sp.long_ptr[i], n = sp.long_ptr[i + 1] - k_begin;
  if (n <= 1) return;
  const int per = (n + kSumMergeWarps - 1) / kSumMergeWarps;
  const int k0 = k_begin + min(n, warp * per), k1 = k_begin + min(n, (warp + 1) * per);
  T acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) vinit<R>(acc[k]);
  for (int r0 = k0; r0 < k1; r0 += U) {
    T v[U][K];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = min(r0 + u, k1 - 1);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = lane + 32 * k;
        vzero(v[u][k]);
        if (c < Dv) v[u][k] = rows[(size_t)r * Dv + c];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (r0 + u < k1) vred<R>(acc[k], v[u][k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = lane + 32 * k;
    if (c < Dv) reinterpret_cast<T*>(sw[warp])[c] = acc[k];
  }
  __syncthreads();
  const int D = Dv * VEC;
  float* dst = out + (size_t)sp.long_seg[i] * D;
  for (int f = threadIdx.x; f < D; f += kSumMergeWarps * 32) {
    float t = R::ident();
    for (int w = 0; w < kSumMergeWarps; ++w) t = R::op(t, sw[w][f]);
    dst[f] = finish<R>(t, scale);
  }
}

// The main launch's blocks, and with COMBINE its partial rows (none when
// the grid is 0). With MaxRed, `scale` is the neutral value of an empty
// segment.
template <int VEC, bool COMBINE, class R = SumRed>
inline int launch_segment_sum(const float* data, int D, const int* ptr, const int* perm,
                              int n_rows, const SegmentSplit& sp, int n_seg, float scale,
                              float* out, float* part, float* rows_out, float* partials,
                              cudaStream_t s) {
  constexpr int NW = R::kMax ? kMaxBlockWarps : kSumBlockWarps;
  const int Dv = D / VEC;
  int grid = 0;
  auto main_launch = [&](auto w) {
    constexpr int Wc = decltype(w)::value;
    if constexpr (!R::kMax || Wc <= 8) {  // the max's rows: at most 8 floats
      const int run = (Wc == 32 || COMBINE) && perm == nullptr ? kSumRun : 0;
      grid = sum_blocks<VEC, Wc, NW>(n_seg, sp, run);
      if (grid > 0) {
        segment_sum_kernel<VEC, Wc, COMBINE, R, NW><<<grid, NW * 32, 0, s>>>(
            data, Dv, ptr, perm, n_rows, sp, n_seg, run, scale, out, part, rows_out, partials);
      }
    }
  };
  switch (row_lanes(Dv)) {
    case 1: main_launch(std::integral_constant<int, 1>{}); break;
    case 2: main_launch(std::integral_constant<int, 2>{}); break;
    case 4: main_launch(std::integral_constant<int, 4>{}); break;
    case 8: main_launch(std::integral_constant<int, 8>{}); break;
    case 16: main_launch(std::integral_constant<int, 16>{}); break;
    default: main_launch(std::integral_constant<int, 32>{}); break;
  }
  if (sp.n_chunks > sp.n_long) {  // a hub: its parts' partial rows
    segment_sum_merge_kernel<VEC, R><<<sp.n_long, kSumMergeWarps * 32, 0, s>>>(part, Dv, sp,
                                                                               scale, out);
  }
  return grid;
}

template <bool COMBINE, class R = SumRed>
inline int segment_sum_vec(const float* data, int D, const int* ptr, const int* perm,
                           int n_rows, const SegmentSplit& sp, int n_seg, float scale, float* out,
                           float* part, float* rows_out, float* partials, cudaStream_t s) {
  if (D % 4 == 0) {
    return launch_segment_sum<4, COMBINE, R>(data, D, ptr, perm, n_rows, sp, n_seg, scale, out,
                                             part, rows_out, partials, s);
  }
  if (D % 2 == 0) {
    return launch_segment_sum<2, COMBINE, R>(data, D, ptr, perm, n_rows, sp, n_seg, scale, out,
                                             part, rows_out, partials, s);
  }
  return launch_segment_sum<1, COMBINE, R>(data, D, ptr, perm, n_rows, sp, n_seg, scale, out,
                                           part, rows_out, partials, s);
}

// The segment sum of D-wide rows (1 <= D <= kSegMaxD) over the CSR (ptr,
// perm) of n_rows rows; sp: its long segments (more than kSumRows rows) cut
// into parts of kSumPartRows rows; part: (sp.n_chunks, D) scratch, read and
// written only where a segment has several parts. Rows are read as
// 16-byte vectors when D % 4 == 0 (8-byte when D % 4 == 2): data, part and
// out must then be aligned to them.
inline void segment_sum(const float* data, int D, const int* ptr, const int* perm, int n_rows,
                        const SegmentSplit& sp, int n_seg, float scale, float* out, float* part,
                        cudaStream_t s) {
  segment_sum_vec<false>(data, D, ptr, perm, n_rows, sp, n_seg, scale, out, part, nullptr,
                         nullptr, s);
}

// The same walk over the point CSR (rows ptr[s] .. ptr[s+1]) with the
// COMBINE flag: also rows_out (n_rows, D) = scale * data, and one partial
// row of scale-times column sums per block of the main launch in partials,
// at least (sp.n_chunks + ceil(n_seg / 32), D). Returns the partial rows
// written (the main launch's blocks). rows_out and partials aligned as out.
inline int segment_sum_combine(const float* data, int D, const int* ptr, int n_rows,
                               const SegmentSplit& sp, int n_seg, float scale, float* out,
                               float* part, float* rows_out, float* partials, cudaStream_t s) {
  return segment_sum_vec<true>(data, D, ptr, nullptr, n_rows, sp, n_seg, scale, out, part,
                               rows_out, partials, s);
}

// The segment max of D-wide rows (1 <= D <= kSegMaxCols) on the same walk,
// split (sp) and scratch (part, read and written only where a segment has
// several parts) as segment_sum's; an empty segment gives `neutral`. data,
// part and out aligned as there.
inline void segment_max(const float* data, int D, const int* ptr, const int* perm, int n_rows,
                        const SegmentSplit& sp, int n_seg, float neutral, float* out, float* part,
                        cudaStream_t s) {
  segment_sum_vec<false, MaxRed>(data, D, ptr, perm, n_rows, sp, n_seg, neutral, out, part,
                                 nullptr, nullptr, s);
}

}  // namespace gasfm
