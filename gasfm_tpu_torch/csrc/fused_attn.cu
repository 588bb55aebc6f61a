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
// The point side keeps that bound. Point degrees are power-law (the wide
// scene: median 2, one point of 670 edges), and a warp that walks a whole
// point serially, a DRAM latency plus a shuffle chain per edge, makes the
// longest point the whole launch. So the points come split by length once
// per graph on the host (ViewGraph.pt_chunks): no warp walks more than
// kAttendChunk edge rows of one point. A warp's unit is one of
//   - a quad: points 4u .. 4u + 3, 8 lanes each, 4 features per lane (a
//     32-wide row is one 16-byte load per lane); a point of at most
//     kAttendChunk edges (an empty one too) is short and is walked here,
//     a longer one's lanes idle;
//   - a chunk: kAttendChunk rows (the last one ragged) of a long point, a
//     lane per feature (the split's chunk list), after the quads.
// Each walker loads several rows (kQuadUnroll per point of a quad,
// kChunkUnroll per chunk) before it runs their logits, so that many loads
// are in flight. A quad writes its short points' results; a chunk writes a
// partial (the online triple forward, the d xr sum backward) and a second
// launch merges each long point's partials in chunk order
// (flash-decoding). The forward's residual m is the max over all of a
// point's chunks, as the backward's exp(min(logit - m, 0)) needs.
//
// The camera side (perm != NULL) is a block of kAttendWarps warps per camera,
// the dual kernel's code (attend.cuh). The JAX package never takes it.
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
#include <type_traits>

#include "attend.cuh"

namespace gasfm {

constexpr int kAttendWarps = 16;         // warps per camera block
constexpr int kPointWarps = 8;           // warps per point-side block
constexpr int kPointBwdBlocksPerSm = 4;  // resident backward blocks per SM (64 registers)
constexpr int kAttendChunk = 32;         // the split length: the most rows of a point per warp
constexpr int kQuad = 4;                 // short points per warp
constexpr int kQuadUnroll = 4;           // rows per point whose loads issue together
constexpr int kChunkUnroll = 8;          // rows per chunk whose loads issue together
constexpr int kTriple = 3 * 32;          // floats of one forward partial: m, den, num per lane

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

// ---- the point side: quads of short points, chunks of long ones --------------

// The split of ViewGraph.pt_chunks, one int32 table:
// [chunk_seg (n_chunks) | chunk_begin (n_chunks) | long_seg (n_long) |
//  long_ptr (n_long + 1)].
struct PointSplit {
  const int* chunk_seg;
  const int* chunk_begin;
  const int* long_seg;
  const int* long_ptr;
  int n_long, n_chunks;

  __host__ __device__ PointSplit(const int* table, int nl, int nc)
      : chunk_seg(table),
        chunk_begin(table + nc),
        long_seg(table + 2 * nc),
        long_ptr(table + 2 * nc + nl),
        n_long(nl),
        n_chunks(nc) {}
};

// A quad's lane: point kQuad * u + (lane / 8), features c0 .. c0 + 3 with
// c0 = 4 * (lane % 8). `rows` is the point's edge count if it is this quad's
// to walk (short), else 0; `mine` says whether the lane writes its point.
struct QuadLane {
  int seg, c0, begin, rows, most;  // most: the largest `rows` of the warp
  bool mine;

  __device__ __forceinline__ QuadLane(const int* __restrict__ ptr, int n_seg, int u) {
    const int lane = threadIdx.x & 31;
    seg = kQuad * u + (lane >> 3);
    c0 = 4 * (lane & 7);
    begin = 0;
    rows = 0;
    mine = false;
    if (seg < n_seg) {
      begin = ptr[seg];
      const int n = ptr[seg + 1] - begin;
      mine = n <= kAttendChunk;
      rows = mine ? n : 0;
    }
    most = max(rows, __shfl_xor_sync(GASFM_FULL_MASK, rows, 8));
    most = max(most, __shfl_xor_sync(GASFM_FULL_MASK, most, 16));
  }
};

// A quad lane's logits: feature j's head is slot j * NH / 4 (NH = 4 / C
// heads per lane for C < 4, else 1). With C >= 4 a head's C features lie
// on C / 4 neighbouring lanes of one point: the in-lane sum, then a
// butterfly over those lanes. Every lane of the warp must call it.
template <int NH>
__device__ __forceinline__ void quad_head_sums(const float (&v)[4], int C, float (&l)[NH]) {
  if constexpr (NH == 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) l[j] = v[j];
  } else if constexpr (NH == 2) {
    l[0] = v[0] + v[1];
    l[1] = v[2] + v[3];
  } else {
    float t = (v[0] + v[1]) + (v[2] + v[3]);
    for (int off = C >> 3; off > 0; off >>= 1) t += __shfl_xor_sync(GASFM_FULL_MASK, t, off);
    l[0] = t;
  }
}

// Forward of one quad: each point's online softmax over its rows, kQuadUnroll
// rows loaded ahead; writes the short points' output rows and residuals.
template <int NH>
__device__ __forceinline__ void attend_quad(
    const float* __restrict__ xl, const float* __restrict__ xr, const float* __restrict__ att,
    const int* __restrict__ ptr, int n_seg, int u, int D, int C, float slope,
    float* __restrict__ out, float* __restrict__ m, float* __restrict__ den) {
  const QuadLane ql(ptr, n_seg, u);
  float q[4], at[4];
  load_row4(xr, D, ql.seg, ql.c0, ql.seg < n_seg, q);
  load_row4(att, D, 0, ql.c0, true, at);
  Online s[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j].init();
  for (int i0 = 0; i0 < ql.most; i0 += kQuadUnroll) {
    float x[kQuadUnroll][4], l[kQuadUnroll][NH], bm[NH];
#pragma unroll
    for (int r = 0; r < kQuadUnroll; ++r) {
      load_row4(xl, D, ql.begin + i0 + r, ql.c0, i0 + r < ql.rows, x[r]);
    }
#pragma unroll
    for (int h = 0; h < NH; ++h) bm[h] = -INFINITY;
#pragma unroll
    for (int r = 0; r < kQuadUnroll; ++r) {
      if (i0 + r < ql.most) {  // the same on every lane: the shuffles see the whole warp
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = leaky_relu(x[r][j] + q[j], slope) * at[j];
        quad_head_sums<NH>(v, C, l[r]);
        if (i0 + r < ql.rows) {
#pragma unroll
          for (int h = 0; h < NH; ++h) bm[h] = fmaxf(bm[h], l[r][h]);
        }
      }
    }
    float bden[NH], bnum[4];
#pragma unroll
    for (int h = 0; h < NH; ++h) bden[h] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) bnum[j] = 0.f;
#pragma unroll
    for (int r = 0; r < kQuadUnroll; ++r) {
      if (i0 + r < ql.rows) {
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const float p = expf(l[r][h] - bm[h]);
          bden[h] += p;
#pragma unroll
          for (int j = h * 4 / NH; j < (h + 1) * 4 / NH; ++j) bnum[j] = fmaf(p, x[r][j], bnum[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j].merge(bm[j * NH / 4], bden[j * NH / 4], bnum[j]);
  }
  if (!ql.mine) return;
  float o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) o[j] = s[j].finish();
  store_row4(out, D, ql.seg, ql.c0, true, o);
  if (m != nullptr) {
    const int H = D / C;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      const int f = ql.c0 + h * 4 / NH;  // the head's first feature on this lane
      if (f < D && f % C == 0) {
        m[(size_t)ql.seg * H + f / C] = s[h * 4 / NH].m;
        den[(size_t)ql.seg * H + f / C] = s[h * 4 / NH].den;
      }
    }
  }
}

// The online softmax of one warp over the contiguous rows [begin, end) of a
// chunk, a lane per feature: kChunkUnroll rows are loaded, then their
// logits, the batch's max and its shifted sums run, and the batch merges
// into the running triple. The row predicate is the same on every lane, so
// the shuffles of group_sum see the whole warp.
__device__ __forceinline__ Online attend_rows(const float* __restrict__ xl, int begin, int end,
                                              int D, int C, float xr, float at, float slope,
                                              int lane) {
  const bool act = lane < D;
  Online s;
  s.init();
  for (int i0 = begin; i0 < end; i0 += kChunkUnroll) {
    float x[kChunkUnroll], l[kChunkUnroll];
#pragma unroll
    for (int r = 0; r < kChunkUnroll; ++r) {
      x[r] = act && i0 + r < end ? __ldg(xl + (size_t)(i0 + r) * D + lane) : 0.f;
    }
    float bm = -INFINITY;
#pragma unroll
    for (int r = 0; r < kChunkUnroll; ++r) {
      if (i0 + r < end) {
        l[r] = group_sum(leaky_relu(x[r] + xr, slope) * at, C);
        bm = fmaxf(bm, l[r]);
      }
    }
    float bden = 0.f, bnum = 0.f;
#pragma unroll
    for (int r = 0; r < kChunkUnroll; ++r) {
      if (i0 + r < end) {
        const float p = expf(l[r] - bm);
        bden += p;
        bnum = fmaf(p, x[r], bnum);
      }
    }
    s.merge(bm, bden, bnum);
  }
  return s;
}

// Chunk k's point and rows [begin, end).
__device__ __forceinline__ void chunk_rows(const int* __restrict__ ptr, const PointSplit& sp,
                                           int k, int& seg, int& begin, int& end) {
  seg = sp.chunk_seg[k];
  begin = sp.chunk_begin[k];
  end = min(begin + kAttendChunk, ptr[seg + 1]);
}

// Forward, one unit per warp: the quads, then the chunks. part: (n_chunks,
// kTriple), each chunk's triple.
template <int NWARPS, int NH>
__global__ void __launch_bounds__(NWARPS * 32) attend_point_kernel(
    const float* __restrict__ xl, const float* __restrict__ xr, const float* __restrict__ att,
    const int* __restrict__ ptr, PointSplit sp, int n_seg, int n_quads, int D, int C,
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
    const float* __restrict__ part, PointSplit sp, int D, int C, float* __restrict__ out,
    float* __restrict__ m, float* __restrict__ den) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * NWARPS + (threadIdx.x >> 5);
  if (i >= sp.n_long) return;
  const int k1 = sp.long_ptr[i + 1];
  Online t;
  t.init();
  for (int k0 = sp.long_ptr[i]; k0 < k1; k0 += kChunkUnroll) {
    float pm[kChunkUnroll], pd[kChunkUnroll], pn[kChunkUnroll];
#pragma unroll
    for (int r = 0; r < kChunkUnroll; ++r) {
      const float* p = part + (size_t)min(k0 + r, k1 - 1) * kTriple;
      pm[r] = p[lane];
      pd[r] = p[32 + lane];
      pn[r] = p[64 + lane];
    }
#pragma unroll
    for (int r = 0; r < kChunkUnroll; ++r) {
      if (k0 + r < k1) t.merge(pm[r], pd[r], pn[r]);
    }
  }
  attend_store(t, sp.long_seg[i], D, C, lane, out, m, den);
}

// Backward of one quad (attend.cuh's per-edge formulas, 4 features per
// lane): writes its short points' d xl rows and d xr rows, adds this lane's
// d att over them to acc4 (features c0 .. c0 + 3, in row order).
template <int NH>
__device__ __forceinline__ void attend_bwd_quad(
    const float* __restrict__ xl, const float* __restrict__ xr, const float* __restrict__ att,
    const float* __restrict__ out, const float* __restrict__ m, const float* __restrict__ den,
    const float* __restrict__ g, const int* __restrict__ ptr, int n_seg, int u, int D, int C,
    float slope, float* __restrict__ dxl, float* __restrict__ dxr, float (&acc4)[4]) {
  const QuadLane ql(ptr, n_seg, u);
  const bool has = ql.seg < n_seg;
  float q[4], at[4], gg[4], o[4], mx[NH], inv[NH];
  load_row4(xr, D, ql.seg, ql.c0, has, q);
  load_row4(att, D, 0, ql.c0, true, at);
  load_row4(g, D, ql.seg, ql.c0, has, gg);
  load_row4(out, D, ql.seg, ql.c0, has, o);
  const int H = D / C;
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    const int f = ql.c0 + h * 4 / NH;
    mx[h] = inv[h] = 0.f;
    if (has && f < D) {
      mx[h] = m[(size_t)ql.seg * H + f / C];
      const float dn = den[(size_t)ql.seg * H + f / C];
      inv[h] = dn > 0.f ? 1.f / dn : 0.f;
    }
  }
  float sum[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i0 = 0; i0 < ql.most; i0 += kQuadUnroll) {
    float x[kQuadUnroll][4];
#pragma unroll
    for (int r = 0; r < kQuadUnroll; ++r) {
      load_row4(xl, D, ql.begin + i0 + r, ql.c0, i0 + r < ql.rows, x[r]);
    }
#pragma unroll
    for (int r = 0; r < kQuadUnroll; ++r) {
      if (i0 + r < ql.most) {  // the same on every lane: the shuffles see the whole warp
        float z[4], gz[4], v[4], w[4], l[NH], hs[NH], alpha[NH], dl[NH];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          z[j] = x[r][j] + q[j];
          gz[j] = leaky_relu(z[j], slope);
          v[j] = gz[j] * at[j];
          w[j] = gg[j] * (x[r][j] - o[j]);
        }
        quad_head_sums<NH>(v, C, l);
        quad_head_sums<NH>(w, C, hs);
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          alpha[h] = expf(fminf(l[h] - mx[h], 0.f)) * inv[h];
          dl[h] = alpha[h] * hs[h];
        }
        if (i0 + r < ql.rows) {
          float d[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int h = j * NH / 4;
            const float dz = dl[h] * at[j] * (z[j] >= 0.f ? 1.f : slope);
            d[j] = fmaf(alpha[h], gg[j], dz);
            sum[j] += dz;
            acc4[j] = fmaf(dl[h], gz[j], acc4[j]);
          }
          store_row4(dxl, D, ql.begin + i0 + r, ql.c0, true, d);
        }
      }
    }
  }
  store_row4(dxr, D, ql.seg, ql.c0, ql.mine, sum);
}

// The backward walk of one warp over the contiguous rows [begin, end) of a
// chunk, a lane per feature: kChunkUnroll rows loaded ahead of their
// chains; writes their d xl rows, adds to this lane's d xr and d att in row
// order.
__device__ __forceinline__ void attend_bwd_rows(const AttendBwdLane& q,
                                                const float* __restrict__ xl, int begin,
                                                int end, int D, int C, float slope, int lane,
                                                float* __restrict__ dxl, float& dxr,
                                                float& datt) {
  const bool act = lane < D;
  for (int i0 = begin; i0 < end; i0 += kChunkUnroll) {
    float x[kChunkUnroll];
#pragma unroll
    for (int r = 0; r < kChunkUnroll; ++r) {
      x[r] = act && i0 + r < end ? __ldg(xl + (size_t)(i0 + r) * D + lane) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kChunkUnroll; ++r) {
      if (i0 + r < end) {
        attend_bwd_edge(q, x[r], C, slope, act, dxl + (size_t)(i0 + r) * D + lane, dxr, datt);
      }
    }
  }
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
    const float* __restrict__ g, const int* __restrict__ ptr, PointSplit sp, int n_seg,
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
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    acc4[j] += __shfl_xor_sync(GASFM_FULL_MASK, acc4[j], 8);
    acc4[j] += __shfl_xor_sync(GASFM_FULL_MASK, acc4[j], 16);
  }
  float mine = 0.f;  // feature `lane`, held by lane lane / 4 as its (lane % 4)-th
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float t = __shfl_sync(GASFM_FULL_MASK, acc4[j], lane >> 2);
    if ((lane & 3) == j) mine = t;
  }
  acc[0] += mine;
  block_partial(acc, sbuf, partials + (size_t)blockIdx.x * 32);
}

// Backward, second launch: a warp per long point sums its chunks' d xr rows
// in chunk order (kChunkUnroll rows loaded ahead).
template <int NWARPS>
__global__ void __launch_bounds__(NWARPS * 32) attend_bwd_merge_kernel(
    const float* __restrict__ dxr_part, PointSplit sp, int D, float* __restrict__ dxr) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * NWARPS + (threadIdx.x >> 5);
  if (i >= sp.n_long) return;
  const int k1 = sp.long_ptr[i + 1];
  float t = 0.f;
  for (int k0 = sp.long_ptr[i]; k0 < k1; k0 += kChunkUnroll) {
    float v[kChunkUnroll];
#pragma unroll
    for (int r = 0; r < kChunkUnroll; ++r) v[r] = dxr_part[(size_t)min(k0 + r, k1 - 1) * 32 + lane];
#pragma unroll
    for (int r = 0; r < kChunkUnroll; ++r) {
      if (k0 + r < k1) t += v[r];
    }
  }
  if (lane < D) dxr[(size_t)sp.long_seg[i] * D + lane] = t;
}

inline int blocks_of(int items, int per_block) { return (items + per_block - 1) / per_block; }

// Call f with std::integral_constant<int, NH>, NH the heads of a quad lane's
// 4 features: 4 / C for C < 4, else 1.
template <typename F>
void by_heads(int C, F&& f) {
  if (C >= 4) {
    f(std::integral_constant<int, 1>{});
  } else if (C == 2) {
    f(std::integral_constant<int, 2>{});
  } else {
    f(std::integral_constant<int, 4>{});
  }
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
//     PointSplit); part: (n_chunks, 96) scratch. xl, xr and att are read
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
  const PointSplit sp(split, n_long, n_chunks);
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
  const PointSplit sp(split, n_long, n_chunks);
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
