// Segment attention on split segments, as device code (sm_90a, float32):
// shared by fused_attn.cu (#13/#14, the point side) and fused_dual_attn.cu
// (the dual core's forward #1 and backward #2, both sides).
//
// Segment degrees are power-law (a point of one scene has up to 670 edges, a
// camera up to ~1,300), and a warp that walks a whole segment serially, a
// DRAM latency plus a shuffle chain per edge, makes the longest segment the
// whole launch. So the segments come split by length once per graph on the
// host (ViewGraph.pt_chunks / cam_chunks, split_segments): no warp walks
// more than kAttendChunk edge rows of one segment. A warp's unit is one of
//   - a quad (contiguous segments only): segments 4u .. 4u + 3, 8 lanes
//     each, 4 features per lane (a 32-wide row is one 16-byte load per
//     lane); a segment of at most kAttendChunk edges (an empty one too) is
//     short and is walked here, a longer one's lanes idle;
//   - a chunk: kAttendChunk rows (the last one ragged) of a long segment
//     (the split's chunk list), or a short camera: a lane per feature on
//     contiguous rows (#13/#14), or laid out as a quad of rows, 8 lanes of
//     4 features, 4 rows at a time (the dual core), its rows contiguous or
//     listed by a permutation (the camera CSR), whose entries the warp reads
//     with one coalesced load.
// Each walker loads several rows (kQuadUnroll per segment of a quad,
// kChunkUnroll per chunk) before it runs their logits, so that many loads
// are in flight. A chunk writes a partial (the online triple forward, the d
// xr sum backward) and a second launch merges each long segment's partials
// in chunk order (flash-decoding). No float atomics: results are bitwise
// reproducible on a given card.
#pragma once

#include <type_traits>

#include "attend.cuh"

namespace gasfm {

constexpr int kAttendChunk = 32;         // the split length: the most rows of a segment per warp
constexpr int kQuad = 4;                 // short segments per warp
constexpr int kQuadUnroll = 4;           // rows per segment whose loads issue together
constexpr int kChunkUnroll = 8;          // rows per chunk whose loads issue together
constexpr int kTriple = 3 * 32;          // floats of one forward partial: m, den, num per lane

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

// Write segment `seg`'s output features c0 .. c0 + 3 from their online
// triples and, when m != NULL, the per-head max and denominator of each head
// that starts on this lane's features.
template <int NH>
__device__ __forceinline__ void store_quad(const Online (&s)[4], int seg, int c0, int D, int C,
                                           float* __restrict__ out, float* __restrict__ m,
                                           float* __restrict__ den) {
  float o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) o[j] = s[j].finish();
  store_row4(out, D, seg, c0, true, o);
  if (m != nullptr) {
    const int H = D / C;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      const int f = c0 + h * 4 / NH;  // the head's first feature on this lane
      if (f < D && f % C == 0) {
        m[(size_t)seg * H + f / C] = s[h * 4 / NH].m;
        den[(size_t)seg * H + f / C] = s[h * 4 / NH].den;
      }
    }
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
  if (ql.mine) store_quad<NH>(s, ql.seg, ql.c0, D, C, out, m, den);
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

// The forward of rows [begin, end) of one segment `seg` (at most
// kAttendChunk; with PERM the edges perm[begin .. end), read by one
// coalesced load and handed round by shuffles), laid out as a quad: the
// warp's 4 lane groups take rows 4i + group, 8 lanes of 4 features each,
// kChunkUnroll rows in flight; each group runs the online softmax of its
// rows, batch by batch as attend_rows does, and the groups' triples merge
// by a butterfly. Returns in lanes 0-7 the triples of features c0 .. c0 + 3
// over all the rows. Every lane of the warp must call it.
template <int NH, bool PERM>
__device__ __forceinline__ void attend_rows4(const float* __restrict__ xl,
                                             const float* __restrict__ xr,
                                             const float* __restrict__ att,
                                             const int* __restrict__ perm, int seg, int begin,
                                             int end, int D, int C, float slope,
                                             Online (&s)[4]) {
  constexpr int kSteps = kChunkUnroll / kQuad;  // rows per lane group in flight
  const int lane = threadIdx.x & 31, grp = lane >> 3, c0 = 4 * (lane & 7);
  float q[4], at[4];
  load_row4(xr, D, seg, c0, true, q);
  load_row4(att, D, 0, c0, true, at);
  int mine = 0;
  if constexpr (PERM) mine = begin + lane < end ? __ldg(perm + begin + lane) : 0;
  const int n = end - begin;
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j].init();
  for (int i0 = 0; i0 < n; i0 += kChunkUnroll) {
    float x[kSteps][4], l[kSteps][NH], bm[NH];
#pragma unroll
    for (int t = 0; t < kSteps; ++t) {
      const int r = i0 + kQuad * t + grp;
      int e = begin + r;
      if constexpr (PERM) e = __shfl_sync(GASFM_FULL_MASK, mine, r & 31);
      load_row4(xl, D, e, c0, r < n, x[t]);
    }
#pragma unroll
    for (int h = 0; h < NH; ++h) bm[h] = -INFINITY;
#pragma unroll
    for (int t = 0; t < kSteps; ++t) {
      if (i0 + kQuad * t < n) {  // the same on every lane: the shuffles see the whole warp
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = leaky_relu(x[t][j] + q[j], slope) * at[j];
        quad_head_sums<NH>(v, C, l[t]);
        if (i0 + kQuad * t + grp < n) {
#pragma unroll
          for (int h = 0; h < NH; ++h) bm[h] = fmaxf(bm[h], l[t][h]);
        }
      }
    }
    float bden[NH], bnum[4];
#pragma unroll
    for (int h = 0; h < NH; ++h) bden[h] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) bnum[j] = 0.f;
#pragma unroll
    for (int t = 0; t < kSteps; ++t) {
      if (i0 + kQuad * t + grp < n) {
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const float p = expf(l[t][h] - bm[h]);
          bden[h] += p;
#pragma unroll
          for (int j = h * 4 / NH; j < (h + 1) * 4 / NH; ++j) bnum[j] = fmaf(p, x[t][j], bnum[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j].merge(bm[j * NH / 4], bden[j * NH / 4], bnum[j]);
  }
#pragma unroll
  for (int off = 8; off < 32; off <<= 1) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float om = __shfl_xor_sync(GASFM_FULL_MASK, s[j].m, off);
      const float od = __shfl_xor_sync(GASFM_FULL_MASK, s[j].den, off);
      const float on = __shfl_xor_sync(GASFM_FULL_MASK, s[j].num, off);
      s[j].merge(om, od, on);
    }
  }
}

// The triples part[k0 .. k1) (row stride kTriple: m, den, num per lane)
// merged in chunk order, kChunkUnroll rows loaded ahead: lane `lane`'s.
__device__ __forceinline__ Online merge_triples(const float* __restrict__ part, int k0, int k1,
                                                int lane) {
  Online t;
  t.init();
  for (; k0 < k1; k0 += kChunkUnroll) {
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
  return t;
}

// Chunk k's segment and rows [begin, end).
__device__ __forceinline__ void chunk_rows(const int* __restrict__ ptr, const SegmentSplit& sp,
                                           int k, int& seg, int& begin, int& end) {
  seg = sp.chunk_seg[k];
  begin = sp.chunk_begin[k];
  end = min(begin + kAttendChunk, ptr[seg + 1]);
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

// A lane's segment data for attend_bwd_rows4, features c0 .. c0 + 3 of
// segment `seg`: its query, attention vector, output cotangent and output,
// and per head slot (feature c0 + h * 4 / NH) the forward's max and
// 1 / denominator.
template <int NH>
struct QuadBwdLane {
  float q[4], at[4], gg[4], o[4], mx[NH], inv[NH];

  __device__ __forceinline__ QuadBwdLane(const float* __restrict__ xr,
                                         const float* __restrict__ att,
                                         const float* __restrict__ out,
                                         const float* __restrict__ m,
                                         const float* __restrict__ den,
                                         const float* __restrict__ g, int seg, int c0, int D,
                                         int C) {
    load_row4(xr, D, seg, c0, true, q);
    load_row4(att, D, 0, c0, true, at);
    load_row4(g, D, seg, c0, true, gg);
    load_row4(out, D, seg, c0, true, o);
    const int H = D / C;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      const int f = c0 + h * 4 / NH;
      mx[h] = inv[h] = 0.f;
      if (f < D) {
        mx[h] = m[(size_t)seg * H + f / C];
        const float dn = den[(size_t)seg * H + f / C];
        inv[h] = dn > 0.f ? 1.f / dn : 0.f;
      }
    }
  }

  // One row x (this lane's 4 features), attend_bwd_quad's per-row formulas:
  // its d xl features d and, for a `valid` row, this lane's d xr and d att
  // added to sum and acc4. Every lane of the warp calls it (the head sums
  // shuffle). attend_bwd_quad keeps its own copy: taking this one slowed
  // #14 by ~7% on the H100.
  __device__ __forceinline__ void row(const float (&x)[4], int C, float slope, bool valid,
                                      float (&d)[4], float (&sum)[4], float (&acc4)[4]) const {
    float z[4], gz[4], v[4], w[4], l[NH], hs[NH], alpha[NH], dl[NH];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      z[j] = x[j] + q[j];
      gz[j] = leaky_relu(z[j], slope);
      v[j] = gz[j] * at[j];
      w[j] = gg[j] * (x[j] - o[j]);
    }
    quad_head_sums<NH>(v, C, l);
    quad_head_sums<NH>(w, C, hs);
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      alpha[h] = expf(fminf(l[h] - mx[h], 0.f)) * inv[h];
      dl[h] = alpha[h] * hs[h];
    }
    if (!valid) return;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int h = j * NH / 4;
      const float dz = dl[h] * at[j] * (z[j] >= 0.f ? 1.f : slope);
      d[j] = fmaf(alpha[h], gg[j], dz);
      sum[j] += dz;
      acc4[j] = fmaf(dl[h], gz[j], acc4[j]);
    }
  }
};

// Backward of rows [begin, end) of one segment `seg` (at most kAttendChunk;
// with PERM the edges perm[begin .. end), read by one coalesced load and
// handed round by shuffles), laid out as a quad: the warp's 4 lane groups
// take rows 4i + group, 8 lanes of 4 features each, kChunkUnroll rows in
// flight. Writes their d xl rows; returns in lanes 0-7 the segment's d xr
// sum over them (features c0 .. c0 + 3: each group's rows in order, then
// the groups by a butterfly), and adds this lane's d att to acc4.
template <int NH, bool PERM>
__device__ __forceinline__ void attend_bwd_rows4(
    const float* __restrict__ xl, const float* __restrict__ xr, const float* __restrict__ att,
    const float* __restrict__ out, const float* __restrict__ m, const float* __restrict__ den,
    const float* __restrict__ g, const int* __restrict__ perm, int seg, int begin, int end,
    int D, int C, float slope, float* __restrict__ dxl, float (&sum)[4], float (&acc4)[4]) {
  constexpr int kSteps = kChunkUnroll / kQuad;  // rows per lane group in flight
  const int lane = threadIdx.x & 31, grp = lane >> 3, c0 = 4 * (lane & 7);
  const QuadBwdLane<NH> sl(xr, att, out, m, den, g, seg, c0, D, C);
  int mine = 0;
  if constexpr (PERM) mine = begin + lane < end ? __ldg(perm + begin + lane) : 0;
  const int n = end - begin;
#pragma unroll
  for (int j = 0; j < 4; ++j) sum[j] = 0.f;
  for (int i0 = 0; i0 < n; i0 += kChunkUnroll) {
    int e[kSteps];
    float x[kSteps][4];
#pragma unroll
    for (int t = 0; t < kSteps; ++t) {
      const int r = i0 + kQuad * t + grp;
      if constexpr (PERM) {
        e[t] = __shfl_sync(GASFM_FULL_MASK, mine, r & 31);
      } else {
        e[t] = begin + r;
      }
      load_row4(xl, D, e[t], c0, r < n, x[t]);
    }
#pragma unroll
    for (int t = 0; t < kSteps; ++t) {
      if (i0 + kQuad * t < n) {  // the same on every lane: the shuffles see the whole warp
        float d[4];
        const bool valid = i0 + kQuad * t + grp < n;
        sl.row(x[t], C, slope, valid, d, sum, acc4);
        if (valid) store_row4(dxl, D, e[t], c0, true, d);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    sum[j] += __shfl_xor_sync(GASFM_FULL_MASK, sum[j], 8);
    sum[j] += __shfl_xor_sync(GASFM_FULL_MASK, sum[j], 16);
  }
}

// The backward walk of one warp over the contiguous rows [begin, end) of a
// chunk, a lane per feature: kChunkUnroll rows loaded ahead of their
// chains; writes their d xl rows, adds to this lane's d xr and d att in row
// order. #14 walks its long points' chunks here, not in attend_bwd_rows4,
// for two reasons: attend_bwd_rows4 sums a chunk's d xr in four row groups
// joined by a butterfly, another order, so #14's d xr would change in its
// last bits; and on the wide scene #14 took 0.0257 ms per call on it against
// 0.0240 here (NVIDIA H100 80GB HBM3, 700 W, kernel_device_time).
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

// A quad lane's d att sums (features c0 .. c0 + 3 of its segment) summed
// over the warp's four segments in a fixed order and handed to the lane of
// each feature: feature `lane`, held by lane lane / 4 as its (lane % 4)-th.
__device__ __forceinline__ float quad_datt_lane(float (&acc4)[4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    acc4[j] += __shfl_xor_sync(GASFM_FULL_MASK, acc4[j], 8);
    acc4[j] += __shfl_xor_sync(GASFM_FULL_MASK, acc4[j], 16);
  }
  float mine = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float t = __shfl_sync(GASFM_FULL_MASK, acc4[j], lane >> 2);
    if ((lane & 3) == j) mine = t;
  }
  return mine;
}

// Lane `lane`'s column of rows [k0, k1) of `part` (row stride 32) summed in
// row order, UNROLL rows loaded ahead: a long segment's d xr partials merged
// in chunk order.
template <int UNROLL>
__device__ __forceinline__ float sum_rows_in_order(const float* __restrict__ part, int k0,
                                                   int k1, int lane) {
  float t = 0.f;
  for (; k0 < k1; k0 += UNROLL) {
    float v[UNROLL];
#pragma unroll
    for (int r = 0; r < UNROLL; ++r) v[r] = part[(size_t)min(k0 + r, k1 - 1) * 32 + lane];
#pragma unroll
    for (int r = 0; r < UNROLL; ++r) {
      if (k0 + r < k1) t += v[r];
    }
  }
  return t;
}


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
