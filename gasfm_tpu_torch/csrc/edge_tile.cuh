// Edge-tile backward of a per-edge prologue, for sm_90a: the layer step's
// backward (fused_layer_step.cu, gasfm_layer_step_bwd) runs it, and the
// frontend's (#4) and the projection update's (#10) backwards can take up the
// same tile layout.
//
// The per-edge work of these backwards is a few small dense products (the
// two GATv2 source linears' transpose, the update's weight W, and the weight
// gradients as sums of outer products over all edges) around a LayerNorm.
// The first design gave each point one warp, lane j feature j, and ran every
// product as a shuffle + shared load + FMA chain per edge (~116 dependent
// steps per edge), with the weight gradients in a second pass over the
// streams. Here a block takes tiles of kTileRows edges in a fixed order
// (persistent, kTileBlocksPerSm blocks per SM), stages each tile's rows in
// shared memory with 16-byte loads, and runs every product register-tiled:
// a thread owns a 2 x 4 (or 1 x 4) output tile and reads each shared operand
// once per four to eight FMAs, warps broadcasting the operands they share.
// The weight gradients stay in registers across all of the block's tiles,
// each entry owned by one thread, and the block writes them as one partial
// row; column_sum_kernel (common.cuh) sums the rows in a fixed order. No
// float atomics, no TF32: float32 FMAs on the CUDA cores, bitwise
// reproducible on a given card.
#pragma once

#include "common.cuh"

namespace gasfm {

constexpr int kTileRows = 32;        // edges per tile
constexpr int kTileThreads = 256;    // 8 warps: one thread per (edge, 4 features) of a tile
constexpr int kTileBlocksPerSm = 3;  // persistent blocks per SM
constexpr int kTileNarrow = 36;      // shared row stride of a stream <= 32 wide
constexpr int kTileWide = 68;        // of a stream <= 64 wide (16-byte aligned rows)

// Copy rows [e0, e0 + kTileRows) of the (E, D) stream `src` into columns
// [col0, col0 + D) of the shared rows dst[r * stride + ...]; rows past E are
// zeros. 16-byte loads when D and col0 are multiples of 4 (the caller keeps
// the stream 16-byte aligned). Every thread of the block calls it.
__device__ __forceinline__ void stage_rows(float* dst, int stride, int col0,
                                           const float* __restrict__ src, int D, int e0,
                                           int E) {
  if (src == nullptr || D == 0) return;
  const int rows = min(kTileRows, E - e0);
  if ((D & 3) == 0 && (col0 & 3) == 0) {
    const int dv = D >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(src + (size_t)e0 * D);
    for (int i = threadIdx.x; i < kTileRows * dv; i += kTileThreads) {
      const int r = i / dv, c = i - r * dv;
      const float4 v = r < rows ? __ldcs(s4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(dst + r * stride + col0 + 4 * c) = v;
    }
  } else {
    const float* s1 = src + (size_t)e0 * D;
    for (int i = threadIdx.x; i < kTileRows * D; i += kTileThreads) {
      const int r = i / D, c = i - r * D;
      dst[r * stride + col0 + c] = r < rows ? __ldcs(s1 + i) : 0.f;
    }
  }
}

// Sum over the 32 features of a row held 4 per lane by 8 consecutive lanes
// (feature 4 (lane % 8) + q), every lane of the 8 receiving it. The tree is
// group_sum(x, 32)'s butterfly (common.cuh) over one feature per lane:
// features xor 16, 8, 4 across the lanes, then xor 2 and 1 inside the lane.
__device__ __forceinline__ float row_sum32(const float (&s)[4]) {
  float t[4] = {s[0], s[1], s[2], s[3]};
  for (int off = 4; off > 0; off >>= 1) {
#pragma unroll
    for (int q = 0; q < 4; ++q) t[q] += __shfl_xor_sync(GASFM_FULL_MASK, t[q], off);
  }
  return (t[0] + t[2]) + (t[1] + t[3]);
}

// ---------------------------------------------------------------------------
// The layer step's backward tile kernel. Per edge, with x = e_l (De), the
// next layer's prologue v = relu(LN(x)) (v = x under raw) and its source
// linears xl_p = v Wlp^T + blp, xl_c = v Wlc^T + blc, and the update
// e_l = ([en | skip2] W^T + ...) / 4:
//
//   dv   = [dxl_p | dxl_c] . [Wlp ; Wlc]  (+ d en_next)
//   d_el = LN + ReLU backward of dv       (+ d e_l's own cotangent)
//   [d en | d skip2] = (d_el / 4) . W
//
// and, summed over all edges into one partial row per block (layout:
// StepRow): d Wlp = dxl_p^T v, d blp, d Wlc = dxl_c^T v, d blc,
// d W = (d_el / 4)^T [en | skip2], d b, d ln_scale, d ln_bias. d ps and d pv,
// the segment sums of d_el / 4, are the caller's (segment.cuh).
// Widths: De, Dp, Dc, d_in, d2 <= 32, Dp + Dc <= 64, K = d_in + d2 <= 64.
// ---------------------------------------------------------------------------

struct StepTileSmem {
  float dx[kTileRows][kTileWide];   // [dxl_p | dxl_c] of the tile's edges
  float a[kTileRows][kTileWide];    // [en | skip2]
  float v[kTileRows][kTileNarrow];  // the normalized output v
  float du[kTileRows][kTileNarrow];  // d_el / 4
  float wf[64][32];                 // [Wlp ; Wlc] (Dp + Dc, De), zero-padded to 32 columns
  float w[32][kTileWide];           // W (De, K)
  float g[32], b[32];               // the LayerNorm's scale and bias
};

// Offsets in the partial row: d Wlp (Dp, De), d blp, d Wlc (Dc, De), d blc,
// d W (De, K), d b, d ln_scale, d ln_bias; returns the row's length.
struct StepRow {
  int wlp, blp, wlc, blc, w, b, g, bn, len;
  __host__ __device__ StepRow(int De, int K, int Dp, int Dc) {
    wlp = 0;
    blp = wlp + Dp * De;
    wlc = blp + Dp;
    blc = wlc + Dc * De;
    w = blc + Dc;
    b = w + De * K;
    g = b + De;
    bn = g + De;
    len = bn + De;
  }
};

__global__ void __launch_bounds__(kTileThreads, kTileBlocksPerSm) layer_step_bwd_tile_kernel(
    const float* __restrict__ en, int d_in, const float* __restrict__ skip2, int d2,
    const float* __restrict__ w, const float* __restrict__ e_l, int E, int De,
    const float* __restrict__ lng, const float* __restrict__ lnb, int raw, float eps,
    const float* __restrict__ wlp, int Dp, const float* __restrict__ wlc, int Dc,
    const float* __restrict__ dxl_p, const float* __restrict__ dxl_c,
    const float* __restrict__ den_next, const float* __restrict__ de_l_ext,
    float* __restrict__ d_el, float* __restrict__ den_out, float* __restrict__ dskip2,
    float* __restrict__ partials) {
  __shared__ __align__(16) StepTileSmem s;
  const int tid = threadIdx.x;
  const int K = d_in + d2, KF = Dp + Dc;
  const int ncg = (K + 3) >> 2;  // 4-column groups of [en | skip2]

  for (int i = tid; i < 64 * 32; i += kTileThreads) {
    const int r = i >> 5, c = i & 31;
    float x = 0.f;
    if (c < De && r < Dp) x = wlp[r * De + c];
    if (c < De && r >= Dp && r < KF) x = wlc[(r - Dp) * De + c];
    s.wf[r][c] = x;
  }
  for (int i = tid; i < De * K; i += kTileThreads) {
    const int j = i / K;
    s.w[j][i - j * K] = w[i];
  }
  if (!raw && tid < De) {
    s.g[tid] = lng[tid];
    s.b[tid] = lnb[tid];
  }

  // Phase 1 (the LayerNorm and the product with [Wlp ; Wlc]): edge r1 of the
  // tile, features c1 .. c1 + 3.
  const int r1 = tid >> 3, c1 = 4 * (tid & 7);
  float dg[4] = {0.f, 0.f, 0.f, 0.f}, db[4] = {0.f, 0.f, 0.f, 0.f};
  // Phase 3 (d Wlp, d Wlc, their biases): dx features i3, i3 + 1, v
  // features j3 .. j3 + 3.
  const int i3 = 2 * (tid >> 3), j3 = 4 * (tid & 7);
  float acc3[2][4] = {}, bias3[2] = {0.f, 0.f};
  // Phase 2 (d en, d skip2): edges 2 rg2, 2 rg2 + 1, columns 4 cg2 .. of
  // [en | skip2]; the first 16 ncg threads.
  const bool on2 = tid < 16 * ncg;
  const int rg2 = on2 ? tid / ncg : 0, k2 = 4 * (tid - rg2 * ncg);
  // Phase 4 (d W, d b): du features j4, j4 + 1, columns k4 .. k4 + 3; the
  // last 16 ncg threads, so phases 2 and 4 share the warps out.
  const int t4 = kTileThreads - 1 - tid;
  const bool on4 = t4 < 16 * ncg;
  const int rg4 = on4 ? t4 / ncg : 0, j4 = 2 * rg4, k4 = 4 * (t4 - rg4 * ncg);
  float acc4[2][4] = {}, bias4[2] = {0.f, 0.f};
  const float inv = 1.f / (float)De;

  for (int tile = blockIdx.x; tile * kTileRows < E; tile += gridDim.x) {
    const int e0 = tile * kTileRows;
    const int e1 = e0 + r1;
    const bool valid = e1 < E;
    float x[4], dv[4], dext[4];
    load_row4(e_l, De, e1, c1, valid, x);
    load_row4(den_next, De, e1, c1, valid, dv);
    load_row4(de_l_ext, De, e1, c1, valid, dext);
    __syncthreads();  // the previous tile's readers are done (and the weights are in)
    stage_rows(&s.dx[0][0], kTileWide, 0, dxl_p, Dp, e0, E);
    stage_rows(&s.dx[0][0], kTileWide, Dp, dxl_c, Dc, e0, E);
    stage_rows(&s.a[0][0], kTileWide, 0, en, d_in, e0, E);
    stage_rows(&s.a[0][0], kTileWide, d_in, skip2, d2, e0, E);
    __syncthreads();

    // ---- phase 1: dv, the LayerNorm + ReLU backward, d_el
    int k = 0;
    for (; k + 3 < KF; k += 4) {  // four k per 16-byte load of the edge's row
      const float4 d4 = *reinterpret_cast<const float4*>(&s.dx[r1][k]);
      const float d[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 wk = *reinterpret_cast<const float4*>(&s.wf[k + u][c1]);
        dv[0] = fmaf(d[u], wk.x, dv[0]);
        dv[1] = fmaf(d[u], wk.y, dv[1]);
        dv[2] = fmaf(d[u], wk.z, dv[2]);
        dv[3] = fmaf(d[u], wk.w, dv[3]);
      }
    }
    for (; k < KF; ++k) {
      const float d = s.dx[r1][k];
      const float4 wk = *reinterpret_cast<const float4*>(&s.wf[k][c1]);
      dv[0] = fmaf(d, wk.x, dv[0]);
      dv[1] = fmaf(d, wk.y, dv[1]);
      dv[2] = fmaf(d, wk.z, dv[2]);
      dv[3] = fmaf(d, wk.w, dv[3]);
    }
    float vo[4], de[4];
    if (raw) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        vo[q] = x[q];
        de[q] = dv[q] + dext[q];
      }
    } else {
      float sq[4], xhat[4], dxh[4], dxx[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) sq[q] = x[q] * x[q];
      const float mean = row_sum32(x) * inv;
      const float var = row_sum32(sq) * inv - mean * mean;
      const float rstd = rsqrtf(var + eps);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = c1 + q;
        const bool act = c < De;
        xhat[q] = act ? (x[q] - mean) * rstd : 0.f;
        const float y = act ? xhat[q] * s.g[c] + s.b[c] : 0.f;
        vo[q] = fmaxf(y, 0.f);
        const float dy = (act && y > 0.f) ? dv[q] : 0.f;  // through the ReLU
        dg[q] = fmaf(dy, xhat[q], dg[q]);
        db[q] += dy;
        dxh[q] = act ? dy * s.g[c] : 0.f;
        dxx[q] = dxh[q] * xhat[q];
      }
      const float m1 = row_sum32(dxh) * inv;
      const float m2 = row_sum32(dxx) * inv;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        de[q] = (c1 + q < De ? rstd * (dxh[q] - m1 - xhat[q] * m2) : 0.f) + dext[q];
      }
    }
    store_row4(d_el, De, e1, c1, valid, de);
    *reinterpret_cast<float4*>(&s.v[r1][c1]) =
        valid ? make_float4(vo[0], vo[1], vo[2], vo[3]) : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(&s.du[r1][c1]) =
        valid ? make_float4(de[0] * 0.25f, de[1] * 0.25f, de[2] * 0.25f, de[3] * 0.25f)
              : make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();

    // ---- phase 2: [d en | d skip2] = du . W, written out
    if (on2) {
      float o[2][4] = {};
      const int ra = 2 * rg2;
      for (int j = 0; j < De; ++j) {
        const float a0 = s.du[ra][j], a1 = s.du[ra + 1][j];
        const float4 wj = *reinterpret_cast<const float4*>(&s.w[j][k2]);
        o[0][0] = fmaf(a0, wj.x, o[0][0]);
        o[0][1] = fmaf(a0, wj.y, o[0][1]);
        o[0][2] = fmaf(a0, wj.z, o[0][2]);
        o[0][3] = fmaf(a0, wj.w, o[0][3]);
        o[1][0] = fmaf(a1, wj.x, o[1][0]);
        o[1][1] = fmaf(a1, wj.y, o[1][1]);
        o[1][2] = fmaf(a1, wj.z, o[1][2]);
        o[1][3] = fmaf(a1, wj.w, o[1][3]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = e0 + ra + h;
        if (e >= E) continue;
        if ((d_in & 3) == 0 && k2 + 3 < d_in) {
          *reinterpret_cast<float4*>(den_out + (size_t)e * d_in + k2) =
              make_float4(o[h][0], o[h][1], o[h][2], o[h][3]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int k = k2 + q;
            if (k < d_in) {
              den_out[(size_t)e * d_in + k] = o[h][q];
            } else if (k < K) {
              dskip2[(size_t)e * d2 + (k - d_in)] = o[h][q];
            }
          }
        }
      }
    }
    // ---- phase 3: d Wlp / d Wlc += dx^T v, their biases
    for (int r = 0; r < kTileRows; ++r) {
      const float2 d = *reinterpret_cast<const float2*>(&s.dx[r][i3]);
      const float4 vv = *reinterpret_cast<const float4*>(&s.v[r][j3]);
      acc3[0][0] = fmaf(d.x, vv.x, acc3[0][0]);
      acc3[0][1] = fmaf(d.x, vv.y, acc3[0][1]);
      acc3[0][2] = fmaf(d.x, vv.z, acc3[0][2]);
      acc3[0][3] = fmaf(d.x, vv.w, acc3[0][3]);
      acc3[1][0] = fmaf(d.y, vv.x, acc3[1][0]);
      acc3[1][1] = fmaf(d.y, vv.y, acc3[1][1]);
      acc3[1][2] = fmaf(d.y, vv.z, acc3[1][2]);
      acc3[1][3] = fmaf(d.y, vv.w, acc3[1][3]);
      bias3[0] += d.x;
      bias3[1] += d.y;
    }
    // ---- phase 4: d W += du^T [en | skip2], d b
    if (on4) {
      for (int r = 0; r < kTileRows; ++r) {
        const float2 d = *reinterpret_cast<const float2*>(&s.du[r][j4]);
        const float4 av = *reinterpret_cast<const float4*>(&s.a[r][k4]);
        acc4[0][0] = fmaf(d.x, av.x, acc4[0][0]);
        acc4[0][1] = fmaf(d.x, av.y, acc4[0][1]);
        acc4[0][2] = fmaf(d.x, av.z, acc4[0][2]);
        acc4[0][3] = fmaf(d.x, av.w, acc4[0][3]);
        acc4[1][0] = fmaf(d.y, av.x, acc4[1][0]);
        acc4[1][1] = fmaf(d.y, av.y, acc4[1][1]);
        acc4[1][2] = fmaf(d.y, av.z, acc4[1][2]);
        acc4[1][3] = fmaf(d.y, av.w, acc4[1][3]);
        bias4[0] += d.x;
        bias4[1] += d.y;
      }
    }
  }

  // ---- this block's partial row
  const StepRow L(De, K, Dp, Dc);
  float* row = partials + (size_t)blockIdx.x * L.len;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i3 + h;
    if (i >= KF) continue;
    const int base = i < Dp ? L.wlp + i * De : L.wlc + (i - Dp) * De;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (j3 + q < De) row[base + j3 + q] = acc3[h][q];
    }
    if (j3 == 0) row[i < Dp ? L.blp + i : L.blc + (i - Dp)] = bias3[h];
  }
  if (on4) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j4 + h;
      if (j >= De) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (k4 + q < K) row[L.w + j * K + k4 + q] = acc4[h][q];
      }
      if (k4 == 0) row[L.b + j] = bias4[h];
    }
  }
  // d ln_scale, d ln_bias: the 32 edge slots' sums, merged in slot order.
  __syncthreads();
  float* red = &s.dx[0][0];  // 32 x 8 x 8 floats
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    red[tid * 8 + q] = dg[q];
    red[tid * 8 + 4 + q] = db[q];
  }
  __syncthreads();
  if (tid < 64) {
    const int which = tid >> 5, c = tid & 31;
    float t = 0.f;
    for (int r = 0; r < kTileRows; ++r) t += red[(r * 8 + (c >> 2)) * 8 + which * 4 + (c & 3)];
    if (c < De) row[(which == 0 ? L.g : L.bn) + c] = t;
  }
}

}  // namespace gasfm
