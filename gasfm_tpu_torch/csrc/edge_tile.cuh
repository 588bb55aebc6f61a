// Edge tiles of a per-edge prologue, for sm_90a: the layer step's forward
// (#5) and backward (#6) (fused_layer_step.cu, gasfm_layer_step_prologue and
// gasfm_layer_step_bwd), the frontend's forward (#3) and backward (#4)
// (fused_dual_attn.cu, gasfm_frontend_prologue and
// gasfm_frontend_prologue_bwd) and the projection update's forward (#9) and
// backward (#10) (fused_proj_update.cu, gasfm_proj_update and
// gasfm_proj_update_bwd) run them.
//
// The per-edge work of these prologues is a few small dense products (the
// update's weight W, the two GATv2 source linears and their transposes, the
// weight gradients as sums of outer products over all edges) around a
// LayerNorm. The first designs gave each edge (forward) or each point
// (backward) one warp, lane j feature j, and ran every product as a shuffle +
// shared load + FMA chain per edge (~80 dependent steps per edge forward,
// ~116 backward), with the backward's weight gradients in a second pass over
// the streams. Here a block takes tiles of kTileRows edges in a fixed order
// (persistent, a few blocks per SM, the weights loaded into shared memory
// once per block), stages each tile's rows in shared memory with 16-byte
// loads, and runs every product register-tiled: a thread owns a 2 x 4 (or
// 1 x 4) output tile and reads each shared operand once per four to eight
// FMAs, warps broadcasting the operands they share. The backward's weight
// gradients stay in registers across all of the block's tiles, each entry
// owned by one thread, and the block writes them as one partial row;
// column_sum_kernel (common.cuh) sums the rows in a fixed order. No float
// atomics, no TF32: float32 FMAs on the CUDA cores, bitwise reproducible on a
// given card.
//
// Edge streams (compile.stream_dtype): every kernel here is a template on the
// storage type of its edge-stream rows, float or bf16 (__nv_bfloat16). A bf16
// row is upcast as it is loaded and rounded to nearest even as it is stored
// (__float2bfloat16_rn); all math, the weights, the tables, the shared tiles
// and the outputs that are not streams stay float32. The shared layout is
// the same for both: bf16 rows are converted as they are staged, so their
// copies are synchronous loads (cp.async copies bytes, it cannot convert),
// 8 bytes for 4 features where the width allows, 4 for 2, else one by one.
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

namespace gasfm {

constexpr int kTileRows = 32;        // edges per tile
constexpr int kTileThreads = 256;    // 8 warps: one thread per (edge, 4 features) of a tile
constexpr int kTileBlocksPerSm = 3;  // persistent blocks per SM
constexpr int kTileNarrow = 36;      // shared row stride of a stream <= 32 wide
constexpr int kTileWide = 68;        // of a stream <= 64 wide (16-byte aligned rows)

using bf16 = __nv_bfloat16;

// 4 bf16 (8 bytes) as floats, and 4 floats rounded into 4 bf16.
__device__ __forceinline__ void bf16x4_to_f32(const uint2 t, float (&v)[4]) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}

__device__ __forceinline__ uint2 f32_to_bf16x4(float a, float b, float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 t;
  t.x = *reinterpret_cast<const unsigned*>(&lo);
  t.y = *reinterpret_cast<const unsigned*>(&hi);
  return t;
}

// One stream element stored from float32.
__device__ __forceinline__ void stream_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void stream_store(bf16* p, float x) { *p = __float2bfloat16_rn(x); }

// load_row4 / store_row4 (common.cuh) of a bf16 stream: one 8-byte access
// where D % 4 == 0 (the caller keeps the stream 16-byte aligned).
__device__ __forceinline__ void load_row4(const bf16* __restrict__ src, int D, int e, int c0,
                                          bool valid, float (&v)[4]) {
  v[0] = v[1] = v[2] = v[3] = 0.f;
  if (src == nullptr || !valid || c0 >= D) return;
  const bf16* p = src + (size_t)e * D + c0;
  if ((D & 3) == 0) {
    bf16x4_to_f32(__ldcs(reinterpret_cast<const uint2*>(p)), v);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (c0 + q < D) v[q] = __bfloat162float(p[q]);
    }
  }
}

__device__ __forceinline__ void store_row4(bf16* __restrict__ dst, int D, int e, int c0,
                                           bool valid, const float (&v)[4]) {
  if (dst == nullptr || !valid || c0 >= D) return;
  bf16* p = dst + (size_t)e * D + c0;
  if ((D & 3) == 0) {
    *reinterpret_cast<uint2*>(p) = f32_to_bf16x4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (c0 + q < D) p[q] = __float2bfloat16_rn(v[q]);
    }
  }
}

// stage_rows of a bf16 stream: the rows upcast into the float32 tile.
__device__ __forceinline__ void stage_rows(float* dst, int stride, int col0,
                                           const bf16* __restrict__ src, int D, int e0, int E) {
  if (src == nullptr || D == 0) return;
  const int rows = min(kTileRows, E - e0);
  const bf16* s0 = src + (size_t)e0 * D;
  if ((D & 3) == 0) {
    const int dv = D >> 2;
    for (int i = threadIdx.x; i < kTileRows * dv; i += kTileThreads) {
      const int r = i / dv, c = i - r * dv;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (r < rows) bf16x4_to_f32(__ldcs(reinterpret_cast<const uint2*>(s0) + i), v);
      float* d = dst + r * stride + col0 + 4 * c;
      d[0] = v[0], d[1] = v[1], d[2] = v[2], d[3] = v[3];
    }
  } else if ((D & 1) == 0) {
    const int dv = D >> 1;
    for (int i = threadIdx.x; i < kTileRows * dv; i += kTileThreads) {
      const int r = i / dv, c = i - r * dv;
      float2 v = make_float2(0.f, 0.f);
      if (r < rows) v = __bfloat1622float2(__ldcs(reinterpret_cast<const __nv_bfloat162*>(s0) + i));
      float* d = dst + r * stride + col0 + 2 * c;
      d[0] = v.x, d[1] = v.y;
    }
  } else {
    for (int i = threadIdx.x; i < kTileRows * D; i += kTileThreads) {
      const int r = i / D, c = i - r * D;
      dst[r * stride + col0 + c] = r < rows ? __bfloat162float(s0[i]) : 0.f;
    }
  }
}

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

// Hopper's asynchronous global -> shared copies (cp.async): `bytes` (16 or
// 4) copied when `valid`, else zeros written (the source size 0; `src` must
// still be a valid address). A thread's copies complete in commit groups.
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid ? 4 : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's commit groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// stage_rows with asynchronous copies: the caller commits, waits and
// synchronises before it reads the rows.
__device__ __forceinline__ void stage_rows_async(float* dst, int stride, int col0,
                                                 const float* __restrict__ src, int D, int e0,
                                                 int E) {
  if (src == nullptr || D == 0) return;
  const int rows = min(kTileRows, E - e0);
  if ((D & 3) == 0 && (col0 & 3) == 0) {
    const int dv = D >> 2;
    const float* s0 = src + (size_t)e0 * D;
    for (int i = threadIdx.x; i < kTileRows * dv; i += kTileThreads) {
      const int r = i / dv, c = i - r * dv;
      cp_async<16>(dst + r * stride + col0 + 4 * c, r < rows ? s0 + 4 * i : src, r < rows);
    }
  } else {
    const float* s1 = src + (size_t)e0 * D;
    for (int i = threadIdx.x; i < kTileRows * D; i += kTileThreads) {
      const int r = i / D, c = i - r * D;
      cp_async<4>(dst + r * stride + col0 + c, r < rows ? s1 + i : src, r < rows);
    }
  }
}

// A bf16 stream's rows are staged synchronously (upcast on the way): the
// caller's commits and waits then cover no copy of them.
__device__ __forceinline__ void stage_rows_async(float* dst, int stride, int col0,
                                                 const bf16* __restrict__ src, int D, int e0,
                                                 int E) {
  stage_rows(dst, stride, col0, src, D, e0, E);
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
// The projection update's backward on a tile, phases 2 and 4 of the layer
// step's backward (layer_step_bwd_tile_kernel) and the whole per-edge work
// of the standalone update's (proj_update_bwd_tile_kernel). With du = d e /
// 4 of the tile's edges (32 rows, zero past De and past E), a = [en |
// skip2] (K = d_in + d2 columns) and W (De, K):
//
//   phase 2: [d en | d skip2] = du . W, written out;
//   phase 4: d W += du^T a and d b += the column sums of du, in registers
//            across all of a block's tiles.
//
// Phase 2 takes the first 16 ncg threads (ncg = ceil(K / 4)), each two
// edges and four columns; phase 4 the last 16 ncg, each two du features and
// four columns, so the two phases share the warps out.
// ---------------------------------------------------------------------------

struct UpdateBwdRoles {
  bool on2, on4;
  int rg2, k2;  // phase 2: edges 2 rg2, 2 rg2 + 1, columns k2 .. k2 + 3
  int j4, k4;   // phase 4: du features j4, j4 + 1, columns k4 .. k4 + 3
  __device__ __forceinline__ UpdateBwdRoles(int tid, int K) {
    const int ncg = (K + 3) >> 2;
    on2 = tid < 16 * ncg;
    rg2 = on2 ? tid / ncg : 0;
    k2 = 4 * (tid - rg2 * ncg);
    const int t4 = kTileThreads - 1 - tid;
    on4 = t4 < 16 * ncg;
    const int rg4 = on4 ? t4 / ncg : 0;
    j4 = 2 * rg4;
    k4 = 4 * (t4 - rg4 * ncg);
  }
};

// Phase 2 for the tile at e0: the sum over j < De in order; d en and d skip2
// stored as S (float, or bf16 rounded).
template <class S>
__device__ __forceinline__ void update_bwd_inputs(const float (*du)[kTileNarrow],
                                                  const float (*w)[kTileWide], int De, int d_in,
                                                  int d2, int rg2, int k2, int e0, int E,
                                                  S* __restrict__ den_out,
                                                  S* __restrict__ dskip2) {
  const int K = d_in + d2;
  float o[2][4] = {};
  const int ra = 2 * rg2;
  for (int j = 0; j < De; ++j) {
    const float a0 = du[ra][j], a1 = du[ra + 1][j];
    const float4 wj = *reinterpret_cast<const float4*>(&w[j][k2]);
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
      store_row4(den_out, d_in, e, k2, true, o[h]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = k2 + q;
        if (k < d_in) {
          stream_store(den_out + (size_t)e * d_in + k, o[h][q]);
        } else if (k < K) {
          stream_store(dskip2 + (size_t)e * d2 + (k - d_in), o[h][q]);
        }
      }
    }
  }
}

// Phase 4 for one tile: the sums over its 32 rows in order.
__device__ __forceinline__ void update_bwd_weights(const float (*du)[kTileNarrow],
                                                   const float (*a)[kTileWide], int j4, int k4,
                                                   float (&acc)[2][4], float (&bias)[2]) {
  for (int r = 0; r < kTileRows; ++r) {
    const float2 d = *reinterpret_cast<const float2*>(&du[r][j4]);
    const float4 av = *reinterpret_cast<const float4*>(&a[r][k4]);
    acc[0][0] = fmaf(d.x, av.x, acc[0][0]);
    acc[0][1] = fmaf(d.x, av.y, acc[0][1]);
    acc[0][2] = fmaf(d.x, av.z, acc[0][2]);
    acc[0][3] = fmaf(d.x, av.w, acc[0][3]);
    acc[1][0] = fmaf(d.y, av.x, acc[1][0]);
    acc[1][1] = fmaf(d.y, av.y, acc[1][1]);
    acc[1][2] = fmaf(d.y, av.z, acc[1][2]);
    acc[1][3] = fmaf(d.y, av.w, acc[1][3]);
    bias[0] += d.x;
    bias[1] += d.y;
  }
}

// Phase 4's sums to a block's partial row: d W (De, K) at dw, d b at db.
__device__ __forceinline__ void store_update_weight_grads(float* __restrict__ dw,
                                                          float* __restrict__ db, int De, int K,
                                                          int j4, int k4,
                                                          const float (&acc)[2][4],
                                                          const float (&bias)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = j4 + h;
    if (j >= De) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (k4 + q < K) dw[j * K + k4 + q] = acc[h][q];
    }
    if (k4 == 0) db[j] = bias[h];
  }
}

// ---------------------------------------------------------------------------
// The frontend's backward on a tile: phases 1 and 3 of the layer step's
// backward (layer_step_bwd_tile_kernel) and the whole per-edge work of the
// frontend's (frontend_bwd_tile_kernel). With x a tile's rows of the
// LayerNorm's input (De), v = relu(LN(x)) (v = x under raw) and the two
// source linears xl_p = v Wlp^T + blp, xl_c = v Wlc^T + blc:
//
//   phase 1: dv = [dxl_p | dxl_c] . [Wlp ; Wlc] (+ v's own cotangent), then
//            the LayerNorm + ReLU backward: d x, and v for phase 3;
//   phase 3: d Wlp += dxl_p^T v, d Wlc += dxl_c^T v, d blp and d blc the
//            column sums of dxl_p and dxl_c, in registers across all of a
//            block's tiles.
//
// Phase 1 takes thread (edge r1 = tid / 8, features c1 = 4 (tid % 8) .. c1 +
// 3), the LayerNorm's sums over the row's 8 lanes (row_sum32); d ln_scale
// and d ln_bias collect per thread, that is per edge slot of the tile, and
// merge in slot order at the end (store_ln_grads). Phase 3 takes thread (dx
// features i3 = 2 (tid / 8), i3 + 1; v features j3 = 4 (tid % 8) .. j3 + 3).
// Widths De, Dp, Dc <= 32.
// ---------------------------------------------------------------------------

// [Wlp ; Wlc] (Dp + Dc, De) into wf, zero-padded to 64 x 32, and the
// LayerNorm's scale and bias into g, b (not under raw). Every thread of the
// block calls it; the caller synchronises before reading.
__device__ __forceinline__ void load_linears_bwd_params(float (*wf)[32], float* g, float* b,
                                                        const float* __restrict__ wlp, int Dp,
                                                        const float* __restrict__ wlc, int Dc,
                                                        int De, const float* __restrict__ lng,
                                                        const float* __restrict__ lnb, int raw) {
  const int tid = threadIdx.x, KF = Dp + Dc;
  for (int i = tid; i < 64 * 32; i += kTileThreads) {
    const int r = i >> 5, c = i & 31;
    float x = 0.f;
    if (c < De && r < Dp) x = wlp[r * De + c];
    if (c < De && r >= Dp && r < KF) x = wlc[(r - Dp) * De + c];
    wf[r][c] = x;
  }
  if (!raw && tid < De) {
    g[tid] = lng[tid];
    b[tid] = lnb[tid];
  }
}

// Phase 1 for the edge whose staged [dxl_p | dxl_c] row (KF = Dp + Dc
// columns) is dxrow, at features c1 .. c1 + 3 of its input x: dv (in: v's
// own cotangent) += the product, the sum over k in order; then vo = v and
// de = d x + dext, both 0 past De, and this slot's d ln_scale, d ln_bias
// added into dg, db. The LayerNorm backward is the JAX kernel's: rstd *
// (dxhat - mean(dxhat) - xhat * mean(dxhat xhat)). Every lane of the warp
// calls it.
__device__ __forceinline__ void linears_ln_bwd4(const float* dxrow, const float (*wf)[32], int KF,
                                                const float* g, const float* b, int raw, int De,
                                                int c1, float inv, float eps,
                                                const float (&x)[4], const float (&dext)[4],
                                                float (&dv)[4], float (&dg)[4], float (&db)[4],
                                                float (&vo)[4], float (&de)[4]) {
  int k = 0;
  for (; k + 3 < KF; k += 4) {  // four k per 16-byte load of the edge's row
    const float4 d4 = *reinterpret_cast<const float4*>(dxrow + k);
    const float d[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 wk = *reinterpret_cast<const float4*>(&wf[k + u][c1]);
      dv[0] = fmaf(d[u], wk.x, dv[0]);
      dv[1] = fmaf(d[u], wk.y, dv[1]);
      dv[2] = fmaf(d[u], wk.z, dv[2]);
      dv[3] = fmaf(d[u], wk.w, dv[3]);
    }
  }
  for (; k < KF; ++k) {
    const float d = dxrow[k];
    const float4 wk = *reinterpret_cast<const float4*>(&wf[k][c1]);
    dv[0] = fmaf(d, wk.x, dv[0]);
    dv[1] = fmaf(d, wk.y, dv[1]);
    dv[2] = fmaf(d, wk.z, dv[2]);
    dv[3] = fmaf(d, wk.w, dv[3]);
  }
  if (raw) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      vo[q] = x[q];
      de[q] = dv[q] + dext[q];
    }
    return;
  }
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
    const float y = act ? xhat[q] * g[c] + b[c] : 0.f;
    vo[q] = fmaxf(y, 0.f);
    const float dy = (act && y > 0.f) ? dv[q] : 0.f;  // through the ReLU
    dg[q] = fmaf(dy, xhat[q], dg[q]);
    db[q] += dy;
    dxh[q] = act ? dy * g[c] : 0.f;
    dxx[q] = dxh[q] * xhat[q];
  }
  const float m1 = row_sum32(dxh) * inv;
  const float m2 = row_sum32(dxx) * inv;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    de[q] = (c1 + q < De ? rstd * (dxh[q] - m1 - xhat[q] * m2) : 0.f) + dext[q];
  }
}

// Phase 3 for one tile: the sums over its 32 rows in order (dx its staged
// [dxl_p | dxl_c] rows, v its rows of v, zero past De and past E).
__device__ __forceinline__ void linears_bwd_weights(const float (*dx)[kTileWide],
                                                    const float (*v)[kTileNarrow], int i3, int j3,
                                                    float (&acc)[2][4], float (&bias)[2]) {
  for (int r = 0; r < kTileRows; ++r) {
    const float2 d = *reinterpret_cast<const float2*>(&dx[r][i3]);
    const float4 vv = *reinterpret_cast<const float4*>(&v[r][j3]);
    acc[0][0] = fmaf(d.x, vv.x, acc[0][0]);
    acc[0][1] = fmaf(d.x, vv.y, acc[0][1]);
    acc[0][2] = fmaf(d.x, vv.z, acc[0][2]);
    acc[0][3] = fmaf(d.x, vv.w, acc[0][3]);
    acc[1][0] = fmaf(d.y, vv.x, acc[1][0]);
    acc[1][1] = fmaf(d.y, vv.y, acc[1][1]);
    acc[1][2] = fmaf(d.y, vv.z, acc[1][2]);
    acc[1][3] = fmaf(d.y, vv.w, acc[1][3]);
    bias[0] += d.x;
    bias[1] += d.y;
  }
}

// Phase 3's sums to a block's partial row, at the offsets of the row layout
// L (StepRow or FrontRow: d Wlp (Dp, De) at L.wlp, d blp, d Wlc (Dc, De), d
// blc).
template <class Row>
__device__ __forceinline__ void store_linears_weight_grads(float* __restrict__ row, const Row& L,
                                                           int Dp, int KF, int De, int i3, int j3,
                                                           const float (&acc)[2][4],
                                                           const float (&bias)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i3 + h;
    if (i >= KF) continue;
    const int base = i < Dp ? L.wlp + i * De : L.wlc + (i - Dp) * De;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (j3 + q < De) row[base + j3 + q] = acc[h][q];
    }
    if (j3 == 0) row[i < Dp ? L.blp + i : L.blc + (i - Dp)] = bias[h];
  }
}

// d ln_scale, d ln_bias: the 32 edge slots' sums (phase 1's dg, db of
// thread (r1, c1)), merged in slot order into row_g[c], row_bn[c] for c <
// De. red: 2048 floats of shared memory that no thread reads once all have
// arrived. Every thread of the block calls it.
__device__ __forceinline__ void store_ln_grads(float* red, float* __restrict__ row_g,
                                               float* __restrict__ row_bn, int De,
                                               const float (&dg)[4], const float (&db)[4]) {
  const int tid = threadIdx.x;
  __syncthreads();
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
    if (c < De) (which == 0 ? row_g : row_bn)[c] = t;
  }
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

// S: the streams' storage (en, skip2, e_l, the cotangents of en_next and
// e_l, and d en, d skip2, d res); d_el, the total cotangent that the tables'
// sums take, stays float32, and with bf16 streams its rounding goes to dres
// (NULL: not written).
template <class S>
__global__ void __launch_bounds__(kTileThreads, kTileBlocksPerSm) layer_step_bwd_tile_kernel(
    const S* __restrict__ en, int d_in, const S* __restrict__ skip2, int d2,
    const float* __restrict__ w, const S* __restrict__ e_l, int E, int De,
    const float* __restrict__ lng, const float* __restrict__ lnb, int raw, float eps,
    const float* __restrict__ wlp, int Dp, const float* __restrict__ wlc, int Dc,
    const float* __restrict__ dxl_p, const float* __restrict__ dxl_c,
    const S* __restrict__ den_next, const S* __restrict__ de_l_ext,
    float* __restrict__ d_el, S* __restrict__ den_out, S* __restrict__ dskip2,
    S* __restrict__ dres, float* __restrict__ partials) {
  __shared__ __align__(16) StepTileSmem s;
  const int tid = threadIdx.x;
  const int K = d_in + d2, KF = Dp + Dc;

  load_linears_bwd_params(s.wf, s.g, s.b, wlp, Dp, wlc, Dc, De, lng, lnb, raw);
  for (int i = tid; i < De * K; i += kTileThreads) {
    const int j = i / K;
    s.w[j][i - j * K] = w[i];
  }

  // Phase 1 (the LayerNorm and the product with [Wlp ; Wlc]): edge r1 of the
  // tile, features c1 .. c1 + 3.
  const int r1 = tid >> 3, c1 = 4 * (tid & 7);
  float dg[4] = {0.f, 0.f, 0.f, 0.f}, db[4] = {0.f, 0.f, 0.f, 0.f};
  // Phase 3 (d Wlp, d Wlc, their biases): dx features i3, i3 + 1, v
  // features j3 .. j3 + 3.
  const int i3 = 2 * (tid >> 3), j3 = 4 * (tid & 7);
  float acc3[2][4] = {}, bias3[2] = {0.f, 0.f};
  // Phases 2 and 4 (d en, d skip2; d W, d b): the update's backward.
  const UpdateBwdRoles ro(tid, K);
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
    float vo[4], de[4];
    linears_ln_bwd4(&s.dx[r1][0], s.wf, KF, s.g, s.b, raw, De, c1, inv, eps, x, dext, dv, dg, db,
                    vo, de);
    store_row4(d_el, De, e1, c1, valid, de);
    store_row4(dres, De, e1, c1, valid, de);
    *reinterpret_cast<float4*>(&s.v[r1][c1]) =
        valid ? make_float4(vo[0], vo[1], vo[2], vo[3]) : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(&s.du[r1][c1]) =
        valid ? make_float4(de[0] * 0.25f, de[1] * 0.25f, de[2] * 0.25f, de[3] * 0.25f)
              : make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();

    // ---- phase 2: [d en | d skip2] = du . W, written out
    if (ro.on2) {
      update_bwd_inputs(s.du, s.w, De, d_in, d2, ro.rg2, ro.k2, e0, E, den_out, dskip2);
    }
    // ---- phase 3: d Wlp / d Wlc += dx^T v, their biases
    if (i3 < KF && j3 < De) linears_bwd_weights(s.dx, s.v, i3, j3, acc3, bias3);
    // ---- phase 4: d W += du^T [en | skip2], d b
    if (ro.on4) update_bwd_weights(s.du, s.a, ro.j4, ro.k4, acc4, bias4);
  }

  // ---- this block's partial row
  const StepRow L(De, K, Dp, Dc);
  float* row = partials + (size_t)blockIdx.x * L.len;
  store_linears_weight_grads(row, L, Dp, KF, De, i3, j3, acc3, bias3);
  if (ro.on4) {
    store_update_weight_grads(row + L.w, row + L.b, De, K, ro.j4, ro.k4, acc4, bias4);
  }
  store_ln_grads(&s.dx[0][0], row + L.g, row + L.bn, De, dg, db);
}

// ---------------------------------------------------------------------------
// The frontend's backward tile kernels (#4): the LayerNorm + ReLU and the
// two source linears of a layer's frontend, backward, from the cotangents
// of xl_p, xl_c (the dual core's backward gives them) and of v itself (den,
// or none): d x written out, and one partial row per block (FrontRow) of
// d Wlp, d blp, d Wlc, d blc, d ln_scale, d ln_bias, which
// column_sum_kernel sums in block order. v is recomputed from x: the
// LayerNorm's statistics are needed for its backward anyway, and reading
// the forward's v would add E x De x 4 bytes.
//
// Two forms. The tile form (frontend_bwd_tile_kernel, any widths <= 32)
// runs phases 1 and 3 above on every tile: persistent blocks load [Wlp ;
// Wlc] once and take tiles tile = block, block + grid, ...; each tile's
// [dxl_p | dxl_c] rows are staged by cp.async into the buffer the previous
// tile did not use, and its x and den rows (one float4 per thread) loaded
// into registers, both a tile ahead. At the first layer's widths (De = 2,
// Dp = Dc = 4) that layout leaves 7 of a row's 8 threads without a feature
// and phase 3 on one warp in eight; the narrow form
// (frontend_bwd_narrow_kernel) gives each thread whole edge rows instead:
// a block's eight warps take spans of eight 32-edge tiles, span = block,
// block + grid, ..., lane r edge r of its warp's tile, each lane's
// gradients summed in registers over its edges, then over the lanes
// (group_sum's butterfly) and the warps in order.
//
// What bounds the tile form on the card is shared-memory traffic, not its
// bytes: phase 1 reads 5 floats from shared memory per 4 FMAs and phase 3
// 6 per 8, ~1.9 GB per call at De = Dp = Dc = 32 on the dense scene, 64 us
// at 128 bytes per clock and SM against 22 us for its device-memory bytes.
// ---------------------------------------------------------------------------

struct FrontBwdSmem {
  float dx[2][kTileRows][kTileWide];  // [dxl_p | dxl_c] of the tile (double-buffered)
  float v[kTileRows][kTileNarrow];    // v of the tile, zero past De and past E
  float wf[64][32];                   // [Wlp ; Wlc] (Dp + Dc, De), zero-padded to 32 columns
  float g[32], b[32];                 // the LayerNorm's scale and bias
};

// Offsets in the partial row: d Wlp (Dp, De), d blp, d Wlc (Dc, De), d blc,
// d ln_scale, d ln_bias; returns the row's length.
struct FrontRow {
  int wlp, blp, wlc, blc, g, bn, len;
  __host__ __device__ FrontRow(int De, int Dp, int Dc) {
    wlp = 0;
    blp = wlp + Dp * De;
    wlc = blp + Dp;
    blc = wlc + Dc * De;
    g = blc + Dc;
    bn = g + De;
    len = bn + De;
  }
};

// SE: the storage of e and d e; SN: of v's cotangent den (float, or bf16).
template <class SE, class SN>
__global__ void __launch_bounds__(kTileThreads, kTileBlocksPerSm) frontend_bwd_tile_kernel(
    const SE* __restrict__ e, const SN* __restrict__ den, int E, int De,
    const float* __restrict__ lng, const float* __restrict__ lnb, int raw, float eps,
    const float* __restrict__ wlp, int Dp, const float* __restrict__ wlc, int Dc,
    const float* __restrict__ dxl_p, const float* __restrict__ dxl_c, SE* __restrict__ de,
    float* __restrict__ partials) {
  __shared__ __align__(16) FrontBwdSmem s;
  const int tid = threadIdx.x;
  const int KF = Dp + Dc;
  load_linears_bwd_params(s.wf, s.g, s.b, wlp, Dp, wlc, Dc, De, lng, lnb, raw);
  const int r1 = tid >> 3, c1 = 4 * (tid & 7);  // phase 1
  const int i3 = 2 * (tid >> 3), j3 = 4 * (tid & 7);  // phase 3
  float dg[4] = {0.f, 0.f, 0.f, 0.f}, db[4] = {0.f, 0.f, 0.f, 0.f};
  float acc[2][4] = {}, bias[2] = {0.f, 0.f};
  const float none[4] = {0.f, 0.f, 0.f, 0.f};
  const float inv = 1.f / (float)De;
  const int stride = gridDim.x * kTileRows;

  float x[4], dv[4], xn[4] = {0.f, 0.f, 0.f, 0.f}, dvn[4] = {0.f, 0.f, 0.f, 0.f};
  int e0 = blockIdx.x * kTileRows;
  if (e0 < E) {
    load_row4(e, De, e0 + r1, c1, e0 + r1 < E, x);
    load_row4(den, De, e0 + r1, c1, e0 + r1 < E, dv);
    stage_rows_async(&s.dx[0][0][0], kTileWide, 0, dxl_p, Dp, e0, E);
    stage_rows_async(&s.dx[0][0][0], kTileWide, Dp, dxl_c, Dc, e0, E);
    cp_async_commit();
  }
  for (int it = 0; e0 < E; e0 += stride, ++it) {
    const int buf = it & 1;
    cp_async_wait<0>();  // this thread's copies of this tile have landed
    __syncthreads();     // everyone's (and the weights); the previous tile's phase 3 is done
    const int f0 = e0 + stride;
    if (f0 < E) {  // the next tile, into the buffer the previous one used
      load_row4(e, De, f0 + r1, c1, f0 + r1 < E, xn);
      load_row4(den, De, f0 + r1, c1, f0 + r1 < E, dvn);
      stage_rows_async(&s.dx[buf ^ 1][0][0], kTileWide, 0, dxl_p, Dp, f0, E);
      stage_rows_async(&s.dx[buf ^ 1][0][0], kTileWide, Dp, dxl_c, Dc, f0, E);
    }
    cp_async_commit();

    // ---- phase 1: dv, the LayerNorm + ReLU backward, d x
    const int e1 = e0 + r1;
    const bool valid = e1 < E;
    float vo[4], dx[4];
    linears_ln_bwd4(&s.dx[buf][r1][0], s.wf, KF, s.g, s.b, raw, De, c1, inv, eps, x, none, dv, dg,
                    db, vo, dx);
    store_row4(de, De, e1, c1, valid, dx);
    *reinterpret_cast<float4*>(&s.v[r1][c1]) =
        valid ? make_float4(vo[0], vo[1], vo[2], vo[3]) : make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();

    // ---- phase 3: d Wlp / d Wlc += dx^T v, their biases
    if (i3 < KF && j3 < De) linears_bwd_weights(s.dx[buf], s.v, i3, j3, acc, bias);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      x[q] = xn[q];
      dv[q] = dvn[q];
    }
  }
  cp_async_wait<0>();

  const FrontRow L(De, Dp, Dc);
  float* row = partials + (size_t)blockIdx.x * L.len;
  store_linears_weight_grads(row, L, Dp, KF, De, i3, j3, acc, bias);
  store_ln_grads(&s.dx[0][0][0], row + L.g, row + L.bn, De, dg, db);
}

// The narrow forms' widths (#4's here, #3's below): De <= kFrontNarrowDe,
// Dp, Dc <= kFrontNarrowDq.
constexpr int kFrontNarrowDe = 2;
constexpr int kFrontNarrowDq = 4;

// Row e of the (E, D) stream src (D <= N) into v, 0 past D or for src ==
// NULL: one 16- or 8-byte load where D is 4 or 2 (the caller keeps the
// stream 16-byte aligned).
template <int N>
__device__ __forceinline__ void load_row_n(const float* __restrict__ src, int D, int e,
                                           float (&v)[N]) {
#pragma unroll
  for (int q = 0; q < N; ++q) v[q] = 0.f;
  if (src == nullptr) return;
  const float* p = src + (size_t)e * D;
  if constexpr (N >= 4) {
    if (D == 4) {
      const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
      v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
      return;
    }
  }
  if (N >= 2 && D == 2) {
    const float2 t = __ldcs(reinterpret_cast<const float2*>(p));
    v[0] = t.x, v[1] = t.y;
    return;
  }
#pragma unroll
  for (int q = 0; q < N; ++q) {
    if (q < D) v[q] = __ldcs(p + q);
  }
}

template <int N>
__device__ __forceinline__ void store_row_n(float* __restrict__ dst, int D, int e,
                                            const float (&v)[N]) {
  if (dst == nullptr) return;
  float* p = dst + (size_t)e * D;
  if constexpr (N >= 4) {
    if (D == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
      return;
    }
  }
  if (N >= 2 && D == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    return;
  }
#pragma unroll
  for (int q = 0; q < N; ++q) {
    if (q < D) p[q] = v[q];
  }
}

// load_row_n / store_row_n of a bf16 stream: one 8-byte access where D is 4,
// 4-byte where D is 2 (a 2-wide bf16 row is 4 bytes: no 16- or 8-byte form).
template <int N>
__device__ __forceinline__ void load_row_n(const bf16* __restrict__ src, int D, int e,
                                           float (&v)[N]) {
#pragma unroll
  for (int q = 0; q < N; ++q) v[q] = 0.f;
  if (src == nullptr) return;
  const bf16* p = src + (size_t)e * D;
  if constexpr (N >= 4) {
    if (D == 4) {
      float t[4];
      bf16x4_to_f32(__ldcs(reinterpret_cast<const uint2*>(p)), t);
      v[0] = t[0], v[1] = t[1], v[2] = t[2], v[3] = t[3];
      return;
    }
  }
  if (N >= 2 && D == 2) {
    const float2 t = __bfloat1622float2(__ldcs(reinterpret_cast<const __nv_bfloat162*>(p)));
    v[0] = t.x, v[1] = t.y;
    return;
  }
#pragma unroll
  for (int q = 0; q < N; ++q) {
    if (q < D) v[q] = __bfloat162float(p[q]);
  }
}

template <int N>
__device__ __forceinline__ void store_row_n(bf16* __restrict__ dst, int D, int e,
                                            const float (&v)[N]) {
  if (dst == nullptr) return;
  bf16* p = dst + (size_t)e * D;
  if constexpr (N >= 4) {
    if (D == 4) {
      *reinterpret_cast<uint2*>(p) = f32_to_bf16x4(v[0], v[1], v[2], v[3]);
      return;
    }
  }
  if (N >= 2 && D == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
    return;
  }
#pragma unroll
  for (int q = 0; q < N; ++q) {
    if (q < D) p[q] = __float2bfloat16_rn(v[q]);
  }
}

template <int DE, int DQ, class SE, class SN>
__global__ void __launch_bounds__(kTileThreads, kTileBlocksPerSm) frontend_bwd_narrow_kernel(
    const SE* __restrict__ e, const SN* __restrict__ den, int E, int De,
    const float* __restrict__ lng, const float* __restrict__ lnb, int raw, float eps,
    const float* __restrict__ wlp, int Dp, const float* __restrict__ wlc, int Dc,
    const float* __restrict__ dxl_p, const float* __restrict__ dxl_c, SE* __restrict__ de,
    float* __restrict__ partials) {
  constexpr int NW = kTileThreads / 32;
  // a lane's sums: d Wlp (DQ x DE), d blp, d Wlc, d blc, d ln_scale, d ln_bias
  constexpr int A_BP = DQ * DE, A_WC = A_BP + DQ, A_BC = A_WC + DQ * DE, A_G = A_BC + DQ,
                A_B = A_G + DE, NA = A_B + DE;
  __shared__ float red[NW][NA];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float wp[DQ][DE], wc[DQ][DE], g[DE], b[DE], acc[NA];
#pragma unroll
  for (int i = 0; i < DQ; ++i) {
#pragma unroll
    for (int j = 0; j < DE; ++j) {
      wp[i][j] = (i < Dp && j < De) ? __ldg(wlp + i * De + j) : 0.f;
      wc[i][j] = (i < Dc && j < De) ? __ldg(wlc + i * De + j) : 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < DE; ++j) {
    g[j] = (!raw && j < De) ? __ldg(lng + j) : 0.f;
    b[j] = (!raw && j < De) ? __ldg(lnb + j) : 0.f;
  }
#pragma unroll
  for (int a = 0; a < NA; ++a) acc[a] = 0.f;
  const float inv = 1.f / (float)De;

  for (int span = blockIdx.x; span * NW * kTileRows < E; span += gridDim.x) {
    const int edge = (span * NW + warp) * kTileRows + lane;
    if (edge >= E) continue;
    float x[DE], dv[DE], dp[DQ], dc[DQ];
    load_row_n(e, De, edge, x);
    load_row_n(den, De, edge, dv);
    load_row_n(dxl_p, Dp, edge, dp);
    load_row_n(dxl_c, Dc, edge, dc);
    // dv += [dxl_p | dxl_c] . [Wlp ; Wlc], the sum over k in order
#pragma unroll
    for (int i = 0; i < DQ; ++i) {
#pragma unroll
      for (int j = 0; j < DE; ++j) dv[j] = fmaf(dp[i], wp[i][j], dv[j]);
    }
#pragma unroll
    for (int i = 0; i < DQ; ++i) {
#pragma unroll
      for (int j = 0; j < DE; ++j) dv[j] = fmaf(dc[i], wc[i][j], dv[j]);
    }
    float v[DE], dx[DE];
    if (raw) {
#pragma unroll
      for (int j = 0; j < DE; ++j) {
        v[j] = x[j];
        dx[j] = dv[j];
      }
    } else {
      // var = E[x^2] - mean^2 rounded as the flax form writes it, each square
      // and mean^2 rounded before the sums (no fused multiply-adds): at De =
      // 2 it is a difference of near-equal terms, and a fused rounding there
      // moves d e by up to 3.5e-4 against the plain version on the bench
      // scenes' first layer (measured), against the check's 1e-4.
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int j = 0; j < DE; ++j) {
        s1 = __fadd_rn(s1, x[j]);
        s2 = __fadd_rn(s2, __fmul_rn(x[j], x[j]));
      }
      const float mean = s1 * inv;
      const float var = __fsub_rn(__fmul_rn(s2, inv), __fmul_rn(mean, mean));
      const float rstd = rsqrtf(var + eps);
      float xhat[DE], dxh[DE], m1 = 0.f, m2 = 0.f;
#pragma unroll
      for (int j = 0; j < DE; ++j) {
        const bool act = j < De;
        xhat[j] = act ? (x[j] - mean) * rstd : 0.f;
        const float y = act ? xhat[j] * g[j] + b[j] : 0.f;
        v[j] = fmaxf(y, 0.f);
        const float dy = (act && y > 0.f) ? dv[j] : 0.f;  // through the ReLU
        acc[A_G + j] = fmaf(dy, xhat[j], acc[A_G + j]);
        acc[A_B + j] += dy;
        dxh[j] = act ? dy * g[j] : 0.f;
        m1 = __fadd_rn(m1, dxh[j]);
        m2 = __fadd_rn(m2, __fmul_rn(dxh[j], xhat[j]));
      }
      m1 *= inv;
      m2 *= inv;
#pragma unroll
      for (int j = 0; j < DE; ++j) dx[j] = j < De ? rstd * (dxh[j] - m1 - xhat[j] * m2) : 0.f;
    }
    store_row_n(de, De, edge, dx);
#pragma unroll
    for (int i = 0; i < DQ; ++i) {
#pragma unroll
      for (int j = 0; j < DE; ++j) {
        acc[i * DE + j] = fmaf(dp[i], v[j], acc[i * DE + j]);
        acc[A_WC + i * DE + j] = fmaf(dc[i], v[j], acc[A_WC + i * DE + j]);
      }
      acc[A_BP + i] += dp[i];
      acc[A_BC + i] += dc[i];
    }
  }

  // ---- this block's partial row: each sum over the lanes, then the warps
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    const float t = group_sum(acc[a], 32);
    if (lane == 0) red[warp][a] = t;
  }
  __syncthreads();
  const FrontRow L(De, Dp, Dc);
  float* row = partials + (size_t)blockIdx.x * L.len;
  for (int a = threadIdx.x; a < NA; a += kTileThreads) {
    float t = 0.f;
    for (int w = 0; w < NW; ++w) t += red[w][a];
    int dst = -1;
    if (a < A_BP) {
      const int i = a / DE, j = a % DE;
      if (i < Dp && j < De) dst = L.wlp + i * De + j;
    } else if (a < A_WC) {
      if (a - A_BP < Dp) dst = L.blp + (a - A_BP);
    } else if (a < A_BC) {
      const int i = (a - A_WC) / DE, j = (a - A_WC) % DE;
      if (i < Dc && j < De) dst = L.wlc + i * De + j;
    } else if (a < A_G) {
      if (a - A_BC < Dc) dst = L.blc + (a - A_BC);
    } else if (a < A_B) {
      if (a - A_G < De) dst = L.g + (a - A_G);
    } else if (a - A_B < De) {
      dst = L.bn + (a - A_B);
    }
    if (dst >= 0) row[dst] = t;
  }
}


// ---------------------------------------------------------------------------
// The standalone projection update's backward tile kernel (#10): from the
// cotangent g of e = ([en | skip2] W^T + ...) / 4 (+ res), du = g / 4 and
// phases 2 and 4 above on every tile. Persistent blocks load W once and
// take tiles tile = block, block + grid, ...; each tile's [en | skip2] rows
// are staged by cp.async into the buffer the previous tile did not use, and
// its g rows (one float4 per thread) loaded into registers, both a tile
// ahead. Each block writes one partial row, d W (De, K) then d b (De):
// column_sum_kernel sums the rows in block order. d ps and d pv are the
// caller's (the segment sums of g at scale 1/4). Widths: De, d_in, d2 <=
// 32, K = d_in + d2 <= 64.
// ---------------------------------------------------------------------------

struct UpdateBwdSmem {
  float a[2][kTileRows][kTileWide];  // [en | skip2] (double-buffered)
  float du[kTileRows][kTileNarrow];  // g / 4, zero past De and past E
  float w[32][kTileWide];            // W (De, K)
};

// S: the streams' storage (g, en, skip2, d en, d skip2). g32 (NULL: not
// written): g as float32, for the tables' sums of a bf16 g.
template <class S>
__global__ void __launch_bounds__(kTileThreads, kTileBlocksPerSm) proj_update_bwd_tile_kernel(
    const S* __restrict__ g, const S* __restrict__ en, int d_in, const S* __restrict__ skip2,
    int d2, const float* __restrict__ w, int E, int De, S* __restrict__ den_out,
    S* __restrict__ dskip2, float* __restrict__ g32, float* __restrict__ partials) {
  __shared__ __align__(16) UpdateBwdSmem s;
  const int tid = threadIdx.x;
  const int K = d_in + d2;
  for (int i = tid; i < De * K; i += kTileThreads) {
    const int j = i / K;
    s.w[j][i - j * K] = w[i];
  }
  const UpdateBwdRoles ro(tid, K);
  const int r1 = tid >> 3, c1 = 4 * (tid & 7);  // this thread's g: edge r1, features c1 ..
  float acc[2][4] = {}, bias[2] = {0.f, 0.f};
  const int stride = gridDim.x * kTileRows;

  float cur[4], nxt[4] = {0.f, 0.f, 0.f, 0.f};
  int e0 = blockIdx.x * kTileRows;
  if (e0 < E) {
    load_row4(g, De, e0 + r1, c1, e0 + r1 < E, cur);
    stage_rows_async(&s.a[0][0][0], kTileWide, 0, en, d_in, e0, E);
    stage_rows_async(&s.a[0][0][0], kTileWide, d_in, skip2, d2, e0, E);
    cp_async_commit();
  }
  for (int it = 0; e0 < E; e0 += stride, ++it) {
    const int buf = it & 1;
    __syncthreads();  // the previous tile's phases are done with du and a[buf ^ 1]
    const int f0 = e0 + stride;
    if (f0 < E) {
      load_row4(g, De, f0 + r1, c1, f0 + r1 < E, nxt);
      stage_rows_async(&s.a[buf ^ 1][0][0], kTileWide, 0, en, d_in, f0, E);
      stage_rows_async(&s.a[buf ^ 1][0][0], kTileWide, d_in, skip2, d2, f0, E);
    }
    cp_async_commit();
    store_row4(g32, De, e0 + r1, c1, e0 + r1 < E, cur);
    *reinterpret_cast<float4*>(&s.du[r1][c1]) =
        make_float4(cur[0] * 0.25f, cur[1] * 0.25f, cur[2] * 0.25f, cur[3] * 0.25f);
    cp_async_wait<1>();  // this thread's copies of this tile have landed
    __syncthreads();     // everyone's, and du (and the weights)
    if (ro.on2) {
      update_bwd_inputs(s.du, s.w, De, d_in, d2, ro.rg2, ro.k2, e0, E, den_out, dskip2);
    }
    if (ro.on4) update_bwd_weights(s.du, s.a[buf], ro.j4, ro.k4, acc, bias);
#pragma unroll
    for (int q = 0; q < 4; ++q) cur[q] = nxt[q];
  }
  cp_async_wait<0>();
  float* row = partials + (size_t)blockIdx.x * (De * K + De);
  if (ro.on4) store_update_weight_grads(row, row + De * K, De, K, ro.j4, ro.k4, acc, bias);
}


// ---------------------------------------------------------------------------
// The layer step's forward tile kernel (#5). Per edge, with a = [en | skip2]
// (K = d_in + d2 columns) and c0 = b + pg:
//
//   phase A: e_l = (a W^T + c0 + ps[pt] + pv[cam]) / 4  (+ res)
//   phase B: v = relu(LN(e_l)), flax form (var = E[x^2] - mean^2); v = e_l
//            under raw
//   phase C: [xl_p | xl_c] = v [Wlp ; Wlc]^T + [blp | blc]
//
// Phases A and B: thread (edge r1, features c1 .. c1 + 3), the LayerNorm's
// sums by row_sum32 over the row's 8 lanes. Phase C: thread (edges ra, ra +
// 1, outputs 4 og .. 4 og + 3 of the 64-wide [xl_p | xl_c], each side
// zero-padded to 32). Each phase's products are its own device code: the
// standalone projection update's forward (#9, proj_update_fwd_tile_kernel)
// is phase A alone, the frontend's forward (#3, frontend_fwd_tile_kernel)
// phases B and C. Widths: d_in, d2, De, Dp, Dc <= 32, K <= 64.
//
// The tiles are double-buffered: while tile t computes, tile t + grid's [en
// | skip2] rows are in flight into the other buffer (cp.async) and its res
// and gathered table rows into registers, from indices loaded one tile
// earlier still (on the H100 ~10% faster than loading each tile when it
// starts).
// ---------------------------------------------------------------------------

constexpr int kStepFwdBlocksPerSm = 3;  // persistent blocks per SM

struct StepFwdSmem {
  float a[2][kTileRows][kTileWide];  // [en | skip2] of the tile, zero past K (double-buffered)
  float v[kTileRows][kTileNarrow];   // v of the tile, zero past De
  float wt[64][32];                  // W^T (K, De), zero-padded
  float wf[32][64];                  // [Wlp ; Wlc]^T: column o < 32 feeds xl_p, o >= 32 xl_c
  float bf[64];                      // [blp | blc], zero-padded likewise
  float c0[32], g[32], b[32];        // b + pg; the LayerNorm's scale and bias
};

// The rows of one edge that phase A reads outside the staged tile: its
// gathered table rows and its residual (features c1 .. c1 + 3).
struct StepEdgeRows {
  float ps[4], pv[4], res[4];
};

// Features c0 .. c0 + 3 of row `row` of a (rows, D) table, read through the
// cache (a table's rows repeat across edges), 0 past D or for !valid.
__device__ __forceinline__ void gather_row4(const float* __restrict__ src, int D, int row,
                                            int c0, bool valid, float (&v)[4]) {
  v[0] = v[1] = v[2] = v[3] = 0.f;
  if (!valid || c0 >= D) return;
  const float* p = src + (size_t)row * D + c0;
  if ((D & 3) == 0) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (c0 + q < D) v[q] = __ldg(p + q);
    }
  }
}

template <class S>
__device__ __forceinline__ void load_step_rows(StepEdgeRows& r, const float* __restrict__ ps,
                                               const float* __restrict__ pv,
                                               const S* __restrict__ res, int De, int e,
                                               int p, int c, int c1, bool valid) {
  gather_row4(ps, De, p, c1, valid, r.ps);
  gather_row4(pv, De, c, c1, valid, r.pv);
  load_row4(res, De, e, c1, valid, r.res);
}

// W^T (K, De) into wt, zero-padded to 64 x 32, and c0 = b + pg (zero past
// De). Consecutive threads store consecutive words (no bank conflicts); the
// transposing reads come from L2. Every thread of the block calls it; the
// caller synchronises before reading.
__device__ __forceinline__ void load_update_fwd_params(float (*wt)[32], float* c0,
                                                       const float* __restrict__ w,
                                                       const float* __restrict__ b,
                                                       const float* __restrict__ pg, int K,
                                                       int De) {
  const int tid = threadIdx.x;
  for (int i = tid; i < 64 * 32; i += kTileThreads) {
    const int k = i >> 5, j = i & 31;
    wt[k][j] = (k < K && j < De) ? w[j * K + k] : 0.f;
  }
  if (tid < 32) c0[tid] = tid < De ? b[tid] + pg[tid] : 0.f;
}

// Phases B and C's parameters: [Wlp ; Wlc]^T (De, 64) into wf (column o < 32
// feeds xl_p, o >= 32 xl_c, zero past De rows and past Dp / Dc columns),
// [blp | blc] into bf, the LayerNorm's scale and bias into g and b (zeros
// under raw). Every thread of the block calls it; the caller synchronises
// before reading.
__device__ __forceinline__ void load_front_fwd_params(
    float (*wf)[64], float* bf, float* g, float* b, const float* __restrict__ wlp,
    const float* __restrict__ blp, int Dp, const float* __restrict__ wlc,
    const float* __restrict__ blc, int Dc, int De, const float* __restrict__ lng,
    const float* __restrict__ lnb, int raw) {
  const int tid = threadIdx.x;
  for (int i = tid; i < 32 * 64; i += kTileThreads) {
    const int k = i >> 6, o = i & 63;
    float x = 0.f;
    if (k < De && o < Dp) x = wlp[o * De + k];
    if (k < De && o >= 32 && o - 32 < Dc) x = wlc[(o - 32) * De + k];
    wf[k][o] = x;
  }
  if (tid < 64) {
    bf[tid] = tid < 32 ? (tid < Dp ? blp[tid] : 0.f) : (tid - 32 < Dc ? blc[tid - 32] : 0.f);
  }
  if (tid < 32) {
    g[tid] = (!raw && tid < De) ? lng[tid] : 0.f;
    b[tid] = (!raw && tid < De) ? lnb[tid] : 0.f;
  }
}

// Zeros in the columns past K of both buffers of staged [en | skip2] rows
// (never staged; step_update4 reads them up to K rounded up to 4).
template <int ROWS>
__device__ __forceinline__ void zero_tile_pad(float (*a)[ROWS][kTileWide], int K) {
  for (int i = threadIdx.x; i < 2 * ROWS * kTileWide; i += kTileThreads) {
    if (i % kTileWide >= K) (&a[0][0][0])[i] = 0.f;
  }
}

// Phase A for R edges whose staged rows start at arow, astride floats apart
// (KP = K rounded up to 4, each staged row zero past K), with W^T in wt and
// c0 = b + pg: features c1 .. c1 + 3 of each edge's e_l, 0 past De, from
// the sum gs = ps[pt] + pv[cam] of its gathered rows and its residual res.
// Per edge the sum over k runs in order, then c0, then gs, as the per-edge
// kernels' did; the R edges share each load of W^T.
template <int R>
__device__ __forceinline__ void step_update4(const float (*wt)[32], const float* c0,
                                             const float* arow, int astride, int KP, int De,
                                             int c1, const float (*gs)[4],
                                             const float (*res)[4], float (*x)[4]) {
  float acc[R][4] = {};
  for (int k = 0; k < KP; k += 4) {
    float av[R][4];
#pragma unroll
    for (int h = 0; h < R; ++h) {
      const float4 a4 = *reinterpret_cast<const float4*>(arow + h * astride + k);
      av[h][0] = a4.x, av[h][1] = a4.y, av[h][2] = a4.z, av[h][3] = a4.w;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 wk = *reinterpret_cast<const float4*>(&wt[k + u][c1]);
#pragma unroll
      for (int h = 0; h < R; ++h) {
        acc[h][0] = fmaf(av[h][u], wk.x, acc[h][0]);
        acc[h][1] = fmaf(av[h][u], wk.y, acc[h][1]);
        acc[h][2] = fmaf(av[h][u], wk.z, acc[h][2]);
        acc[h][3] = fmaf(av[h][u], wk.w, acc[h][3]);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < R; ++h) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c1 + q;
      x[h][q] = c < De ? ((acc[h][q] + c0[c]) + gs[h][q]) * 0.25f + res[h][q] : 0.f;
    }
  }
}

// Phase B: v = relu(LN(x)) over the De features of a row held 4 per lane by
// 8 lanes (0 past De), with the LayerNorm's scale g and bias b (shared
// memory). Every lane of the warp calls it.
__device__ __forceinline__ void step_norm4(const float* g, const float* b, const float (&x)[4],
                                           int De, int c1, float inv, float eps, float (&v)[4]) {
  float sq[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) sq[q] = x[q] * x[q];
  const float mean = row_sum32(x) * inv;
  const float var = row_sum32(sq) * inv - mean * mean;
  const float rstd = rsqrtf(var + eps);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = c1 + q;
    v[q] = c < De ? fmaxf((x[q] - mean) * rstd * g[c] + b[c], 0.f) : 0.f;
  }
}

// Phase C: outputs 4 og .. 4 og + 3 of [xl_p | xl_c] for edges ra, ra + 1 of
// the tile v (DP = De rounded up to 4; v zero past De), with [Wlp ; Wlc]^T in
// wf and [blp | blc] in bf (shared memory, load_front_fwd_params). The sum
// over k runs in order, then the bias, as the per-edge kernels' did.
__device__ __forceinline__ void step_linears4(const float (*v)[kTileNarrow],
                                              const float (*wf)[64], const float* bf, int ra,
                                              int og, int DP, float (&o)[2][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int q = 0; q < 4; ++q) o[h][q] = 0.f;
  }
  for (int k = 0; k < DP; k += 4) {
    const float4 v0 = *reinterpret_cast<const float4*>(&v[ra][k]);
    const float4 v1 = *reinterpret_cast<const float4*>(&v[ra + 1][k]);
    const float a0[4] = {v0.x, v0.y, v0.z, v0.w}, a1[4] = {v1.x, v1.y, v1.z, v1.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 wk = *reinterpret_cast<const float4*>(&wf[k + u][4 * og]);
      o[0][0] = fmaf(a0[u], wk.x, o[0][0]);
      o[0][1] = fmaf(a0[u], wk.y, o[0][1]);
      o[0][2] = fmaf(a0[u], wk.z, o[0][2]);
      o[0][3] = fmaf(a0[u], wk.w, o[0][3]);
      o[1][0] = fmaf(a1[u], wk.x, o[1][0]);
      o[1][1] = fmaf(a1[u], wk.y, o[1][1]);
      o[1][2] = fmaf(a1[u], wk.z, o[1][2]);
      o[1][3] = fmaf(a1[u], wk.w, o[1][3]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int q = 0; q < 4; ++q) o[h][q] += bf[4 * og + q];
  }
}

// S: the streams' storage (en, skip2, res, e_l, en_next); xl_p, xl_c float32.
// e_l and en_next are rounded as stored: the LayerNorm and the linears take
// them in float32.
template <class S>
__global__ void __launch_bounds__(kTileThreads, kStepFwdBlocksPerSm) layer_step_fwd_tile_kernel(
    const S* __restrict__ en, int d_in, const S* __restrict__ skip2, int d2,
    const S* __restrict__ res, const float* __restrict__ w, const float* __restrict__ b,
    const float* __restrict__ pg, const float* __restrict__ ps, const float* __restrict__ pv,
    const int* __restrict__ pt_idx, const int* __restrict__ cam_idx, int E, int De,
    const float* __restrict__ lng, const float* __restrict__ lnb, int raw, float eps,
    const float* __restrict__ wlp, const float* __restrict__ blp, int Dp,
    const float* __restrict__ wlc, const float* __restrict__ blc, int Dc,
    S* __restrict__ e_l, S* __restrict__ en_next, float* __restrict__ xl_p,
    float* __restrict__ xl_c) {
  __shared__ __align__(16) StepFwdSmem s;
  const int tid = threadIdx.x;
  const int K = d_in + d2, KP = (K + 3) & ~3, DP = (De + 3) & ~3;

  // The weights, once per block. Consecutive threads store consecutive
  // words (no bank conflicts); the transposing reads come from L2.
  load_update_fwd_params(s.wt, s.c0, w, b, pg, K, De);
  load_front_fwd_params(s.wf, s.bf, s.g, s.b, wlp, blp, Dp, wlc, blc, Dc, De, lng, lnb, raw);
  zero_tile_pad(s.a, K);

  const int r1 = tid >> 3, c1 = 4 * (tid & 7);   // phases A and B
  const int og = tid & 15, ra = 2 * (tid >> 4);  // phase C
  float* const out_c = og < 8 ? xl_p : xl_c;
  const int Dout = og < 8 ? Dp : Dc, col = 4 * (og & 7);
  const float inv = 1.f / (float)De;
  const int stride = gridDim.x * kTileRows;

  StepEdgeRows cur, nxt;
  int np = 0, nc = 0;  // the next tile's indices, loaded a tile ahead
  int e0 = blockIdx.x * kTileRows;
  if (e0 < E) {
    const int e = e0 + r1;
    const bool valid = e < E;
    load_step_rows(cur, ps, pv, res, De, e, valid ? pt_idx[e] : 0, valid ? cam_idx[e] : 0, c1,
                   valid);
    stage_rows_async(&s.a[0][0][0], kTileWide, 0, en, d_in, e0, E);
    stage_rows_async(&s.a[0][0][0], kTileWide, d_in, skip2, d2, e0, E);
    cp_async_commit();
    const int e2 = e0 + stride + r1;
    if (e2 < E) {
      np = pt_idx[e2];
      nc = cam_idx[e2];
    }
  }
  for (int it = 0; e0 < E; e0 += stride, ++it) {
    const int e1 = e0 + r1;
    const bool valid = e1 < E;
    const int buf = it & 1;
    // The other buffer was last read in the previous tile's phase A, which a
    // barrier since has closed.
    const int f0 = e0 + stride;
    if (f0 < E) {
      const int f = f0 + r1;
      load_step_rows(nxt, ps, pv, res, De, f, np, nc, c1, f < E);
      stage_rows_async(&s.a[buf ^ 1][0][0], kTileWide, 0, en, d_in, f0, E);
      stage_rows_async(&s.a[buf ^ 1][0][0], kTileWide, d_in, skip2, d2, f0, E);
      const int f2 = f + stride;
      np = f2 < E ? pt_idx[f2] : 0;
      nc = f2 < E ? cam_idx[f2] : 0;
    }
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of this tile have landed
    __syncthreads();     // everyone's (and the weights); the previous tile's phase C is done

    // ---- phases A and B: e_l, v
    float x[1][4], v[4];
    const float gs[1][4] = {{cur.ps[0] + cur.pv[0], cur.ps[1] + cur.pv[1], cur.ps[2] + cur.pv[2],
                             cur.ps[3] + cur.pv[3]}};
    step_update4<1>(s.wt, s.c0, &s.a[buf][r1][0], kTileWide, KP, De, c1, gs, &cur.res, x);
    store_row4(e_l, De, e1, c1, valid, x[0]);
    if (raw) {
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = x[0][q];
    } else {
      step_norm4(s.g, s.b, x[0], De, c1, inv, eps, v);
      store_row4(en_next, De, e1, c1, valid, v);
    }
    *reinterpret_cast<float4*>(&s.v[r1][c1]) = make_float4(v[0], v[1], v[2], v[3]);
    __syncthreads();

    // ---- phase C: xl_p, xl_c, stored through L2, where the dual core,
    // launched next, finds them (streaming stores cost it ~5%)
    float o[2][4];
    step_linears4(s.v, s.wf, s.bf, ra, og, DP, o);
    store_row4(out_c, Dout, e0 + ra, col, e0 + ra < E, o[0]);
    store_row4(out_c, Dout, e0 + ra + 1, col, e0 + ra + 1 < E, o[1]);
    cur = nxt;
  }
  cp_async_wait<0>();
}


// ---------------------------------------------------------------------------
// The frontend's forward (#3): the LayerNorm + ReLU of a layer's edge
// stream e (E, De), flax form, or e itself under raw, then both GATv2 source
// linears: writes en = relu(LN(e)) (not under raw), xl_p = en Wlp^T + blp
// and xl_c = en Wlc^T + blc; the dual core (#1) runs next. Per edge it moves
// 4 (2 De + Dp + Dc) bytes against ~2 De (Dp + Dc) FMAs: bytes bound it (48
// bytes per edge at the first layer's De = 2, Dp = Dc = 4; 512 at De = Dp =
// Dc = 32). Its first design gave each edge a warp, lane j feature j: at
// the first layer 30 of 32 lanes idle, two 32-lane butterflies and eight
// shuffled FMAs per edge. Two forms, chosen by width as #4's are:
//
// - the tile form (frontend_fwd_tile_kernel, any widths <= 32): phases B
//   and C of the layer step's forward (step_norm4, step_linears4) on
//   32-edge tiles; persistent blocks load [Wlp ; Wlc]^T once and take the
//   tiles tile = block, block + grid, ..., each tile's e rows staged by
//   cp.async into the buffer the previous tile did not use, a tile ahead;
// - the narrow form (frontend_fwd_narrow_kernel, De <= kFrontNarrowDe and
//   Dp, Dc <= kFrontNarrowDq: the first layer): a lane per edge, the 28
//   parameters in registers, e read with one 8-byte load, en written with
//   one 8-byte store and xl_p, xl_c with one 16-byte store each (a warp's
//   rows contiguous). Nothing is summed across edges, so its blocks are not
//   persistent: one lane per edge.
//
// Both round as the warp per edge did: the mean and E[x^2] in
// group_sum(x, 32)'s order (row_sum32; over two features: x0 + x1 and
// x0^2 + x1^2, each square rounded), var = E[x^2] - mean^2 written as
// there, the linears' sum over k in order, then the bias.
// ---------------------------------------------------------------------------

struct FrontFwdSmem {
  float x[2][kTileRows][kTileNarrow];  // e of the tile (double-buffered)
  float v[kTileRows][kTileNarrow];     // v of the tile, zero past De
  float wf[32][64];                    // [Wlp ; Wlc]^T, zero-padded
  float bf[64];                        // [blp | blc], zero-padded
  float g[32], b[32];                  // the LayerNorm's scale and bias
};

// SE: the storage of e; SN: of en (float, or bf16 rounded from the float32
// v that the linears take).
template <class SE, class SN>
__global__ void __launch_bounds__(kTileThreads, kTileBlocksPerSm) frontend_fwd_tile_kernel(
    const SE* __restrict__ e, int E, int De, const float* __restrict__ lng,
    const float* __restrict__ lnb, int raw, float eps, const float* __restrict__ wlp,
    const float* __restrict__ blp, int Dp, const float* __restrict__ wlc,
    const float* __restrict__ blc, int Dc, SN* __restrict__ en, float* __restrict__ xl_p,
    float* __restrict__ xl_c) {
  __shared__ __align__(16) FrontFwdSmem s;
  const int tid = threadIdx.x;
  const int DP = (De + 3) & ~3;
  const int stride = gridDim.x * kTileRows;
  int e0 = blockIdx.x * kTileRows;
  // the first tile's rows in flight while the weights load
  stage_rows_async(&s.x[0][0][0], kTileNarrow, 0, e, De, e0, E);
  cp_async_commit();
  load_front_fwd_params(s.wf, s.bf, s.g, s.b, wlp, blp, Dp, wlc, blc, Dc, De, lng, lnb, raw);

  const int r1 = tid >> 3, c1 = 4 * (tid & 7);   // phase B
  const int og = tid & 15, ra = 2 * (tid >> 4);  // phase C
  float* const out_c = og < 8 ? xl_p : xl_c;
  const int Dout = og < 8 ? Dp : Dc, col = 4 * (og & 7);
  const float inv = 1.f / (float)De;
  for (int it = 0; e0 < E; e0 += stride, ++it) {
    const int buf = it & 1;
    // The other buffer was last read in the previous tile's phase B, which a
    // barrier since has closed.
    const int f0 = e0 + stride;
    if (f0 < E) stage_rows_async(&s.x[buf ^ 1][0][0], kTileNarrow, 0, e, De, f0, E);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of this tile have landed
    __syncthreads();     // everyone's (and the weights); the previous tile's phase C is done

    // ---- phase B: v (features c1 .. c1 + 3 of edge r1, zero past De)
    const int e1 = e0 + r1;
    const bool valid = e1 < E;
    const float4 x4 = *reinterpret_cast<const float4*>(&s.x[buf][r1][c1]);
    const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
    float x[4], v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) x[q] = c1 + q < De ? xs[q] : 0.f;
    if (raw) {
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = x[q];
    } else {
      step_norm4(s.g, s.b, x, De, c1, inv, eps, v);
      store_row4(en, De, e1, c1, valid, v);
    }
    *reinterpret_cast<float4*>(&s.v[r1][c1]) = make_float4(v[0], v[1], v[2], v[3]);
    __syncthreads();

    // ---- phase C: xl_p, xl_c, stored through L2, where the dual core,
    // launched next, finds them
    float o[2][4];
    step_linears4(s.v, s.wf, s.bf, ra, og, DP, o);
    store_row4(out_c, Dout, e0 + ra, col, e0 + ra < E, o[0]);
    store_row4(out_c, Dout, e0 + ra + 1, col, e0 + ra + 1 < E, o[1]);
  }
  cp_async_wait<0>();
}

template <int DE, int DQ, class SE, class SN>
__global__ void __launch_bounds__(kTileThreads) frontend_fwd_narrow_kernel(
    const SE* __restrict__ e, int E, int De, const float* __restrict__ lng,
    const float* __restrict__ lnb, int raw, float eps, const float* __restrict__ wlp,
    const float* __restrict__ blp, int Dp, const float* __restrict__ wlc,
    const float* __restrict__ blc, int Dc, SN* __restrict__ en, float* __restrict__ xl_p,
    float* __restrict__ xl_c) {
  const int edge = blockIdx.x * kTileThreads + threadIdx.x;
  if (edge >= E) return;
  float wp[DQ][DE], wc[DQ][DE], bp[DQ], bc[DQ], g[DE], b[DE];
#pragma unroll
  for (int i = 0; i < DQ; ++i) {
#pragma unroll
    for (int j = 0; j < DE; ++j) {
      wp[i][j] = (i < Dp && j < De) ? __ldg(wlp + i * De + j) : 0.f;
      wc[i][j] = (i < Dc && j < De) ? __ldg(wlc + i * De + j) : 0.f;
    }
    bp[i] = i < Dp ? __ldg(blp + i) : 0.f;
    bc[i] = i < Dc ? __ldg(blc + i) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < DE; ++j) {
    g[j] = (!raw && j < De) ? __ldg(lng + j) : 0.f;
    b[j] = (!raw && j < De) ? __ldg(lnb + j) : 0.f;
  }
  float x[DE], v[DE];
  load_row_n(e, De, edge, x);
  if (raw) {
#pragma unroll
    for (int j = 0; j < DE; ++j) v[j] = x[j];
  } else {
    // the warp per edge's rounding: each square rounded before the sums (no
    // fused multiply-add), both sums in feature order
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < DE; ++j) {
      s1 = __fadd_rn(s1, x[j]);
      s2 = __fadd_rn(s2, __fmul_rn(x[j], x[j]));
    }
    const float inv = 1.f / (float)De;
    const float mean = s1 * inv;
    const float var = s2 * inv - mean * mean;
    const float rstd = rsqrtf(var + eps);
#pragma unroll
    for (int j = 0; j < DE; ++j) {
      v[j] = j < De ? fmaxf((x[j] - mean) * rstd * g[j] + b[j], 0.f) : 0.f;
    }
    store_row_n(en, De, edge, v);
  }
  float yp[DQ], yc[DQ];
#pragma unroll
  for (int i = 0; i < DQ; ++i) {
    float ap = 0.f, ac = 0.f;
#pragma unroll
    for (int j = 0; j < DE; ++j) {
      ap = fmaf(v[j], wp[i][j], ap);
      ac = fmaf(v[j], wc[i][j], ac);
    }
    yp[i] = ap + bp[i];
    yc[i] = ac + bc[i];
  }
  store_row_n(xl_p, Dp, edge, yp);
  store_row_n(xl_c, Dc, edge, yc);
}

// ---------------------------------------------------------------------------
// The standalone projection update's forward tile kernel (#9): phase A
// above, e = ([en | skip2] W^T + c0 + ps[pt] + pv[cam]) / 4 (+ res),
// written with 16-byte stores where De allows. Its cost on the card is
// shared-memory traffic: a thread that computes 4 features of one edge
// reads 5 floats from shared memory per 4 FMAs (W^T's row and the edge's
// [en | skip2] value), 22.5 of the dense scene's 31 us at 128 bytes per
// clock and SM. So a thread takes two edges (edges 2 rp, 2 rp + 1 of a
// span of two 32-edge tiles, features c1 .. c1 + 3), each load of W^T
// feeding both: 3 floats per 4 FMAs. Persistent blocks load W^T and c0
// once and take spans span = block, block + grid, ...; at the top of each
// span (after the barrier that closes the previous span's reads) the next
// span's [en | skip2] rows go in flight by cp.async into the other buffer,
// and its res and gathered rows (their sum ps + pv, as phase A adds them)
// into registers, from indices loaded a span earlier still. One barrier
// per span.
// ---------------------------------------------------------------------------

constexpr int kUpdateFwdSpan = 2 * kTileRows;  // edges per block per step
constexpr int kUpdateFwdBlocksPerSm = 3;       // persistent blocks per SM

struct UpdateFwdSmem {
  float a[2][kUpdateFwdSpan][kTileWide];  // [en | skip2] of the span, zero past K (double-buffered)
  float wt[64][32];                       // W^T (K, De), zero-padded
  float c0[32];                           // b + pg
};

// The rows of one edge that #9 reads outside the staged span: the sum of
// its gathered table rows (summed when loaded: with two edges per thread,
// a tile ahead, that keeps 16 registers fewer than StepEdgeRows) and its
// residual (features c1 .. c1 + 3).
struct UpdateEdgeRows {
  float gs[4], res[4];
};

template <class S>
__device__ __forceinline__ void load_update_rows(UpdateEdgeRows& r, const float* __restrict__ ps,
                                                 const float* __restrict__ pv,
                                                 const S* __restrict__ res, int De, int e,
                                                 int p, int c, int c1, bool valid) {
  float a[4], b[4];
  gather_row4(ps, De, p, c1, valid, a);
  gather_row4(pv, De, c, c1, valid, b);
#pragma unroll
  for (int q = 0; q < 4; ++q) r.gs[q] = a[q] + b[q];
  load_row4(res, De, e, c1, valid, r.res);
}

// S: the streams' storage (en, skip2, res, out; out rounded as stored).
template <class S>
__global__ void __launch_bounds__(kTileThreads, kUpdateFwdBlocksPerSm) proj_update_fwd_tile_kernel(
    const S* __restrict__ en, int d_in, const S* __restrict__ skip2, int d2,
    const S* __restrict__ res, const float* __restrict__ w, const float* __restrict__ b,
    const float* __restrict__ pg, const float* __restrict__ ps, const float* __restrict__ pv,
    const int* __restrict__ pt_idx, const int* __restrict__ cam_idx, int E, int De,
    S* __restrict__ out) {
  __shared__ __align__(16) UpdateFwdSmem s;
  const int K = d_in + d2, KP = (K + 3) & ~3;
  const int r0 = 2 * (threadIdx.x >> 3), c1 = 4 * (threadIdx.x & 7);  // edges r0, r0 + 1
  const int stride = gridDim.x * kUpdateFwdSpan;

  // a span's rows into buffer buf: two tiles of [en | skip2]
  auto stage = [&](int buf, int f0) {
    for (int t = 0; t < 2; ++t) {
      float* dst = &s.a[buf][t * kTileRows][0];
      stage_rows_async(dst, kTileWide, 0, en, d_in, f0 + t * kTileRows, E);
      stage_rows_async(dst, kTileWide, d_in, skip2, d2, f0 + t * kTileRows, E);
    }
  };
  UpdateEdgeRows cur[2], nxt[2];
  int np[2] = {0, 0}, nc[2] = {0, 0};  // the next span's indices, loaded a span ahead
  int e0 = blockIdx.x * kUpdateFwdSpan;
  if (e0 < E) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = e0 + r0 + h;
      const bool valid = e < E;
      load_update_rows(cur[h], ps, pv, res, De, e, valid ? pt_idx[e] : 0,
                       valid ? cam_idx[e] : 0, c1, valid);
      const int e2 = e + stride;
      if (e2 < E) {
        np[h] = pt_idx[e2];
        nc[h] = cam_idx[e2];
      }
    }
    stage(0, e0);
    cp_async_commit();
  }
  // the weights while the first span's rows are in flight (on a graph of a
  // few spans that latency is most of the call)
  load_update_fwd_params(s.wt, s.c0, w, b, pg, K, De);
  zero_tile_pad(s.a, K);
  for (int it = 0; e0 < E; e0 += stride, ++it) {
    const int buf = it & 1;
    cp_async_wait<0>();  // this thread's copies of this span have landed
    __syncthreads();     // everyone's (and the weights); the previous span's reads are done
    const int f0 = e0 + stride;
    if (f0 < E) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int f = f0 + r0 + h;
        load_update_rows(nxt[h], ps, pv, res, De, f, np[h], nc[h], c1, f < E);
        const int f2 = f + stride;
        np[h] = f2 < E ? pt_idx[f2] : 0;
        nc[h] = f2 < E ? cam_idx[f2] : 0;
      }
      stage(buf ^ 1, f0);
    }
    cp_async_commit();
    const float gs[2][4] = {{cur[0].gs[0], cur[0].gs[1], cur[0].gs[2], cur[0].gs[3]},
                            {cur[1].gs[0], cur[1].gs[1], cur[1].gs[2], cur[1].gs[3]}};
    const float rs[2][4] = {{cur[0].res[0], cur[0].res[1], cur[0].res[2], cur[0].res[3]},
                            {cur[1].res[0], cur[1].res[1], cur[1].res[2], cur[1].res[3]}};
    float x[2][4];
    step_update4<2>(s.wt, s.c0, &s.a[buf][r0][0], kTileWide, KP, De, c1, gs, rs, x);
#pragma unroll
    for (int h = 0; h < 2; ++h) store_row4(out, De, e0 + r0 + h, c1, e0 + r0 + h < E, x[h]);
    cur[0] = nxt[0];
    cur[1] = nxt[1];
  }
  cp_async_wait<0>();
}

}  // namespace gasfm
