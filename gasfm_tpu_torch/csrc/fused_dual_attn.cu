// Dual GATv2 segment attention and the layer frontend, for sm_90a, forward
// and backward.
//
// Replaces the TPU kernels of gasfm_tpu/ops/pallas/fused_dual_attn.py:
//   - gasfm_dual_attend       <- _dual_fwd_raw / _dual_fwd_kernel (fused_dual_attend)
//   - gasfm_dual_attend_bwd   <- _dual_bwd_raw / _dual_bwd_kernel
//   - gasfm_frontend_prologue <- the LN + ReLU + source-linear prologue of
//     _front_fwd_raw / _front_fwd_kernel (fused_frontend); the wrapper runs
//     gasfm_dual_attend right after it. It runs the edge tiles of
//     edge_tile.cuh (frontend_fwd_tile_kernel, or frontend_fwd_narrow_kernel,
//     a lane per edge, at the first layer's widths): one launch.
//   - gasfm_frontend_prologue_bwd <- the prologue half of _front_bwd_raw /
//     _front_bwd_kernel; the wrapper runs gasfm_dual_attend_bwd before it.
//     It runs the edge tiles of edge_tile.cuh (frontend_bwd_tile_kernel,
//     or frontend_bwd_narrow_kernel at the first layer's widths) and one
//     column sum of their per-block partial rows: two launches.
//
// What bounds it on the H100: bytes. Per edge the core reads its two source
// rows (xl_p, xl_c: 4*(Dp+Dc) bytes) and one camera-order index; per segment
// one query row and one output row; ~10 flops per feature and edge are far
// below the card's float32 rate, so the floor is those bytes over 3.35 TB/s.
// Design against it: no one-hot matmuls (the TPU kernel's way to gather on
// the MXU) — the edges of a point are contiguous in the point-major layout
// and the edges of a camera are listed by the camera CSR, so each segment is
// a loop over its own rows, read once, with the online softmax (m, den, num)
// in registers. Degrees are power-law, and a warp that walks a whole segment
// serially makes the longest one the launch's length: the first forward
// walked a point per warp (one row per DRAM latency; the power-law scene's
// point of 133 edges) and a camera per 16-warp block, scheduled after every
// point block, 8.7x / 10.3x the byte bound on the two bench scenes. Both
// CSRs now come split at kAttendChunk edges once per graph on the host
// (ViewGraph.pt_chunks, cam_chunks), in both directions of the core
// (attend_split.cuh, shared with the single-direction kernel, fused_attn.cu):
//   - Forward: warps take the long cameras' and points' 32-edge chunks
//     first, then the short cameras, then quads of four short points (8
//     lanes of 4 features, 16-byte loads). A chunk or short camera is laid
//     out as a quad of rows, 8 lanes of 4 features per row, 4 rows at a
//     time, 8 in flight, a camera's permutation entries read by one
//     coalesced load; a chunk writes its online triple, and a second launch
//     (a block per long segment, its warps on contiguous runs of chunks,
//     merged in order) writes each long segment's output and residuals.
//     Two launches.
// Under autograd the forward also writes each segment's per-head max and
// denominator (n, H) / (m, H), so the backward reads them instead of
// recomputing the softmax (one more pass over xl); m is the max over all
// of a segment's chunks. Without residuals only out_p and out_c are
// written.
//   - Backward (#2): the same split and unit order. Per edge it recomputes
// the logit from xl and the query and writes d xl; a chunk writes a partial
// d xr row, and a second launch merges each long segment's partials in
// chunk order, points and cameras together. The attention vectors'
// gradients are per-block partial rows of both sides, [d att_p | d att_c],
// and one fixed-order column sum (common.cuh): three launches.
//   - The prologue's backward (#4) is bytes-bound too: per edge it reads e,
// d xl_p, d xl_c and the cotangent of v, and writes d e, against ~4 De (Dp +
// Dc) FMAs. Its first design gave each edge a warp, lane j feature j (28
// of 32 lanes idle at the first layer's De = 2), and took the source
// linears' weight gradients in a second pass over d xl and v, a kernel
// staging 32 x 64 tiles whatever the widths, plus three column sums: five
// launches. Now the edges go in 32-edge tiles (edge_tile.cuh): phases 1
// and 3 of the layer step's backward, every weight gradient in registers,
// one partial row per block and one column sum.
// No float atomics anywhere: results are bitwise reproducible run to run.
#include "attend_split.cuh"
#include "edge_tile.cuh"

namespace gasfm {

constexpr int kDualWarps = 8;  // warps per block of the dual core's forward launches

// One direction's operands of the forward; perm is the camera CSR's, NULL
// on the point side; m and den NULL without residuals.
struct DualFwdSide {
  const float *xl, *xr, *att;
  const int *ptr, *perm;
  int n_seg, D, C;
  float *out, *m, *den, *part;
};

// Rows [begin, end) of segment `seg` (at most kAttendChunk: a chunk or a
// short segment) of one side, walked as a quad of rows (attend_rows4): a
// chunk's online triple to its row of part (`chunk` >= 0), a short
// segment's output and residuals to out, m, den.
template <int NH, bool PERM>
__device__ __forceinline__ void dual_fwd_rows(const DualFwdSide& sd, int seg, int begin,
                                              int end, int chunk, float slope) {
  const int lane = threadIdx.x & 31;
  Online s[4];
  attend_rows4<NH, PERM>(sd.xl, sd.xr, sd.att, sd.perm, seg, begin, end, sd.D, sd.C, slope, s);
  if (lane >= 8) return;
  const int c0 = 4 * lane;
  if (chunk < 0) {
    store_quad<NH>(s, seg, c0, sd.D, sd.C, sd.out, sd.m, sd.den);
    return;
  }
  float* p = sd.part + (size_t)chunk * kTriple;
  *reinterpret_cast<float4*>(p + c0) = make_float4(s[0].m, s[1].m, s[2].m, s[3].m);
  *reinterpret_cast<float4*>(p + 32 + c0) = make_float4(s[0].den, s[1].den, s[2].den, s[3].den);
  *reinterpret_cast<float4*>(p + 64 + c0) = make_float4(s[0].num, s[1].num, s[2].num, s[3].num);
}

// Main launch, a unit per warp, in the order long camera chunks, long point
// chunks, cameras (a warp walks a camera of at most kAttendChunk edges; a
// longer one's warp has nothing to do), point quads (attend_quad: four
// short points, 8 lanes of 4 features each). The long walkers start first,
// the short ones fill the tail. NHP / NHC: the head slots of a quad lane's 4
// features on the point / camera side.
template <int NWARPS, int NHP, int NHC>
__global__ void __launch_bounds__(NWARPS * 32) dual_attend_kernel(
    DualFwdSide pt, SegmentSplit spp, DualFwdSide cam, SegmentSplit spc, int n_quads,
    float slope) {
  const int u = blockIdx.x * NWARPS + (threadIdx.x >> 5);
  const int u1 = spc.n_chunks, u2 = u1 + spp.n_chunks, u3 = u2 + cam.n_seg;
  int seg, begin, end;
  if (u < u1) {
    chunk_rows(cam.ptr, spc, u, seg, begin, end);
    dual_fwd_rows<NHC, true>(cam, seg, begin, end, u, slope);
  } else if (u < u2) {
    chunk_rows(pt.ptr, spp, u - u1, seg, begin, end);
    dual_fwd_rows<NHP, false>(pt, seg, begin, end, u - u1, slope);
  } else if (u < u3) {
    seg = u - u2, begin = cam.ptr[seg], end = cam.ptr[seg + 1];
    if (end - begin > kAttendChunk) return;  // long: its chunks and the merge
    dual_fwd_rows<NHC, true>(cam, seg, begin, end, -1, slope);
  } else if (u - u3 < n_quads) {
    attend_quad<NHP>(pt.xl, pt.xr, pt.att, pt.ptr, pt.n_seg, u - u3, pt.D, pt.C, slope, pt.out,
                     pt.m, pt.den);
  }
}

// Second launch: a block per long segment, the cameras' first. Warp w
// merges the triples of its share of the segment's chunks (a contiguous
// run, the w-th of NWARPS) in chunk order, then warp 0 merges the warps'
// triples in warp order and writes the segment's output and residuals: a
// hub segment costs NWARPS short runs. m is the max over every chunk, the
// segment's exact max, as the backward's exp(min(logit - m, 0)) needs.
template <int NWARPS>
__global__ void __launch_bounds__(NWARPS * 32) dual_attend_merge_kernel(DualFwdSide pt,
                                                                        SegmentSplit spp,
                                                                        DualFwdSide cam,
                                                                        SegmentSplit spc) {
  __shared__ float sm[NWARPS][32], sd[NWARPS][32], sn[NWARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool is_cam = (int)blockIdx.x < spc.n_long;
  const int j = is_cam ? blockIdx.x : blockIdx.x - spc.n_long;
  // pick the side's fields one by one: a reference to either parameter
  // struct would copy both to the stack
  const int* long_ptr = is_cam ? spc.long_ptr : spp.long_ptr;
  const int k0 = long_ptr[j], n = long_ptr[j + 1] - k0, per = (n + NWARPS - 1) / NWARPS;
  const Online t = merge_triples(is_cam ? cam.part : pt.part, k0 + min(n, warp * per),
                                 k0 + min(n, (warp + 1) * per), lane);
  sm[warp][lane] = t.m;
  sd[warp][lane] = t.den;
  sn[warp][lane] = t.num;
  __syncthreads();
  if (warp != 0) return;
  Online r;
  r.init();
  for (int w = 0; w < NWARPS; ++w) r.merge(sm[w][lane], sd[w][lane], sn[w][lane]);
  const int seg = (is_cam ? spc.long_seg : spp.long_seg)[j];
  if (is_cam) {
    attend_store(r, seg, cam.D, cam.C, lane, cam.out, cam.m, cam.den);
  } else {
    attend_store(r, seg, pt.D, pt.C, lane, pt.out, pt.m, pt.den);
  }
}

// ---- backward of the dual core (attend_split.cuh) --------------------------------

constexpr int kDualBwdWarps = 8;        // warps per block of the backward's launches
constexpr int kDualBwdBlocksPerSm = 3;  // resident blocks per SM of its main launch
constexpr int kMergeUnroll = 16;        // partial rows in flight per merging warp

// One direction's operands of the backward; perm is the camera CSR's, NULL
// on the point side.
struct DualSide {
  const float *xl, *xr, *att, *out, *m, *den, *g;
  const int *ptr, *perm;
  int n_seg, D, C;
  float *dxl, *dxr, *dxr_part;
};

// Chunk k of a long segment, as a quad of rows (attend_bwd_rows4): its rows'
// d xl and its d xr partial row; adds this lane's d att to acc4.
template <int NH, bool PERM>
__device__ __forceinline__ void dual_bwd_chunk(const DualSide& sd, const SegmentSplit& sp, int k,
                                               float slope, float (&acc4)[4]) {
  int seg, begin, end;
  chunk_rows(sd.ptr, sp, k, seg, begin, end);
  float sum[4];
  attend_bwd_rows4<NH, PERM>(sd.xl, sd.xr, sd.att, sd.out, sd.m, sd.den, sd.g, sd.perm, seg,
                             begin, end, sd.D, sd.C, slope, sd.dxl, sum, acc4);
  const int lane = threadIdx.x & 31;
  if (lane < 8) {
    *reinterpret_cast<float4*>(sd.dxr_part + (size_t)k * 32 + 4 * lane) =
        make_float4(sum[0], sum[1], sum[2], sum[3]);
  }
}

// Main launch: warps stride over the units (a fixed assignment for a given
// grid) in the order long camera chunks, long point chunks, cameras (a warp
// walks a camera of at most kAttendChunk edges and writes its d xr row; a
// longer one's warp has nothing to do), point quads. The long walkers start
// first, the short ones fill the tail. Every unit is laid out as a quad: 8
// lanes of 4 features per row, 4 rows (or 4 short points) at a time. NHP /
// NHC: the head slots of a lane's 4 features on the point / camera side.
// partials: (gridDim.x, 64), one row per block, [d att_p | d att_c].
template <int NWARPS, int NHP, int NHC>
__global__ void __launch_bounds__(NWARPS * 32, kDualBwdBlocksPerSm) dual_attend_bwd_kernel(
    DualSide pt, SegmentSplit spp, DualSide cam, SegmentSplit spc, int n_quads, float slope,
    float* __restrict__ partials) {
  __shared__ float sbuf[2 * 32];
  const int lane = threadIdx.x & 31;
  float acc4p[4] = {0.f, 0.f, 0.f, 0.f};  // this lane's d att_p, features c0 .. c0 + 3
  float acc4c[4] = {0.f, 0.f, 0.f, 0.f};  // and d att_c
  const int u1 = spc.n_chunks, u2 = u1 + spp.n_chunks, u3 = u2 + cam.n_seg;
  const int n_units = u3 + n_quads;
  for (int u = blockIdx.x * NWARPS + (threadIdx.x >> 5); u < n_units; u += gridDim.x * NWARPS) {
    if (u < u1) {
      dual_bwd_chunk<NHC, true>(cam, spc, u, slope, acc4c);
    } else if (u < u2) {
      dual_bwd_chunk<NHP, false>(pt, spp, u - u1, slope, acc4p);
    } else if (u < u3) {
      const int c = u - u2, begin = cam.ptr[c], end = cam.ptr[c + 1];
      if (end - begin > kAttendChunk) continue;  // long: its chunks and the merge
      float sum[4];
      attend_bwd_rows4<NHC, true>(cam.xl, cam.xr, cam.att, cam.out, cam.m, cam.den, cam.g,
                                  cam.perm, c, begin, end, cam.D, cam.C, slope, cam.dxl, sum,
                                  acc4c);
      store_row4(cam.dxr, cam.D, c, 4 * lane, lane < 8, sum);
    } else {
      attend_bwd_quad<NHP>(pt.xl, pt.xr, pt.att, pt.out, pt.m, pt.den, pt.g, pt.ptr, pt.n_seg,
                           u - u3, pt.D, pt.C, slope, pt.dxl, pt.dxr, acc4p);
    }
  }
  float acc[2] = {quad_datt_lane(acc4p), quad_datt_lane(acc4c)};
  block_partial(acc, sbuf, partials + (size_t)blockIdx.x * 64);
}

// Second launch: a warp per long segment, the cameras' first, sums its
// chunks' d xr partial rows in chunk order.
template <int NWARPS>
__global__ void __launch_bounds__(NWARPS * 32) dual_bwd_merge_kernel(DualSide pt,
                                                                     SegmentSplit spp,
                                                                     DualSide cam,
                                                                     SegmentSplit spc) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * NWARPS + (threadIdx.x >> 5);
  const bool is_cam = i < spc.n_long;
  const int j = is_cam ? i : i - spc.n_long;
  if (!is_cam && j >= spp.n_long) return;
  // pick the side's fields one by one: a reference to either parameter
  // struct would copy both to the stack
  const int* long_ptr = is_cam ? spc.long_ptr : spp.long_ptr;
  const int seg = (is_cam ? spc.long_seg : spp.long_seg)[j];
  const int D = is_cam ? cam.D : pt.D;
  const float t = sum_rows_in_order<kMergeUnroll>(is_cam ? cam.dxr_part : pt.dxr_part,
                                                  long_ptr[j], long_ptr[j + 1], lane);
  if (lane < D) (is_cam ? cam.dxr : pt.dxr)[(size_t)seg * D + lane] = t;
}

}  // namespace gasfm

// split_p / split_c: the point and camera splits at kAttendChunk edges
// (ViewGraph.pt_chunks / cam_chunks; layout SegmentSplit); part_p
// (n_chunks_p, kTriple) and part_c (n_chunks_c, kTriple) scratch. m_p,
// den_p, m_c, den_c: the residuals (n, H) / (m, H), or all NULL (not
// written). The (E, D) and (S, D) streams are read as
// 16-byte vectors when D % 4 == 0 and must then be 16-byte aligned.
extern "C" int gasfm_dual_attend(
    const float* xl_p, const float* xl_c, const float* xr_p, const float* xr_c,
    const float* att_p, const float* att_c, const int* pt_ptr, const int* cam_ptr,
    const int* cam_perm, const int* split_p, int n_long_p, int n_chunks_p, const int* split_c,
    int n_long_c, int n_chunks_c, int n_pts, int n_cams, int Dp, int Cp, int Dc, int Cc,
    float slope, float* out_p, float* out_c, float* m_p, float* den_p, float* m_c,
    float* den_c, float* part_p, float* part_c, void* stream) {
  using namespace gasfm;
  cudaStream_t s = (cudaStream_t)stream;
  const DualFwdSide pt{xl_p, xr_p, att_p, pt_ptr, nullptr, n_pts, Dp, Cp,
                       out_p, m_p, den_p, part_p};
  const DualFwdSide cam{xl_c, xr_c, att_c, cam_ptr, cam_perm, n_cams, Dc, Cc,
                        out_c, m_c, den_c, part_c};
  const SegmentSplit spp(split_p, n_long_p, n_chunks_p), spc(split_c, n_long_c, n_chunks_c);
  const int n_quads = blocks_of(n_pts, kQuad);
  const int units = n_chunks_c + n_chunks_p + n_cams + n_quads;
  if (units > 0) {
    by_heads(Cp, [&](auto np) {
      by_heads(Cc, [&](auto nc) {
        dual_attend_kernel<kDualWarps, decltype(np)::value, decltype(nc)::value>
            <<<blocks_of(units, kDualWarps), kDualWarps * 32, 0, s>>>(pt, spp, cam, spc,
                                                                       n_quads, slope);
      });
    });
  }
  if (n_long_p + n_long_c > 0) {
    dual_attend_merge_kernel<kDualWarps>
        <<<n_long_p + n_long_c, kDualWarps * 32, 0, s>>>(pt, spp, cam, spc);
  }
  return (int)cudaGetLastError();
}

// The prologue (#3): en (E, De, not written under raw), xl_p (E, Dp) and
// xl_c (E, Dc) from e (E, De), all widths <= 32. At De <= kFrontNarrowDe and
// Dp, Dc <= kFrontNarrowDq the narrow form runs, a lane per edge (grid:
// ceil(E / kTileThreads) blocks); else the tile form, its persistent blocks
// (at most kTileBlocksPerSm per SM, at most one per tile) taking 32-edge
// tiles. e, en, xl_p and xl_c are read and written as 16- or 8-byte vectors
// where their widths allow and must then be 16-byte aligned.
// e_bf16 / en_bf16: e, and en, are bf16 streams (en rounded from the float32
// v that the linears take), else float32; a bf16 e has a bf16 en.
template <class SE, class SN>
static void frontend_prologue(const void* e, int E, int De, const float* lng, const float* lnb,
                              int raw, float eps, const float* wlp, const float* blp, int Dp,
                              const float* wlc, const float* blc, int Dc, void* en, float* xl_p,
                              float* xl_c, int grid, cudaStream_t s) {
  using namespace gasfm;
  const SE* ep = static_cast<const SE*>(e);
  SN* enp = static_cast<SN*>(en);
  if (De <= kFrontNarrowDe && Dp <= kFrontNarrowDq && Dc <= kFrontNarrowDq) {
    frontend_fwd_narrow_kernel<kFrontNarrowDe, kFrontNarrowDq, SE, SN>
        <<<grid, kTileThreads, 0, s>>>(ep, E, De, lng, lnb, raw, eps, wlp, blp, Dp, wlc, blc,
                                       Dc, enp, xl_p, xl_c);
  } else {
    frontend_fwd_tile_kernel<SE, SN><<<grid, kTileThreads, 0, s>>>(
        ep, E, De, lng, lnb, raw, eps, wlp, blp, Dp, wlc, blc, Dc, enp, xl_p, xl_c);
  }
}

extern "C" int gasfm_frontend_prologue(
    const void* e, int E, int De, const float* lng, const float* lnb, int raw,
    float eps, const float* wlp, const float* blp, int Dp, const float* wlc,
    const float* blc, int Dc, void* en, float* xl_p, float* xl_c, int e_bf16, int en_bf16,
    int grid, void* stream) {
  using gasfm::bf16;
  if (E > 0) {
    auto run = e_bf16    ? &frontend_prologue<bf16, bf16>
               : en_bf16 ? &frontend_prologue<float, bf16>
                         : &frontend_prologue<float, float>;
    run(e, E, De, lng, lnb, raw, eps, wlp, blp, Dp, wlc, blc, Dc, en, xl_p, xl_c, grid,
        (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

// split_p / split_c: the point and camera splits at kAttendChunk edges
// (ViewGraph.pt_chunks / cam_chunks; layout SegmentSplit); dxr_part_p
// (n_chunks_p, 32), dxr_part_c (n_chunks_c, 32) and partials (grid, 64)
// scratch, grid the main launch's blocks (at most kDualBwdBlocksPerSm per
// SM); datt: (2, 32), row 0 d att_p (first Dp columns), row 1 d att_c (first
// Dc columns). The point side's (n, Dp) and (E, Dp) streams are read and
// written as 16-byte vectors when Dp % 4 == 0 and must then be 16-byte
// aligned.
extern "C" int gasfm_dual_attend_bwd(
    const float* xl_p, const float* xl_c, const float* xr_p, const float* xr_c,
    const float* att_p, const float* att_c, const float* out_p, const float* out_c,
    const float* m_p, const float* den_p, const float* m_c, const float* den_c,
    const float* g_p, const float* g_c, const int* pt_ptr, const int* cam_ptr,
    const int* cam_perm, const int* split_p, int n_long_p, int n_chunks_p, const int* split_c,
    int n_long_c, int n_chunks_c, int n_pts, int n_cams, int Dp, int Cp, int Dc, int Cc,
    float slope, float* dxl_p, float* dxl_c, float* dxr_p, float* dxr_c, float* datt,
    float* dxr_part_p, float* dxr_part_c, float* partials, int grid, void* stream) {
  using namespace gasfm;
  cudaStream_t s = (cudaStream_t)stream;
  const DualSide pt{xl_p, xr_p, att_p, out_p, m_p, den_p, g_p, pt_ptr, nullptr,
                    n_pts, Dp, Cp, dxl_p, dxr_p, dxr_part_p};
  const DualSide cam{xl_c, xr_c, att_c, out_c, m_c, den_c, g_c, cam_ptr, cam_perm,
                     n_cams, Dc, Cc, dxl_c, dxr_c, dxr_part_c};
  const SegmentSplit spp(split_p, n_long_p, n_chunks_p), spc(split_c, n_long_c, n_chunks_c);
  if (grid > 0) {
    by_heads(Cp, [&](auto np) {
      by_heads(Cc, [&](auto nc) {
        dual_attend_bwd_kernel<kDualBwdWarps, decltype(np)::value, decltype(nc)::value>
            <<<grid, kDualBwdWarps * 32, 0, s>>>(pt, spp, cam, spc, blocks_of(n_pts, kQuad),
                                                 slope, partials);
      });
    });
  }
  const int n_long = n_long_p + n_long_c;
  if (n_long > 0) {
    dual_bwd_merge_kernel<kDualBwdWarps>
        <<<blocks_of(n_long, kDualBwdWarps), kDualBwdWarps * 32, 0, s>>>(pt, spp, cam, spc);
  }
  launch_column_sum(partials, grid, 64, datt, s);
  return (int)cudaGetLastError();
}

// The prologue's backward (#4). den (E, De) the cotangent of its output v,
// or NULL; de (E, De). partials (grid, FrontRow(De, Dp, Dc).len) scratch;
// sums (FrontRow's len): d wlp (Dp, De), d blp, d wlc (Dc, De), d blc, d
// ln_scale, d ln_bias (zeros under raw). At De <= kFrontNarrowDe and Dp, Dc
// <= kFrontNarrowDq the narrow form runs, its blocks taking spans of
// kTileThreads edges; else the tile form, its blocks 32-edge tiles. grid:
// the kernel's blocks, at most kTileBlocksPerSm per SM, at most one per
// span or tile. e, den, dxl_p and dxl_c are read as 16- or 8-byte vectors
// where their widths allow and must then be 16-byte aligned.
// e_bf16: e and de are bf16 streams (de rounded); den_bf16: den is (the
// cotangent of a bf16 en); else float32. A bf16 e has a bf16 den.
template <class SE, class SN>
static void frontend_prologue_bwd(const void* e, int E, int De, const float* lng,
                                  const float* lnb, int raw, float eps, const float* wlp, int Dp,
                                  const float* wlc, int Dc, const float* dxl_p,
                                  const float* dxl_c, const void* den, void* de, float* partials,
                                  int rows, cudaStream_t s) {
  using namespace gasfm;
  const SE* ep = static_cast<const SE*>(e);
  const SN* denp = static_cast<const SN*>(den);
  SE* dep = static_cast<SE*>(de);
  if (De <= kFrontNarrowDe && Dp <= kFrontNarrowDq && Dc <= kFrontNarrowDq) {
    frontend_bwd_narrow_kernel<kFrontNarrowDe, kFrontNarrowDq, SE, SN>
        <<<rows, kTileThreads, 0, s>>>(ep, denp, E, De, lng, lnb, raw, eps, wlp, Dp, wlc, Dc,
                                       dxl_p, dxl_c, dep, partials);
  } else {
    frontend_bwd_tile_kernel<SE, SN><<<rows, kTileThreads, 0, s>>>(
        ep, denp, E, De, lng, lnb, raw, eps, wlp, Dp, wlc, Dc, dxl_p, dxl_c, dep, partials);
  }
}

extern "C" int gasfm_frontend_prologue_bwd(
    const void* e, int E, int De, const float* lng, const float* lnb, int raw, float eps,
    const float* wlp, int Dp, const float* wlc, int Dc, const float* dxl_p,
    const float* dxl_c, const void* den, void* de, float* partials, float* sums, int e_bf16,
    int den_bf16, int grid, void* stream) {
  using namespace gasfm;
  cudaStream_t s = (cudaStream_t)stream;
  const int rows = E > 0 ? grid : 0;
  if (rows > 0) {
    auto run = e_bf16 ? &frontend_prologue_bwd<bf16, bf16>
                      : den_bf16 ? &frontend_prologue_bwd<float, bf16>
                                 : &frontend_prologue_bwd<float, float>;
    run(e, E, De, lng, lnb, raw, eps, wlp, Dp, wlc, Dc, dxl_p, dxl_c, den, de, partials, rows,
        s);
  }
  launch_column_sum(partials, rows, FrontRow(De, Dp, Dc).len, sums, s);
  return (int)cudaGetLastError();
}
