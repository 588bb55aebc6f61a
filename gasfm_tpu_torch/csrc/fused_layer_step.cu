// Merged layer step prologue, for sm_90a: layer l's projection update fused
// with layer l+1's frontend prologue, forward and backward. The wrapper runs
// the dual core (fused_dual_attn.cu, gasfm_dual_attend) right after the
// forward, and its backward (gasfm_dual_attend_bwd) right before the backward.
//
// Replaces the TPU kernels of gasfm_tpu/ops/pallas/fused_layer_step.py
// (_fwd_raw / _fwd_kernel, fused_layer_step; _bwd_raw / _bwd_body). Per edge:
//
//   e_l      = ([en | skip2] . W^T + c0 + ps[pt] + pv[cam]) / 4  (+ res)
//   en_{l+1} = relu(LN_{l+1}(e_l))          (skipped under raw, en_{l+1} = e_l)
//   xl_p, xl_c = the next layer's two GATv2 source linears of en_{l+1}
//
// with c0 = b + pg (lin_proj's bias plus the global table row). The first layer's
// width-adapting residual rides the skip2 slot (skip2 = relu(LN_res(uv)),
// W's skip columns = 4 * W_skip, c0 += 4 * b_skip), as in the JAX package.
//
// What bounds it on the H100: bytes. At the flagship's interior widths
// (d_in = De = Dp = Dc = 32, d2 = 2, with res) a call reads per edge en (128
// bytes), skip2 (8), res (128) and the two indices (8), and writes e_l,
// en_{l+1}, xl_p and xl_c (4 x 128): 784 bytes per edge, plus the tables ps
// and pv once (128 bytes per point and per camera) and the weights, against
// ~3.1k float32 FMAs per edge (W 34 x 32, the two linears 2 x 32 x 32),
// ~0.4 of the bytes' time at 67 TFLOP/s. The first design gave each edge one
// warp, lane j feature j: every product a chain of shuffles, shared loads and
// FMAs (~80 dependent steps per edge), its loads two levels deep (the
// indices, then the table rows), and 2,112 blocks each reloading ~17 KB of
// weights with a transposing store that put all 32 lanes on one bank. Now
// the forward runs the edge tiles of edge_tile.cuh
// (layer_step_fwd_tile_kernel): persistent blocks load the weights once with
// conflict-free stores and walk 32-edge tiles, each tile's [en | skip2] rows
// staged with 16-byte copies, every product register-tiled, the LayerNorm's
// sums over the 8 lanes of a row, and the next tile's rows in flight
// (cp.async) while a tile computes.
//
// Backward (gasfm_layer_step_bwd), four launches: the edge-tile kernel
// (edge_tile.cuh), one column sum of its partial rows, and the point and
// camera segment sums of d_el / 4 (segment.cuh, #15/#18's, each with a merge
// launch where a hub exists) for d ps and d pv. What bounds
// it on the H100 is bytes again (~0.6 KB per edge: e_l, en, skip2, d xl_p,
// d xl_c and the two output cotangents read once, d e_l, d en and d skip2
// written once, d e_l read twice more by the sums) against ~6.5k float32 FMAs
// per edge, which the CUDA cores take in a third of the bytes' time if the
// products keep them fed. The first design gave each point one warp with
// lane j holding feature j: every product was a chain of shuffles and shared
// loads (~116 dependent steps per edge), a warp waited on its point's edges
// one at a time (133 on the longest power-law point), and the weight
// gradients took a second, outer-sum pass over the streams plus
// separate camera and LayerNorm sums: 7 launches, ~0.46 / ~0.68 ms per call
// on the two bench scenes. Now the work is split by edges, not by points:
// tiles of 32 edges staged in shared memory with 16-byte loads, every
// product register-tiled, every weight gradient in registers across a
// block's tiles, each sum in a fixed order without atomics.
//
// The standalone projection update (#9, fused_proj_update.cu) runs the tile
// forward's phase A, the frontend's forward (#3, fused_dual_attn.cu) its
// phases B and C, and the frontend's backward (#4) the tile backward's
// phases 1 and 3.
#include "edge_tile.cuh"
#include "segment.cuh"

// With bf16 set the streams en, skip2, res, e_l and en_next are bf16
// (compile.stream_dtype = bf16), else float32. grid: the tile kernel's
// blocks, at most kStepFwdBlocksPerSm per SM. en, skip2, res, ps, pv and the
// outputs are read and written as 16-byte (bf16: 8-byte) vectors where their
// widths allow and must then be 16-byte aligned.
template <class S>
static void layer_step_prologue(const void* en, int d_in, const void* skip2, int d2,
                                const void* res, const float* w, const float* b,
                                const float* pg, const float* ps, const float* pv,
                                const int* pt_idx, const int* cam_idx, int E, int De,
                                const float* lng, const float* lnb, int raw, float eps,
                                const float* wlp, const float* blp, int Dp, const float* wlc,
                                const float* blc, int Dc, void* e_l, void* en_next,
                                float* xl_p, float* xl_c, int grid, cudaStream_t s) {
  using namespace gasfm;
  layer_step_fwd_tile_kernel<S><<<grid, kTileThreads, 0, s>>>(
      static_cast<const S*>(en), d_in, static_cast<const S*>(skip2), d2,
      static_cast<const S*>(res), w, b, pg, ps, pv, pt_idx, cam_idx, E, De, lng, lnb, raw, eps,
      wlp, blp, Dp, wlc, blc, Dc, static_cast<S*>(e_l), static_cast<S*>(en_next), xl_p, xl_c);
}

extern "C" int gasfm_layer_step_prologue(
    const void* en, int d_in, const void* skip2, int d2, const void* res,
    const float* w, const float* b, const float* pg, const float* ps, const float* pv,
    const int* pt_idx, const int* cam_idx, int E, int De, const float* lng,
    const float* lnb, int raw, float eps, const float* wlp, const float* blp,
    int Dp, const float* wlc, const float* blc, int Dc, void* e_l,
    void* en_next, float* xl_p, float* xl_c, int bf16, int grid, void* stream) {
  if (E > 0) {
    auto run = bf16 ? &layer_step_prologue<gasfm::bf16> : &layer_step_prologue<float>;
    run(en, d_in, skip2, d2, res, w, b, pg, ps, pv, pt_idx, cam_idx, E, De, lng, lnb, raw, eps,
        wlp, blp, Dp, wlc, blc, Dc, e_l, en_next, xl_p, xl_c, grid, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

// d_el (E, De, float32): the total cotangent of e_l (with float32 streams
// returned as d res); den_out (E, d_in); dskip2 (E, d2) or NULL; dps (n, De);
// dpv (m, De); den_next and de_l_ext may be NULL (no cotangent). With bf16
// set the streams en, skip2, e_l, den_next, de_l_ext, den_out and dskip2 are
// bf16, and dres (E, De, or NULL) takes d_el rounded to bf16. partials (grid, row) scratch, sums
// (row,): the weight gradients, laid out as StepRow (edge_tile.cuh) says.
// grid: the tile kernel's blocks, at most kTileBlocksPerSm per SM. split_p /
// split_c: both CSRs split as the segment sum takes them (segment.cuh;
// ViewGraph.pt_chunks / cam_chunks, layout SegmentSplit); part_p
// (n_chunks_p, De) and part_c (n_chunks_c, De) their scratch.
template <class S>
static void layer_step_bwd_tiles(const void* en, int d_in, const void* skip2, int d2,
                                 const float* w, const void* e_l, int E, int De,
                                 const float* lng, const float* lnb, int raw, float eps,
                                 const float* wlp, int Dp, const float* wlc, int Dc,
                                 const float* dxl_p, const float* dxl_c, const void* den_next,
                                 const void* de_l_ext, float* d_el, void* den_out,
                                 void* dskip2, void* dres, float* partials, int rows,
                                 cudaStream_t s) {
  using namespace gasfm;
  layer_step_bwd_tile_kernel<S><<<rows, kTileThreads, 0, s>>>(
      static_cast<const S*>(en), d_in, static_cast<const S*>(skip2), d2, w,
      static_cast<const S*>(e_l), E, De, lng, lnb, raw, eps, wlp, Dp, wlc, Dc, dxl_p, dxl_c,
      static_cast<const S*>(den_next), static_cast<const S*>(de_l_ext), d_el,
      static_cast<S*>(den_out), static_cast<S*>(dskip2), static_cast<S*>(dres), partials);
}

extern "C" int gasfm_layer_step_bwd(
    const void* en, int d_in, const void* skip2, int d2, const float* w, const void* e_l,
    const int* pt_ptr, int n_pts, const int* cam_ptr, const int* cam_perm, int n_cams,
    const int* split_p, int n_long_p, int n_chunks_p, const int* split_c, int n_long_c,
    int n_chunks_c, float* part_p, float* part_c, int E,
    int De, const float* lng, const float* lnb, int raw, float eps, const float* wlp, int Dp,
    const float* wlc, int Dc, const float* dxl_p, const float* dxl_c, const void* den_next,
    const void* de_l_ext, float* d_el, void* den_out, void* dskip2, float* dps, float* dpv,
    float* partials, float* sums, void* dres, int bf16, int grid, void* stream) {
  using namespace gasfm;
  cudaStream_t s = (cudaStream_t)stream;
  const int rows = E > 0 ? grid : 0;
  if (rows > 0) {
    auto run = bf16 ? &layer_step_bwd_tiles<gasfm::bf16> : &layer_step_bwd_tiles<float>;
    run(en, d_in, skip2, d2, w, e_l, E, De, lng, lnb, raw, eps, wlp, Dp, wlc, Dc, dxl_p, dxl_c,
        den_next, de_l_ext, d_el, den_out, dskip2, bf16 ? dres : nullptr, partials, rows, s);
  }
  launch_column_sum(partials, rows, StepRow(De, d_in + d2, Dp, Dc).len, sums, s);
  segment_sum(d_el, De, pt_ptr, nullptr, E, SegmentSplit(split_p, n_long_p, n_chunks_p), n_pts,
              0.25f, dps, part_p, s);
  segment_sum(d_el, De, cam_ptr, cam_perm, E, SegmentSplit(split_c, n_long_c, n_chunks_c),
              n_cams, 0.25f, dpv, part_c, s);
  return (int)cudaGetLastError();
}
