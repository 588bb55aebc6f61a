// The standalone projection update of a GASFM layer, for sm_90a, forward and
// backward:
//
//   e = ([en | skip2] . W^T + b + pg + ps[pt] + pv[cam]) / 4  (+ res)
//
// Replaces the TPU kernels of gasfm_tpu/ops/pallas/fused_proj_update.py:
//   - gasfm_proj_update     <- _fwd_raw / _fwd_kernel (packed_edge_update, :464)
//   - gasfm_proj_update_bwd <- _bwd_raw / _bwd_kernel
// The JAX package runs it on a packed layer whose successor is not packed
// (the depth head's layer L-2, whose successor widens the stream), where the
// update cannot defer into the next layer-step kernel. The TPU kernels work
// on lane-packed streams (4 edges per 128-lane row) with block-diagonal
// weights, one-hot matmul gathers of the point window and the camera table,
// and table gradients resident across the sequential grid. None of that
// carries over: here both directions take the edge tiles of edge_tile.cuh,
// the gathers are direct loads, and the table gradients are CSR segment
// sums.
//
// What bounds it on the H100: bytes over 3.35 TB/s. The forward reads en,
// skip2 and res and the two gathered table rows per edge and writes e, about
// 0.65 KB per edge at De = 32, d2 = 2, against ~2 * 34 * 32 flops. Its
// first design gave each edge a warp, lane j feature j, and ran the product
// as a 34-step shuffle + shared-load + FMA chain per edge (4.8x its bound on
// the dense scene); now it is the layer step forward's phase A on edge
// tiles (proj_update_fwd_tile_kernel, edge_tile.cuh): persistent blocks
// hold W^T in shared memory, stage the next span of two 32-edge tiles'
// [en | skip2] rows by cp.async and load its res and gathered rows while a
// span computes, each thread four features of two edges (the shared-memory
// reads of W^T, which bound it, shared by both), the sum over k in the
// per-edge code's order (so e is bitwise the first design's), written with
// 16-byte stores.
// The backward reads g, en and skip2 and writes d en, d skip2, d ps and d
// pv (~0.4 KB per edge) against ~4 * 34 * 32 flops per edge; d res = g is
// the wrapper's, with no kernel work. Its first design gave each point a
// warp that ran d en and d skip2 of each of the point's edges as a 32-step
// shuffle + shared-load + FMA chain (the power-law scene's 133-edge point
// 133 x 32 dependent steps on one warp), summed the cameras in a block each
// and read g, en and skip2 a second time for the outer sums of d W: 20x its
// bound on the power-law scene. Now it runs the layer step backward's edge
// tiles (edge_tile.cuh, proj_update_bwd_tile_kernel: 32-edge tiles in
// persistent blocks, [d en | d skip2] = du . W and d W, d b in registers,
// register-tiled, the next tile's rows in flight), one column sum of the
// blocks' partial rows, and the segment sum's split walks for d ps and d pv
// (segment.cuh, #15/#18's, each with a merge launch where a hub exists).
// No float atomics: bitwise reproducible on a given card.
#include "edge_tile.cuh"
#include "segment.cuh"

// en (E, d_in), skip2 (E, d2) or NULL, res (E, De) or NULL, w (De, d_in + d2),
// b, pg (De,), ps (n, De), pv (m, De); out (E, De). grid: the tile kernel's
// blocks, at most kUpdateFwdBlocksPerSm per SM. en, skip2, res, ps, pv and
// out are read and written as 16-byte vectors where their widths allow and
// must then be 16-byte aligned.
// With bf16 set en, skip2, res and out are bf16 streams (out rounded), else
// float32.
template <class S>
static void proj_update(const void* en, int d_in, const void* skip2, int d2, const void* res,
                        const float* w, const float* b, const float* pg, const float* ps,
                        const float* pv, const int* pt_idx, const int* cam_idx, int E, int De,
                        void* out, int grid, cudaStream_t s) {
  using namespace gasfm;
  proj_update_fwd_tile_kernel<S><<<grid, kTileThreads, 0, s>>>(
      static_cast<const S*>(en), d_in, static_cast<const S*>(skip2), d2,
      static_cast<const S*>(res), w, b, pg, ps, pv, pt_idx, cam_idx, E, De,
      static_cast<S*>(out));
}

extern "C" int gasfm_proj_update(const void* en, int d_in, const void* skip2, int d2,
                                 const void* res, const float* w, const float* b,
                                 const float* pg, const float* ps, const float* pv,
                                 const int* pt_idx, const int* cam_idx, int E, int De,
                                 void* out, int bf16, int grid, void* stream) {
  if (E > 0) {
    auto run = bf16 ? &proj_update<gasfm::bf16> : &proj_update<float>;
    run(en, d_in, skip2, d2, res, w, b, pg, ps, pv, pt_idx, cam_idx, E, De, out, grid,
        (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

// g (E, De) the cotangent of e; den (E, d_in); dskip2 (E, d2) or NULL; dps (n,
// De); dpv (m, De). partials (grid, De * K + De) scratch, K = d_in + d2;
// sums (De * K + De): d W (De, K) then d b. grid: the tile kernel's blocks,
// at most kTileBlocksPerSm per SM. split_p / split_c: both CSRs split as
// the segment sum takes them (segment.cuh; ViewGraph.pt_chunks /
// cam_chunks, layout SegmentSplit); part_p (n_chunks_p, De) and part_c
// (n_chunks_c, De) their scratch. g, en and skip2 are read as 16-byte
// (bf16: 8-byte) vectors where their widths allow and must then be 16-byte
// aligned. With bf16 set g, en, skip2, den and dskip2 are bf16 streams (den,
// dskip2 rounded), and the tile kernel writes g upcast to g32 (E, De), which
// the tables' sums read.
template <class S>
static void proj_update_bwd_tiles(const void* g, const void* en, int d_in, const void* skip2,
                                  int d2, const float* w, int E, int De, void* den,
                                  void* dskip2, float* g32, float* partials, int rows,
                                  cudaStream_t s) {
  using namespace gasfm;
  proj_update_bwd_tile_kernel<S><<<rows, kTileThreads, 0, s>>>(
      static_cast<const S*>(g), static_cast<const S*>(en), d_in, static_cast<const S*>(skip2),
      d2, w, E, De, static_cast<S*>(den), static_cast<S*>(dskip2), g32, partials);
}

extern "C" int gasfm_proj_update_bwd(const void* g, const void* en, int d_in,
                                     const void* skip2, int d2, const float* w,
                                     const int* pt_ptr, int n_pts, const int* cam_ptr,
                                     const int* cam_perm, int n_cams, const int* split_p,
                                     int n_long_p, int n_chunks_p, const int* split_c,
                                     int n_long_c, int n_chunks_c, float* part_p, float* part_c,
                                     int E, int De, void* den, void* dskip2, float* dps,
                                     float* dpv, float* partials, float* sums, float* g32,
                                     int bf16, int grid, void* stream) {
  using namespace gasfm;
  cudaStream_t s = (cudaStream_t)stream;
  const int rows = E > 0 ? grid : 0;
  if (rows > 0) {
    auto run = bf16 ? &proj_update_bwd_tiles<gasfm::bf16> : &proj_update_bwd_tiles<float>;
    run(g, en, d_in, skip2, d2, w, E, De, den, dskip2, bf16 ? g32 : nullptr, partials, rows, s);
  }
  launch_column_sum(partials, rows, De * (d_in + d2) + De, sums, s);
  const float* gsum = bf16 ? g32 : static_cast<const float*>(g);
  segment_sum(gsum, De, pt_ptr, nullptr, E, SegmentSplit(split_p, n_long_p, n_chunks_p), n_pts,
              0.25f, dps, part_p, s);
  segment_sum(gsum, De, cam_ptr, cam_perm, E, SegmentSplit(split_c, n_long_c, n_chunks_c),
              n_cams, 0.25f, dpv, part_c, s);
  return (int)cudaGetLastError();
}
