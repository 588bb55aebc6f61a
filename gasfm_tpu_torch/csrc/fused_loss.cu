// ESFM loss terms, forward and backward, for sm_90a.
//
// Replaces the TPU kernels of gasfm_tpu/ops/pallas/fused_loss.py
// (_fwd_raw / _fwd_kernel, fused_esfm_terms; _bwd_raw / _bwd_kernel). Per
// edge e = (cam, pt):
//
//   proj  = P[cam] (3x4) . X[pt] (4)
//   pos   = depth >= margin (hinge) or |depth| >= margin
//   term  = pos ? ||proj_xy / depth - uv|| : (margin - depth) * hinge_w
//
// and three scalars: sum of terms, number of edges, number of pos edges.
//
// What bounds it on the H100: bytes — 64 + 16 + 8 + 8 bytes gathered or read
// per edge against ~40 flops, and at the bench scenes' 70-116k edges a call
// is its launch and a chain of dependent loads. The first design took two
// launches per call (one thread per edge, the camera row as 12 scalar
// loads, a 3 x 256 shared tree with 8 barriers, then a one-block launch
// that summed the ~450 block partials). Now (esfm_terms_kernel) one launch:
// each thread takes kTermsEdges edges, their ids and observations (float2)
// loaded coalesced and their camera rows (three float4) and points (float4)
// loaded before any is used; a warp sums by shuffles, the block's warps in
// shared memory in warp order, one partial triple per block; the last block
// to finish (a ticket: an acquire-release atomic increment after its
// partial's store) sums the partials in block order. No float atomics: the
// bits are the same on every run on a given card. Device ms per call on the
// dense scene (tools/loss_variants.py, H100 80GB HBM3, 700 W): 0.0045; the
// pass alone 0.0035, so the ticket and the merge cost 0.0010; a second
// launch for the merge in place of the ticket 0.0048; __threadfence around
// a relaxed atomicInc 0.0049; the pass without its camera and point gathers
// 0.0035 with the merge.
//
// The ticket's counter must be 0 when a call starts. It belongs to the
// stream: the wrapper keeps one per (device, stream), zeroed once, and the
// last block's increment wraps it back to 0 (atom.inc with bound nb - 1
// stores 0 when it reads nb - 1). Calls on one stream run one after
// another, so no two calls race on a counter; a counter owned by the call
// would need a zeroed buffer per call, a memset launch, the launch this
// design removes.
//
// Backward (gasfm_esfm_terms_bwd): the cotangent of the edge sum, times d
// term / d proj per edge, with the gradient-direction equalization of the
// reference's backward hook (none / all / valid_only), gives g (3) per edge;
// then dP[cam] += g X^T and dX[pt] += P^T g. Both table gradients are
// segment sums, and they run on the segment sum's walk and split
// (csrc/segment.cuh, segment_sum_block; ViewGraph.pt_chunks / cam_chunks,
// parts of kSumPartRows) with rows computed in place of loaded: a row
// source (EdgeGradRows) holds what a segment's rows share (the camera's P
// row, or the point's X row, and the cotangent scalars), fetches an edge's
// operands (on the camera side its point id, point and observation, on the
// point side its camera row and observation), and makes its row with
// esfm_edge_grad. The point side's
// rows are D = 4 (P^T g), one lane each (float4); the camera side's D = 12
// (g x X), one lane each (Row12). A short segment takes a lane group of 8
// lanes, four to a warp; a long one a block of 8 warps (4 blocks and 64
// registers per SM, as the segment max's); a hub's edges come in parts of
// 2,048 whose partial rows a merge launch per side adds in part order. The
// camera side's blocks come first in the one launch, the points' after
// (points first: 1.1-1.2x as long on every bench scene).
// The first design gave a point a warp (the dense scene's ~14-edge points
// left 18 of 32 lanes idle, the power-law's ~3-edge points 29) and a camera
// a 256-thread block walking one edge per thread with nothing loaded ahead
// (a hub camera's 8,192 edges: 32 dependent rounds), its 12 x 256 shared
// tree with 8 barriers, the camera blocks last in the grid.

#include "segment.cuh"

namespace gasfm {

constexpr int kTermsThreads = 256;
constexpr int kTermsWarps = kTermsThreads / 32;
// Edges per thread of the forward: 1, 2 and 4 take 0.0047, 0.0045 and
// 0.0049 ms a call on the dense scene, 0.0037, 0.0035 and 0.0043 on the wide
// one; 512-thread blocks of 2, 0.0045 and 0.0039, and 0.0043 against 0.0036
// on the hub-parts graph (tools/loss_variants.py, H100 80GB HBM3, 700 W).
constexpr int kTermsEdges = 2;
// The longest point whose backward rows a lane group walks (see
// EdgeGradRows).
constexpr int kLossLongPoint = 32;

// ESFM term of one edge, as (term, pos).
__device__ __forceinline__ void esfm_term(const float4 p0, const float4 p1, const float4 p2,
                                          const float4 x, const float2 o, float margin,
                                          int hinge, float hinge_w, float& term, float& pos_f) {
  const float pr0 = p0.x * x.x + p0.y * x.y + p0.z * x.z + p0.w * x.w;
  const float pr1 = p1.x * x.x + p1.y * x.y + p1.z * x.z + p1.w * x.w;
  const float depth = p2.x * x.x + p2.y * x.y + p2.z * x.z + p2.w * x.w;
  const bool pos = hinge ? depth >= margin : fabsf(depth) >= margin;
  const float den = pos ? depth : 1.f;
  const float rx = pr0 / den - o.x;
  const float ry = pr1 / den - o.y;
  const float sq = rx * rx + ry * ry;
  const float rn = sq > 0.f ? sqrtf(sq) : 0.f;
  term = pos ? rn : (margin - depth) * hinge_w;
  pos_f = pos ? 1.f : 0.f;
}

// atomicInc(c, wrap) at gpu scope with acquire-release order: this thread's
// earlier writes are visible to whoever reads the counter after it, and
// what was written before earlier increments is visible to this thread.
__device__ __forceinline__ unsigned int ticket_inc(unsigned int* c, unsigned int wrap) {
  unsigned int old;
  asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(c), "r"(wrap)
               : "memory");
  return old;
}

// The sums of v (3 per thread) over the block: each warp's by group_sum,
// then the warps' in warp order; thread 0 gets them. Every thread must call
// it.
__device__ __forceinline__ void block_sum3(float (&v)[3], float (*sw)[kTermsWarps]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 3; ++k) v[k] = group_sum(v[k], 32);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) sw[k][warp] = v[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float t = 0.f;
      for (int w = 0; w < kTermsWarps; ++w) t += sw[k][w];
      v[k] = t;
    }
  }
}

// Block b takes the edges b * kTermsThreads * kTermsEdges + t + j *
// kTermsThreads (thread t, j = 0 .. kTermsEdges - 1), its sums in j order;
// writes its partial triple to partials[3 b ..]; the last block to take a
// ticket sums the nb partials: thread t those of blocks t, t + 256, ... in
// order, then block_sum3.
__global__ void __launch_bounds__(kTermsThreads) esfm_terms_kernel(
    const float4* __restrict__ P4, const float4* __restrict__ X4, const float2* __restrict__ uv,
    const int* __restrict__ cam_idx, const int* __restrict__ pt_idx, int E, float margin,
    int hinge, float hinge_w, float* __restrict__ partials, unsigned int* __restrict__ ticket,
    float* __restrict__ out) {
  __shared__ float sw[3][kTermsWarps];
  __shared__ bool last;
  const int base = blockIdx.x * kTermsThreads * kTermsEdges + threadIdx.x;
  int cam[kTermsEdges], pt[kTermsEdges];
  float2 o[kTermsEdges];
#pragma unroll
  for (int j = 0; j < kTermsEdges; ++j) {
    const int e = base + j * kTermsThreads;
    cam[j] = pt[j] = 0;
    o[j] = make_float2(0.f, 0.f);
    if (e < E) {
      cam[j] = __ldg(cam_idx + e);
      pt[j] = __ldg(pt_idx + e);
      o[j] = __ldg(uv + e);
    }
  }
  float4 p[kTermsEdges][3], x[kTermsEdges];
#pragma unroll
  for (int j = 0; j < kTermsEdges; ++j) {
    if (base + j * kTermsThreads < E) {
      const float4* pc = P4 + 3 * (size_t)cam[j];
      p[j][0] = __ldg(pc);
      p[j][1] = __ldg(pc + 1);
      p[j][2] = __ldg(pc + 2);
      x[j] = __ldg(X4 + pt[j]);
    }
  }
  float v[3] = {0.f, 0.f, 0.f};  // sum of terms, edges, positive edges
#pragma unroll
  for (int j = 0; j < kTermsEdges; ++j) {
    if (base + j * kTermsThreads < E) {
      float term, pos;
      esfm_term(p[j][0], p[j][1], p[j][2], x[j], o[j], margin, hinge, hinge_w, term, pos);
      v[0] += term;
      v[1] += 1.f;
      v[2] += pos;
    }
  }
  block_sum3(v, sw);
  const unsigned int nb = gridDim.x;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) partials[3 * (size_t)blockIdx.x + k] = v[k];
    last = ticket_inc(ticket, nb - 1) == nb - 1;
  }
  __syncthreads();
  if (!last) return;
  float t[3] = {0.f, 0.f, 0.f};
  for (unsigned int b = threadIdx.x; b < nb; b += kTermsThreads) {
#pragma unroll
    for (int k = 0; k < 3; ++k) t[k] += __ldcg(partials + 3 * (size_t)b + k);
  }
  block_sum3(t, sw);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) out[k] = t[k];
  }
}

// ---- backward ------------------------------------------------------------------

constexpr int kEqNone = 0, kEqAll = 1, kEqValidOnly = 2;

// g = d loss / d proj of edge e (after equalization), with the camera row p
// and the point x it was computed from. Mirrors _bwd_kernel line for line.
__device__ __forceinline__ void esfm_edge_grad(const float (&p)[12], const float4 x,
                                               float u, float v, float margin, int hinge,
                                               float hinge_w, int eq_mode, float coef,
                                               float icnt, float g[3]) {
  float pr[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    pr[i] = p[4 * i] * x.x + p[4 * i + 1] * x.y + p[4 * i + 2] * x.z + p[4 * i + 3] * x.w;
  }
  const float depth = pr[2];
  const bool pos = hinge ? depth >= margin : fabsf(depth) >= margin;
  const float denom = pos ? depth : 1.f;
  const float inv_d = 1.f / denom;
  const float px = pr[0] / denom, py = pr[1] / denom;
  const float rx = px - u, ry = py - v;
  const float sq = rx * rx + ry * ry;
  const bool nz = sq > 0.f;
  const float inv_rn = nz ? 1.f / sqrtf(sq) : 0.f;
  const float hx = rx * inv_rn, hy = ry * inv_rn;  // exactly 0 at the 0-residual tie
  float g0 = pos ? hx * inv_d * coef : 0.f;
  float g1 = pos ? hy * inv_d * coef : 0.f;
  const float rdotp = hx * (pr[0] * inv_d) + hy * (pr[1] * inv_d);
  float gd = (pos ? -rdotp * inv_d : -hinge_w) * coef;
  if (eq_mode != kEqNone && (eq_mode == kEqAll || pos)) {
    const float n3 = sqrtf(g0 * g0 + g1 * g1 + gd * gd);
    const float scale = icnt / fmaxf(n3, 1e-12f);
    g0 *= scale;
    g1 *= scale;
    gd *= scale;
  }
  g[0] = g0;
  g[1] = g1;
  g[2] = gd;
}

__device__ __forceinline__ void unpack_row(const float4 a, const float4 b, const float4 c,
                                           float (&p)[12]) {
  p[0] = a.x, p[1] = a.y, p[2] = a.z, p[3] = a.w;
  p[4] = b.x, p[5] = b.y, p[6] = b.z, p[7] = b.w;
  p[8] = c.x, p[9] = c.y, p[10] = c.z, p[11] = c.w;
}

// What every edge's gradient row is computed from.
struct EdgeGradArgs {
  const float4* P4;  // (m, 3) float4: the camera rows
  const float4* X4;  // (n,) the points
  const float2* uv;  // (E,) the observations
  const int* cam_idx;
  const int* pt_idx;
  const float* coef_p;   // d loss / d (edge sum), on the card
  const float* count_p;  // the equalization count, on the card
  float margin, hinge_w;
  int hinge, eq_mode;
};

// The cotangent scalars of a segment's view: coef and 1 / max(count, 1).
__device__ __forceinline__ void coef_icnt(const EdgeGradArgs& a, float& coef, float& icnt) {
  coef = __ldg(a.coef_p);
  icnt = 1.f / fmaxf(__ldg(a.count_p), 1.f);
}

// The row source of the walk (segment.cuh's TableRows interface) whose row
// for edge e of a segment is its gradient: on the point side (kCamera false,
// segments the points, VEC = 4) P[cam]^T g, the point's X shared by its
// rows; on the camera side (VEC = 12, segments the cameras through
// cam_perm) g x X[pt], the camera's P row shared. kAhead: rows a lane
// fetches before it makes them, their operands held meanwhile (14 floats a
// row on the point side, 6 on the camera side) under the 64-register cap.
// Device ms per call (tools/loss_variants.py, H100 80GB HBM3, 700 W): 4
// point rows spill 272 bytes and take 1.2-1.6x as long; 2, 3 and 4 camera
// rows (0, 12 and 4 bytes of spills) take 0.0077, 0.0077 and 0.0083 on the
// dense scene, 0.0076, 0.0073 and 0.0069 on the wide one, 0.0104, 0.0101
// and 0.0100 on the hub camera. kLongAbove: the longest segment a lane
// group walks; a longer one takes a block. A lane group's rows are a chain
// of ceil(rows / 8 / kAhead) rounds of dependent loads, four for a 64-edge
// point, so the points stop at kLossLongPoint (power-law scene 0.0076
// against 0.0084 at 64; at 16 or 24 the dense scene's ~14-edge points take
// blocks, 2.0x and 1.2x slower), the cameras at the sum's 64 (the wide
// scene's ~37-edge cameras stay four to a warp).
template <bool kCamera>
struct EdgeGradRows;

template <>
struct EdgeGradRows<false> {
  static constexpr int kLongAbove = kLossLongPoint;
  struct View {
    struct Fetched {
      float4 p0, p1, p2;
      float2 o;
    };
    static constexpr int kAhead = 2;
    EdgeGradArgs a;
    float4 x;
    float coef, icnt;
    __device__ __forceinline__ Fetched fetch(int e, int) const {
      const float4* pc = a.P4 + 3 * (size_t)__ldg(a.cam_idx + e);
      return Fetched{__ldg(pc), __ldg(pc + 1), __ldg(pc + 2), __ldg(a.uv + e)};
    }
    __device__ __forceinline__ float4 row(const Fetched& f, int) const {
      float p[12], g[3];
      unpack_row(f.p0, f.p1, f.p2, p);
      esfm_edge_grad(p, x, f.o.x, f.o.y, a.margin, a.hinge, a.hinge_w, a.eq_mode, coef, icnt,
                     g);
      float d[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) d[j] = p[j] * g[0] + p[4 + j] * g[1] + p[8 + j] * g[2];
      return make_float4(d[0], d[1], d[2], d[3]);
    }
  };
  EdgeGradArgs a;
  __device__ __forceinline__ View at(int s) const {
    View v{a, make_float4(0.f, 0.f, 0.f, 0.f), 0.f, 0.f};
    if (s >= 0) {
      v.x = __ldg(a.X4 + s);
      coef_icnt(a, v.coef, v.icnt);
    }
    return v;
  }
};

template <>
struct EdgeGradRows<true> {
  static constexpr int kLongAbove = kSumRows;
  struct View {
    struct Fetched {
      float4 x;
      float2 o;
    };
    static constexpr int kAhead = 3;
    EdgeGradArgs a;
    float4 p0, p1, p2;
    float coef, icnt;
    __device__ __forceinline__ Fetched fetch(int e, int) const {
      return Fetched{__ldg(a.X4 + __ldg(a.pt_idx + e)), __ldg(a.uv + e)};
    }
    __device__ __forceinline__ Row12 row(const Fetched& f, int) const {
      float p[12], g[3];
      unpack_row(p0, p1, p2, p);
      esfm_edge_grad(p, f.x, f.o.x, f.o.y, a.margin, a.hinge, a.hinge_w, a.eq_mode, coef, icnt,
                     g);
      return Row12{vscale(f.x, g[0]), vscale(f.x, g[1]), vscale(f.x, g[2])};
    }
  };
  EdgeGradArgs a;
  __device__ __forceinline__ View at(int s) const {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    View v{a, z, z, z, 0.f, 0.f};
    if (s >= 0) {
      const float4* pc = a.P4 + 3 * (size_t)s;
      v.p0 = __ldg(pc);
      v.p1 = __ldg(pc + 1);
      v.p2 = __ldg(pc + 2);
      coef_icnt(a, v.coef, v.icnt);
    }
    return v;
  }
};

// Blocks of 8 warps, as the segment max's: the gradient's operands need more
// registers than a loaded row, and 32-warp blocks cap a thread at 32. 16
// warps take 1.1x as long on the power-law and wide scenes; 4 warps 0.9x
// there but 1.25x on the dense scene, 1.3x on the hub camera and 1.5x on
// the hub-parts graph (tools/loss_variants.py).
constexpr int kLossBwdWarps = kMaxBlockWarps;

// Both table gradients in one launch: blocks [0, cam_blocks) the camera
// side's walk (dP), the rest the point side's (dX).
__global__ void __launch_bounds__(kLossBwdWarps * 32, kSumBlockWarps / kLossBwdWarps)
    esfm_terms_bwd_kernel(EdgeGradArgs a, const int* __restrict__ cam_ptr,
                          const int* __restrict__ cam_perm, SegmentSplit cam_sp, int n_cams,
                          const int* __restrict__ pt_ptr, SegmentSplit pt_sp, int n_pts, int E,
                          int cam_blocks, float* __restrict__ dP, float* __restrict__ cam_part,
                          float* __restrict__ dX, float* __restrict__ pt_part) {
  __shared__ __align__(16) float sw[kLossBwdWarps][kSegMaxD];
  if ((int)blockIdx.x < cam_blocks) {
    segment_sum_block<12, 1, false, SumRed, kLossBwdWarps>(
        blockIdx.x, EdgeGradRows<true>{a}, 1, cam_ptr, cam_perm, E, cam_sp, n_cams, 0, 1.f, dP,
        cam_part, nullptr, nullptr, sw);
  } else {
    segment_sum_block<4, 1, false, SumRed, kLossBwdWarps>(
        blockIdx.x - cam_blocks, EdgeGradRows<false>{a}, 1, pt_ptr, nullptr, E, pt_sp, n_pts, 0,
        1.f, dX, pt_part, nullptr, nullptr, sw);
  }
}

}  // namespace gasfm

// partials: (ceil(E / 1024), 3) scratch; ticket: a counter at 0, left at 0
// (see the header); out: (3,) = (sum of terms, #edges, #pos). P_flat and
// Xt 16-byte aligned, uv 8-byte aligned.
extern "C" int gasfm_esfm_terms(const float* P, const float* Xt, const float* uv,
                                const int* cam_idx, const int* pt_idx, int E,
                                float margin, int hinge, float hinge_w,
                                float* partials, unsigned int* ticket, float* out,
                                void* stream) {
  using namespace gasfm;
  const int nb = E > 0 ? blocks_of(E, kTermsThreads * kTermsEdges) : 1;
  esfm_terms_kernel<<<nb, kTermsThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(P), reinterpret_cast<const float4*>(Xt),
      reinterpret_cast<const float2*>(uv), cam_idx, pt_idx, E, margin, hinge, hinge_w, partials,
      ticket, out);
  return (int)cudaGetLastError();
}

// coef: device pointer to d loss / d (edge sum); count: device pointer to the
// equalization count (valid-and-positive edges for valid_only, all edges for
// all), read as 1 / max(count, 1). eq_mode: 0 none, 1 all, 2 valid_only.
// pt_split / cam_split: the sides' splits at kSumPartRows, kSumRows
// (SegmentSplit layout); pt_part (pt_chunks, 4) and cam_part (cam_chunks,
// 12): scratch, read and written only where a segment has several parts
// (NULL otherwise). dP (m, 12), dX (n, 4). P, Xt, dP, dX and the parts
// 16-byte aligned, uv 8-byte.
extern "C" int gasfm_esfm_terms_bwd(const float* P, const float* Xt, const float* uv,
                                    const int* cam_idx, const int* pt_idx, const int* pt_ptr,
                                    const int* cam_ptr, const int* cam_perm, int E, int n_pts,
                                    int n_cams, float margin, int hinge, float hinge_w,
                                    int eq_mode, const float* coef, const float* count,
                                    const int* pt_split, int pt_long, int pt_chunks,
                                    const int* cam_split, int cam_long, int cam_chunks,
                                    float* pt_part, float* cam_part, float* dP, float* dX,
                                    void* stream) {
  using namespace gasfm;
  cudaStream_t s = (cudaStream_t)stream;
  const EdgeGradArgs a{reinterpret_cast<const float4*>(P), reinterpret_cast<const float4*>(Xt),
                       reinterpret_cast<const float2*>(uv), cam_idx, pt_idx, coef, count,
                       margin, hinge_w, hinge, eq_mode};
  const SegmentSplit psp(pt_split, pt_long, pt_chunks), csp(cam_split, cam_long, cam_chunks);
  const int cam_blocks = sum_blocks<12, 1, kLossBwdWarps>(n_cams, csp, 0);
  const int grid = cam_blocks + sum_blocks<4, 1, kLossBwdWarps>(n_pts, psp, 0);
  if (grid > 0) {
    esfm_terms_bwd_kernel<<<grid, kLossBwdWarps * 32, 0, s>>>(
        a, cam_ptr, cam_perm, csp, n_cams, pt_ptr, psp, n_pts, E, cam_blocks, dP, cam_part, dX,
        pt_part);
  }
  if (csp.n_chunks > csp.n_long) {  // a hub camera: its parts' partial rows
    segment_sum_merge_kernel<4><<<csp.n_long, kSumMergeWarps * 32, 0, s>>>(cam_part, 3, csp, 1.f,
                                                                          dP);
  }
  if (psp.n_chunks > psp.n_long) {  // a hub point
    segment_sum_merge_kernel<4><<<psp.n_long, kSumMergeWarps * 32, 0, s>>>(pt_part, 1, psp, 1.f,
                                                                          dX);
  }
  return (int)cudaGetLastError();
}
