// CSR segment sum and row gather, for sm_90a.
//
// Replaces the TPU kernels of gasfm_tpu/ops/pallas/segment_kernels.py:
//   - gasfm_segment_sum <- _segment_sum_raw (segment_sum_kernel, the dense
//     one-hot sum used for the cameras) and _wseg_sum_raw
//     (windowed_segment_sum, the point-window sum);
//   - gasfm_gather_rows <- _gather_rows_raw (gather_rows_kernel) and
//     _wgather_raw (windowed_gather).
// The TPU kernels gather and scatter by one-hot matmuls on the MXU, over
// point windows or the whole (<= 1024-row) camera table. Here the edges of a
// point are contiguous in the point-major layout and the edges of a camera
// are listed by the camera CSR (cam_perm), so "windowed" and "dense"
// collapse into one CSR walk per segment: the point side with perm = NULL,
// the camera side through perm. Each kernel is the other's backward.
//
// What bounds them on the H100: bytes over 3.35 TB/s. A segment sum reads
// its E x D input once and writes S x D (plus the offsets and, on the camera
// side, the permutation): ~127 MB at D = 256 on the dense bench scene, ~38
// us. The design against it (segment.cuh): 16-byte loads where D % 4 == 0,
// row groups so narrow rows keep every lane busy, a warp per point (the
// point segments are short: ~14 and ~3 edges on the two bench scenes) and a
// block of 32 warps per camera (the camera segments are few and long), each
// sum in registers and merged in a fixed order. The gather writes E x D and
// reads each table row once per edge (the tables are small enough to stay in
// the 50 MB L2): one thread per output vector, consecutive threads on
// consecutive addresses.
#include "segment.cuh"

namespace gasfm {

constexpr int kGatherThreads = 256;

// out[e] = table[ids[e]], Dv vectors per row.
template <int VEC>
__global__ void __launch_bounds__(kGatherThreads) gather_rows_kernel(
    const float* __restrict__ table, int Dv, const int* __restrict__ ids, long long total,
    float* __restrict__ out) {
  using T = typename VecT<VEC>::T;
  const T* tab = reinterpret_cast<const T*>(table);
  T* o = reinterpret_cast<T*>(out);
  for (long long i = (long long)blockIdx.x * kGatherThreads + threadIdx.x; i < total;
       i += (long long)gridDim.x * kGatherThreads) {
    const long long e = i / Dv;
    const int c = (int)(i - e * Dv);
    o[i] = tab[(size_t)ids[e] * Dv + c];
  }
}

template <int VEC>
void launch_gather(const float* table, int D, const int* ids, int E, float* out,
                   cudaStream_t s) {
  const int Dv = D / VEC;
  const long long total = (long long)E * Dv;
  if (total <= 0) return;
  const long long want = (total + kGatherThreads - 1) / kGatherThreads;
  const int grid = (int)(want < (1LL << 20) ? want : (1LL << 20));
  gather_rows_kernel<VEC><<<grid, kGatherThreads, 0, s>>>(table, Dv, ids, total, out);
}

}  // namespace gasfm

// out (n_seg, D) = per-segment sums of data (E, D): the rows ptr[s] ..
// ptr[s+1] (perm == NULL, the point CSR) or perm[ptr[s]] .. (the camera
// CSR). Empty segments give 0. 1 <= D <= 256; 16-byte aligned rows when
// D % 4 == 0.
extern "C" int gasfm_segment_sum(const float* data, int D, const int* ptr, const int* perm,
                                 int n_seg, float* out, void* stream) {
  gasfm::segment_sum(data, D, ptr, perm, n_seg, 1.f, out, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// out (E, D) = table[ids] with table (S, D); 1 <= D <= 256.
extern "C" int gasfm_gather_rows(const float* table, int D, const int* ids, int E, float* out,
                                 void* stream) {
  using namespace gasfm;
  cudaStream_t s = (cudaStream_t)stream;
  if (D % 4 == 0) {
    launch_gather<4>(table, D, ids, E, out, s);
  } else {
    launch_gather<1>(table, D, ids, E, out, s);
  }
  return (int)cudaGetLastError();
}
