// Adam with bf16 moments and / or an f32 master copy of bf16 weights, for
// sm_90a: one multi-tensor launch per update over every parameter tensor.
//
// Port-only: the JAX package's Adam is XLA (no pallas_call). It computes, per
// element, the update of whichever JAX optimizer the conf selects
// (gasfm_tpu/train/state.py build_optimizer):
//
//   - nu stored bf16 (train.adam_nu_dtype = bf16): the clone
//     _scale_by_adam_cast, mu and nu upcast before the decay,
//       mu' = b1 * mu + (1 - b1) * g
//       nu' = b2 * nu + (1 - b2) * (g * g)
//   - nu stored f32 (optax.adam, mu_dtype bf16 or f32):
//       mu' = (1 - b1) * g + round_mu(b1 * mu)
//       nu' = (1 - b2) * (g * g) + b2 * nu
//     where a bf16 mu times the Python float b1 is a bf16 product: b1 is
//     bf16(0.9) = 0.8984375 and the product is rounded to bf16 before the f32
//     add (optax.tree.update_moment's weak-typed `decay * t`);
//
// then, with count' = count + 1 (saturating, optax.safe_increment),
// bc1 = 1 - b1^count', bc2 = 1 - b2^count' in f32,
//
//   p' = p + (-lr) * ((mu' / bc1) / (sqrt(nu' / bc2) + eps))
//
// and mu', nu' stored in their dtypes (round to nearest even). p is the f32
// parameter, or under train.param_dtype = bf16 the f32 master, whose bf16
// rounding is also written to the model's bf16 parameter (the JAX wrapper
// _with_f32_master: its updates are the new params). The gradient is read
// in its own dtype (bf16 under the master without clipping) and upcast.
//
// Every operation is a separately rounded IEEE f32 operation (the _rn
// intrinsics, which nvcc never contracts to FMA), in the order of the plain
// PyTorch version (ops/kernels/adam.py), so the two agree bitwise on the
// card; powf is the CUDA math library's, as torch.pow's on the card.
//
// Layout: `table` holds one AdamTensor per parameter tensor (built once per
// optimizer), `chunks` one (tensor, first element) pair per chunk of at most
// `chunk` elements of one tensor, in tensor order. The gradients' addresses
// change from call to call, so they come by value, in the kernel's parameter
// block (__grid_constant__, read in place), at most kMaxTensors per launch:
// a CUDA graph records the addresses of the gradients it was recorded with.
// Blocks take chunks in a grid-stride loop; a thread takes 4 consecutive
// elements at a time (see adam_kernel).
//
// Adam's count is an int32 on the device: every block reads it, and the
// last block to finish (a ticket, reset by that block) writes count + 1,
// on the last launch of an update only. No block reads the count after any
// block has taken its ticket, so every block sees the old count.
//
// What bounds it on the H100: bytes over 3.35 TB/s. Per parameter: read g
// (4 or 2 B), mu and nu (2 or 4 B each), p (4 B); write mu, nu, p (and the
// bf16 copy, 2 B): 20 B for bf16 moments, 24 B for a bf16 mu alone, against
// 28 B for PyTorch's fused f32 Adam (g, p, mu, nu read; p, mu, nu written).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace gasfm {

constexpr int kMaxTensors = 1024;  // 8 KB of gradient addresses per launch (CUDA 12.1+: up to 32 KB of parameters)
constexpr int kAdamThreads = 256;

constexpr float kB1 = 0.9f;
constexpr float kB2 = 0.999f;
constexpr float kOneMinusB1 = (float)(1.0 - 0.9);
constexpr float kOneMinusB2 = (float)(1.0 - 0.999);
constexpr float kB1Bf16 = 0.8984375f;  // bf16(0.9)
constexpr float kEps = 1e-8f;

struct AdamTensor {
  float* p;              // f32 parameter, or the f32 master
  __nv_bfloat16* copy;   // the model's bf16 parameter under the master, else null
  void* mu;
  void* nu;
  long long n;
};

struct GradPtrs {
  const void* g[kMaxTensors];
};

template <typename T>
__device__ __forceinline__ float load_f32(const void* base, long long i);

template <>
__device__ __forceinline__ float load_f32<float>(const void* base, long long i) {
  return static_cast<const float*>(base)[i];
}

template <>
__device__ __forceinline__ float load_f32<__nv_bfloat16>(const void* base, long long i) {
  return __bfloat162float(static_cast<const __nv_bfloat16*>(base)[i]);
}

template <typename T>
__device__ __forceinline__ void store_f32(void* base, long long i, float x);

template <>
__device__ __forceinline__ void store_f32<float>(void* base, long long i, float x) {
  static_cast<float*>(base)[i] = x;
}

template <>
__device__ __forceinline__ void store_f32<__nv_bfloat16>(void* base, long long i, float x) {
  static_cast<__nv_bfloat16*>(base)[i] = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
__device__ __forceinline__ void load4(const void* base, long long i, float (&x)[4]);

template <>
__device__ __forceinline__ void load4<float>(const void* base, long long i, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(static_cast<const float*>(base) + i);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

template <>
__device__ __forceinline__ void load4<__nv_bfloat16>(const void* base, long long i,
                                                     float (&x)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(base) + i);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  x[0] = __low2float(lo);
  x[1] = __high2float(lo);
  x[2] = __low2float(hi);
  x[3] = __high2float(hi);
}

template <typename T>
__device__ __forceinline__ void store4(void* base, long long i, const float (&x)[4]);

template <>
__device__ __forceinline__ void store4<float>(void* base, long long i, const float (&x)[4]) {
  *reinterpret_cast<float4*>(static_cast<float*>(base) + i) = make_float4(x[0], x[1], x[2], x[3]);
}

template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(void* base, long long i,
                                                      const float (&x)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
  uint2 v;
  v.x = *reinterpret_cast<const unsigned*>(&lo);
  v.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(base) + i) = v;
}

// One element's update (see the top of the file): the moments in f32, the
// new parameter.
template <bool CLONE, bool MU_BF16>
__device__ __forceinline__ void adam_element(float g, float m, float v, float p, float bc1,
                                             float bc2, float neg_lr, float& m1, float& v1,
                                             float& p1) {
  const float gg = __fmul_rn(g, g);
  if (CLONE) {
    m1 = __fadd_rn(__fmul_rn(kB1, m), __fmul_rn(kOneMinusB1, g));
    v1 = __fadd_rn(__fmul_rn(kB2, v), __fmul_rn(kOneMinusB2, gg));
  } else {
    const float bm = MU_BF16 ? round_bf16(__fmul_rn(kB1Bf16, m)) : __fmul_rn(kB1, m);
    m1 = __fadd_rn(__fmul_rn(kOneMinusB1, g), bm);
    v1 = __fadd_rn(__fmul_rn(kOneMinusB2, gg), __fmul_rn(kB2, v));
  }
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v1, bc2)), kEps);
  const float step = __fdiv_rn(__fdiv_rn(m1, bc1), den);
  p1 = __fadd_rn(p, __fmul_rn(neg_lr, step));
}

__device__ __forceinline__ unsigned long long address_bits(const void* p) {
  return (unsigned long long)(uintptr_t)p;
}

// A chunk is taken 4 elements per thread (16-byte f32 and 8-byte bf16
// vectors) where every array of its tensor starts on 16 bytes (a chunk
// starts at a multiple of 4 elements), its last n % 4 elements one per
// thread; a tensor with an unaligned array (a gradient that is a view) one
// element per thread throughout. Both take the same per-element operations.
template <typename MuT, typename NuT, typename GT, bool MASTER>
__global__ void __launch_bounds__(kAdamThreads) adam_kernel(
    const __grid_constant__ GradPtrs grads, int first_tensor,
    const AdamTensor* __restrict__ table, const int2* __restrict__ chunks, int n_chunks,
    int chunk, int* __restrict__ count, int* __restrict__ ticket, const float* __restrict__ lr,
    int write_count) {
  constexpr bool kClone = sizeof(NuT) == 2;  // nu bf16: _scale_by_adam_cast
  constexpr bool kMuBf16 = sizeof(MuT) == 2;
  const int c0 = *count;
  const int c1 = c0 < INT_MAX ? c0 + 1 : c0;
  const float bc1 = __fadd_rn(1.f, -powf(kB1, (float)c1));
  const float bc2 = __fadd_rn(1.f, -powf(kB2, (float)c1));
  const float neg_lr = -*lr;

  for (int k = blockIdx.x; k < n_chunks; k += gridDim.x) {
    const int2 ck = chunks[k];
    const AdamTensor t = table[ck.x];
    const void* g_base = grads.g[ck.x - first_tensor];
    const long long start = ck.y;
    const long long end = min(start + (long long)chunk, t.n);
    const unsigned long long bits = address_bits(g_base) | address_bits(t.mu) |
                                    address_bits(t.nu) | address_bits(t.p) |
                                    (MASTER ? address_bits(t.copy) : 0ull);
    long long scalar_from = start;
    if ((bits & 15ull) == 0) {
      const long long n4 = (end - start) / 4;
      for (long long j = threadIdx.x; j < n4; j += kAdamThreads) {
        const long long i = start + 4 * j;
        float g[4], m[4], v[4], p[4], m1[4], v1[4], p1[4];
        load4<GT>(g_base, i, g);
        load4<MuT>(t.mu, i, m);
        load4<NuT>(t.nu, i, v);
        load4<float>(t.p, i, p);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          adam_element<kClone, kMuBf16>(g[u], m[u], v[u], p[u], bc1, bc2, neg_lr, m1[u], v1[u],
                                        p1[u]);
        }
        store4<MuT>(t.mu, i, m1);
        store4<NuT>(t.nu, i, v1);
        store4<float>(t.p, i, p1);
        if (MASTER) store4<__nv_bfloat16>(t.copy, i, p1);
      }
      scalar_from = start + 4 * n4;
    }
    for (long long i = scalar_from + threadIdx.x; i < end; i += kAdamThreads) {
      float m1, v1, p1;
      adam_element<kClone, kMuBf16>(load_f32<GT>(g_base, i), load_f32<MuT>(t.mu, i),
                                    load_f32<NuT>(t.nu, i), t.p[i], bc1, bc2, neg_lr, m1, v1,
                                    p1);
      store_f32<MuT>(t.mu, i, m1);
      store_f32<NuT>(t.nu, i, v1);
      t.p[i] = p1;
      if (MASTER) t.copy[i] = __float2bfloat16_rn(p1);
    }
  }

  if (write_count) {
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      if (atomicAdd(ticket, 1) == (int)gridDim.x - 1) {
        *count = c1;
        *ticket = 0;
      }
    }
  }
}

template <typename MuT, typename NuT, typename GT, bool MASTER>
void launch_adam(const GradPtrs& grads, int first_tensor, const AdamTensor* table,
                 const int2* chunks, int n_chunks, int chunk, int* count, int* ticket,
                 const float* lr, int write_count, int grid, cudaStream_t s) {
  adam_kernel<MuT, NuT, GT, MASTER><<<grid, kAdamThreads, 0, s>>>(
      grads, first_tensor, table, chunks, n_chunks, chunk, count, ticket, lr, write_count);
}

template <typename MuT, typename NuT>
int dispatch_grad(int g_bf16, int master, const GradPtrs& grads, int first_tensor,
                  const AdamTensor* table, const int2* chunks, int n_chunks, int chunk,
                  int* count, int* ticket, const float* lr, int write_count, int grid,
                  cudaStream_t s) {
  if (master) {
    if (g_bf16) {
      launch_adam<MuT, NuT, __nv_bfloat16, true>(grads, first_tensor, table, chunks, n_chunks,
                                                 chunk, count, ticket, lr, write_count, grid, s);
    } else {
      launch_adam<MuT, NuT, float, true>(grads, first_tensor, table, chunks, n_chunks, chunk,
                                         count, ticket, lr, write_count, grid, s);
    }
  } else {
    if (g_bf16) return (int)cudaErrorInvalidValue;  // bf16 gradients come with the master
    launch_adam<MuT, NuT, float, false>(grads, first_tensor, table, chunks, n_chunks, chunk,
                                        count, ticket, lr, write_count, grid, s);
  }
  return 0;
}

}  // namespace gasfm

// One launch of the update over tensors [first_tensor, first_tensor +
// n_tensors) of `table`: `grad_ptrs` (host array, n_tensors <= 1024) their
// gradients' device addresses, `chunks` (n_chunks, 2) int32 on the device
// their chunks, count / ticket int32 scalars on the device, lr an f32
// scalar on the device. write_count: 1 on an update's last launch.
extern "C" int gasfm_adam(int mu_bf16, int nu_bf16, int g_bf16, int master,
                          const void* const* grad_ptrs, int first_tensor, int n_tensors,
                          const void* table, const int* chunks, int n_chunks, int chunk,
                          int* count, int* ticket, const float* lr, int write_count, int grid,
                          void* stream) {
  using namespace gasfm;
  if (n_tensors < 0 || n_tensors > kMaxTensors || grid < 1) return (int)cudaErrorInvalidValue;
  GradPtrs grads;
  for (int i = 0; i < n_tensors; ++i) grads.g[i] = grad_ptrs[i];
  for (int i = n_tensors; i < kMaxTensors; ++i) grads.g[i] = nullptr;
  cudaStream_t s = (cudaStream_t)stream;
  const AdamTensor* tab = static_cast<const AdamTensor*>(table);
  const int2* ck = reinterpret_cast<const int2*>(chunks);
  int code;
  if (mu_bf16 && nu_bf16) {
    code = dispatch_grad<__nv_bfloat16, __nv_bfloat16>(g_bf16, master, grads, first_tensor, tab,
                                                       ck, n_chunks, chunk, count, ticket, lr,
                                                       write_count, grid, s);
  } else if (mu_bf16) {
    code = dispatch_grad<__nv_bfloat16, float>(g_bf16, master, grads, first_tensor, tab, ck,
                                               n_chunks, chunk, count, ticket, lr, write_count,
                                               grid, s);
  } else if (nu_bf16) {
    code = dispatch_grad<float, __nv_bfloat16>(g_bf16, master, grads, first_tensor, tab, ck,
                                               n_chunks, chunk, count, ticket, lr, write_count,
                                               grid, s);
  } else {
    code = dispatch_grad<float, float>(g_bf16, master, grads, first_tensor, tab, ck, n_chunks,
                                       chunk, count, ticket, lr, write_count, grid, s);
  }
  if (code) return code;
  return (int)cudaGetLastError();
}
