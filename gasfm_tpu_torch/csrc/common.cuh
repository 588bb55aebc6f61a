// Device helpers shared by the port's kernels (sm_90a, float32 throughout).
//
// Edge-stream convention of every kernel here: one warp owns one edge (or
// one segment), and lane j holds feature j of a width-D row (D <= 32), so a
// row is one coalesced 4*D-byte access. Multi-head rows are head-major: head
// h owns lanes [h*C, (h+1)*C) with C a power of two, and per-head sums are
// butterfly shuffles inside those lane groups.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define GASFM_FULL_MASK 0xffffffffu

namespace gasfm {

__device__ __forceinline__ float leaky_relu(float z, float slope) {
  return z >= 0.f ? z : slope * z;
}

// Sum over aligned groups of `width` lanes (a power of two <= 32); every lane
// of a group receives its group's sum. All 32 lanes must take part.
__device__ __forceinline__ float group_sum(float v, int width) {
  for (int off = width >> 1; off > 0; off >>= 1) {
    v += __shfl_xor_sync(GASFM_FULL_MASK, v, off);
  }
  return v;
}

// Online-softmax accumulator of one feature lane: the running max `m` of its
// head's logits, and the denominator and numerator taken at shift `m`. Any
// per-segment shift cancels in num / den, so the result is the segment
// softmax-weighted sum exactly, whatever order the edges arrive in.
struct Online {
  float m, den, num;

  __device__ __forceinline__ void init() {
    m = -INFINITY;
    den = 0.f;
    num = 0.f;
  }

  __device__ __forceinline__ void push(float logit, float x) {
    if (logit <= m) {
      const float p = expf(logit - m);
      den += p;
      num = fmaf(p, x, num);
    } else {  // new max: rescale what was summed so far (0 on the first edge)
      const float a = expf(m - logit);
      den = fmaf(den, a, 1.f);
      num = fmaf(num, a, x);
      m = logit;
    }
  }

  __device__ __forceinline__ void merge(float om, float oden, float onum) {
    const float m_new = fmaxf(m, om);
    if (m_new == -INFINITY) return;  // both empty
    const float a = expf(m - m_new);
    const float b = expf(om - m_new);
    den = den * a + oden * b;
    num = num * a + onum * b;
    m = m_new;
  }

  // An empty segment aggregates to 0 (the den > 0 guard of the reference).
  __device__ __forceinline__ float finish() const {
    return den > 0.f ? num / den : 0.f;
  }
};

}  // namespace gasfm
