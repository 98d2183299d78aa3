// Pieces shared by the flash-attention forward (K3) and backward (K4, K5)
// kernels: the reference's mask, the rounding of outputs and the ranges of
// tiles a tile can see.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash {

// The reference's mask value (kernel.py NEG_INF): exp(NEG_INF - m) is an
// exact 0 in f32 for every finite m the scores reach.
constexpr float NEG_INF = -1e30f;

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as .astype does
}

// kernel.py:44-48: causal keeps k <= q; a window keeps k > q - window
// (window <= 0 stands for None). Rows or keys past S are padding.
__device__ __forceinline__ bool allowed(int qp, int kp, int S, int causal,
                                        int window) {
  if (qp >= S || kp >= S) return false;
  if (causal && kp > qp) return false;
  if (window > 0 && kp <= qp - window) return false;
  return true;
}

// the kv tiles [lo, hi] a q tile [q0, q1] can see (fully masked tiles are
// skipped: the reference's corr = exp(NEG_INF - m) or p = exp(NEG_INF -
// lse) zeroes their share exactly)
__device__ __forceinline__ void kv_range(int q0, int q1, int blk, int ntiles,
                                         int causal, int window, int* lo,
                                         int* hi) {
  *hi = causal ? min(q1 / blk, ntiles - 1) : ntiles - 1;
  *lo = window > 0 ? max(0, q0 - window + 1) / blk : 0;
}

// the q tiles [lo, hi] a kv tile [k0, k1] is seen by
__device__ __forceinline__ void q_range(int k0, int k1, int blk, int ntiles,
                                        int causal, int window, int* lo,
                                        int* hi) {
  *lo = causal ? k0 / blk : 0;
  *hi = window > 0 ? min(ntiles - 1, (k1 + window - 1) / blk) : ntiles - 1;
}

}  // namespace flash

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
