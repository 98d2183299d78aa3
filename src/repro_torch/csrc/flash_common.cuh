// Pieces shared by the flash-attention forward (K3) and backward (K4, K5)
// kernels: element conversion, the reference's mask, tile geometry and the
// 16-lane row reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash {

// The reference's mask value (kernel.py NEG_INF): exp(NEG_INF - m) is an
// exact 0 in f32 for every finite m the scores reach.
constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;  // 16 x 16: ty = tid / 16, tx = tid % 16

// Tile geometry for head dims up to HDMAX. A thread owns rows ty + 16 i
// (i < TR) of a tile, score columns tx + 16 j (j < TR) and output columns
// tx + 16 c (c < TC). 64-row tiles up to hd = 128; 32 rows above, so that
// the backward kernels' four (rows x hd) f32 tiles stay in shared memory.
template <int HDMAX>
struct Tile {
  static constexpr int BLK = HDMAX <= 128 ? 64 : 32;
  static constexpr int TR = BLK / 16;
  static constexpr int TC = HDMAX / 16;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

// Reductions over the 16 lanes of one tile row (lanes 0-15 or 16-31).
__device__ __forceinline__ float row_max(float x) {
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// rows [row0, row0 + rows) of a (S, hd) matrix into a (rows, stride) f32
// tile, times `mul`; zeros past S. Coalesced: neighbouring threads read
// neighbouring elements.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int rows, int S, int hd,
                                          int stride, float mul) {
  for (int idx = threadIdx.x; idx < rows * hd; idx += THREADS) {
    int r = idx / hd, d = idx - r * hd, g = row0 + r;
    dst[r * stride + d] = g < S ? to_f32(src[(size_t)g * hd + d]) * mul : 0.f;
  }
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
