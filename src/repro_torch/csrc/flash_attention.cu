// K3: causal / sliding-window attention forward with online softmax.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py ::
// _flash_kernel (launched by flash_attention, pallas_call at kernel.py:86).
// Computes what it computes: s = (q * hd^-0.5) k^T with masked scores at
// -1e30, a running max m, sum l and f32 accumulator over the kv tiles,
// o = acc / max(l, 1e-30) in q's dtype and lse = m + log(max(l, 1e-30)) in
// f32. q, k, v are (B, H, S, hd) in f32 or bf16.
//
// What bounds it on this card: operations. At hd = 128 a causal call does
// about S^2 hd / 2 multiply-adds twice (q k^T and p v) per (b, h) and moves
// 4 S hd elements, ~64 operations per byte in f32: far above the ~20 an
// H100 sustains in f32 outside the tensor cores (67 T/s over 3.35 TB/s).
//
// What the design does about it: nothing O(S^2) leaves the block. One
// block of 256 threads per (b, h, 64-row q tile) keeps its q tile, the
// current k and v tiles and the tile of probabilities in shared memory (f32,
// rows padded by one word so that the 16 rows a warp reads at one column
// fall in 16 banks); each thread keeps 4 x 4 scores and 4 rows x hd/16
// columns of the accumulator, with the row statistics, in registers, and a
// row's max and sum are 16-lane shuffle reductions. Fully masked kv tiles
// are skipped (about half of them when causal). The products run on the
// f32 CUDA cores with the accurate expf/logf (no --use_fast_math); the
// tensor cores (wgmma on bf16, TMA-fed) are later work.
#include "flash_common.cuh"

namespace {

using namespace flash;

template <typename T, int HDMAX>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int S, int hd, int causal,
                     int window, float scale) {
  using G = Tile<HDMAX>;
  constexpr int BLK = G::BLK, TR = G::TR, TC = G::TC;
  extern __shared__ float smem[];
  const int st = hd + 1;                 // padded row stride
  float* Qs = smem;                      // (BLK, st), q * scale
  float* Ks = Qs + BLK * st;             // (BLK, st)
  float* Vs = Ks + BLK * st;             // (BLK, st)
  float* Ps = Vs + BLK * st;             // (BLK, BLK + 1) probabilities

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * BLK;
  const size_t base = (size_t)blockIdx.y * S * hd;
  const int ntiles = (S + BLK - 1) / BLK;

  load_tile(Qs, q + base, q0, BLK, S, hd, st, scale);

  float m[TR], l[TR], acc[TR][TC];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < TC; ++c) acc[i][c] = 0.f;
  }

  int lo, hi;
  kv_range(q0, min(q0 + BLK, S) - 1, BLK, ntiles, causal, window, &lo, &hi);
  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * BLK;
    __syncthreads();  // the previous tile's readers are done
    load_tile(Ks, k + base, k0, BLK, S, hd, st, 1.f);
    load_tile(Vs, v + base, k0, BLK, S, hd, st, 1.f);
    __syncthreads();

    float s[TR][TR];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TR; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      float qa[TR], kb[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i) qa[i] = Qs[(ty + 16 * i) * st + d];
#pragma unroll
      for (int j = 0; j < TR; ++j) kb[j] = Ks[(tx + 16 * j) * st + d];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TR; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int r = ty + 16 * i, qp = q0 + r;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < TR; ++j) {
        if (!allowed(qp, k0 + tx + 16 * j, S, causal, window))
          s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < TR; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[r * (BLK + 1) + tx + 16 * j] = p;
        ps += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < TC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BLK; ++j) {
      float vb[TC];
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const int col = tx + 16 * c;
        vb[c] = col < hd ? Vs[j * st + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const float p = Ps[(ty + 16 * i) * (BLK + 1) + j];
#pragma unroll
        for (int c = 0; c < TC; ++c) acc[i][c] = fmaf(p, vb[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= S) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    const size_t row = base + (size_t)qp * hd;
#pragma unroll
    for (int c = 0; c < TC; ++c) {
      const int col = tx + 16 * c;
      if (col < hd) o[row + col] = from_f32<T>(acc[i][c] / lc);
    }
    if (tx == 0) lse[(size_t)blockIdx.y * S + qp] = m[i] + logf(lc);
  }
}

template <int HDMAX>
int smem_bytes(int hd) {
  constexpr int BLK = Tile<HDMAX>::BLK;
  return (3 * BLK * (hd + 1) + BLK * (BLK + 1)) * (int)sizeof(float);
}

template <typename T, int HDMAX>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int BH, int S, int hd, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr int BLK = Tile<HDMAX>::BLK;
  const int smem = smem_bytes<HDMAX>(hd);
  auto kern = flash_fwd_kernel<T, HDMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BLK - 1) / BLK, BH);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), S, hd, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, void* lse,
             int BH, int S, int hd, int causal, int window, float scale,
             cudaStream_t s) {
  if (hd <= 64)
    return launch<T, 64>(q, k, v, o, lse, BH, S, hd, causal, window, scale, s);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, o, lse, BH, S, hd, causal, window, scale,
                          s);
  if (hd <= 256)
    return launch<T, 256>(q, k, v, o, lse, BH, S, hd, causal, window, scale,
                          s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window <= 0 means no window. Returns
// the launch's cudaGetLastError() (0 = launched).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, void* lse, int BH, int S, int hd,
                                int causal, int window, float scale,
                                int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, lse, BH, S, hd, causal, window, scale,
                           s);
  return dispatch<__nv_bfloat16>(q, k, v, o, lse, BH, S, hd, causal, window,
                                 scale, s);
}

extern "C" int flash_fwd_smem_bytes(int hd) {
  if (hd <= 64) return smem_bytes<64>(hd);
  if (hd <= 128) return smem_bytes<128>(hd);
  return smem_bytes<256>(hd);
}
