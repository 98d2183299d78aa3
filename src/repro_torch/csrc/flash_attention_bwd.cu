// K4 (dq) and K5 (dk, dv): the attention backward, recomputing the
// probabilities p = exp(s - lse) from (q, k, lse) so that nothing O(S^2)
// reaches device memory.
//
// Replaces the TPU kernels src/repro/kernels/flash_attention/kernel_bwd.py ::
// _dq_kernel (pallas_call at kernel_bwd.py:110) and :: _dkv_kernel
// (pallas_call at kernel_bwd.py:132). Same math: s = (q * scale) k^T masked
// at -1e30, p = exp(s - lse), dp = do v^T, ds = p (dp - drow) scale;
// dq = ds k, dv = p^T do, dk = ds^T q with the unscaled q (ds carries the
// scale). q, k, v, do are (B, H, S, hd) in f32 or bf16; lse and
// drow = rowsum(do * o) are (B, H, S) f32. Outputs take q's, k's and v's
// dtypes.
//
// What bounds it on this card: operations. dq does three (S x S x hd)
// products over the visible half (causal), dk/dv four, against 6-8 S hd
// elements moved: tens of operations per byte in f32.
//
// What the design does about it: as the forward (flash_attention.cu). dq:
// one block per (b, h, 64-row q tile) holding q, do and the current k, v
// tiles in shared memory, looping over the kv tiles it can see; dk, dv:
// one block per (b, h, 64-row kv tile) holding k, v and the current q, do
// tiles, looping over the q tiles that can see it. Each block keeps its
// accumulators in registers and writes each output element once: no
// atomics, so every run gives the same bits. Fully masked tiles are
// skipped (their p is an exact 0 in the reference). f32 CUDA cores,
// accurate expf.
#include "flash_common.cuh"

namespace {

using namespace flash;

// s[i][j] = sum_d (A[ty + 16 i, d] * mul_a) * (B[tx + 16 j, d] * mul_b)
// over two padded tiles (the reference scales q, then multiplies)
template <int TR>
__device__ __forceinline__ void tile_dot(const float* A, const float* B,
                                         int hd, int st, int ty, int tx,
                                         float mul_a, float mul_b,
                                         float (&s)[TR][TR]) {
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TR; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < hd; ++d) {
    float a[TR], b[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i) a[i] = A[(ty + 16 * i) * st + d] * mul_a;
#pragma unroll
    for (int j = 0; j < TR; ++j) b[j] = B[(tx + 16 * j) * st + d] * mul_b;
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TR; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// acc[i][c] += sum_j W[(ty + 16 i), j] * X[j, tx + 16 c], j < blk
template <int TR, int TC>
__device__ __forceinline__ void tile_acc(const float* W, int wst,
                                         const float* X, int st, int blk,
                                         int hd, int ty, int tx,
                                         float (&acc)[TR][TC]) {
#pragma unroll 4
  for (int j = 0; j < blk; ++j) {
    float x[TC];
#pragma unroll
    for (int c = 0; c < TC; ++c) {
      const int col = tx + 16 * c;
      x[c] = col < hd ? X[j * st + col] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const float w = W[(ty + 16 * i) * wst + j];
#pragma unroll
      for (int c = 0; c < TC; ++c) acc[i][c] = fmaf(w, x[c], acc[i][c]);
    }
  }
}

template <typename T, int TR, int TC>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[TR][TC],
                                           int row0, int S, int hd, int ty,
                                           int tx) {
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int g = row0 + ty + 16 * i;
    if (g >= S) continue;
#pragma unroll
    for (int c = 0; c < TC; ++c) {
      const int col = tx + 16 * c;
      if (col < hd) out[(size_t)g * hd + col] = from_f32<T>(acc[i][c]);
    }
  }
}

template <typename T, int HDMAX>
__global__ void __launch_bounds__(THREADS)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ drow,
              T* __restrict__ dq, int S, int hd, int causal, int window,
              float scale) {
  using G = Tile<HDMAX>;
  constexpr int BLK = G::BLK, TR = G::TR, TC = G::TC;
  extern __shared__ float smem[];
  const int st = hd + 1;
  float* Qs = smem;                  // q * scale
  float* Ds = Qs + BLK * st;         // do
  float* Ks = Ds + BLK * st;
  float* Vs = Ks + BLK * st;
  float* Ss = Vs + BLK * st;         // (BLK, BLK + 1): ds

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * BLK;
  const size_t base = (size_t)blockIdx.y * S * hd;
  const size_t rbase = (size_t)blockIdx.y * S;
  const int ntiles = (S + BLK - 1) / BLK;

  load_tile(Qs, q + base, q0, BLK, S, hd, st, scale);
  load_tile(Ds, dout + base, q0, BLK, S, hd, st, 1.f);
  float lse_r[TR], dr_r[TR], acc[TR][TC];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int qp = q0 + ty + 16 * i;
    lse_r[i] = qp < S ? lse[rbase + qp] : 0.f;
    dr_r[i] = qp < S ? drow[rbase + qp] : 0.f;
#pragma unroll
    for (int c = 0; c < TC; ++c) acc[i][c] = 0.f;
  }

  int lo, hi;
  kv_range(q0, min(q0 + BLK, S) - 1, BLK, ntiles, causal, window, &lo, &hi);
  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * BLK;
    __syncthreads();
    load_tile(Ks, k + base, k0, BLK, S, hd, st, 1.f);
    load_tile(Vs, v + base, k0, BLK, S, hd, st, 1.f);
    __syncthreads();
    float s[TR][TR], dp[TR][TR];
    tile_dot<TR>(Qs, Ks, hd, st, ty, tx, 1.f, 1.f, s);
    tile_dot<TR>(Ds, Vs, hd, st, ty, tx, 1.f, 1.f, dp);
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < TR; ++j) {
        const int c = tx + 16 * j;
        const float sv =
            allowed(q0 + r, k0 + c, S, causal, window) ? s[i][j] : NEG_INF;
        const float p = expf(sv - lse_r[i]);
        Ss[r * (BLK + 1) + c] = p * (dp[i][j] - dr_r[i]) * scale;
      }
    }
    __syncthreads();
    tile_acc<TR, TC>(Ss, BLK + 1, Ks, st, BLK, hd, ty, tx, acc);
  }
  store_rows<T>(dq + base, acc, q0, S, hd, ty, tx);
}

template <typename T, int HDMAX>
__global__ void __launch_bounds__(THREADS)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ drow,
               T* __restrict__ dk, T* __restrict__ dv, int S, int hd,
               int causal, int window, float scale) {
  using G = Tile<HDMAX>;
  constexpr int BLK = G::BLK, TR = G::TR, TC = G::TC;
  extern __shared__ float smem[];
  const int st = hd + 1;
  float* Ks = smem;
  float* Vs = Ks + BLK * st;
  float* Qs = Vs + BLK * st;         // unscaled q
  float* Ds = Qs + BLK * st;         // do
  float* Ps = Ds + BLK * st;         // (BLK, BLK + 1): p^T, key-major
  float* Ss = Ps + BLK * (BLK + 1);  // (BLK, BLK + 1): ds^T
  float* lse_s = Ss + BLK * (BLK + 1);
  float* dr_s = lse_s + BLK;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int k0 = blockIdx.x * BLK;
  const size_t base = (size_t)blockIdx.y * S * hd;
  const size_t rbase = (size_t)blockIdx.y * S;
  const int ntiles = (S + BLK - 1) / BLK;

  load_tile(Ks, k + base, k0, BLK, S, hd, st, 1.f);
  load_tile(Vs, v + base, k0, BLK, S, hd, st, 1.f);
  float dk_acc[TR][TC], dv_acc[TR][TC];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int c = 0; c < TC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  int lo, hi;
  q_range(k0, min(k0 + BLK, S) - 1, BLK, ntiles, causal, window, &lo, &hi);
  for (int qt = lo; qt <= hi; ++qt) {
    const int q0 = qt * BLK;
    __syncthreads();
    load_tile(Qs, q + base, q0, BLK, S, hd, st, 1.f);
    load_tile(Ds, dout + base, q0, BLK, S, hd, st, 1.f);
    for (int r = tid; r < BLK; r += THREADS) {
      const int qp = q0 + r;
      lse_s[r] = qp < S ? lse[rbase + qp] : 0.f;
      dr_s[r] = qp < S ? drow[rbase + qp] : 0.f;
    }
    __syncthreads();
    // key rows ty + 16 i, query columns tx + 16 j; the q factor is scaled
    // before the product, as the reference's (q * scale) @ k^T
    float sq[TR][TR], dp[TR][TR];
    tile_dot<TR>(Ks, Qs, hd, st, ty, tx, 1.f, scale, sq);
    tile_dot<TR>(Vs, Ds, hd, st, ty, tx, 1.f, 1.f, dp);
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < TR; ++j) {
        const int c = tx + 16 * j;
        const float sv =
            allowed(q0 + c, k0 + r, S, causal, window) ? sq[i][j] : NEG_INF;
        const float p = expf(sv - lse_s[c]);
        Ps[r * (BLK + 1) + c] = p;
        Ss[r * (BLK + 1) + c] = p * (dp[i][j] - dr_s[c]) * scale;
      }
    }
    __syncthreads();
    tile_acc<TR, TC>(Ps, BLK + 1, Ds, st, BLK, hd, ty, tx, dv_acc);
    tile_acc<TR, TC>(Ss, BLK + 1, Qs, st, BLK, hd, ty, tx, dk_acc);
  }
  store_rows<T>(dk + base, dk_acc, k0, S, hd, ty, tx);
  store_rows<T>(dv + base, dv_acc, k0, S, hd, ty, tx);
}

template <int HDMAX>
int dq_smem(int hd) {
  constexpr int BLK = Tile<HDMAX>::BLK;
  return (4 * BLK * (hd + 1) + BLK * (BLK + 1)) * (int)sizeof(float);
}

template <int HDMAX>
int dkv_smem(int hd) {
  constexpr int BLK = Tile<HDMAX>::BLK;
  return (4 * BLK * (hd + 1) + 2 * BLK * (BLK + 1) + 2 * BLK) *
         (int)sizeof(float);
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *drow;
  void *dq, *dk, *dv;
  int BH, S, hd, causal, window;
  float scale;
  cudaStream_t stream;
};

template <typename T, int HDMAX>
int launch_dq(const Args& a) {
  const int smem = dq_smem<HDMAX>(a.hd);
  auto kern = dq_kernel<T, HDMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int BLK = Tile<HDMAX>::BLK;
  dim3 grid((a.S + BLK - 1) / BLK, a.BH);
  kern<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.drow),
      static_cast<T*>(a.dq), a.S, a.hd, a.causal, a.window, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int HDMAX>
int launch_dkv(const Args& a) {
  const int smem = dkv_smem<HDMAX>(a.hd);
  auto kern = dkv_kernel<T, HDMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int BLK = Tile<HDMAX>::BLK;
  dim3 grid((a.S + BLK - 1) / BLK, a.BH);
  kern<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.drow),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.S, a.hd, a.causal,
      a.window, a.scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, bool dkv) {
  if (a.hd <= 64) return dkv ? launch_dkv<T, 64>(a) : launch_dq<T, 64>(a);
  if (a.hd <= 128) return dkv ? launch_dkv<T, 128>(a) : launch_dq<T, 128>(a);
  if (a.hd <= 256) return dkv ? launch_dkv<T, 256>(a) : launch_dq<T, 256>(a);
  return (int)cudaErrorInvalidValue;
}

int run(const Args& a, int dtype, bool dkv) {
  return dtype == 0 ? dispatch<float>(a, dkv)
                    : dispatch<__nv_bfloat16>(a, dkv);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; window <= 0 means no window. Each
// returns the launch's cudaGetLastError() (0 = launched).
extern "C" int flash_dq_launch(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* drow, void* dq, int BH, int S,
                               int hd, int causal, int window, float scale,
                               int dtype, void* stream) {
  Args a{q, k, v, dout, lse, drow, dq, nullptr, nullptr, BH, S, hd, causal,
         window, scale, static_cast<cudaStream_t>(stream)};
  return run(a, dtype, false);
}

extern "C" int flash_dkv_launch(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* drow, void* dk, void* dv, int BH,
                                int S, int hd, int causal, int window,
                                float scale, int dtype, void* stream) {
  Args a{q, k, v, dout, lse, drow, nullptr, dk, dv, BH, S, hd, causal,
         window, scale, static_cast<cudaStream_t>(stream)};
  return run(a, dtype, true);
}

extern "C" int flash_dq_smem_bytes(int hd) {
  if (hd <= 64) return dq_smem<64>(hd);
  if (hd <= 128) return dq_smem<128>(hd);
  return dq_smem<256>(hd);
}

extern "C" int flash_dkv_smem_bytes(int hd) {
  if (hd <= 64) return dkv_smem<64>(hd);
  if (hd <= 128) return dkv_smem<128>(hd);
  return dkv_smem<256>(hd);
}
