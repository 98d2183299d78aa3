// K6: the Mamba-2 SSD intra-chunk block.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py :: _ssd_kernel
// (launched by ssd_intra_chunk, pallas_call at kernel.py:66). Per (batch,
// chunk, head), with cs = cumsum(dA) over the chunk's L steps:
//   y[l, p]      = sum_{m <= l} (c_l . b_m) exp(cs_l - cs_m) xd[m, p]
//   states[p, n] = sum_l b[l, n] exp(cs_{L-1} - cs_l) xd[l, p]
//   chunk_decay  = exp(cs_{L-1})
// Inputs xd (B, nc, L, H, P), dA (B, nc, L, H), b and c (B, nc, L, N);
// outputs y_diag (B, nc, L, H, P), states (B, nc, H, P, N) and chunk_decay
// (B, nc, H), all f32.
//
// What bounds it on this card: operations, barely. At L = 128, P = 64,
// N = 128 a (batch, chunk, head) does ~2.6 M multiply-adds (c b^T over the
// lower triangle, W xd, the state product) against ~70 KB it must move,
// ~75 operations per byte before c b^T is shared between heads.
//
// What the design does about it: the (L, L) decay matrix never reaches
// device memory. One block of 256 threads per (b, chunk, head) takes the
// cumulative sum of dA in shared memory, holds b (L x N, rows padded by a
// word) and xd (L x P) there, and walks the chunk in 32-row tiles of
// c: each tile's W = (c b^T) * exp(cs_l - cs_m) is formed in shared
// memory over m <= l only and multiplied into y at once. The state
// product reuses the b tile. Each output element is written once. f32 CUDA
// cores, accurate expf; c b^T is recomputed per head (the TPU kernel
// shares it across a head tile), and tensor cores are later work.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TL = 32;  // rows of c (and of y) per tile

__global__ void __launch_bounds__(THREADS)
    ssd_kernel(const float* __restrict__ xd, const float* __restrict__ dA,
               const float* __restrict__ b, const float* __restrict__ c,
               float* __restrict__ y, float* __restrict__ states,
               float* __restrict__ decay, int nc, int L, int H, int P,
               int N) {
  extern __shared__ float smem[];
  const int bst = N + 1;
  float* cs = smem;                // (L)
  float* bs = cs + L;              // (L, N + 1)
  float* xs = bs + L * bst;        // (L, P)
  float* ct = xs + L * P;          // (TL, N)
  float* W = ct + TL * N;          // (TL, L)

  const int h = blockIdx.x, ci = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x;
  const size_t chunk = (size_t)bi * nc + ci;
  const float* bp = b + chunk * L * N;
  const float* cp = c + chunk * L * N;

  for (int l = tid; l < L; l += THREADS) cs[l] = dA[(chunk * L + l) * H + h];
  for (int idx = tid; idx < L * N; idx += THREADS) {
    const int l = idx / N, n = idx - l * N;
    bs[l * bst + n] = bp[idx];
  }
  for (int idx = tid; idx < L * P; idx += THREADS) {
    const int l = idx / P, p = idx - l * P;
    xs[idx] = xd[((chunk * L + l) * H + h) * P + p];
  }
  __syncthreads();
  if (tid == 0)
    for (int l = 1; l < L; ++l) cs[l] += cs[l - 1];
  __syncthreads();

  for (int l0 = 0; l0 < L; l0 += TL) {
    const int rows = min(TL, L - l0);
    for (int idx = tid; idx < rows * N; idx += THREADS)
      ct[idx] = cp[(size_t)l0 * N + idx];
    __syncthreads();
    // W[r, m] = (c_l . b_m) exp(cs_l - cs_m) for m <= l = l0 + r
    for (int idx = tid; idx < rows * L; idx += THREADS) {
      const int r = idx / L, m = idx - r * L, l = l0 + r;
      float w = 0.f;
      if (m <= l) {
        float att = 0.f;
        for (int n = 0; n < N; ++n)
          att = fmaf(ct[r * N + n], bs[m * bst + n], att);
        w = att * expf(cs[l] - cs[m]);
      }
      W[idx] = w;
    }
    __syncthreads();
    for (int idx = tid; idx < rows * P; idx += THREADS) {
      const int r = idx / P, p = idx - r * P, l = l0 + r;
      float acc = 0.f;
      for (int m = 0; m <= l; ++m) acc = fmaf(W[r * L + m], xs[m * P + p], acc);
      y[((chunk * L + l) * H + h) * P + p] = acc;
    }
    __syncthreads();
  }

  // xd[l, p] * exp(cs_{L-1} - cs_l), in place (y is done with xs)
  const float last = cs[L - 1];
  for (int idx = tid; idx < L * P; idx += THREADS)
    xs[idx] *= expf(last - cs[idx / P]);
  __syncthreads();
  float* st = states + (chunk * H + h) * (size_t)P * N;
  for (int idx = tid; idx < P * N; idx += THREADS) {
    const int p = idx / N, n = idx - p * N;
    float acc = 0.f;
    for (int l = 0; l < L; ++l) acc = fmaf(xs[l * P + p], bs[l * bst + n], acc);
    st[idx] = acc;
  }
  if (tid == 0) decay[chunk * H + h] = expf(last);
}

}  // namespace

extern "C" int ssd_smem_bytes(int L, int P, int N) {
  return (L + L * (N + 1) + L * P + TL * N + TL * L) * (int)sizeof(float);
}

// All tensors f32 and contiguous. Returns the launch's cudaGetLastError()
// (0 = launched).
extern "C" int ssd_launch(const void* xd, const void* dA, const void* b,
                          const void* c, void* y, void* states, void* decay,
                          int B, int nc, int L, int H, int P, int N,
                          void* stream) {
  const int smem = ssd_smem_bytes(L, P, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, nc, B);
  ssd_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xd), static_cast<const float*>(dA),
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<float*>(y), static_cast<float*>(states),
      static_cast<float*>(decay), nc, L, H, P, N);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
